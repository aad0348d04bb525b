"""The benchmark's inputs, made from the run's seed."""
