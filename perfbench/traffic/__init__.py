"""One driver per kind of traffic; a cell's workload file names its kind."""
