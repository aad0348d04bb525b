"""The benchmark of the PyTorch/CUDA port `deepxi_tpu_torch` (BENCHMARK.json
at the repository's root names its cells and metrics). `run.py` is the
command; configurations, cells, traffic drivers and per-layer readers are
files found by name."""
