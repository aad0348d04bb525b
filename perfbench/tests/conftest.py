"""The benchmark's own tests: `python -m pytest perfbench/tests`. Those
marked `cuda` need an NVIDIA card and skip without one."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")
