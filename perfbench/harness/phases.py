"""Seconds of each part of a cell's set-up, for standard error (set-up as a
whole is `setup_s`)."""

from __future__ import annotations

import contextlib
import time

import torch


class Phases:
    def __init__(self, device):
        self.device, self.seconds = device, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0

    def line(self) -> str:
        return ", ".join(f"{k} {v:.3f} s" for k, v in self.seconds.items())
