"""Tracing and profiling hooks (follows deepxi_tpu/utils/profiling.py).

`trace` records a `torch.profiler` trace (host and, on the card, device
activity) into a directory; `annotate` names a host span of any running
profiler's trace; `StageTimer` accumulates wall-clock stage times that wait
for the card's work, so reported times include the device's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled
from torch.utils import _pytree as pytree

_NO_SPAN = contextlib.nullcontext()


def _synchronize_cuda(tree) -> None:
    """Wait for the card when any leaf of `tree` is a CUDA tensor."""
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    with timer.stage("train_step", block_on=loss): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time the block; with `block_on` (a tensor or a tree of them)
        holding a CUDA tensor, the card is synchronised before the clock
        stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize_cuda(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        rows = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            n = self.counts[k]
            tot = self.totals[k]
            rows.append(f"{k:24s} total {tot:8.3f}s  calls {n:6d}  "
                        f"mean {1000 * tot / n:8.3f}ms")
        return "\n".join(rows)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Record a `torch.profiler` trace of the block into `log_dir` (a
    Chrome/TensorBoard trace file); a no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """`with annotate(name):` a host span of the running `torch.profiler`
    trace, on the clock of its device events: a function-scope
    `RecordFunction`, so it adds no annotation to the device's track and no
    op to a `torch.export` graph. With no profiler running (or under a
    compiler's trace) it is a shared no-op context, one C call's cost."""
    if _profiler_enabled() and not torch.compiler.is_compiling():
        return _RecordFunctionFast(name)
    return _NO_SPAN
