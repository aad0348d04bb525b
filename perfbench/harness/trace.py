"""The traced window: torch.profiler over the window, reduced to device
time by kernel name, the device's busy and idle time, and the host's
activity in the device's idle gaps.

`short_name` and the lead-in kernel are copied from the repository's
`tools/torch_profile.py` (`short_name`, `device_ms`): a trace now and then
lacks the first device event of its window, so each trace starts with a
lead-in kernel (`torch.cuda._sleep`), left out of every count.
"""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

LEAD_IN = "spin_kernel"      # torch.cuda._sleep's kernel
WINDOW = "perfbench.window"  # the host span around the traced window


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespace and
    parameter list: `mha_attention_kernel<1, float>`."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name).strip()
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0 and i > 0:
            return name[:i].strip()
    return name


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


@dataclass
class Summary:
    """A traced window: `ops` (short name, start s, end s) of each device
    operation inside it, times from the window's start; `host` (name,
    start s, end s) of each host operation; the window's length and the
    seconds in which some device operation ran."""
    window_s: float
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merged([(s, e) for _, s, e in self.ops]))

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.ops:
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def matching(self, *parts: str) -> List[Tuple[str, float, float]]:
        """The device operations whose name contains one of `parts`."""
        return [op for op in self.ops if any(p in op[0] for p in parts)]

    def idle_gaps(self, top: int = 10, look_back: int = 256) -> List[List]:
        """The device's idle time inside the window, summed by what the
        host was doing at each gap's middle: the latest-starting host
        operation (of the `look_back` before it) that spans the middle,
        which in nested spans is the innermost; the `top` largest."""
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        busy = merged([(s, e) for _, s, e in self.ops])
        edges = [0.0] + [x for iv in busy for x in iv] + [self.window_s]
        by: Dict[str, float] = {}
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            i = bisect.bisect_right(starts, mid)
            label = "host outside any traced operation"
            for name, _, he in reversed(host[max(0, i - look_back):i]):
                if he > mid:
                    label = name
                    break
            by[label] = by.get(label, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": self.idle_gaps(top)}


class Traced:
    """`with Traced() as tr: ...` profiles the block on the card; then
    `tr.summary` is its `Summary`. The block's host time is the window."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarise(self._prof.profiler.kineto_results.events(), wall)
        return False


def summarise(events, wall_s: float) -> Summary:
    """Reduce the profiler's raw events (`name()`, `device_type()`,
    `start_ns()`, `end_ns()`) to a `Summary` of the WINDOW span (of its
    host length from the first device operation if the span is missing).
    The span's annotation on the device's track is no device work."""
    cuda = torch.autograd.DeviceType.CUDA
    t0 = t1 = None
    ops, host = [], []
    for e in events:
        name, on_card = e.name(), e.device_type() == cuda
        start, end = e.start_ns(), e.end_ns()
        if name == WINDOW:
            if not on_card:
                t0, t1 = start, end
        elif on_card:
            name = short_name(name)
            if LEAD_IN not in name:
                ops.append((name, start, end))
        else:
            host.append((name, start, end))
    if t0 is None:
        t0 = min((s for _, s, _ in ops), default=0)
        t1 = t0 + wall_s * 1e9

    def clip(items):
        return [(n, (max(s, t0) - t0) / 1e9, (min(e, t1) - t0) / 1e9)
                for n, s, e in items if e > t0 and s < t1]
    return Summary((t1 - t0) / 1e9, clip(ops), clip(host))
