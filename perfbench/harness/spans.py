"""What the span readers share: the port's host spans (`utils.profiling.
annotate`, e.g. `deepxi.enhance`) found by exact name among the traced
window's host operations, the host ms inside them, and the device's idle ms
inside them (the window less the union of the device operations). Each
returns None where the trace holds no such span, as a program without the
spans gives."""

from __future__ import annotations

from typing import List, Tuple

from perfbench.harness.trace import merged

Intervals = List[Tuple[float, float]]


def intervals(summary, name: str) -> Intervals:
    """The union of the host spans named exactly `name`, in the window."""
    return merged([(s, e) for n, s, e in summary.host if n == name])


def length(ivs: Intervals) -> float:
    return sum(e - s for s, e in ivs)


def intersect(a: Intervals, b: Intervals) -> Intervals:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Intervals, b: Intervals) -> Intervals:
    """The parts of sorted disjoint `a` outside sorted disjoint `b`."""
    return intersect(a, complement(b, a[0][0], a[-1][1])) if a else []


def complement(ivs: Intervals, start: float, end: float) -> Intervals:
    """[start, end) less the sorted disjoint `ivs`."""
    out, at = [], start
    for s, e in ivs:
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if s < e]


def idle(summary) -> Intervals:
    """The window's time in which no device operation ran."""
    return complement(merged([(s, e) for _, s, e in summary.ops]), 0.0, summary.window_s)


def host_ms_per(ctx, name: str, count: int, outside: str = None):
    """Host ms inside the spans `name` (less those inside the spans
    `outside`), over `count` calls, steps or hops."""
    spans = intervals(ctx.trace, name)
    if not spans or count <= 0:
        return None
    if outside is not None:
        inner = intervals(ctx.trace, outside)
        if not inner:
            return None
        spans = subtract(spans, inner)
    return 1e3 * length(spans) / count


def idle_ms_per(ctx, name: str, count: int):
    """Device-idle ms inside the spans `name`, over `count` calls, steps
    or hops."""
    spans = intervals(ctx.trace, name)
    if not spans or not ctx.trace.ops or count <= 0:
        return None
    return 1e3 * length(intersect(idle(ctx.trace), spans)) / count
