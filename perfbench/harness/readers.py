"""What the per-layer readers share: the device's idle share, a step's
share of the TF32 peak, device time a call by kernel name, and a kernel's
share of its roofline. Each returns None where the trace has nothing to
read; no share reads 0 for want of a kernel."""

from __future__ import annotations

from perfbench.harness import peaks

COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def idle_pct(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def peak_pct(ctx, flops: float):
    """`flops` done in the traced window over the window at the TF32 peak."""
    if flops <= 0 or ctx.trace.window_s <= 0:
        return None
    return 100.0 * flops / (ctx.trace.window_s * peaks.TF32_FLOP_S)


def device_ms_per(ctx, parts, count: int):
    """Device ms of the operations whose name holds one of `parts`, over
    `count` calls, steps or hops."""
    ops = ctx.trace.matching(*parts)
    if not ops or count <= 0:
        return None
    return 1e3 * sum(e - s for _, s, e in ops) / count


def roofline_pct(ctx, parts, least_s: float):
    """The least time of the traced work (`least_s`) over the device time
    of the kernels whose name holds one of `parts`."""
    ops = ctx.trace.matching(*parts)
    spent = sum(e - s for _, s, e in ops)
    if not ops or spent <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / spent


def busy_ms_per(ctx, count: int):
    """Device ms in which some operation ran, over `count` calls, steps or
    hops."""
    if not ctx.trace.ops or count <= 0:
        return None
    return 1e3 * ctx.trace.busy_s / count
