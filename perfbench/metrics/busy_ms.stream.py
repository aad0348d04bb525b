"""Device ms a hop in which some kernel or copy ran (device layer): the
traced window's busy time over its hops. Read from the operations' own
durations, so the profiler's stretch of the hops' schedule (the replay of
a ~500-node graph under CUPTI) does not enter it, as it enters an idle
share or a step's share of the peak over the window."""

from perfbench.harness.readers import busy_ms_per


def read(ctx):
    return busy_ms_per(ctx, ctx.work["hops"])
