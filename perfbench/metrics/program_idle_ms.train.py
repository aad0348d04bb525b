"""Device-idle ms a step that falls inside the port's `deepxi.train.step`
span (device layer): the part of `device_idle_pct.train` that the step
itself leaves; the rest falls in the caller's loop."""

from perfbench.harness.spans import idle_ms_per


def read(ctx):
    return idle_ms_per(ctx, "deepxi.train.step", ctx.work["steps"])
