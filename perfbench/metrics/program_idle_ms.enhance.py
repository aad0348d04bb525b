"""Device-idle ms a call that falls inside the port's `deepxi.enhance`
span (device layer): the part of `device_idle_pct.enhance` that the
program's own call leaves; the rest falls in the caller's loop."""

from perfbench.harness.spans import idle_ms_per


def read(ctx):
    return idle_ms_per(ctx, "deepxi.enhance", ctx.work["calls"])
