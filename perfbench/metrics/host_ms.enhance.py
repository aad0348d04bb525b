"""Host ms a call inside the port's `deepxi.enhance` span (model step
layer: the whole of `enhance.make_enhancer`'s call, its input copy, the
launches and whatever the host waits for in it)."""

from perfbench.harness.spans import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "deepxi.enhance", ctx.work["calls"])
