"""Host ms a hop inside the port's `deepxi.stream.step` span and outside
its `deepxi.stream.replay` (serving layer: `StreamingServer.step`'s chunk
copy in, the copies of the state in and out of the captured state, the
output's clone)."""

from perfbench.harness.spans import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "deepxi.stream.step", ctx.work["hops"],
                       outside="deepxi.stream.replay")
