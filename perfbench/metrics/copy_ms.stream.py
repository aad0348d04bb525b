"""Device ms a hop of the host-to-card and card-to-host copies of
`serving.StreamingServer.step` (the chunk in, the hop out)."""

from perfbench.harness.readers import COPIES, device_ms_per


def read(ctx):
    return device_ms_per(ctx, COPIES, ctx.work["hops"])
