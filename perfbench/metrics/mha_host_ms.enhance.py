"""Host ms a call inside the port's `deepxi.mha` span (model step layer:
`mhanetv3_apply_fused`'s mask, in-projection, positions, padding, the
block calls and the output), the launches and whatever the host waits
for in them."""

from perfbench.harness.spans import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "deepxi.mha", ctx.work["calls"])
