"""Host ms a call inside the port's `deepxi.enhance.input` span (host-card
copies layer: `make_enhancer`'s copy of the caller's pageable int16 batch
to the card, and its normalisation)."""

from perfbench.harness.spans import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "deepxi.enhance.input", ctx.work["calls"])
