"""Device ms a call of the host-to-card and card-to-host copies (the int16
batch in, the enhanced waveform out)."""

from perfbench.harness.readers import COPIES, device_ms_per


def read(ctx):
    return device_ms_per(ctx, COPIES, ctx.work["calls"])
