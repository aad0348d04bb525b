"""The enhancement calls' share of the TF32 peak: the network's forward on
every frame plus an FFT's count for the analysis and the synthesis, from
the configuration's shapes, over the traced window (model step layer:
`enhance.make_enhancer`)."""

from perfbench.harness import work
from perfbench.harness.readers import peak_pct


def read(ctx):
    w = ctx.work
    return peak_pct(ctx, w["calls"] * w["valid_frames"] * work.enhance_flops_per_frame(ctx.cfg))
