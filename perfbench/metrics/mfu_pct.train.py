"""The train steps' share of the TF32 peak: forward, input and weight
gradients on the valid frames, and the three spectra of each example, from
the configuration's shapes, over the traced window (model step layer:
`training.make_train_step`)."""

from perfbench.harness import work
from perfbench.harness.readers import peak_pct


def read(ctx):
    per_frame = work.train_flops_per_frame(ctx.cfg) + 3 * work.fft_flops(ctx.cfg["K"])
    return peak_pct(ctx, sum(frames for _, _, frames in ctx.work["shapes"]) * per_frame)
