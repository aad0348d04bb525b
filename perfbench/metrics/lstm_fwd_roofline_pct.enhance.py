"""The LSTM forward kernel's share of its roofline in enhancement
(`lstm_forward_kernel`, csrc/lstm.cu): a launch a block, each 8 B H^2 a
valid frame at the TF32 peak against w_h, xp and ys once at the memory's
peak, over the kernel's device time."""

from perfbench.harness import peaks, work
from perfbench.harness.readers import roofline_pct


def read(ctx):
    w, H = ctx.work, ctx.cfg["d_model"]
    B = w["rows"]
    least = peaks.least_seconds(work.lstm_flops(H) * w["valid_frames"],
                                work.lstm_forward_bytes(w["T"], B, H))
    return roofline_pct(ctx, ("lstm_forward_kernel",),
                        w["calls"] * ctx.cfg["n_blocks"] * least)
