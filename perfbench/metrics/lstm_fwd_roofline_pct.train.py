"""The saving LSTM forward's share of its roofline in training
(`lstm_forward_kernel`): a launch a block and step, each 8 B H^2 a valid
frame at the TF32 peak against w_h, xp and ys once, and the gates and
cell state it saves for the backward, at the memory's peak."""

from perfbench.harness import peaks, work
from perfbench.harness.readers import roofline_pct


def read(ctx):
    H = ctx.cfg["d_model"]
    least = sum(peaks.least_seconds(work.lstm_flops(H) * frames,
                                    work.lstm_forward_bytes(T, B, H)
                                    + work.F32 * T * B * 5 * H)
                for T, B, frames in ctx.work["shapes"])
    return roofline_pct(ctx, ("lstm_forward_kernel",), ctx.cfg["n_blocks"] * least)
