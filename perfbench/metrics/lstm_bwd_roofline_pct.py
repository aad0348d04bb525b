"""The LSTM backward kernel's share of its roofline (`lstm_backward_kernel`,
csrc/lstm.cu): a launch a block and step, each 8 B H^2 a valid frame at the
TF32 peak against dy, the saved gates and cell state, dxp and w_h once at
the memory's peak, over the kernel's device time."""

from perfbench.harness import peaks, work
from perfbench.harness.readers import roofline_pct


def read(ctx):
    H = ctx.cfg["d_model"]
    least = sum(peaks.least_seconds(work.lstm_flops(H) * frames,
                                    work.lstm_backward_bytes(T, B, H))
                for T, B, frames in ctx.work["shapes"])
    return roofline_pct(ctx, ("lstm_backward_kernel",), ctx.cfg["n_blocks"] * least)
