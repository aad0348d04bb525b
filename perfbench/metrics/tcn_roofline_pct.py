"""The fused TCN forward's share of its roofline (`tcn_window_kernel`,
csrc/tcn_fused.cu): the least time of the block stack a call (every block
on the valid frames at the TF32 peak, against the stack's input and output
once and each block's weights once at the memory's peak) over the
kernels' device time."""

from perfbench.harness import peaks, work
from perfbench.harness.readers import roofline_pct


def read(ctx):
    w = ctx.work
    flops, nbytes = work.tcn_stack(ctx.cfg, w["rows"], w["T"], w["valid_frames"])
    return roofline_pct(ctx, ("tcn_window_kernel",),
                        w["calls"] * peaks.least_seconds(flops, nbytes))
