"""The fused block's attention launch's share of its roofline
(`mha_attention_kernel`, csrc/mha_common.cuh): the least time of the
blocks' causal attention a call (4 d a (frame, key) pair with the key at
or before the frame, on valid frames, at the TF32 peak, against q, k, v
and o once at the memory's peak; `reference/networks/MHANetV3.py`,
`attention_work`) over the kernel's device time."""

from perfbench import named
from perfbench.harness import peaks
from perfbench.harness.readers import roofline_pct


def read(ctx):
    w = ctx.work
    flops, nbytes = named.module("reference/networks", "MHANetV3").attention_work(
        ctx.cfg, w["rows"], w["T"])
    return roofline_pct(ctx, ("mha_attention_kernel",),
                        w["calls"] * ctx.cfg["n_blocks"] * peaks.least_seconds(flops, nbytes))
