"""The fused transformer block's share of its roofline (csrc/
mha_block_fused.cu: `mha_qkv_kernel`, the block's `mha_attention_kernel`
launch, `mha_post_kernel`): the least time of the blocks a call (each on
the valid frames: the products a frame plus 4 d a causal (frame, key)
pair at the TF32 peak, against the block's weights and its activations in
and out once at the memory's peak; `reference/networks/MHANetV3.py`,
`block_work`) over the three kernels' device time."""

from perfbench import named
from perfbench.harness import peaks
from perfbench.harness.readers import roofline_pct

KERNELS = ("mha_qkv_kernel", "mha_attention_kernel", "mha_post_kernel")


def read(ctx):
    w = ctx.work
    flops, nbytes = named.module("reference/networks", "MHANetV3").block_work(
        ctx.cfg, w["rows"], w["T"])
    return roofline_pct(ctx, KERNELS,
                        w["calls"] * ctx.cfg["n_blocks"] * peaks.least_seconds(flops, nbytes))
