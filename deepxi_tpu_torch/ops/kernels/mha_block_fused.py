"""The fused MHANet transformer block (follows
deepxi_tpu/ops/kernels/mha_block_fused.py).

`fused_transformer_block` runs one whole block (QKV projections, masked
attention, output projection, residual, LN1, the 4x FFN, residual, LN2) as
one call of `csrc/mha_block_fused.cu` (three launches: projections,
attention, the per-row rest, the last as thread block clusters when rows
are few; `block_grid` gives the launch shapes) for a CUDA tensor, and its plain version
`fused_transformer_block_ref` for a CPU tensor, both as the op
`deepxi::fused_transformer_block` (`ops.kernels.kernel_op`; its weights a
list of 12 tensors in `BlockWeights` order, so `torch.export` and CUDA graph
capture go through the kernel). Its `launches` counter counts calls, one per
block, in the CUDA implementation. The widths (heads, d_model, the FFN's) are read from
the weights; the wrapper builds one library per set of widths that
`kernel_takes` accepts, and raises ValueError on the card at any other.

Semantics as the JAX kernel: q scaled by d_k^-1/2, logits
``q.k + (-1e10)(1 - valid_q valid_k [causal])`` over all Tp keys and a
full-row softmax on every row (padded rows included), LayerNorms with a
two-pass variance, eps 1e-6, scale and bias. The JAX kernel's query-row
tiling (`tile_q`) does not change the function and is left out.

`mhanetv3_apply_fused` is the MHANetV3 (or, with ``positional=False``,
MHANetV2) forward through these blocks for sequences of at most
`whole_max_t` frames; longer ones run `models.attention.MHANetV3` with
``attention_impl="stream"``, as the JAX function does, and are counted by
its `long_route_calls`. Each call is the host span `deepxi.mha`
(`utils.profiling.annotate`).

Inference only: raises under autograd when an input or weight requires grad.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple

import torch

from deepxi_tpu_torch.models.attention import (MHANetV2, MHANetV3,
                                               layer_norm_two_pass,
                                               sequence_valid_mask)
from deepxi_tpu_torch.models.tcn import output_activation
from deepxi_tpu_torch.ops.kernels import (_build, kernel_op, launch_context,
                                          raw_stream, refuse_autograd)
from deepxi_tpu_torch.ops.kernels import mha_fused
from deepxi_tpu_torch.ops.kernels.mha_fused import (KERNEL_HEADS,
                                                    masked_softmax_attention)
from deepxi_tpu_torch.utils.profiling import annotate

# mhanet-1.1c's widths, the defaults of `random_block_weights`.
KERNEL_D_MODEL, KERNEL_D_FF = 256, 1024


def kernel_takes(d_model: int, n_heads: int, d_ff: int) -> bool:
    """Whether the block kernels can be built for these widths: heads that
    `mha_fused.kernel_takes` accepts, splitting d_model evenly, and an FFN
    width that is a multiple of d_model (the products walk it d_model
    columns at a time)."""
    return (n_heads >= 1 and d_model % n_heads == 0
            and mha_fused.kernel_takes(n_heads, d_model // n_heads)
            and d_ff >= d_model and d_ff % d_model == 0)


class BlockWeights(NamedTuple):
    """One MHANetV2/V3 transformer block (the JAX layouts)."""
    qk: torch.Tensor     # [H, C, d_k] query kernel
    kk: torch.Tensor     # [H, C, d_k]
    vk: torch.Tensor     # [H, C, d_k]
    ok: torch.Tensor     # [H, d_k, C] output projection
    ln1_s: torch.Tensor  # [C]
    ln1_b: torch.Tensor  # [C]
    ff1_w: torch.Tensor  # [C, d_ff]
    ff1_b: torch.Tensor  # [d_ff]
    ff2_w: torch.Tensor  # [d_ff, C]
    ff2_b: torch.Tensor  # [C]
    ln2_s: torch.Tensor  # [C]
    ln2_b: torch.Tensor  # [C]


def random_block_weights(generator: torch.Generator, device,
                         d_model: int = KERNEL_D_MODEL, n_heads: int = KERNEL_HEADS,
                         d_ff: int = KERNEL_D_FF) -> BlockWeights:
    """N(0, 1/fan_in) kernels, N(0, 0.1^2) biases and LN scales 1 + N(0,
    0.1^2), drawn on the CPU from `generator`."""
    dk = d_model // n_heads

    def rnd(*shape, std, mean=0.0):
        return (mean + torch.randn(*shape, generator=generator) * std).to(device)

    return BlockWeights(
        *(rnd(n_heads, d_model, dk, std=d_model ** -0.5) for _ in range(3)),
        rnd(n_heads, dk, d_model, std=d_model ** -0.5),
        rnd(d_model, std=0.1, mean=1.0), rnd(d_model, std=0.1),
        rnd(d_model, d_ff, std=d_model ** -0.5), rnd(d_ff, std=0.1),
        rnd(d_ff, d_model, std=d_ff ** -0.5), rnd(d_model, std=0.1),
        rnd(d_model, std=0.1, mean=1.0), rnd(d_model, std=0.1))


def fused_transformer_block_ref(x: torch.Tensor, validf: torch.Tensor,
                                weights: BlockWeights, causal: bool) -> torch.Tensor:
    """Plain version on x [B, Tp, C] with validf [B, 1, Tp] float 1/0."""
    w = weights
    valid = validf[:, 0] != 0
    q = torch.einsum("btc,Hcd->btHd", x, w.qk) * (float(w.qk.shape[2]) ** -0.5)
    k = torch.einsum("btc,Hcd->btHd", x, w.kk)
    v = torch.einsum("btc,Hcd->btHd", x, w.vk)
    o = masked_softmax_attention(q, k, v, valid, valid, causal)
    att = torch.einsum("btHd,Hdc->btc", o, w.ok)
    x1 = layer_norm_two_pass(x + att, w.ln1_s, w.ln1_b)
    f2 = torch.relu(x1 @ w.ff1_w + w.ff1_b) @ w.ff2_w
    return layer_norm_two_pass(x1 + f2 + w.ff2_b, w.ln2_s, w.ln2_b)


def _check(x: torch.Tensor, validf: torch.Tensor, weights: BlockWeights):
    """Raise on what the kernel does not take; returns the widths (heads,
    head width, FFN width), read from the query kernel and W1."""
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 [B, T, C] tensor, "
                         f"not {tuple(x.shape)} {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    B, T, C = x.shape
    if validf.shape != (B, 1, T) or validf.device != x.device:
        raise ValueError(f"validf must be [B, 1, T] = {(B, 1, T)} on {x.device}")
    H, dk, F = weights.qk.shape[0], weights.qk.shape[-1], weights.ff1_w.shape[-1]
    if H * dk != C or not kernel_takes(C, H, F):
        raise ValueError(f"the kernels do not take d_model {C} with {H} heads of "
                         f"{dk} and d_ff {F} (see kernel_takes)")
    shapes = BlockWeights((H, C, dk), (H, C, dk), (H, C, dk), (H, dk, C), (C,), (C,),
                          (C, F), (F,), (F, C), (C,), (C,), (C,))
    for t, shape in zip(weights, shapes):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"block weight of shape {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}; expected a contiguous {shape} "
                             f"float32 on {x.device}")
    return H, dk, F


def build_spec(n_heads: int, head_dim: int, d_ff: int):
    """The `_build` spec of `csrc/mha_block_fused.cu` at these widths."""
    return "mha_block_fused", {**mha_fused.head_defines(n_heads, head_dim),
                               "MHA_DFF": d_ff}


def block_grid(B: int, T: int, n_heads: int = KERNEL_HEADS,
               head_dim: int = KERNEL_D_MODEL // KERNEL_HEADS,
               d_ff: int = KERNEL_D_FF) -> Dict[str, int]:
    """The launch shapes of `fused_transformer_block` at [B, T] rows on the
    current card: rows a CTA and CTAs of the projection kernel, rows a slab,
    cluster size and CTAs of the post kernel (output projection, LN1, FFN,
    LN2)."""
    lib = _build.load(*build_spec(n_heads, head_dim, d_ff))
    out = (ctypes.c_int * 5)()
    rc = lib.mha_block_grid(B, T, out)
    if rc != 0:
        raise ValueError(f"no launch shape for B={B} T={T}")
    return dict(zip(("qkv_rows", "qkv_ctas", "post_rows", "post_cluster",
                     "post_ctas"), out))


def _block_cuda(x: torch.Tensor, validf: torch.Tensor, weights: List[torch.Tensor],
                causal: bool) -> torch.Tensor:
    bw = BlockWeights(*weights)
    H, dk, F = _check(x, validf, bw)
    B, T, _ = x.shape
    vf = validf.to(torch.float32).contiguous()
    q, k, v, o, out = (torch.empty_like(x) for _ in range(5))
    lib = _build.load(*build_spec(H, dk, F))
    with launch_context(x.device):
        rc = lib.mha_block_forward(
            x.data_ptr(), vf.data_ptr(), *(t.data_ptr() for t in bw),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            out.data_ptr(), B, T, int(causal), float(dk) ** -0.5,
            raw_stream(x.device))
    _build.check(lib, rc, "mha_block_forward")
    fused_transformer_block.launches += 1
    return out


_block_op = kernel_op(
    "fused_transformer_block", _block_cuda,
    lambda x, validf, weights, causal: fused_transformer_block_ref(
        x, validf, BlockWeights(*weights), causal))


def fused_transformer_block(x: torch.Tensor, validf: torch.Tensor,
                            weights: BlockWeights, causal: bool) -> torch.Tensor:
    """One whole transformer block: x [B, Tp, C] -> [B, Tp, C], validf
    [B, 1, Tp] float 1/0 frame validity from the network input."""
    refuse_autograd([x, *weights], "fused_transformer_block")
    return _block_op(x, validf, list(weights), causal)


fused_transformer_block.launches = 0


def block_weights(params: Dict[str, torch.Tensor], i: int) -> BlockWeights:
    """Block i's weights from a flat MHANetV2/V3 parameter dict."""
    m = f"block{i}_mha."
    return BlockWeights(
        params[m + "query_kernel"], params[m + "key_kernel"],
        params[m + "value_kernel"], params[m + "projection_kernel"],
        *(params[f"block{i}_{mod}.{leaf}"] for mod, leaf in (
            ("ln1", "scale"), ("ln1", "bias"), ("ff1", "kernel"), ("ff1", "bias"),
            ("ff2", "kernel"), ("ff2", "bias"), ("ln2", "scale"), ("ln2", "bias"))))


@functools.lru_cache(maxsize=None)
def _stream_net(positional: bool, n_feat: int, n_outp: int, d_model: int,
                n_blocks: int, n_heads: int, causal: bool, outp_act: str,
                max_len: int):
    """The long route's module, on the meta device: `functional_call` gives
    it the weights."""
    kw = dict(d_model=d_model, n_blocks=n_blocks, n_heads=n_heads,
              causal=causal, outp_act=outp_act, attention_impl="stream")
    with torch.device("meta"):
        if positional:
            return MHANetV3(n_feat, n_outp, max_len=max_len, **kw)
        return MHANetV2(n_feat, n_outp, **kw)


def mhanetv3_apply_fused(params: Dict[str, torch.Tensor], x: torch.Tensor,
                         n_blocks: int = 5, n_heads: int = 8,
                         d_model: int = 256, max_len: int = 2048,
                         causal: bool = True, outp_act: str = "Sigmoid",
                         positional: bool = True,
                         whole_max_t: int = 2048) -> torch.Tensor:
    """MHANetV3 forward ([B, T, F] network input, padded frames all zero)
    with every transformer block one `fused_transformer_block` call;
    ``positional=False`` makes it MHANetV2. `params` is the flat
    `module.leaf` dict of `models.attention.MHANetV3.state_dict()`.
    Sequences longer than `whole_max_t` frames run the module with streaming
    attention."""
    refuse_autograd([x, *params.values()], "mhanetv3_apply_fused")
    with annotate("deepxi.mha"):
        B, T, F = x.shape
        if T > whole_max_t:
            from torch.func import functional_call
            mhanetv3_apply_fused.long_route_calls += 1
            net = _stream_net(positional, F, params["out_conv.bias"].shape[0],
                              d_model, n_blocks, n_heads, causal, outp_act, max_len)
            return functional_call(net, params, (x,))

        valid = sequence_valid_mask(x).to(torch.float32)
        h = x @ params["in_conv.kernel"][0]
        h = torch.relu(layer_norm_two_pass(h, params["in_ln.scale"], params["in_ln.bias"]))
        if positional:
            pos = torch.arange(T, device=x.device) % max_len
            h = h + params["pos_emb.embedding"][pos][None]
        Tp = -(-T // 128) * 128
        if Tp != T:
            h = torch.nn.functional.pad(h, (0, 0, 0, Tp - T))
            valid = torch.nn.functional.pad(valid, (0, Tp - T))
        vf = valid[:, None, :]
        for i in range(n_blocks):
            h = fused_transformer_block(h, vf, block_weights(params, i), causal)
        out = h[:, :T] @ params["out_conv.kernel"][0] + params["out_conv.bias"]
        return output_activation(out, outp_act)


mhanetv3_apply_fused.long_route_calls = 0
