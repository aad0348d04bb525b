"""Deep Xi's MHANetV3 (mhanet-1.1c; anicolson/DeepXi deepxi/network/
attention.py, `MHANetV3`), written plainly from a state dict of its
published layer names:

  h = ReLU(LN(x W_in))                       bias-free 1x1 in-projection
  h = h + E[t mod max_len]                   learned positions [max_len, d]
  each of n_blocks post-LN blocks:
    q, k, v = h W_q[j] d_k^-1/2, h W_k[j], h W_v[j]   heads j of d_k, no bias
    o[j] = softmax(q k^T + (-1e10)(1 - m)) v          m: valid query and key,
                                                      key <= query (causal)
    h = LN1(h + sum_j o[j] W_o[j])
    h = LN2(h + ReLU(h W_1 + b_1) W_2 + b_2)          FFN d -> d_ff -> d
  y = sigmoid(h W_out + b_out)

A frame is valid iff any feature of the network input is nonzero (Keras's
`Masking(0.0)`, which the published network takes its mask from). Every
product goes through `mm`, so the TF32 control rounds each one.

Departures from the published code, none of which changes a valid frame's
output beyond float32 rounding:
  * LayerNorm takes its variance in two passes, E[(x - E[x])^2] (as the
    program's fused block does); Keras's and flax's take one,
    E[x^2] - E[x]^2. eps 1e-6, scale and bias, as published.
  * A frame that is not valid attends to no valid key: every logit takes
    -1e10, which float32 absorbs, so its row is the plain mean of the
    values of the keys an implementation visits (here the T frames; the
    program's block visits T padded to a multiple of 128). Such a frame's
    output is implementation-defined; valid frames never read it (its key
    is masked), so compare valid frames only.
  * The projections are one [d, heads * d_k] product each, not tfa's
    einsum over [heads, d, d_k]: the same sums.

Operations count a multiply-add as two. `flops_per_frame` counts the
products whose cost does not depend on T (in-projection, each block's four
projections and FFN, output): 8,127,488 at mhanet-1.1c's widths. The
attention's 4 d a (frame, key) pair and block, over the valid keys at or
before the frame, grows with T, and the readers that know T count it
(`attention_work`, `block_work`): at T = 625 it is about 16% of the
forward, which `mfu_pct.enhance` therefore leaves out."""

from __future__ import annotations

import torch

from perfbench.reference.ops import layer_norm, matmul

NEG = -1.0e10   # tfa's additive masking constant
F32 = 4


def shapes(cfg: dict, n_feat: int, n_outp: int) -> dict:
    """{state-dict name: (shape, init)}, as `ResNetV2.shapes`; the
    attention kernels [heads, d, d_k] and [heads, d_k, d] as tfa keeps them,
    the positional table [max_len, d]."""
    d, H, f = cfg["d_model"], cfg["n_heads"], cfg["d_ff"]
    dk = d // H
    out = {"in_conv.kernel": ((1, n_feat, d), f"fan_in:{n_feat}"),
           "in_ln.scale": ((d,), "ones"), "in_ln.bias": ((d,), "zeros"),
           "pos_emb.embedding": ((cfg["max_len"], d), f"fan_in:{d}")}
    for i in range(cfg["n_blocks"]):
        m = f"block{i}_mha."
        for w in ("query", "key", "value"):
            out[f"{m}{w}_kernel"] = ((H, d, dk), f"fan_in:{d}")
        out[f"{m}projection_kernel"] = ((H, dk, d), f"fan_in:{d}")
        out[f"block{i}_ln1.scale"] = ((d,), "ones")
        out[f"block{i}_ln1.bias"] = ((d,), "zeros")
        out[f"block{i}_ff1.kernel"] = ((d, f), f"fan_in:{d}")
        out[f"block{i}_ff1.bias"] = ((f,), "zeros")
        out[f"block{i}_ff2.kernel"] = ((f, d), f"fan_in:{f}")
        out[f"block{i}_ff2.bias"] = ((d,), "zeros")
        out[f"block{i}_ln2.scale"] = ((d,), "ones")
        out[f"block{i}_ln2.bias"] = ((d,), "zeros")
    out["out_conv.kernel"] = ((1, d, n_outp), f"fan_in:{d}")
    out["out_conv.bias"] = ((n_outp,), "zeros")
    return out


def block_flops_per_frame(cfg: dict) -> int:
    """A block's products a frame whose cost does not depend on T: q, k,
    v and the output projection (d -> d each) and the FFN (1,572,864 at
    mhanet-1.1c's widths)."""
    d = cfg["d_model"]
    return 2 * (4 * d * d + 2 * d * cfg["d_ff"])


def causal_pairs(T: int) -> int:
    """(frame, key) pairs with the key at or before the frame, over T
    valid frames: sum of t + 1."""
    return T * (T + 1) // 2


def attention_work(cfg: dict, rows: int, T: int):
    """(operations, bytes) of one block's causal attention on `rows` rows
    of T valid frames: 4 d a causal pair (q.k, and the weight times v),
    against q, k, v and o once."""
    d = cfg["d_model"]
    return 4 * d * rows * causal_pairs(T), 4 * F32 * rows * T * d


def block_work(cfg: dict, rows: int, T: int):
    """(operations, bytes) of one whole block on `rows` rows of T valid
    frames: the products a frame plus the causal attention, against the
    block's weights and its activations in and out once (75.735 GFLOP at
    B=64, T=625; csrc/mha_block_fused.cu's header)."""
    d, f = cfg["d_model"], cfg["d_ff"]
    weights = F32 * (4 * d * d + 2 * d * f + f + 5 * d)
    att, _ = attention_work(cfg, rows, T)
    return block_flops_per_frame(cfg) * rows * T + att, weights + 2 * F32 * rows * T * d


def flops_per_frame(cfg: dict, n_feat: int, n_outp: int) -> int:
    """The forward a frame, the attention left out (see the module's
    docstring): in-projection, blocks, output."""
    d = cfg["d_model"]
    return 2 * n_feat * d + cfg["n_blocks"] * block_flops_per_frame(cfg) + 2 * d * n_outp


def train_flops_per_frame(cfg: dict, n_feat: int, n_outp: int) -> int:
    """Forward, input gradients and weight gradients: three times each
    product, less the in-projection's input gradient; the attention left
    out."""
    return 3 * flops_per_frame(cfg, n_feat, n_outp) - 2 * n_feat * cfg["d_model"]


def attention(h, valid, p: dict, m: str, cfg: dict, mm=matmul):
    """One block's multi-head attention on h [B, T, d], before the
    residual."""
    B, T, d = h.shape
    H = cfg["n_heads"]
    dk = d // H

    def heads(name):
        w = p[f"{m}{name}_kernel"].permute(1, 0, 2).reshape(d, d)
        return mm(h, w).reshape(B, T, H, dk).transpose(1, 2)

    q = heads("query") * float(dk) ** -0.5
    k, v = heads("key"), heads("value")
    mask = valid[:, None, :, None] & valid[:, None, None, :]
    if cfg["causal"]:
        mask = mask & torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    logits = mm(q, k.transpose(-1, -2)) + NEG * (1.0 - mask.float())
    o = mm(torch.softmax(logits, -1), v)
    return mm(o.transpose(1, 2).reshape(B, T, d), p[f"{m}projection_kernel"].reshape(d, d))


def forward(p: dict, x: torch.Tensor, cfg: dict, mm=matmul) -> torch.Tensor:
    valid = (x != 0).any(-1)
    h = torch.relu(layer_norm(mm(x, p["in_conv.kernel"][0]), p["in_ln.scale"], p["in_ln.bias"]))
    pos = torch.arange(x.shape[1], device=x.device) % cfg["max_len"]
    h = h + p["pos_emb.embedding"][pos]
    for i in range(cfg["n_blocks"]):
        b = f"block{i}_"
        h = layer_norm(h + attention(h, valid, p, b + "mha.", cfg, mm),
                       p[b + "ln1.scale"], p[b + "ln1.bias"])
        f = mm(torch.relu(mm(h, p[b + "ff1.kernel"]) + p[b + "ff1.bias"]), p[b + "ff2.kernel"])
        h = layer_norm(h + f + p[b + "ff2.bias"], p[b + "ln2.scale"], p[b + "ln2.bias"])
    return torch.sigmoid(mm(h, p["out_conv.kernel"][0]) + p["out_conv.bias"])
