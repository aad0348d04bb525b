"""Multi-head attention networks (follows deepxi_tpu/models/attention.py):
`MHANet` (V1), and `MHANetV2` and `MHANetV3`, the mhanet-1.0c/1.1c networks,
with the "full", "block", "fused" and "stream" attention.

V2/V3 attention follows tfa.layers.MultiHeadAttention as the reference uses
it: einsum projections with kernels [H, C, d_k] and [H, d_k, C] and no bias,
q scaled by d_k^-1/2, the mask applied as ``logits += -1e10 (1 - mask)``. V1
projects with bias-free dense layers, divides the logits by sqrt(d_k), adds a
-1e9 mask, and multiplies the softmax by the sequence mask. A frame is valid
iff any feature of the NETWORK INPUT is nonzero (Keras ``Masking(0.0)``).
LayerNorms are flax's ``nn.LayerNorm`` (variance in one pass, E[x^2] -
E[x]^2, eps 1e-6, scale and bias). Parameters keep the flax names and
layouts, so the weight bridge passes them unchanged, and `init_flax_like`
draws them as flax initialises the JAX modules.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepxi_tpu_torch.models import tcn
from deepxi_tpu_torch.models.tcn import Conv1d, layer_norm, output_activation

NEG_INF_V1 = -1.0e9   # MHANet V1's additive mask
NEG_INF_V2 = -1.0e10  # tfa's masking constant
ATTENTION_IMPLS = ("full", "block", "fused", "stream")


def sequence_valid_mask(x: torch.Tensor) -> torch.Tensor:
    """[B, T, F] network input -> [B, T] bool: a frame is valid iff any
    feature is nonzero."""
    return (x != 0.0).any(dim=-1)


def attention_masks(x: torch.Tensor, causal: bool):
    """MHANet V1's masks: (additive [B, T, T], 0 where the query and key
    are valid (and key <= query when causal) and -1e9 elsewhere; the
    multiplicative sequence mask [B, T, T], 1 where both are valid)."""
    valid = sequence_valid_mask(x)
    seq2d = valid[:, None, :] & valid[:, :, None]
    logical = seq2d
    if causal:
        T = x.shape[1]
        logical = logical & torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    att_mask = torch.where(logical, 0.0, NEG_INF_V1).to(torch.float32)
    return att_mask, seq2d.to(torch.float32)


def attention_mask_v2(x: torch.Tensor, causal: bool) -> torch.Tensor:
    """Float 1/0 mask [B, 1, T, T]: valid query and valid key (and key <=
    query when causal)."""
    valid = sequence_valid_mask(x)
    logical = valid[:, None, :] & valid[:, :, None]
    if causal:
        T = x.shape[1]
        logical = logical & torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return logical.to(torch.float32)[:, None]


def layer_norm_one_pass(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        eps: float = 1e-6) -> torch.Tensor:
    """flax `nn.LayerNorm`: var = max(E[x^2] - E[x]^2, 0); without `scale`
    and `bias` (``use_scale=False, use_bias=False``) the statistics only."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps)
    if scale is not None:
        mul = mul * scale
    y = (x - mu) * mul
    return y if bias is None else y + bias


def layer_norm_two_pass(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """The fused block kernel's LayerNorm: var = E[(x - E[x])^2]."""
    return layer_norm(x, eps) * scale + bias


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(epsilon=1e-6)`: `scale` and `bias` [C]."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_one_pass(x, self.scale, self.bias)


class Dense(nn.Module):
    """flax `nn.Dense`: `kernel` [C_in, C_out] and, unless `use_bias` is
    False, `bias` [C_out]."""

    def __init__(self, c_in: int, c_out: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class Embed(nn.Module):
    """flax `nn.Embed`: `embedding` [n, C]."""

    def __init__(self, n: int, c: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(n, c))


def blockwise_attention(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                        valid: torch.Tensor, causal: bool, block_q: int) -> torch.Tensor:
    """Query-blocked attention (the JAX package's `_blockwise_attention`):
    a loop over blocks of `block_q` queries, q zero-padded to a whole number
    of blocks, each block's [B, H, block_q, T] logits masked by
    ``-1e10 (1 - mask)`` with the mask rebuilt from the [B, T] valid vector
    (a padded query row reads the last frame's validity; key <= query when
    causal), so no [T, T] tensor is made. The same additive-mask softmax as
    "full": outputs match it to float rounding.

    qp/kp/vp: [B, T, H, d]; valid: [B, T] bool. Returns [B, T, H, d]."""
    B, T, H, d = qp.shape
    Tpad = -(-T // block_q) * block_q
    if Tpad != T:
        qp = F.pad(qp, (0, 0, 0, 0, 0, Tpad - T))
    key_pos = torch.arange(T, device=qp.device)
    outs = []
    for q0 in range(0, Tpad, block_q):
        logits = torch.einsum("btHd,bsHd->bHts", qp[:, q0:q0 + block_q], kp)
        q_pos = q0 + torch.arange(block_q, device=qp.device)
        q_valid = valid[:, torch.clamp(q_pos, max=T - 1)]
        mb = valid[:, None, :] & q_valid[:, :, None]            # [B, bq, T]
        if causal:
            mb = mb & (key_pos[None, None, :] <= q_pos[None, :, None])
        logits = logits + NEG_INF_V2 * (1.0 - mb[:, None].to(logits.dtype))
        outs.append(torch.einsum("bHts,bsHd->btHd", torch.softmax(logits, -1), vp))
    return torch.cat(outs, 1)[:, :T]


class MultiHeadAttentionV1(nn.Module):
    """MHANet V1's attention: bias-free dense projections `linear_q`,
    `linear_k`, `linear_v` and `linear_o` ([d_model, d_model] kernels),
    logits divided by sqrt(d_k), the additive mask added, softmax, then the
    weights multiplied by the sequence mask (the reference's order)."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads, self.d_k = n_heads, d_model // n_heads
        for name in ("linear_q", "linear_k", "linear_v", "linear_o"):
            self.add_module(name, Dense(d_model, d_model, use_bias=False))

    def forward(self, x: torch.Tensor, att_mask: torch.Tensor,
                seq_mask: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape

        def heads(h):
            return h.reshape(B, T, self.n_heads, self.d_k).transpose(1, 2)

        qh, kh, vh = (heads(getattr(self, n)(x)) for n in ("linear_q", "linear_k", "linear_v"))
        logits = torch.einsum("bhtd,bhsd->bhts", qh, kh) / (float(self.d_k) ** 0.5)
        w = torch.softmax(logits + att_mask[:, None], -1) * seq_mask[:, None]
        out = torch.einsum("bhts,bhsd->bhtd", w, vh).transpose(1, 2).reshape(B, T, C)
        return self.linear_o(out)


class TFAMultiHeadAttention(nn.Module):
    """tfa-style multi-head attention. `impl`: "full" materialises
    [B, H, T, T] logits (the plain reference); "block" loops over blocks of
    `block_q` queries (`blockwise_attention`, plain PyTorch, trainable);
    "fused" runs `ops.kernels.mha_fused.flash_attention`; "stream" runs
    `ops.kernels.mha_flash_stream.flash_attention_streaming` (block_k 512,
    as the JAX module calls it). All but "full" take the [B, T] valid mask
    instead of the [B, 1, T, T] one and match "full" on valid rows."""

    def __init__(self, head_size: int, num_heads: int, in_size: int,
                 output_size: int, impl: str = "full", block_q: int = 256):
        super().__init__()
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"Invalid attention impl {impl!r} "
                             f"({', '.join(ATTENTION_IMPLS)})")
        self.head_size, self.impl, self.block_q = head_size, impl, block_q
        shape = (num_heads, in_size, head_size)
        self.query_kernel = nn.Parameter(torch.zeros(shape))
        self.key_kernel = nn.Parameter(torch.zeros(shape))
        self.value_kernel = nn.Parameter(torch.zeros(shape))
        self.projection_kernel = nn.Parameter(
            torch.zeros(num_heads, head_size, output_size))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        qp = (torch.einsum("btI,HId->btHd", x, self.query_kernel)
              * (float(self.head_size) ** -0.5))
        kp = torch.einsum("bsI,HId->bsHd", x, self.key_kernel)
        vp = torch.einsum("bsI,HId->bsHd", x, self.value_kernel)
        if self.impl == "full":
            logits = torch.einsum("btHd,bsHd->bHts", qp, kp)
            if mask is not None:
                logits = logits + NEG_INF_V2 * (1.0 - mask)
            out = torch.einsum("bHts,bsHd->btHd", torch.softmax(logits, -1), vp)
        elif valid is None:
            raise ValueError(f"{self.impl} attention needs the [B, T] valid mask")
        elif self.impl == "block":
            out = blockwise_attention(qp, kp, vp, valid, causal, self.block_q)
        else:
            heads = (qp.contiguous(), kp.contiguous(), vp.contiguous())
            if self.impl == "stream":
                from deepxi_tpu_torch.ops.kernels.mha_flash_stream import \
                    flash_attention_streaming
                out = flash_attention_streaming(*heads, valid, causal, self.block_q)
            else:
                from deepxi_tpu_torch.ops.kernels.mha_fused import flash_attention
                out = flash_attention(*heads, valid, causal)
        return torch.einsum("btHd,Hdo->bto", out, self.projection_kernel)


class MHANet(nn.Module):
    """MHANet V1: a bias-free 1x1 in-conv, LayerNorm and ReLU, then
    `n_blocks` post-LN transformer blocks (`MultiHeadAttentionV1`, residual,
    LN, FFN d -> 4d (ReLU) -> d, residual, LN), then the output conv and
    activation. At mhanet-1.1c's widths (d_model 256, 5 blocks, 8 heads) it
    has 4,076,033 parameters in 65 leaves."""

    def __init__(self, n_feat: int, n_outp: int, d_model: int = 256,
                 n_blocks: int = 5, n_heads: int = 8, causal: bool = True,
                 outp_act: str = "Sigmoid"):
        super().__init__()
        self.n_blocks, self.causal, self.outp_act = n_blocks, causal, outp_act
        self.in_conv = Conv1d(n_feat, d_model, use_bias=False)
        self.in_ln = LayerNorm(d_model)
        for i in range(n_blocks):
            self.add_module(f"block{i}_mha", MultiHeadAttentionV1(d_model, n_heads))
            self.add_module(f"block{i}_ln1", LayerNorm(d_model))
            self.add_module(f"block{i}_ff1", Dense(d_model, 4 * d_model))
            self.add_module(f"block{i}_ff2", Dense(4 * d_model, d_model))
            self.add_module(f"block{i}_ln2", LayerNorm(d_model))
        self.out_conv = Conv1d(d_model, n_outp)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        att_mask, seq_mask = (m.to(inp.dtype) for m in attention_masks(inp, self.causal))
        x = torch.relu(self.in_ln(self.in_conv(inp)))
        for i in range(self.n_blocks):
            blk = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
            x = blk("ln1")(x + blk("mha")(x, att_mask, seq_mask))
            x = blk("ln2")(x + blk("ff2")(torch.relu(blk("ff1")(x))))
        return output_activation(self.out_conv(x), self.outp_act)


class MHANetV2(nn.Module):
    """MHANet V2: a bias-free 1x1 in-conv, LayerNorm and ReLU, then
    `n_blocks` post-LN transformer blocks (tfa attention, residual, LN, FFN
    d -> 4d (ReLU) -> d, residual, LN), then the output conv and activation.
    Weights come from `compat.artifact`."""

    def __init__(self, n_feat: int, n_outp: int, d_model: int = 256,
                 n_blocks: int = 5, n_heads: int = 8, causal: bool = True,
                 outp_act: str = "Sigmoid", attention_impl: str = "full",
                 block_q: int = 256):
        super().__init__()
        self.n_blocks, self.causal, self.outp_act = n_blocks, causal, outp_act
        self.attention_impl = attention_impl
        self.in_conv = Conv1d(n_feat, d_model, use_bias=False)
        self.in_ln = LayerNorm(d_model)
        d_k, d_ff = d_model // n_heads, 4 * d_model
        for i in range(n_blocks):
            self.add_module(f"block{i}_mha", TFAMultiHeadAttention(
                d_k, n_heads, d_model, d_model, attention_impl, block_q))
            self.add_module(f"block{i}_ln1", LayerNorm(d_model))
            self.add_module(f"block{i}_ff1", Dense(d_model, d_ff))
            self.add_module(f"block{i}_ff2", Dense(d_ff, d_model))
            self.add_module(f"block{i}_ln2", LayerNorm(d_model))
        self.out_conv = Conv1d(d_model, n_outp)

    def positional(self, x: torch.Tensor) -> torch.Tensor:
        return x  # V2 has no positional encoding

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        if self.attention_impl == "full":
            mask, valid = attention_mask_v2(inp, self.causal), None
        else:
            mask, valid = None, sequence_valid_mask(inp)
        x = torch.relu(self.in_ln(self.in_conv(inp)))
        x = self.positional(x)
        for i in range(self.n_blocks):
            blk = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
            h = blk("mha")(x, mask=mask, valid=valid, causal=self.causal)
            x = blk("ln1")(x + h)
            h = blk("ff2")(torch.relu(blk("ff1")(x)))
            x = blk("ln2")(x + h)
        return output_activation(self.out_conv(x), self.outp_act)


class MHANetV3(MHANetV2):
    """MHANetV2 plus a learned positional embedding added after the
    in-projection, indexed by `arange(T) % max_len` (positions wrap past
    `max_len` frames). mhanet-1.1c (d_model 256, 5 blocks, 8 heads, max_len
    2048) has 4,600,321 parameters."""

    def __init__(self, n_feat: int, n_outp: int, max_len: int = 2048, **kw):
        super().__init__(n_feat, n_outp, **kw)
        self.max_len = max_len
        self.pos_emb = Embed(max_len, self.in_ln.scale.shape[0])

    def positional(self, x: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(x.shape[1], device=x.device) % self.max_len
        return x + self.pos_emb.embedding[pos][None]


def _xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax `xavier_uniform()` (in_axis -2, out_axis -1): the leading axes
    are the receptive field, so a [H, I, d] kernel has fan_in H*I and
    fan_out H*d; uniform in +-sqrt(6 / (fan_in + fan_out))."""
    receptive = w[..., 0, 0].numel()
    fan_in, fan_out = receptive * w.shape[-2], receptive * w.shape[-1]
    a = (6.0 / (fan_in + fan_out)) ** 0.5
    nn.init.uniform_(w, -a, a, generator=generator)


def init_flax_like(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise an MHANet (V1, V2, V3) in place as flax does, from `generator` (a
    CPU generator; initialise on the CPU, then move): the 1x1 convs and the
    Dense kernels lecun_normal (a normal truncated to 2 standard deviations
    with variance 1 / fan_in), the attention kernels xavier_uniform, the
    positional embedding a normal of variance 1 / d_model (flax `Embed`),
    biases zero and LayerNorm scales one. Modules are visited in
    registration order; the numbers differ from flax's (another generator),
    the distributions are the same."""
    tcn.init_flax_like(net, generator)  # the convs
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Dense):
                std = m.kernel.shape[0] ** -0.5 / tcn.TRUNC_STD
                nn.init.trunc_normal_(m.kernel, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, TFAMultiHeadAttention):
                for w in (m.query_kernel, m.key_kernel, m.value_kernel,
                          m.projection_kernel):
                    _xavier_uniform_(w, generator)
            elif isinstance(m, Embed):
                nn.init.normal_(m.embedding, 0.0, m.embedding.shape[1] ** -0.5,
                                generator=generator)
            elif isinstance(m, LayerNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
    return net
