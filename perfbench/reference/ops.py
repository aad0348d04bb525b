"""The products and the LayerNorm the reference networks share."""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest even; the
    gradient passes straight through."""
    bits = x.detach().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


def matmul(a, b):
    return a @ b


def matmul_tf32(a, b):
    """The product as the tensor cores' TF32 mode makes it: operands rounded
    to TF32, sums in float32 (the precision control)."""
    return round_tf32(a) @ round_tf32(b)


def layer_norm(x, scale=None, bias=None, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps)
    if scale is not None:
        y = y * scale
    return y if bias is None else y + bias
