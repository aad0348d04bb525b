"""Residual temporal convolutional networks (follows deepxi_tpu/models/tcn.py):
`ResNet` (resnet-1.0c/1.0n), `ResNetV2` (resnet-1.1c/1.1n), `ResNetV3`, and
`init_flax_like`, a seeded initialisation that follows flax's. Causal convs
pad (k-1)d on the left (Keras 'causal'), non-causal ones split it, the
larger half on the right (Keras 'same').

Activations are [B, T, C] and conv kernels [k, C_in, C_out], the JAX
package's layouts, so parameters pass between the two packages unchanged.
A dilated conv is k shifted matrix products; this plain network is the
reference that the fused kernels in `ops/kernels/tcn_fused.py` are held to.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def cyclic_dilation(i: int, max_d_rate: int) -> int:
    """Dilation for block i: cycles 1, 2, ..., max_d_rate, 1, 2, ..."""
    return int(2 ** (i % (math.log2(max_d_rate) + 1)))


def output_activation(x: torch.Tensor, outp_act: str) -> torch.Tensor:
    """Shared output head activation."""
    if outp_act == "Sigmoid":
        return torch.sigmoid(x)
    if outp_act == "ReLU":
        return torch.relu(x)
    if outp_act == "Softplus":
        return F.softplus(x)
    if outp_act == "Linear":
        return x
    raise ValueError(f"Invalid outp_act: {outp_act!r}")


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Frame-wise LayerNorm over channels with no scale or centre."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
           d: int = 1, causal: bool = True) -> torch.Tensor:
    """[B, T, C_in] -> [B, T, C_out] dilated conv with kernel
    [k, C_in, C_out] (and no bias when `bias` is None): the input is
    zero-padded (k-1)d on the left when causal, else (k-1)d // 2 on the left
    and the rest on the right."""
    k, T = kernel.shape[0], x.shape[1]
    total = (k - 1) * d
    left = total if causal else total // 2
    xp = F.pad(x, (0, 0, left, total - left))
    y = torch.matmul(xp[:, :T], kernel[0])
    if bias is not None:
        y = bias + y
    for j in range(1, k):
        y = y + torch.matmul(xp[:, j * d: j * d + T], kernel[j])
    return y


class Conv1d(nn.Module):
    """Parameters of one conv: `kernel` [k, C_in, C_out] and, unless
    `use_bias` is False, `bias` [C_out]; zero until weights are loaded or
    `init_flax_like` runs."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, d: int = 1,
                 use_bias: bool = True, causal: bool = True):
        super().__init__()
        self.d, self.causal = d, causal
        self.kernel = nn.Parameter(torch.zeros(k, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.kernel, self.bias, self.d, self.causal)


class ScaleNorm(nn.Module):
    """LayerNorm with a learned scale and no centre (ResNetV2's `ff_ln`)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x) * self.scale


class AffineNorm(nn.Module):
    """LayerNorm with a learned scale and centre (ResNet's)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x) * self.scale + self.bias


class ResNet(nn.Module):
    """The original Deep Xi ResNet (resnet-1.0c/1.0n): conv (no bias) ->
    LN -> ReLU, then n_blocks bottleneck blocks of three LN -> ReLU -> conv
    units, the LayerNorms with scale and centre and only the third conv
    biased, then the output conv and activation."""

    def __init__(self, n_feat: int, n_outp: int, n_blocks: int = 40,
                 d_model: int = 256, d_f: int = 64, k: int = 3,
                 max_d_rate: int = 16, causal: bool = True,
                 outp_act: str = "Sigmoid"):
        super().__init__()
        self.n_blocks, self.outp_act, self.causal = n_blocks, outp_act, causal
        self.ff_conv = Conv1d(n_feat, d_model, use_bias=False)
        self.ff_ln = AffineNorm(d_model)
        for i in range(n_blocks):
            d = cyclic_dilation(i, max_d_rate)
            for u, (c_in, c_out, kk, dd, bias) in enumerate(
                    ((d_model, d_f, 1, 1, False), (d_f, d_f, k, d, False),
                     (d_f, d_model, 1, 1, True)), start=1):
                self.add_module(f"block{i}_u{u}_ln", AffineNorm(c_in))
                self.add_module(f"block{i}_u{u}_conv",
                                Conv1d(c_in, c_out, kk, dd, bias, causal))
        self.out_conv = Conv1d(d_model, n_outp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.ff_ln(self.ff_conv(x)))
        for i in range(self.n_blocks):
            h = x
            for u in (1, 2, 3):
                ln = getattr(self, f"block{i}_u{u}_ln")
                h = getattr(self, f"block{i}_u{u}_conv")(torch.relu(ln(h)))
            x = x + h
        return output_activation(self.out_conv(x), self.outp_act)


UNIT_TYPES = ("ReLU->LN->W+b", "LN->ReLU->W+b")


class ResNetV2(nn.Module):
    """ResNetV2 (resnet-1.1c causal, resnet-1.1n not): conv -> scale-only
    LN -> ReLU, then n_blocks bottleneck blocks of three biased units with
    stat-only LN in `unit_type` order, then the output conv and activation.
    resnet-1.1c (40 blocks, d_model 256, d_f 64, k 3, max_d_rate 16) has
    1,949,953 parameters. Weights come from `compat.artifact` or
    `init_flax_like`."""

    def __init__(self, n_feat: int, n_outp: int, n_blocks: int = 40,
                 d_model: int = 256, d_f: int = 64, k: int = 3,
                 max_d_rate: int = 16, outp_act: str = "Sigmoid",
                 causal: bool = True, unit_type: str = "ReLU->LN->W+b"):
        super().__init__()
        if unit_type not in UNIT_TYPES:
            raise ValueError(f"Invalid unit_type: {unit_type!r}")
        self.n_blocks, self.outp_act = n_blocks, outp_act
        self.causal, self.unit_type = causal, unit_type
        self.ln_first = unit_type == "LN->ReLU->W+b"
        self.ff_conv = Conv1d(n_feat, d_model)
        self._feedforward_norm(d_model)
        for i in range(n_blocks):
            d = cyclic_dilation(i, max_d_rate)
            self.add_module(f"block{i}_u1_conv", Conv1d(d_model, d_f))
            self.add_module(f"block{i}_u2_conv", Conv1d(d_f, d_f, k, d, causal=causal))
            self.add_module(f"block{i}_u3_conv", Conv1d(d_f, d_model))
        self.out_conv = Conv1d(d_model, n_outp)

    def _feedforward_norm(self, d_model: int) -> None:
        self.ff_ln = ScaleNorm(d_model)

    def feedforward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.ff_ln(self.ff_conv(x)))

    def _unit(self, h: torch.Tensor, conv: Conv1d) -> torch.Tensor:
        if self.ln_first:
            return conv(torch.relu(layer_norm(h)))
        return conv(layer_norm(torch.relu(h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.feedforward(x)
        for i in range(self.n_blocks):
            h = self._unit(x, getattr(self, f"block{i}_u1_conv"))
            h = self._unit(h, getattr(self, f"block{i}_u2_conv"))
            x = x + self._unit(h, getattr(self, f"block{i}_u3_conv"))
        return output_activation(self.out_conv(x), self.outp_act)


class ResNetV3(ResNetV2):
    """ResNetV2 with the first layer corrected to conv -> ReLU -> stat-only
    LN (no `ff_ln` parameters)."""

    def _feedforward_norm(self, d_model: int) -> None:
        pass

    def feedforward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(torch.relu(self.ff_conv(x)))


# Standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides by it so the truncated draw keeps the variance.
TRUNC_STD = 0.87962566103423978


def init_flax_like(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise in place as flax does, from `generator` (a CPU generator;
    initialise on the CPU, then move): conv kernels lecun_normal, a normal
    truncated to 2 standard deviations with variance 1 / fan_in and
    fan_in = k * C_in; zero biases; LayerNorm scales ones and centres
    zeros. Modules are visited in registration order. The numbers differ from flax's (another
    generator); the distribution is the same."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Conv1d):
                k, c_in, _ = m.kernel.shape
                std = (k * c_in) ** -0.5 / TRUNC_STD
                nn.init.trunc_normal_(m.kernel, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (ScaleNorm, AffineNorm)):
                m.scale.fill_(1.0)
                if isinstance(m, AffineNorm):
                    m.bias.zero_()
    return net
