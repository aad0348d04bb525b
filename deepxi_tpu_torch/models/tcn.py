"""Residual temporal convolutional networks (follows deepxi_tpu/models/tcn.py;
so far `ResNetV2`, the resnet-1.1c/1.1n network, and `init_flax_like`, a
seeded initialisation that follows flax's).

Activations are [B, T, C] and conv kernels [k, C_in, C_out], the JAX
package's layouts, so parameters pass between the two packages unchanged.
A dilated conv is k shifted matrix products; this plain network is the
reference that the fused kernels in `ops/kernels/tcn_fused.py` are held to.
"""

from __future__ import annotations

import math

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


def conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           d: int = 1) -> torch.Tensor:
    """[B, T, C_in] -> [B, T, C_out] causal dilated conv with kernel
    [k, C_in, C_out]: the input is zero-padded (k-1)d on the left."""
    k, T = kernel.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, (k - 1) * d, 0))
    y = bias + torch.matmul(xp[:, :T], kernel[0])
    for j in range(1, k):
        y = y + torch.matmul(xp[:, j * d: j * d + T], kernel[j])
    return y


class Conv1d(nn.Module):
    """Parameters of one causal conv: `kernel` [k, C_in, C_out] and `bias`
    [C_out], zero until weights are loaded or `init_flax_like` runs."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, d: int = 1):
        super().__init__()
        self.d = d
        self.kernel = nn.Parameter(torch.zeros(k, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.kernel, self.bias, self.d)


class ScaleNorm(nn.Module):
    """LayerNorm with a learned scale and no centre (ResNetV2's `ff_ln`)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x) * self.scale


class ResNetV2(nn.Module):
    """Causal ResNetV2 with ReLU->LN->W+b units (resnet-1.1c): conv ->
    scale-only LN -> ReLU, then n_blocks bottleneck blocks of three biased
    units with stat-only LN, then the output conv and activation. resnet-1.1c
    (40 blocks, d_model 256, d_f 64, k 3, max_d_rate 16) has 1,949,953
    parameters. Weights come from `compat.artifact` or `init_flax_like`."""

    def __init__(self, n_feat: int, n_outp: int, n_blocks: int = 40,
                 d_model: int = 256, d_f: int = 64, k: int = 3,
                 max_d_rate: int = 16, outp_act: str = "Sigmoid"):
        super().__init__()
        self.n_blocks, self.outp_act = n_blocks, outp_act
        self.ff_conv = Conv1d(n_feat, d_model)
        self.ff_ln = ScaleNorm(d_model)
        for i in range(n_blocks):
            d = cyclic_dilation(i, max_d_rate)
            self.add_module(f"block{i}_u1_conv", Conv1d(d_model, d_f))
            self.add_module(f"block{i}_u2_conv", Conv1d(d_f, d_f, k, d))
            self.add_module(f"block{i}_u3_conv", Conv1d(d_f, d_model))
        self.out_conv = Conv1d(d_model, n_outp)

    @staticmethod
    def _unit(h: torch.Tensor, conv: Conv1d) -> torch.Tensor:
        return conv(layer_norm(torch.relu(h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.ff_ln(self.ff_conv(x)))
        for i in range(self.n_blocks):
            h = self._unit(x, getattr(self, f"block{i}_u1_conv"))
            h = self._unit(h, getattr(self, f"block{i}_u2_conv"))
            x = x + self._unit(h, getattr(self, f"block{i}_u3_conv"))
        return output_activation(self.out_conv(x), self.outp_act)


# Standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides by it so the truncated draw keeps the variance.
_TRUNC_STD = 0.87962566103423978


def init_flax_like(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise in place as flax does, from `generator` (a CPU generator;
    initialise on the CPU, then move): conv kernels lecun_normal, a normal
    truncated to 2 standard deviations with variance 1 / fan_in and
    fan_in = k * C_in; zero biases; `ff_ln.scale` ones. Modules are visited
    in registration order. The numbers differ from flax's (another
    generator); the distribution is the same."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Conv1d):
                k, c_in, _ = m.kernel.shape
                std = (k * c_in) ** -0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.kernel, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                m.bias.zero_()
            elif isinstance(m, ScaleNorm):
                m.scale.fill_(1.0)
    return net
