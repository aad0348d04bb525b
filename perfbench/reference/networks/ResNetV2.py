"""Deep Xi's ResNetV2 (resnet-1.1c), written plainly from a state dict of
its published layer names: a 1x1 conv, a scale-only LayerNorm, ReLU;
blocks of three ReLU -> LayerNorm -> conv units, the middle one causal and
dilated 1, 2, .., max_d_rate cyclically; a 1x1 output conv and a sigmoid.
Its operations a frame count a multiply-add as two."""

from __future__ import annotations

import math

import torch

from perfbench.reference.ops import layer_norm, matmul


def shapes(cfg: dict, n_feat: int, n_outp: int) -> dict:
    """{state-dict name: (shape, init)}; init "fan_in:<n>" (normal, std
    1/sqrt(n)), "orthogonal", "zeros" or "ones"."""
    d, f, k = cfg["d_model"], cfg["d_f"], cfg["k"]
    out = {"ff_conv.kernel": ((1, n_feat, d), f"fan_in:{n_feat}"),
           "ff_conv.bias": ((d,), "zeros"), "ff_ln.scale": ((d,), "ones")}
    for i in range(cfg["n_blocks"]):
        for j, (kk, ci, co) in enumerate(((1, d, f), (k, f, f), (1, f, d)), start=1):
            out[f"block{i}_u{j}_conv.kernel"] = ((kk, ci, co), f"fan_in:{kk * ci}")
            out[f"block{i}_u{j}_conv.bias"] = ((co,), "zeros")
    out["out_conv.kernel"] = ((1, d, n_outp), f"fan_in:{d}")
    out["out_conv.bias"] = ((n_outp,), "zeros")
    return out


def block_flops(cfg: dict) -> int:
    """A block a frame: 1x1 d_model -> d_f, k taps d_f -> d_f, 1x1 d_f ->
    d_model (90,112 at resnet-1.1c's widths)."""
    d, f, k = cfg["d_model"], cfg["d_f"], cfg["k"]
    return 2 * (d * f + k * f * f + f * d)


def flops_per_frame(cfg: dict, n_feat: int, n_outp: int) -> int:
    """The forward a frame: in-projection, blocks, output."""
    d = cfg["d_model"]
    return 2 * n_feat * d + cfg["n_blocks"] * block_flops(cfg) + 2 * d * n_outp


def train_flops_per_frame(cfg: dict, n_feat: int, n_outp: int) -> int:
    """Forward, input gradients and weight gradients: three times each
    product, less the in-projection's input gradient (the features take
    none)."""
    return 3 * flops_per_frame(cfg, n_feat, n_outp) - 2 * n_feat * cfg["d_model"]


def dilation(i: int, max_d_rate: int) -> int:
    return 2 ** (i % (int(math.log2(max_d_rate)) + 1))


def receptive_field(cfg: dict) -> int:
    """Frames an output depends on, its own included."""
    return 1 + (cfg["k"] - 1) * sum(dilation(i, cfg["max_d_rate"])
                                    for i in range(cfg["n_blocks"]))


def causal_conv(x, kernel, bias, d, mm=matmul):
    """[B, T, C] -> [B, T, C_out]: y_t = b + sum_j x_{t - (k-1-j) d} W_j."""
    k, T = kernel.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, (k - 1) * d, 0))
    y = bias + mm(xp[:, :T], kernel[0])
    for j in range(1, k):
        y = y + mm(xp[:, j * d:j * d + T], kernel[j])
    return y


def forward(p: dict, x: torch.Tensor, cfg: dict, mm=matmul) -> torch.Tensor:
    h = mm(x, p["ff_conv.kernel"][0]) + p["ff_conv.bias"]
    h = torch.relu(layer_norm(h, p["ff_ln.scale"]))
    for i in range(cfg["n_blocks"]):
        u = h
        for j, d in ((1, 1), (2, dilation(i, cfg["max_d_rate"])), (3, 1)):
            pre = f"block{i}_u{j}_conv."
            u = causal_conv(layer_norm(torch.relu(u)), p[pre + "kernel"], p[pre + "bias"], d, mm)
        h = h + u
    return torch.sigmoid(mm(h, p["out_conv.kernel"][0]) + p["out_conv.bias"])
