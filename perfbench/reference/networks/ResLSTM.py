"""Deep Xi's ResLSTM (reslstm-1.0c), written plainly from a state dict of
its published layer names: a bias-free dense layer, LayerNorm, ReLU;
residual LSTM blocks that hold their state over a frame whose features are
all zero; a dense output layer and a sigmoid. Its operations a frame count
a multiply-add as two."""

from __future__ import annotations

import torch

from perfbench.reference.ops import layer_norm, matmul

GATES = "ifgo"


def shapes(cfg: dict, n_feat: int, n_outp: int) -> dict:
    """{state-dict name: (shape, init)}, as `ResNetV2.shapes`; the recurrent
    kernels orthogonal, as flax's OptimizedLSTMCell makes them."""
    d = cfg["d_model"]
    out = {"ff_dense.kernel": ((n_feat, d), f"fan_in:{n_feat}"),
           "ff_ln.scale": ((d,), "ones"), "ff_ln.bias": ((d,), "zeros")}
    for i in range(cfg["n_blocks"]):
        for g in GATES:
            out[f"block{i}_lstm.cell.i{g}.kernel"] = ((d, d), f"fan_in:{d}")
            out[f"block{i}_lstm.cell.h{g}.kernel"] = ((d, d), "orthogonal")
            out[f"block{i}_lstm.cell.h{g}.bias"] = ((d,), "zeros")
    out["out_dense.kernel"] = ((d, n_outp), f"fan_in:{d}")
    out["out_dense.bias"] = ((n_outp,), "zeros")
    return out


def recurrent_flops(H: int) -> int:
    """h [H] times w_h [H, 4H], a frame and row."""
    return 8 * H * H


def flops_per_frame(cfg: dict, n_feat: int, n_outp: int) -> int:
    """The forward a frame: in-projection, each block's input product
    (d_model -> 4 d_model) and recurrence, output."""
    d = cfg["d_model"]
    return (2 * n_feat * d + cfg["n_blocks"] * (2 * d * 4 * d + recurrent_flops(d))
            + 2 * d * n_outp)


def train_flops_per_frame(cfg: dict, n_feat: int, n_outp: int) -> int:
    """Forward, input gradients and weight gradients: three times each
    product (the recurrent weight gradient is one more product a frame like
    the forward's), less the in-projection's input gradient."""
    return 3 * flops_per_frame(cfg, n_feat, n_outp) - 2 * n_feat * cfg["d_model"]


def lstm(x, valid, w_x, w_h, b, mm=matmul):
    """[B, T, C] through one LSTM (gates i, f, g, o; c = f c + i g;
    h = o tanh c); a frame that is not `valid` keeps the state, and its
    output repeats the last one."""
    B, T, _ = x.shape
    H = w_h.shape[0]
    xp = mm(x, w_x) + b
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = []
    for t in range(T):
        z = xp[:, t] + mm(h, w_h)
        s = torch.sigmoid(z)          # i, f, o (g's column block is unused)
        c_new = s[:, H:2 * H] * c + s[:, :H] * torch.tanh(z[:, 2 * H:3 * H])
        h_new = s[:, 3 * H:] * torch.tanh(c_new)
        keep = valid[:, t, None]
        c = torch.where(keep, c_new, c)
        h = torch.where(keep, h_new, h)
        out.append(h)
    return torch.stack(out, 1)


def forward(p: dict, x: torch.Tensor, cfg: dict, mm=matmul) -> torch.Tensor:
    valid = (x != 0).any(-1)
    h = torch.relu(layer_norm(mm(x, p["ff_dense.kernel"]), p["ff_ln.scale"], p["ff_ln.bias"]))
    for i in range(cfg["n_blocks"]):
        cell = f"block{i}_lstm.cell."
        w_x = torch.cat([p[f"{cell}i{g}.kernel"] for g in GATES], 1)
        w_h = torch.cat([p[f"{cell}h{g}.kernel"] for g in GATES], 1)
        b = torch.cat([p[f"{cell}h{g}.bias"] for g in GATES])
        h = h + lstm(h, valid, w_x, w_h, b, mm)
    return torch.sigmoid(mm(h, p["out_dense.kernel"]) + p["out_dense.bias"])
