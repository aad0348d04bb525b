"""Residual-dense lattice network, RDLNet (follows deepxi_tpu/models/rdlnet.py;
rdlnet-1.0n: 18 blocks, length 7, m_1 32, non-causal).

A triangular lattice of convolutional units per block: at height h a unit
has max(m_1 / 2^h, 1) filters, kernel 2(h+1)-1 and dilation 2^h, after a
ReLU and a LayerNorm with no scale or centre (flax's, variance in one pass;
no leaves). Residual links project the wider tensor to the narrower width
with a bias-free 1x1 conv (`<unit>_proj`), dense links concatenate lattice
neighbours, and each block's output is concatenated with its input, so the
width grows by the last unit's m_1 filters a block. The descent is the
symmetric one the JAX package implements (not the reference's defect).
Module names are the JAX package's (`b{block}_h{height}_l{position}_conv`,
`_proj`), so the weight bridge passes parameters unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from deepxi_tpu_torch.models.attention import layer_norm_one_pass
from deepxi_tpu_torch.models.tcn import Conv1d, output_activation


def lattice_block(inp, bi: int, length: int, unit, residual, concat):
    """One block's lattice over `inp`, with the unit, the weighted residual
    and the concatenation given as functions of (input, height, name),
    (x, y, name) and (a, b): the same walk builds the modules (on channel
    counts) and runs them (on tensors). Returns the last unit's output."""
    L = length
    height = (L - 1) // 2 + 1
    midpoint = (L + 1) // 2
    cell = [[None] * L for _ in range(height)]
    # ascending half
    for l in range(midpoint):
        h_order = range(height) if l < midpoint - 1 else reversed(range(height))
        for h in h_order:
            if h > l:
                continue
            if l == 0:
                unit_inp = inp
            elif l == h:
                unit_inp = cell[h - 1][l - 1]
            else:
                unit_inp = cell[h][l - 1]
            name = f"b{bi}_h{h}_l{l}"
            U = unit(unit_inp, h, name)
            if l == h:
                out = U
            elif h == 0 and l == 1:
                out = residual(U, inp, name)
            elif h + 1 == l:
                out = residual(U, cell[h - 1][l - 2], name)
            else:
                out = residual(U, cell[h][l - 2], name)
            if l == 0 or h == height - 1 or (h == 0 and l < midpoint - 1):
                pass
            elif l == midpoint - 1:
                out = concat(out, cell[h + 1][l])
            else:
                out = concat(out, cell[h - 1][l])
            cell[h][l] = out
    # descending half (symmetric)
    for l in range(midpoint, L):
        for h in reversed(range(height)):
            if h >= L - l:
                continue
            name = f"b{bi}_h{h}_l{l}"
            out = residual(unit(cell[h][l - 1], h, name), cell[h][l - 2], name)
            if l != L - h - 1:
                out = concat(out, cell[h + 1][l])
            cell[h][l] = out
    return cell[0][L - 1]


class RDLNet(nn.Module):
    """RDLNet over [B, T, n_feat]. A unit is ReLU -> LN -> conv with
    `unit_type` "ReLU->LN->W+b", else ReLU -> conv (as the JAX module).
    rdlnet-1.0n (18 blocks, length 7, m_1 32, n_feat = n_outp = 257) has
    1,373,466 parameters in 740 leaves."""

    def __init__(self, n_feat: int, n_outp: int, n_blocks: int = 18, length: int = 7,
                 m_1: int = 32, causal: bool = False, unit_type: str = "ReLU->LN->W+b",
                 outp_act: str = "Sigmoid"):
        super().__init__()
        self.n_blocks, self.length, self.m_1 = n_blocks, length, m_1
        self.causal, self.outp_act = causal, outp_act
        self.ln = unit_type == "ReLU->LN->W+b"

        def unit(c_in, h, name):
            n_filt = max(m_1 // (2 ** h), 1)
            self.add_module(f"{name}_conv", Conv1d(c_in, n_filt, 2 * (h + 1) - 1, 2 ** h,
                                                   causal=causal))
            return n_filt

        def residual(cx, cy, name):
            if cx != cy:
                self.add_module(f"{name}_proj", Conv1d(max(cx, cy), min(cx, cy),
                                                       use_bias=False))
            return min(cx, cy)

        c = n_feat
        for i in range(n_blocks):
            c += lattice_block(c, i, length, unit, residual, lambda a, b: a + b)
        self.out_conv = Conv1d(c, n_outp)

    def _unit(self, x: torch.Tensor, h: int, name: str) -> torch.Tensor:
        x = torch.relu(x)
        if self.ln:
            x = layer_norm_one_pass(x)
        return getattr(self, f"{name}_conv")(x)

    def _residual(self, x: torch.Tensor, y: torch.Tensor, name: str) -> torch.Tensor:
        if x.shape[-1] > y.shape[-1]:
            x = getattr(self, f"{name}_proj")(x)
        elif x.shape[-1] < y.shape[-1]:
            y = getattr(self, f"{name}_proj")(y)
        return x + y

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        x = inp
        for i in range(self.n_blocks):
            x = torch.cat([lattice_block(x, i, self.length, self._unit, self._residual,
                                         lambda a, b: torch.cat([a, b], -1)), x], -1)
        return output_activation(self.out_conv(x), self.outp_act)
