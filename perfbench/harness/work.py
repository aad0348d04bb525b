"""Operations and bytes of the work a call asks for, from the
configuration's shapes and the call's valid frames, so that the same work
counts the same whatever implements it. A multiply-add is two operations;
a byte of each input is read once and of each output written once.

  * A network's forward and training step a frame: its reference file's
    `flops_per_frame` and `train_flops_per_frame` (`reference/networks/`);
    a ResNetV2 block 90,112 at resnet-1.1c's widths (PERF.md section 6).
  * LSTM recurrence (per frame and row): h [H] times w_h [H, 4H], 8 H^2.
  * Real FFT of K points: 2.5 K log2 K (analysis and synthesis a frame).
"""

from __future__ import annotations

import math

import perfbench.reference as ref
from perfbench import named

F32 = 4


def tcn_block_flops(cfg: dict) -> int:
    return ref.net(cfg).block_flops(cfg)


def _widths(cfg: dict):
    fam = ref.family(cfg)
    return fam.n_feat(cfg), fam.n_outp(cfg)


def forward_flops_per_frame(cfg: dict) -> int:
    """The network's forward a frame."""
    return ref.net(cfg).flops_per_frame(cfg, *_widths(cfg))


def train_flops_per_frame(cfg: dict) -> int:
    """Forward, input gradients and weight gradients a frame."""
    return ref.net(cfg).train_flops_per_frame(cfg, *_widths(cfg))


def fft_flops(K: int) -> float:
    return 2.5 * K * math.log2(K)


def enhance_flops_per_frame(cfg: dict) -> float:
    """Analysis, network, synthesis a frame."""
    return forward_flops_per_frame(cfg) + 2 * fft_flops(cfg["K"])


def lstm_flops(H: int) -> int:
    """The recurrent product a frame and row, forward or backward."""
    return named.module("reference/networks", "ResLSTM").recurrent_flops(H)


def lstm_forward_bytes(T: int, B: int, H: int) -> int:
    """w_h, the input products xp [T, B, 4H] and the outputs ys [T, B, H]."""
    return F32 * (4 * H * H + T * B * 4 * H + T * B * H)


def lstm_backward_bytes(T: int, B: int, H: int) -> int:
    """w_h, dy [T, B, H], the saved gates [T, B, 4H] and cell state
    [T, B, H], and dxp [T, B, 4H]."""
    return F32 * (4 * H * H + T * B * H + T * B * 4 * H + T * B * H + T * B * 4 * H)


def tcn_stack(cfg: dict, rows: int, T: int, valid_frames: int):
    """(operations, bytes) of the block stack a call: every block on the
    valid frames; the stack's input read and output written once, and each
    block's weights once."""
    d, f, k = cfg["d_model"], cfg["d_f"], cfg["k"]
    weights = F32 * (d * f + f + k * f * f + f + f * d + d)
    flops = cfg["n_blocks"] * tcn_block_flops(cfg) * valid_frames
    return flops, 2 * F32 * rows * T * d + cfg["n_blocks"] * weights
