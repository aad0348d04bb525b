"""The masked LSTM recurrence of ResLSTM / ResBiLSTM as one op (follows the
`nn.scan` of deepxi_tpu/models/rnn.py, which XLA compiles into one
while-loop; the JAX package has no Pallas kernel for it).

`masked_lstm(xp, w_h, mask, reverse)` is the op `deepxi::masked_lstm`
(`ops.kernels.kernel_op`): on the card the CUDA kernel of `csrc/lstm.cu`, on
the CPU its plain version `masked_lstm_plain`, which is the definition. An
exported program holds one call a direction a block, where `torch.export`
of the plain loop would unroll it frame by frame.

Semantics (flax's `nn.OptimizedLSTMCell` under a masked scan): xp [T, B, 4H]
is the input product plus the recurrent bias, time-major, gates i|f|g|o;
w_h [H, 4H]; mask [T, B] bool. Per frame z = xp[t] + h w_h; i, f, o =
sigmoid, g = tanh; c' = f c + i g; h' = o tanh(c'). A masked frame keeps
(c, h) and repeats the previous output. The carry starts at zero; `reverse`
walks from the last (padded) frame to the first. Returns ys [T, B, H], the
output after each frame.

On the card one host call runs the recurrence: T launches of one frame
kernel each on the current stream, no host synchronisation, the output and
the cell state from PyTorch's caching allocator. `masked_lstm.launches`
counts the frame launches (T a call) and `masked_lstm.calls` the calls,
both in the CUDA implementation. The kernel takes float32 or float64 and
1 <= H <= 1024 (`kernel_takes`); outside that the op raises on the card.

No backward: a network under autograd (training) runs `masked_lstm_plain`
itself (`models/rnn.MaskedLSTM`); the op refuses autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepxi_tpu_torch.ops.kernels import kernel_op, launch_context, raw_stream

DTYPES = (torch.float32, torch.float64)
MAX_H = 1024
# Hidden units a CTA (csrc/lstm.cu COLS), and the H100's streaming
# multiprocessors, which `rows_a_block` aims to cover with CTAs.
COLS = 8
SMS = 132


def masked_lstm_plain(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor,
                      reverse: bool) -> torch.Tensor:
    """Plain version: the recurrence a frame at a time in PyTorch
    operations (autograd records through it)."""
    T, B, _ = xp.shape
    h_size = w_h.shape[0]
    m = mask[..., None]                                     # [T, B, 1] bool
    c = h = xp.new_zeros(B, h_size)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        z = torch.addmm(xp[t], h, w_h)
        s = torch.sigmoid(z)            # i, f and o (and g, unused)
        g = torch.tanh(z[:, 2 * h_size:3 * h_size])
        c_new = torch.addcmul(s[:, h_size:2 * h_size] * c, s[:, :h_size], g)
        h_new = s[:, 3 * h_size:] * torch.tanh(c_new)
        c = torch.where(m[t], c_new, c)
        h = torch.where(m[t], h_new, h)
        ys[t] = h   # the output: h', or the previous output where masked
    return torch.stack(ys, 0)


def kernel_takes(H: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes this width and type: float32 or float64,
    1 <= H <= 1024 (h_{t-1} of up to 16 rows staged in shared memory)."""
    return dtype in DTYPES and 1 <= H <= MAX_H


def rows_a_block(B: int, H: int) -> int:
    """Batch rows a CTA (the kernel's NB): the most, up to 16, that still
    leave a CTA for each SM, so a w_h load feeds as many rows' FMAs as the
    grid allows; 1 when even that leaves SMs idle."""
    nb = 16
    while nb > 1 and -(-H // COLS) * -(-B // nb) < SMS:
        nb //= 2
    return nb


def _check(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if xp.dim() != 3 or w_h.dim() != 2 or not kernel_takes(w_h.shape[0], xp.dtype):
        raise ValueError(f"masked_lstm takes xp [T, B, 4H] and w_h [H, 4H] of float32 or "
                         f"float64 with 1 <= H <= {MAX_H}, not {tuple(xp.shape)} and "
                         f"{tuple(w_h.shape)} {xp.dtype}")
    T, B, H4 = xp.shape
    H = w_h.shape[0]
    if (H4 != 4 * H or tuple(w_h.shape) != (H, 4 * H) or w_h.dtype != xp.dtype
            or T < 1 or B < 1 or -(-B // rows_a_block(B, H)) > 65535):
        raise ValueError(f"xp {tuple(xp.shape)} and w_h {tuple(w_h.shape)} {w_h.dtype} do "
                         f"not fit: xp [T >= 1, B, 4H], w_h [H, 4H] of xp's dtype")
    if tuple(mask.shape) != (T, B) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [{T}, {B}], not {tuple(mask.shape)} "
                         f"{mask.dtype}")
    if w_h.device != xp.device or mask.device != xp.device:
        raise ValueError("xp, w_h and mask must be on one device")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from deepxi_tpu_torch.ops.kernels import _build
    lib = _build.load("lstm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.masked_lstm_error_string.argtypes = [i]
    lib.masked_lstm_error_string.restype = ctypes.c_char_p
    lib.masked_lstm_forward.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.masked_lstm_forward.restype = i
    return lib


def _masked_lstm_cuda(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor,
                      reverse: bool) -> torch.Tensor:
    _check(xp, w_h, mask)
    xp, w_h, mask = xp.contiguous(), w_h.contiguous(), mask.contiguous()
    T, B, _ = xp.shape
    H = w_h.shape[0]
    ys = xp.new_empty(T, B, H)
    c = xp.new_empty(B, H)
    lib = _lib()
    with launch_context(xp.device):
        rc = lib.masked_lstm_forward(
            xp.data_ptr(), w_h.data_ptr(), mask.data_ptr(), c.data_ptr(), ys.data_ptr(),
            T, B, H, rows_a_block(B, H), int(reverse), int(xp.dtype == torch.float64),
            raw_stream(xp.device))
    if rc != 0:
        raise RuntimeError(f"masked_lstm_forward failed: CUDA error {rc} "
                           f"({lib.masked_lstm_error_string(rc).decode()})")
    masked_lstm.launches += T
    masked_lstm.calls += 1
    return ys


_op = kernel_op("masked_lstm", _masked_lstm_cuda, masked_lstm_plain,
                fake=lambda xp, w_h, mask, reverse: xp.new_empty(*xp.shape[:2], w_h.shape[0]))


def masked_lstm(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
    """The masked recurrence: ys [T, B, H] for xp [T, B, 4H], w_h [H, 4H] and
    mask [T, B] bool. On the card one host call of T kernel launches."""
    if torch.is_grad_enabled() and (xp.requires_grad or w_h.requires_grad):
        raise RuntimeError("masked_lstm has no backward; run it under torch.no_grad(), or "
                           "train through masked_lstm_plain (as models/rnn.MaskedLSTM does)")
    return _op(xp, w_h, mask, bool(reverse))


masked_lstm.launches = 0
masked_lstm.calls = 0
