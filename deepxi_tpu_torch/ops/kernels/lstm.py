"""The masked LSTM recurrence of ResLSTM / ResBiLSTM as one op, and its
gradient (follows the `nn.scan` of deepxi_tpu/models/rnn.py, which XLA
compiles into one while-loop and differentiates; the JAX package has no
Pallas kernel for it).

`masked_lstm(xp, w_h, mask, reverse)` is the recurrence. Where autograd
records nothing (inference, export) it is the op `deepxi::masked_lstm`
(`ops.kernels.kernel_op`): on the card the forward kernel of `csrc/lstm.cu`,
on the CPU its plain version `masked_lstm_plain`, which is the definition;
an exported program holds one call a direction a block, where `torch.export`
of the plain loop would unroll it frame by frame. Under autograd (training)
it is a `torch.autograd.Function`: the forward kernel saving the gate
activations and the cell state (`masked_lstm_train`), then the backward
kernel (`masked_lstm_backward`) and one matrix product for the recurrent
weights' gradient; on the CPU their plain versions `masked_lstm_train_plain`
and `masked_lstm_backward_plain` (BPTT over frames in PyTorch operations,
which defines the backward kernel).

Semantics (flax's `nn.OptimizedLSTMCell` under a masked scan): xp [T, B, 4H]
is the input product plus the recurrent bias, time-major, gates i|f|g|o;
w_h [H, 4H]; mask [T, B] bool. Per frame z = xp[t] + h w_h; i, f, o =
sigmoid, g = tanh; c' = f c + i g; h' = o tanh(c'). A masked frame keeps
(c, h) and repeats the previous output. The carry starts at zero; `reverse`
walks from the last (padded) frame to the first. Returns ys [T, B, H], the
output after each frame.

On the card each kernel is one cooperative launch a call on the current
stream (every CTA resident for all T frames; a barrier a frame, grid-wide in
the forward, the row group's own in the backward), its outputs, saved state
and the backward's scratch (its barrier counters and partial sums) from
PyTorch's caching allocator on that stream, no host synchronisation.
`masked_lstm.launches` counts the forward's launches (the
op's and the training forward's), `masked_lstm.tensor_core_launches` those of
them whose recurrent product ran on the tensor cores (float32 from
LSTM_FWD_TC_ROWS rows a CTA, csrc/lstm.cu; `kernel_plan`'s "tensor_cores"),
`masked_lstm_backward.launches` the backward's, all where they launch. The
kernels take float32 or float64 and 1 <= H <= 1024 (`kernel_takes`); outside
that, or where the grid cannot be resident at once, the card raises.

`lstm_input_proj(x, w_x, b)` is the block's input product, xp [T, B, 4H] =
x [B, T, C] [W_i|W_f|W_g|W_o] + b written time-major, w_x the four gate
kernels [C, H]: the op `deepxi::lstm_input_proj` where autograd records
nothing. On the card the kernels of `csrc/lstm_input_proj.cu` take float32
with C a multiple of 4 (split TF32 on the tensor cores, the bias and the
time-major store in the epilogue) and float64 (FMAs); outside that the card
raises. The float32 kernel reads W_x split K-major into TF32 hi and lo,
which the split kernel writes when the gate kernels change and which is kept
while they do not (`_kept_split`). `lstm_input_proj.launches` counts the
product's launches, `lstm_input_proj.split_launches` the split's. On the
CPU the op is its plain version `lstm_input_proj_plain`, `addmm` and a copy
of its transposed view. Under autograd `models/rnn.py` takes
`input_product`, autograd's `addmm`.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.weak import WeakIdKeyDictionary

from deepxi_tpu_torch.ops.kernels import (_build, kernel_op, launch_context, raw_stream,
                                          records_grad)

DTYPES = (torch.float32, torch.float64)
MAX_H = 1024


def _plain_steps(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor, reverse: bool,
                 save: bool):
    """The recurrence a frame at a time in PyTorch operations: ys, and with
    `save` the gate activations [T, B, 4H] and c after each frame [T, B, H]."""
    T, B, _ = xp.shape
    h_size = w_h.shape[0]
    m = mask[..., None]                                     # [T, B, 1] bool
    c = h = xp.new_zeros(B, h_size)
    ys, gates, cs = [None] * T, [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        z = torch.addmm(xp[t], h, w_h)
        s = torch.sigmoid(z)            # i, f and o (and g, unused)
        g = torch.tanh(z[:, 2 * h_size:3 * h_size])
        c_new = torch.addcmul(s[:, h_size:2 * h_size] * c, s[:, :h_size], g)
        h_new = s[:, 3 * h_size:] * torch.tanh(c_new)
        c = torch.where(m[t], c_new, c)
        h = torch.where(m[t], h_new, h)
        ys[t] = h   # the output: h', or the previous output where masked
        if save:
            gates[t] = torch.cat([s[:, :2 * h_size], g, s[:, 3 * h_size:]], 1)
            cs[t] = c
    if save:
        return torch.stack(ys, 0), torch.stack(gates, 0), torch.stack(cs, 0)
    return torch.stack(ys, 0)


def masked_lstm_plain(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor,
                      reverse: bool) -> torch.Tensor:
    """Plain version of the forward: ys (autograd records through it)."""
    return _plain_steps(xp, w_h, mask, reverse, save=False)


def masked_lstm_train_plain(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor,
                            reverse: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: (ys, the gate activations
    i|f|g|o [T, B, 4H], c after each frame [T, B, H]); ys is
    `masked_lstm_plain`'s, bitwise."""
    return _plain_steps(xp, w_h, mask, reverse, save=True)


def masked_lstm_backward_plain(dys: torch.Tensor, gates: torch.Tensor, cs: torch.Tensor,
                               w_h: torch.Tensor, mask: torch.Tensor,
                               reverse: bool) -> torch.Tensor:
    """Plain version of the backward: dxp [T, B, 4H] for the upstream
    gradient dys [T, B, H] and the training forward's saved state, BPTT in
    the reverse of processing order with the carry (dh, dc) from zero. A
    valid frame takes the cell's derivatives (c_{t-1} is c after the frame
    before in processing order, 0 at the first) and passes dz_t w_h^T back
    as dh; a masked frame has dz_t = 0 and passes dh + dy_t and dc on."""
    T, B, h_size = dys.shape
    order = range(T - 1, -1, -1) if reverse else range(T)
    dh = dc = dys.new_zeros(B, h_size)
    zero = dys.new_zeros(B, h_size)
    dxp = [None] * T
    prev = [None] + list(order)[:-1]        # the frame before each, in processing order
    for t, tp in reversed(list(zip(order, prev))):
        m = mask[t][:, None]
        dh_tot = dh + dys[t]
        i, f, g, o = torch.split(gates[t], h_size, 1)
        tc = torch.tanh(cs[t])
        c_prev = cs[tp] if tp is not None else zero
        dz_o = dh_tot * tc * o * (1 - o)
        dc_tot = dc + dh_tot * o * (1 - tc * tc)
        dz = torch.cat([dc_tot * g * i * (1 - i), dc_tot * c_prev * f * (1 - f),
                        dc_tot * i * (1 - g * g), dz_o], 1)
        dz = torch.where(m, dz, torch.zeros_like(dz))
        dxp[t] = dz
        dc = torch.where(m, dc_tot * f, dc)
        dh = torch.where(m, zero, dh_tot) + dz @ w_h.T
    return torch.stack(dxp, 0)


def recurrent_weight_grad(ys: torch.Tensor, dxp: torch.Tensor, reverse: bool) -> torch.Tensor:
    """dW_h [H, 4H] = sum over frames of h_{t-1}^T dz_t, h_{t-1} the output
    of the frame before in processing order (0 at the first): one matrix
    product over all frames and rows."""
    T, B, h_size = ys.shape
    zero = ys.new_zeros(1, B, h_size)
    h_prev = torch.cat([ys[1:], zero]) if reverse else torch.cat([zero, ys[:-1]])
    return h_prev.reshape(T * B, h_size).T @ dxp.reshape(T * B, 4 * h_size)


def kernel_takes(H: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take this width and type: float32 or float64,
    1 <= H <= 1024."""
    return dtype in DTYPES and 1 <= H <= MAX_H


def _check(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
    if xp.dim() != 3 or w_h.dim() != 2 or not kernel_takes(w_h.shape[0], xp.dtype):
        raise ValueError(f"masked_lstm takes xp [T, B, 4H] and w_h [H, 4H] of float32 or "
                         f"float64 with 1 <= H <= {MAX_H}, not {tuple(xp.shape)} and "
                         f"{tuple(w_h.shape)} {xp.dtype}")
    T, B, H4 = xp.shape
    H = w_h.shape[0]
    if (H4 != 4 * H or tuple(w_h.shape) != (H, 4 * H) or w_h.dtype != xp.dtype
            or T < 1 or B < 1):
        raise ValueError(f"xp {tuple(xp.shape)} and w_h {tuple(w_h.shape)} {w_h.dtype} do "
                         f"not fit: xp [T >= 1, B, 4H], w_h [H, 4H] of xp's dtype")
    if tuple(mask.shape) != (T, B) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [{T}, {B}], not {tuple(mask.shape)} "
                         f"{mask.dtype}")
    if w_h.device != xp.device or mask.device != xp.device:
        raise ValueError("xp, w_h and mask must be on one device")


def _lib() -> ctypes.CDLL:
    """csrc/lstm.cu's library (a test or a tool puts a build variant here)."""
    return _build.load("lstm")


def grid(backward: bool, B: int, H: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(U, R): the kernels' grid at (B, H) on the current card, ceil(H / U)
    CTAs of U hidden units for each of R row groups, at most one CTA an SM
    (csrc/lstm.cu `grid_plan`). Raises where none fits."""
    U, R = ctypes.c_int(), ctypes.c_int()
    if not _lib().masked_lstm_grid(int(backward), B, H, int(dtype == torch.float64),
                                   ctypes.byref(U), ctypes.byref(R)):
        raise RuntimeError(f"masked_lstm has no grid for B={B}, H={H} {dtype}: the per-unit "
                           f"state of the batch rows does not fit in shared memory")
    return U.value, R.value


def kernel_plan(backward: bool, B: int, H: int, dtype: torch.dtype = torch.float32) -> dict:
    """The plan a kernel takes at (B, H): U units a CTA, R row groups, the
    grid's CTAs, NB rows a stage (the backward's: the CTA's rows, all at
    once), whether w_h's slice sits in shared memory (the backward holds it
    in registers in float32, or its tensor-core fragments in shared memory),
    whether the recurrent product runs on the tensor cores (float32, from a
    build constant of rows a CTA: the forward's LSTM_FWD_TC_ROWS, the
    backward's LSTM_TC_ROWS), and the shared memory a CTA (bytes)."""
    U, R = grid(backward, B, H, dtype)
    nb, ws, tc, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    _lib().masked_lstm_plan(int(backward), B, H, U, R, int(dtype == torch.float64),
                            ctypes.byref(nb), ctypes.byref(ws), ctypes.byref(tc),
                            ctypes.byref(smem))
    return {"U": U, "R": R, "ctas": -(-H // U) * R, "NB": nb.value,
            "w_h_in_shared": bool(ws.value), "tensor_cores": bool(tc.value),
            "smem": smem.value}


# what a failed launch's message adds to its shape
_REFUSED = ("(a grid that cannot be resident at once, or per-unit state of B rows past "
            "shared memory, is refused, never run)")


def _forward_cuda(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor, reverse: bool,
                  save: bool):
    _check(xp, w_h, mask)
    xp, w_h, mask = xp.contiguous(), w_h.contiguous(), mask.contiguous()
    T, B, _ = xp.shape
    H = w_h.shape[0]
    ys = xp.new_empty(T, B, H)
    gates = xp.new_empty(T, B, 4 * H) if save else None
    cs = xp.new_empty(T, B, H) if save else None
    tc = ctypes.c_int()
    lib = _lib()
    with launch_context(xp.device):
        rc = lib.masked_lstm_forward(
            xp.data_ptr(), w_h.data_ptr(), mask.data_ptr(), ys.data_ptr(),
            gates.data_ptr() if save else None, cs.data_ptr() if save else None,
            T, B, H, *grid(False, B, H, xp.dtype), int(reverse), int(xp.dtype == torch.float64),
            raw_stream(xp.device), ctypes.byref(tc))
    _build.check(lib, rc, f"masked_lstm_forward at [T, B, H] = {[T, B, H]} {_REFUSED}")
    masked_lstm.launches += 1
    masked_lstm.tensor_core_launches += tc.value
    return (ys, gates, cs) if save else ys


def _masked_lstm_cuda(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor,
                      reverse: bool) -> torch.Tensor:
    return _forward_cuda(xp, w_h, mask, reverse, save=False)


_op = kernel_op("masked_lstm", _masked_lstm_cuda, masked_lstm_plain,
                fake=lambda xp, w_h, mask, reverse: xp.new_empty(*xp.shape[:2], w_h.shape[0]))


def masked_lstm_train(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor,
                      reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training forward: (ys, gates [T, B, 4H], cs [T, B, H]), what
    `masked_lstm_backward` takes. On the card one launch of the forward
    kernel; on the CPU `masked_lstm_train_plain`."""
    if xp.device.type == "cpu":
        return masked_lstm_train_plain(xp, w_h, mask, bool(reverse))
    return _forward_cuda(xp, w_h, mask, bool(reverse), save=True)


def masked_lstm_backward(dys: torch.Tensor, gates: torch.Tensor, cs: torch.Tensor,
                         w_h: torch.Tensor, mask: torch.Tensor,
                         reverse: bool = False) -> torch.Tensor:
    """dxp [T, B, 4H] for the upstream gradient dys [T, B, H] and
    `masked_lstm_train`'s gates and cs. On the card one launch of the
    backward kernel; on the CPU `masked_lstm_backward_plain`."""
    if dys.device.type == "cpu":
        return masked_lstm_backward_plain(dys, gates, cs, w_h, mask, bool(reverse))
    T, B, H = dys.shape
    _check(gates, w_h, mask)
    if (tuple(gates.shape) != (T, B, 4 * H) or tuple(cs.shape) != (T, B, H)
            or dys.dtype != gates.dtype or cs.dtype != gates.dtype
            or dys.device != gates.device or cs.device != gates.device):
        raise ValueError(f"dys {tuple(dys.shape)}, gates {tuple(gates.shape)} and cs "
                         f"{tuple(cs.shape)} do not fit: [T, B, H], [T, B, 4H], [T, B, H] "
                         f"of one dtype and device")
    dys, gates, cs, w_h = dys.contiguous(), gates.contiguous(), cs.contiguous(), w_h.contiguous()
    dxp = gates.new_empty(T, B, 4 * H)
    f64 = int(dys.dtype == torch.float64)
    U, R = grid(True, B, H, dys.dtype)
    lib = _lib()
    # the row groups' barrier counters and partial sums: this call's own
    scratch = torch.empty(lib.masked_lstm_backward_scratch(B, H, U, R, f64),
                          dtype=torch.uint8, device=dys.device)
    mask32 = mask.contiguous().to(torch.int32)  # a word a row, copied by cp.async
    with launch_context(dys.device):
        rc = lib.masked_lstm_backward(
            dys.data_ptr(), gates.data_ptr(), cs.data_ptr(), w_h.data_ptr(), mask32.data_ptr(),
            dxp.data_ptr(), scratch.data_ptr(), T, B, H, U, R, int(reverse), f64,
            raw_stream(dys.device))
    _build.check(lib, rc, f"masked_lstm_backward at [T, B, H] = {[T, B, H]} {_REFUSED}")
    masked_lstm_backward.launches += 1
    return dxp


class _Recurrence(torch.autograd.Function):
    """The recurrence under autograd: the training forward, then the
    backward kernel for dxp and `recurrent_weight_grad` for dW_h."""

    @staticmethod
    def forward(ctx, xp, w_h, mask, reverse):
        ys, gates, cs = masked_lstm_train(xp, w_h, mask, reverse)
        ctx.save_for_backward(ys, gates, cs, w_h, mask)
        ctx.reverse = reverse
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, dys):
        ys, gates, cs, w_h, mask = ctx.saved_tensors
        dxp = masked_lstm_backward(dys, gates, cs, w_h, mask, ctx.reverse)
        dw_h = recurrent_weight_grad(ys, dxp, ctx.reverse) if ctx.needs_input_grad[1] else None
        return dxp, dw_h, None, None


def masked_lstm(xp: torch.Tensor, w_h: torch.Tensor, mask: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
    """The masked recurrence: ys [T, B, H] for xp [T, B, 4H], w_h [H, 4H] and
    mask [T, B] bool; differentiable in xp and w_h. On the card one kernel
    launch (two under autograd: forward and backward)."""
    if records_grad(xp, w_h):
        return _Recurrence.apply(xp, w_h, mask, bool(reverse))
    return _op(xp, w_h, mask, bool(reverse))


def input_product(x: torch.Tensor, w_x: Sequence[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] times the gate kernels w_x [C, H] side by side, plus b, as
    one `addmm`: the time-major [T, B, 4H] view of its [B, T, 4H] result
    (what autograd records in training)."""
    B, T, _ = x.shape
    return torch.addmm(b, x.reshape(B * T, -1), torch.cat(list(w_x), 1)) \
        .reshape(B, T, -1).transpose(0, 1)


def lstm_input_proj_plain(x: torch.Tensor, w_x: List[torch.Tensor],
                          b: torch.Tensor) -> torch.Tensor:
    """Plain version of the input projection: `input_product` copied
    time-major, xp [T, B, 4H] contiguous."""
    return input_product(x, w_x, b).contiguous()


def _check_proj(x: torch.Tensor, w_x: List[torch.Tensor], b: torch.Tensor) -> None:
    """Raise unless the card's kernels take these inputs: x [B, T, C], four
    gate kernels [C, H] and b [4H] of one device, float32 with C a multiple
    of 4 (TMA's 16-byte rows) or float64."""
    w0, dt, dev = w_x[0] if w_x else x, x.dtype, x.device
    ok = (len(w_x) == 4 and x.dim() == 3 and w0.dim() == 2 and x.shape[2] == w0.shape[0]
          and b.shape == (4 * w0.shape[1],) and b.dtype == dt and b.device == dev
          and (dt == torch.float64 or (dt == torch.float32 and x.shape[2] % 4 == 0))
          and all(w.shape == w0.shape and w.dtype == dt and w.device == dev for w in w_x))
    if not ok:
        raise ValueError(
            "lstm_input_proj takes x [B, T, C], four gate kernels [C, H] and b [4H] on one "
            "device, float32 with C a multiple of 4 or float64, not "
            f"{tuple(x.shape)} {x.dtype}, {[tuple(w.shape) for w in w_x]}, {tuple(b.shape)}")


# the first gate kernel of each W_x kept split -> (what it was split from, the split)
_SPLITS = WeakIdKeyDictionary()


def _kept_split(w_x: List[torch.Tensor], stream: int, split):
    """`split()`, the float32 kernel's W_x operand, made once for these gate
    kernels and kept while they stay the same tensors, at the same memory,
    unchanged in place (their version counters), and read on the same
    stream; made anew for inference tensors, which count no versions. The
    entry goes with the first gate kernel."""
    if any(w.is_inference() for w in w_x):
        return split()
    key = (stream,) + tuple((w.data_ptr(), w._version) for w in w_x)
    kept = _SPLITS.get(w_x[0])
    if kept is None or kept[0] != key:
        kept = _SPLITS[w_x[0]] = (key, split())
    return kept[1]


def _lstm_input_proj_cuda(x: torch.Tensor, w_x: List[torch.Tensor],
                          b: torch.Tensor) -> torch.Tensor:
    _check_proj(x, w_x, b)
    B, T, C = x.shape
    H = w_x[0].shape[1]
    xp = x.new_empty(T, B, 4 * H)
    if B * T == 0:
        return xp
    x, b, w_x = x.contiguous(), b.contiguous(), [w.contiguous() for w in w_x]
    lib = _build.load("lstm_input_proj")
    with launch_context(x.device):
        stream = raw_stream(x.device)
        if x.dtype == torch.float64:
            rc = lib.lstm_input_proj_f64(x.data_ptr(), *(w.data_ptr() for w in w_x),
                                         b.data_ptr(), xp.data_ptr(), B, T, C, H, stream)
        else:
            def split():
                w_split = torch.empty(2, 4 * H, C, dtype=torch.int32, device=x.device)
                _build.check(lib, lib.lstm_input_proj_split(*(w.data_ptr() for w in w_x),
                                                            w_split.data_ptr(), C, H, stream),
                             f"lstm_input_proj splitting W_x [{C}, {4 * H}]")
                lstm_input_proj.split_launches += 1
                return w_split

            # under CUDA graph capture the graph records the split, so that a
            # replay reads the weights as they are then
            w_split = split() if torch.cuda.is_current_stream_capturing() \
                else _kept_split(w_x, stream, split)
            rc = lib.lstm_input_proj_forward(x.data_ptr(), w_split.data_ptr(), b.data_ptr(),
                                             xp.data_ptr(), B, T, C, 4 * H, stream)
    _build.check(lib, rc, f"lstm_input_proj at [B, T, C, 4H] = {[B, T, C, 4 * H]}")
    lstm_input_proj.launches += 1
    return xp


_proj_op = kernel_op("lstm_input_proj", _lstm_input_proj_cuda, lstm_input_proj_plain,
                     fake=lambda x, w_x, b: x.new_empty(x.shape[1], x.shape[0], b.shape[0]))


def lstm_input_proj(x: torch.Tensor, w_x: Sequence[torch.Tensor],
                    b: torch.Tensor) -> torch.Tensor:
    """The LSTM block's input product, time-major: xp [T, B, 4H] = x [B, T, C]
    [W_i|W_f|W_g|W_o] + b [4H] for the gate kernels w_x [C, H], contiguous;
    not differentiable (training takes `input_product` under autograd). On
    the card one launch (two where W_x's split is made), on the CPU
    `lstm_input_proj_plain`."""
    return _proj_op(x, list(w_x), b)


masked_lstm.launches = 0
masked_lstm.tensor_core_launches = 0
masked_lstm_backward.launches = 0
lstm_input_proj.launches = 0
lstm_input_proj.split_launches = 0
