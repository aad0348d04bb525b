"""KV-cache attention step of streaming MHANet (follows
deepxi_tpu/ops/kernels/mha_cache.py).

`mha_cache_step` runs the CUDA kernel of `csrc/mha_cache.cu` for a CUDA
tensor and its plain version `mha_cache_step_ref` for a CPU tensor, both as
the op `deepxi::mha_cache_step` (`ops.kernels.kernel_op`), whose clock is
always a tensor; it has a plain-integer `launches` counter (one per call,
counted in the CUDA implementation, so a CUDA graph's replay counts none).

Semantics, as the JAX function: q [B, H, d] float32, pre-scaled; key and
value caches [B, L, H, d] in float32 or bfloat16, upcast to float32; the
mask of written rows ``valid = arange(L) <= t`` for the stream's clock `t`
(every batch row shares it; past the cap, t >= L, all rows are valid);
logits ``q.k + (-1e10)(1 - valid)`` over all L rows, a full-row float32
softmax, then the weighted values: [B, H, d] float32. The JAX function takes
the mask itself; streaming only ever hands it this one, so the port takes
`t`: a Python int >= 0, or a 0-d int32 tensor on q's device (the stream's
clock, as `MHAStreamState.t`), which must hold a value >= 0. On the card the
kernel reads the clock from device memory (an int is first written into a
one-element device tensor) and visits only the n_valid = min(t + 1, L)
written rows: row 0 is always valid, so each masked row's weight is
exp(-1e10 + ...) = 0 exactly in float32. The wrapper reads no device value
back, so a call can be captured in a CUDA graph and replayed at later
clocks.

One launch a call, whose grid depends only on (B, L): `key_splits` CTAs a
batch row, each taking the 32-key chunks `split_keys` gives it; with more
than one split the last CTA of a row merges the partial softmaxes, which
each call writes to scratch of its own (from the stream-ordered caching
allocator, or the graph's pool under capture), using a counter a row. An
eager call takes the counters of its stream, made zero at the stream's
first call and left zero by the kernel, so calls on one stream are ordered
and calls on two streams never share them; a call under graph capture takes
new zeros from the graph's pool (a fill node of the graph), so replays share
them with nothing else.

The heads' widths are compile-time constants of the kernel, built once per
set of widths that `mha_fused.kernel_takes` accepts; at any other the
wrapper raises ValueError on the card.

Inference only, as `pallas_call`: the wrapper raises under autograd when an
input requires grad.
"""

from __future__ import annotations

import torch

from deepxi_tpu_torch.models.attention import NEG_INF_V2
from deepxi_tpu_torch.ops.kernels import (_build, kernel_op, launch_context,
                                          raw_stream, refuse_autograd)
from deepxi_tpu_torch.ops.kernels.mha_fused import head_defines, kernel_takes

CACHE_DTYPES = (torch.float32, torch.bfloat16)
# Keys of the split's unit (csrc/mha_cache.cu CHUNK), and the CTAs a launch
# aims for (two on each of the H100's 132 streaming multiprocessors): below
# that many batch rows the keys are split across CTAs.
CHUNK_KEYS = 32
SPLIT_CTAS = 264


def mha_cache_step_ref(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                       t) -> torch.Tensor:
    """Plain version: the additive mask over all L rows and a full-row
    softmax on the caches upcast to float32; t an int or a 0-d tensor."""
    L = kc.shape[1]
    valid = (torch.arange(L, device=q.device) <= t).to(torch.float32)
    logits = torch.einsum("bHd,bLHd->bHL", q, kc.to(torch.float32))
    logits = logits + NEG_INF_V2 * (1.0 - valid)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bHL,bLHd->bHd", w, vc.to(torch.float32))


def _check(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
           t: torch.Tensor) -> None:
    """Raise on what the kernel does not take (reading no device value)."""
    if q.dtype != torch.float32 or q.dim() != 3 or not kernel_takes(*q.shape[1:]):
        raise ValueError(f"q must be float32 [B, H, d] with heads the kernel "
                         f"takes (mha_fused.kernel_takes), not {tuple(q.shape)} "
                         f"{q.dtype}")
    B, H, d = q.shape
    if (kc.dtype not in CACHE_DTYPES or kc.dim() != 4 or kc.shape[0] != B
            or tuple(kc.shape[2:]) != (H, d) or vc.shape != kc.shape
            or vc.dtype != kc.dtype or not 1 <= B <= 65535):
        raise ValueError(f"kc and vc must be [B={B} <= 65535, L, {H}, {d}] caches of "
                         f"one dtype (float32 or bfloat16), not {tuple(kc.shape)} "
                         f"{kc.dtype} and {tuple(vc.shape)} {vc.dtype}")
    for x in (q, kc, vc):
        if not x.is_contiguous() or x.device != q.device or x.data_ptr() % 16:
            raise ValueError("q, kc and vc must be contiguous, 16-byte aligned "
                             "and on one device")
    if t.dim() != 0 or t.dtype != torch.int32 or t.device != q.device:
        raise ValueError(f"a tensor clock t must be 0-d int32 on {q.device}, not "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def key_splits(B: int, L: int) -> int:
    """CTAs a batch row (the kernel's grid x): one when B alone fills the
    card's CTA slots, else enough for SPLIT_CTAS, at most one a chunk."""
    return max(1, min(-(-L // CHUNK_KEYS), SPLIT_CTAS // B))


def split_keys(S: int, L: int, t: int):
    """The Python twin of the kernel's split: the key range [k0, k1) of
    each of the S CTAs of a batch row at the clock t (empty when k0 >= k1):
    the balanced split of the written rows' 32-key chunks."""
    n_valid = min(max(t, 0) + 1, L)
    nc = -(-n_valid // CHUNK_KEYS)
    return [(s * nc // S * CHUNK_KEYS, min((s + 1) * nc // S * CHUNK_KEYS, n_valid))
            for s in range(S)]


_COUNTERS = {}


def _counters(device: torch.device, B: int) -> torch.Tensor:
    """Zeros for the merge's counters of B rows: under graph capture new
    ones in the graph's pool; else the current stream's, made at its first
    call (65535 rows, the most a launch takes) and left zero by the kernel."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(B, dtype=torch.int32, device=device)
    key = (device, raw_stream(device))
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(65535, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def _step_cuda(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    _check(q, kc, vc, t)
    B, L = kc.shape[:2]
    H, d = q.shape[1:]
    S = key_splits(B, L)
    part, counters = ((torch.empty(B, S, H, d + 2, device=q.device),
                       _counters(q.device, B)) if S > 1 else (None, None))
    out = torch.empty_like(q)
    lib = _build.load("mha_cache", head_defines(H, d))
    with launch_context(q.device):
        rc = lib.mha_cache_forward(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), t.data_ptr(), out.data_ptr(),
            *(x if x is None else x.data_ptr() for x in (part, counters)), B, L, S,
            int(kc.dtype == torch.bfloat16), raw_stream(q.device))
    _build.check(lib, rc, "mha_cache_forward")
    mha_cache_step.launches += 1
    return out


_step_op = kernel_op("mha_cache_step", _step_cuda, mha_cache_step_ref)


def mha_cache_step(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                   t) -> torch.Tensor:
    """One streaming attention step: q [B, H, d] against the caches' rows
    written up to the clock t (an int, or a 0-d int32 tensor on q's device);
    returns [B, H, d] float32. One kernel launch on the card, no host
    synchronisation."""
    refuse_autograd([q, kc, vc], "mha_cache_step")
    if not isinstance(t, torch.Tensor):
        if not isinstance(t, int) or isinstance(t, bool) or t < 0:
            raise ValueError(f"the clock t must be an int >= 0 or a 0-d int32 "
                             f"tensor, not {t!r}")
        t = torch.full((), t, dtype=torch.int32, device=q.device)
    return _step_op(q, kc, vc, t)


mha_cache_step.launches = 0
