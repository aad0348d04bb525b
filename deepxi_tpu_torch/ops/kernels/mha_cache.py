"""KV-cache attention step of streaming MHANet (follows
deepxi_tpu/ops/kernels/mha_cache.py).

`mha_cache_step` runs the CUDA kernel of `csrc/mha_cache.cu` for a CUDA
tensor and its plain version `mha_cache_step_ref` for a CPU tensor; it has a
plain-integer `launches` counter (one per call).

Semantics, as the JAX function: q [B, H, d] float32, pre-scaled; key and
value caches [B, L, H, d] in float32 or bfloat16, upcast to float32; the
mask of written rows ``valid = arange(L) <= t`` for the stream's clock `t`
(every batch row shares it; past the cap, t >= L, all rows are valid);
logits ``q.k + (-1e10)(1 - valid)`` over all L rows, a full-row float32
softmax, then the weighted values: [B, H, d] float32. The JAX function takes
the mask itself; streaming only ever hands it this one, so the port takes
`t`, and the kernel gets ``n_valid = min(t + 1, L)`` as a launch argument:
row 0 is always valid, so each masked row's weight is exp(-1e10 + ...) = 0
exactly in float32 and the kernel reads only the written rows.

Inference only, as `pallas_call`: the wrapper raises under autograd when an
input requires grad.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepxi_tpu_torch.models.attention import NEG_INF_V2
from deepxi_tpu_torch.ops.kernels import refuse_autograd
from deepxi_tpu_torch.ops.kernels.mha_fused import (KERNEL_HEAD_DIM,
                                                    KERNEL_HEADS)

CACHE_DTYPES = (torch.float32, torch.bfloat16)
# Keys a warp scores at a time (csrc/mha_cache.cu TK), and the CTAs a launch
# aims for (about four a streaming multiprocessor): below that many batch
# rows the keys are split across CTAs and the partial softmaxes merged.
TILE_KEYS = 32
SPLIT_CTAS = 528


def mha_cache_step_ref(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                       t: int) -> torch.Tensor:
    """Plain version: the additive mask over all L rows and a full-row
    softmax on the caches upcast to float32."""
    L = kc.shape[1]
    valid = (torch.arange(L, device=q.device) <= t).to(torch.float32)
    logits = torch.einsum("bHd,bLHd->bHL", q, kc.to(torch.float32))
    logits = logits + NEG_INF_V2 * (1.0 - valid)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bHL,bLHd->bHd", w, vc.to(torch.float32))


def _check(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, t: int) -> None:
    """Raise on what the kernel does not take."""
    H, d = KERNEL_HEADS, KERNEL_HEAD_DIM
    if q.dtype != torch.float32 or q.dim() != 3 or tuple(q.shape[1:]) != (H, d):
        raise ValueError(f"q must be float32 [B, {H}, {d}], not "
                         f"{tuple(q.shape)} {q.dtype}")
    B = q.shape[0]
    if (kc.dtype not in CACHE_DTYPES or kc.dim() != 4 or kc.shape[0] != B
            or tuple(kc.shape[2:]) != (H, d) or vc.shape != kc.shape
            or vc.dtype != kc.dtype):
        raise ValueError(f"kc and vc must be [B={B}, L, {H}, {d}] caches of one "
                         f"dtype (float32 or bfloat16), not {tuple(kc.shape)} "
                         f"{kc.dtype} and {tuple(vc.shape)} {vc.dtype}")
    for x in (q, kc, vc):
        if not x.is_contiguous() or x.device != q.device or x.data_ptr() % 16:
            raise ValueError("q, kc and vc must be contiguous, 16-byte aligned "
                             "and on one device")
    if not isinstance(t, int) or t < 0:
        raise ValueError(f"the clock t must be an int >= 0, not {t!r}")


def key_splits(B: int, n_valid: int):
    """(keys a CTA walks, CTAs a batch row): one run of all n_valid keys
    when B alone fills the card, else runs of whole 32-key tiles."""
    tiles = -(-n_valid // TILE_KEYS)
    want = min(tiles, max(1, -(-SPLIT_CTAS // B)))
    per = -(-tiles // want) * TILE_KEYS
    return per, -(-n_valid // per)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from deepxi_tpu_torch.ops.kernels import _build
    lib = _build.load("mha_cache")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mha_cache_error_string.argtypes = [i]
    lib.mha_cache_error_string.restype = ctypes.c_char_p
    lib.mha_cache_forward.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.mha_cache_forward.restype = i
    return lib


def mha_cache_step(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                   t: int) -> torch.Tensor:
    """One streaming attention step: q [B, H, d] against the caches' rows
    written up to the clock t; returns [B, H, d] float32."""
    refuse_autograd([q, kc, vc], "mha_cache_step")
    if q.device.type == "cpu":
        return mha_cache_step_ref(q, kc, vc, t)
    _check(q, kc, vc, t)
    B, L = kc.shape[:2]
    n_valid = min(t + 1, L)
    per, n_split = key_splits(B, n_valid)
    out = torch.empty_like(q)
    parts = [None] * 3
    if n_split > 1:
        shape = (B, n_split, KERNEL_HEADS)
        parts = [torch.empty(shape, device=q.device),
                 torch.empty(shape, device=q.device),
                 torch.empty(shape + (KERNEL_HEAD_DIM,), device=q.device)]
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.mha_cache_forward(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
            *(x if x is None else x.data_ptr() for x in parts), B, L, n_valid,
            per, n_split, int(kc.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mha_cache_forward failed: CUDA error {rc} "
                           f"({lib.mha_cache_error_string(rc).decode()})")
    mha_cache_step.launches += 1
    return out


mha_cache_step.launches = 0
