"""Masked multi-head attention without [B, H, T, T] in memory (follows
deepxi_tpu/ops/kernels/mha_fused.py).

`flash_attention` runs the CUDA kernel of `csrc/mha_attention.cu` for a CUDA
tensor and its plain version `flash_attention_ref` for a CPU tensor, both as
the op `deepxi::flash_attention` (`ops.kernels.kernel_op`); it has a
plain-integer `launches` counter, counted in the CUDA implementation. The kernel is shared with
`mha_flash_stream.flash_attention_streaming`, which differs only in the keys
a padded query row visits.

Semantics (the tfa convention of the reference): logits
``q.k + (-1e10)(1 - valid_q valid_k [causal])``, a full-row softmax, then
the weighted values. The JAX kernel pads the keys to T rounded up to 128
(zero k and v, invalid), so a fully masked query row (an invalid frame)
averages the values of all those keys; both versions here reproduce that on
every row. The JAX kernel's query tiling (`block_q`) does not change the
function and is left out. On the card a warp takes 16 query rows of one
head and walks 64-key tiles with an online softmax, its products on the
tensor cores to f32 accuracy. The heads' widths are compile-time constants
of the kernel: the wrapper builds one library per set of widths that
`kernel_takes` accepts, and raises ValueError on the card at any other.

Inference only, as `pallas_call`: the wrappers raise under autograd when an
input requires grad.
"""

from __future__ import annotations

import torch

from deepxi_tpu_torch.models.attention import NEG_INF_V2
from deepxi_tpu_torch.ops.kernels import (_build, kernel_op, launch_context,
                                          raw_stream, refuse_autograd)

# mhanet-1.1c's heads, the default of `mha_block_fused.random_block_weights`.
KERNEL_HEADS = 8


def kernel_takes(n_heads: int, head_dim: int) -> bool:
    """Whether the attention kernels (`csrc/mha_common.cuh` and
    `csrc/mha_cache.cu`; shared with `mha_flash_stream` and `mha_cache`) can
    be built for these heads: a head width that is a multiple of 4 up to 64
    (16-byte staging; the tensor-core tiles pad it to a multiple of 8 with
    zeros, and a lane holds its rows' accumulators in registers), at most
    32 heads and 1024 columns."""
    return (1 <= n_heads <= 32 and head_dim % 4 == 0 and 4 <= head_dim <= 64
            and n_heads * head_dim <= 1024)


def head_defines(n_heads: int, head_dim: int) -> dict:
    """The build defines of the attention kernels at these heads."""
    return {"MHA_NH": n_heads, "MHA_DK": head_dim}


def masked_softmax_attention(qp, kp, vp, valid_q, valid_k, causal: bool,
                             n_visit=None) -> torch.Tensor:
    """softmax(q.k + (-1e10)(1 - mask)) v for queries [B, T, H, d] against
    keys [B, S, H, d]; valid_q [B, T], valid_k [B, S] bool; when causal, row
    t sees keys s <= t. `n_visit` ([T] ints) leaves keys at or past it out
    of row t's softmax altogether."""
    T, S = qp.shape[1], kp.shape[1]
    logits = torch.einsum("btHd,bsHd->bHts", qp, kp)
    m = valid_q[:, :, None] & valid_k[:, None, :]
    if causal:
        m = m & torch.ones(T, S, dtype=torch.bool, device=qp.device).tril()
    logits = logits + NEG_INF_V2 * (1.0 - m[:, None].to(logits.dtype))
    if n_visit is not None:
        keys = torch.arange(S, device=qp.device)
        logits = logits.masked_fill(keys[None, :] >= n_visit[:, None], float("-inf"))
    return torch.einsum("bHts,bsHd->btHd", torch.softmax(logits, -1), vp)


def pad_keys(kp, vp, valid, n_keys: int):
    """K, V and key validity zero-padded (invalid) from T to n_keys keys."""
    pad = n_keys - kp.shape[1]
    f = torch.nn.functional.pad
    return (f(kp, (0, 0, 0, 0, 0, pad)), f(vp, (0, 0, 0, 0, 0, pad)),
            f(valid, (0, pad)))


def flash_attention_ref(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                        valid: torch.Tensor, causal: bool) -> torch.Tensor:
    """Plain version: the full-row softmax over T rounded up to 128 keys."""
    T = qp.shape[1]
    kp2, vp2, vk = pad_keys(kp, vp, valid, -(-T // 128) * 128)
    return masked_softmax_attention(qp, kp2, vp2, valid, vk, causal)


def check_heads(*heads: torch.Tensor) -> None:
    """Raise on what the attention kernel does not take."""
    shape = heads[0].shape
    for t in heads:
        if (t.dtype != torch.float32 or t.dim() != 4 or not t.is_contiguous()
                or t.shape != shape or t.device != heads[0].device
                or t.data_ptr() % 16):
            raise ValueError("q, k, v must be contiguous float32 [B, T, H, d] "
                             "tensors of one shape on one device")
    if not kernel_takes(*shape[2:]):
        raise ValueError(f"the kernel takes up to 32 heads of a multiple of 4 "
                         f"up to 64, at most 1024 columns, not {tuple(shape[2:])}")


def launch_attention(qp, kp, vp, valid, causal: bool, n_keys: int,
                     skip_bq: int = 0, skip_bk: int = 0) -> torch.Tensor:
    """One launch of `mha_attention_forward` on CUDA tensors; returns the
    [B, T, H, d] output. The kernel reads `valid` (bool) as bytes."""
    check_heads(qp, kp, vp)
    B, T = qp.shape[:2]
    if valid.shape != (B, T) or valid.dtype != torch.bool or valid.device != qp.device:
        raise ValueError(f"valid must be a bool [B, T] = {(B, T)} tensor on "
                         f"{qp.device}, not {valid.dtype} {tuple(valid.shape)} "
                         f"on {valid.device}")
    valid = valid.contiguous()
    out = torch.empty_like(qp)
    lib = _build.load("mha_attention", head_defines(*qp.shape[2:]))
    with launch_context(qp.device):
        rc = lib.mha_attention_forward(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), valid.data_ptr(),
            out.data_ptr(), B, T, n_keys, int(causal), skip_bq, skip_bk,
            raw_stream(qp.device))
    _build.check(lib, rc, "mha_attention_forward")
    return out


def _flash_cuda(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                valid: torch.Tensor, causal: bool) -> torch.Tensor:
    T = qp.shape[1]
    out = launch_attention(qp, kp, vp, valid, causal, -(-T // 128) * 128)
    flash_attention.launches += 1
    return out


_flash_op = kernel_op("flash_attention", _flash_cuda, flash_attention_ref)


def flash_attention(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    valid: torch.Tensor, causal: bool) -> torch.Tensor:
    """Masked multi-head attention on [B, T, H, d] projected heads (q
    pre-scaled) with valid [B, T] bool; returns [B, T, H, d]."""
    refuse_autograd([qp, kp, vp], "flash_attention")
    return _flash_op(qp, kp, vp, valid, causal)


flash_attention.launches = 0
