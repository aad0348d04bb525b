"""Streaming (online-softmax) attention of unbounded length (follows
deepxi_tpu/ops/kernels/mha_flash_stream.py).

`flash_attention_streaming` runs the CUDA kernel of `csrc/mha_attention.cu`
(shared with `mha_fused.flash_attention`) for a CUDA tensor and its plain
version `flash_attention_streaming_ref` for a CPU tensor, both as the op
`deepxi::flash_attention_streaming` (`ops.kernels.kernel_op`); it has a
plain-integer `launches` counter, counted in the CUDA implementation.

Semantics: the additive -1e10 mask and softmax of `mha_fused`, with the JAX
kernel's key walk. Keys are padded to T rounded up to `block_k`; a causal
query tile of `block_q` rows visits only the key tiles up to its diagonal.
Valid rows are the full-row softmax either way; a fully masked (padded)
query row averages the values of the keys it visits, so its output depends
on `block_q` and `block_k`, and both versions here take them as the JAX
kernel does and agree with it on every row. The card's own tiles are 16 to
64 query rows by 64 keys (the JAX defaults are 256 by 512); they do not
change the function, since the kernel takes the key limit of each row from
`block_q` and `block_k`.

Inference only: raises under autograd when an input requires grad.
"""

from __future__ import annotations

import torch

from deepxi_tpu_torch.ops.kernels import kernel_op, refuse_autograd
from deepxi_tpu_torch.ops.kernels.mha_fused import (launch_attention,
                                                    masked_softmax_attention,
                                                    pad_keys)


def keys_visited(T: int, causal: bool, block_q: int, block_k: int,
                 device=None) -> torch.Tensor:
    """[T] count of keys the JAX kernel walks for each query row: T rounded
    up to block_k, or, when causal, the key tiles up to the diagonal of the
    row's query tile."""
    n_k = -(-T // block_k)
    rows = torch.arange(T, device=device)
    if not causal:
        return torch.full_like(rows, n_k * block_k)
    last = torch.clamp((rows // block_q * block_q + block_q - 1) // block_k,
                       max=n_k - 1)
    return (last + 1) * block_k


def flash_attention_streaming_ref(qp: torch.Tensor, kp: torch.Tensor,
                                  vp: torch.Tensor, valid: torch.Tensor,
                                  causal: bool, block_q: int = 256,
                                  block_k: int = 512) -> torch.Tensor:
    """Plain version: each row's softmax over the keys it visits."""
    T = qp.shape[1]
    kp2, vp2, vk = pad_keys(kp, vp, valid, -(-T // block_k) * block_k)
    return masked_softmax_attention(
        qp, kp2, vp2, valid, vk, causal,
        n_visit=keys_visited(T, causal, block_q, block_k, qp.device))


def _stream_cuda(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                 valid: torch.Tensor, causal: bool, block_q: int,
                 block_k: int) -> torch.Tensor:
    if block_q < 1 or block_k < 1:
        raise ValueError("block_q and block_k must be positive")
    T = qp.shape[1]
    out = launch_attention(qp, kp, vp, valid, causal,
                           -(-T // block_k) * block_k,
                           skip_bq=block_q if causal else 0,
                           skip_bk=block_k if causal else 0)
    flash_attention_streaming.launches += 1
    return out


_stream_op = kernel_op("flash_attention_streaming", _stream_cuda,
                       flash_attention_streaming_ref)


def flash_attention_streaming(qp: torch.Tensor, kp: torch.Tensor,
                              vp: torch.Tensor, valid: torch.Tensor,
                              causal: bool, block_q: int = 256,
                              block_k: int = 512) -> torch.Tensor:
    """Masked multi-head attention on [B, T, H, d] projected heads (q
    pre-scaled) with valid [B, T] bool, walking key tiles with an online
    softmax; returns [B, T, H, d]."""
    refuse_autograd([qp, kp, vp], "flash_attention_streaming")
    return _stream_op(qp, kp, vp, valid, causal, block_q, block_k)


flash_attention_streaming.launches = 0
