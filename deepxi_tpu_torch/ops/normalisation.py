"""Frame-wise, sequence-wise and causal sequence-wise layer normalisation
with sequence masks (follows deepxi_tpu/ops/normalisation.py).

Activations are [B, T, F]; `seq_len` [B] gives each row's valid frames.
The variance epsilon is 1e-12. The causal moments are cumulative sums over
time with denominators (t+1) F, and each frame's squared deviation is taken
from its own running mean before the sum, the reference's estimator. The
sequence-wise norms mask their inputs before the sums and zero their outputs
past each row's length. An unknown `norm_type` raises.
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-12


def _seq_mask(seq_len: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, T] float {0, 1}."""
    return (torch.arange(max_len, device=seq_len.device)[None, :]
            < seq_len[:, None]).to(torch.float32)


def _affine(y: torch.Tensor, beta: Optional[torch.Tensor],
            gamma: Optional[torch.Tensor]) -> torch.Tensor:
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y


def frame_layer_norm(x: torch.Tensor, beta: Optional[torch.Tensor] = None,
                     gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Moments over the channel axis of each (b, t)."""
    mu = x.mean(dim=-1, keepdim=True)
    sigma = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return _affine((x - mu) * (1.0 / torch.sqrt(sigma + _EPS)), beta, gamma)


def seq_layer_norm(x: torch.Tensor, seq_len: torch.Tensor,
                   beta: Optional[torch.Tensor] = None,
                   gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One (mu, sigma) a sequence over its valid frames and all channels;
    the output re-masked."""
    mask = _seq_mask(seq_len, x.shape[1])[..., None]
    den = mask.sum(dim=1, keepdim=True) * x.shape[-1]
    mu = (x * mask).sum(dim=(1, 2), keepdim=True) / den
    sigma = (torch.square(x - mu) * mask).sum(dim=(1, 2), keepdim=True) / den
    return _affine((x - mu) * (1.0 / torch.sqrt(sigma + _EPS)), beta, gamma) * mask


def seq_causal_layer_norm(x: torch.Tensor, seq_len: torch.Tensor,
                          beta: Optional[torch.Tensor] = None,
                          gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frame t normalised by the cumulative moments of frames 0..t."""
    f = x.shape[-1]
    mask = _seq_mask(seq_len, x.shape[1])
    xm = x * mask[..., None]
    den = torch.arange(1, x.shape[1] + 1, dtype=x.dtype, device=x.device) * f
    mu = (torch.cumsum(xm.sum(dim=-1), dim=-1) / den)[..., None]
    dev = torch.square(xm - mu).sum(dim=-1)
    sigma = (torch.cumsum(dev, dim=-1) / den)[..., None]
    y = _affine((x - mu) * (1.0 / torch.sqrt(sigma + _EPS)), beta, gamma)
    return y * mask[..., None]


def normalisation(x: torch.Tensor, norm_type: str = "FrameLayerNorm",
                  seq_len: Optional[torch.Tensor] = None,
                  beta: Optional[torch.Tensor] = None,
                  gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch by name: SeqCausalLayerNorm, SeqLayerNorm, FrameLayerNorm or
    unnormalised."""
    if norm_type == "SeqCausalLayerNorm":
        return seq_causal_layer_norm(x, seq_len, beta, gamma)
    if norm_type == "SeqLayerNorm":
        return seq_layer_norm(x, seq_len, beta, gamma)
    if norm_type == "FrameLayerNorm":
        return frame_layer_norm(x, beta, gamma)
    if norm_type == "unnormalised":
        return x
    raise ValueError(f"Normalisation type does not exist: {norm_type}.")
