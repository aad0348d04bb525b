"""Adaptive filters: NLMS, LMS, block NLMS and adaptive noise cancellation
(follows deepxi_tpu/dsp/adaptive.py). The JAX package's `lax.scan` over
samples (over blocks for `block_nlms`) is a Python loop here, on the
tensors' device and in their dtype: one step a sample, a handful of
launches each on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _tap_matrix(x: torch.Tensor, n_taps: int) -> torch.Tensor:
    """[N, n_taps] tap-delay rows: row i = x[i], x[i-1], ..., x[i-n_taps+1]."""
    xp = F.pad(x, (n_taps - 1, 0))
    idx = (torch.arange(x.shape[0], device=x.device)[:, None] + (n_taps - 1)
           - torch.arange(n_taps, device=x.device)[None, :])
    return xp[idx]


def _scan(U: torch.Tensor, d: torch.Tensor, update) -> Tuple[torch.Tensor, torch.Tensor,
                                                             torch.Tensor]:
    """Run w_{t+1} = update(w_t, u_t, e_t), e_t = d_t - u_t . w_t from w_0 =
    0 over the rows of U; returns (y, e, w)."""
    w = torch.zeros(U.shape[-1], dtype=U.dtype, device=U.device)
    ys = []
    for t in range(U.shape[0]):
        u = U[t]
        y = u @ w
        ys.append(y)
        w = update(w, u, d[t] - y)
    y = torch.stack(ys)
    return y, d[:U.shape[0]] - y, w


def nlms(x: torch.Tensor, d: torch.Tensor, n_taps: int = 64, mu: float = 0.5,
         eps: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalised LMS: filter the excitation x [N] to track the desired
    signal d [N]; w_{t+1} = w_t + mu e_t u_t / (||u_t||^2 + eps).
    Returns (y, e, w): filter output, error (the cancelled signal), final
    weights."""
    return _scan(_tap_matrix(x, n_taps), d,
                 lambda w, u, e: w + mu * e * u / (torch.dot(u, u) + eps))


def lms(x: torch.Tensor, d: torch.Tensor, n_taps: int = 64, mu: float = 0.01
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain LMS: w_{t+1} = w_t + mu e_t u_t."""
    return _scan(_tap_matrix(x, n_taps), d, lambda w, u, e: w + mu * e * u)


def cancel_noise(primary: torch.Tensor, reference: torch.Tensor, n_taps: int = 64,
                 mu: float = 0.5) -> torch.Tensor:
    """Adaptive noise cancellation: the NLMS filter models the
    reference-to-primary noise path; the error is the cleaned output."""
    return nlms(reference, primary, n_taps=n_taps, mu=mu)[1]


def block_nlms(x: torch.Tensor, d: torch.Tensor, n_taps: int = 64, mu: float = 0.5,
               eps: float = 1e-3, block: int = 256
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-updated NLMS: the weights move once a block of `block` samples
    by the block's mean normalised gradient (a trailing partial block is
    dropped)."""
    N = (x.shape[0] // block) * block
    U = _tap_matrix(x[:N], n_taps).reshape(N // block, block, n_taps)
    D = d[:N].reshape(N // block, block)
    w = torch.zeros(n_taps, dtype=x.dtype, device=x.device)
    ys, es = [], []
    for b in range(N // block):
        u = U[b]
        y = u @ w
        e = D[b] - y
        norm = torch.sum(u * u, dim=-1, keepdim=True) + eps
        w = w + mu * torch.mean(e[:, None] * u / norm, dim=0)
        ys.append(y)
        es.append(e)
    return torch.cat(ys), torch.cat(es), w
