"""Short-time framing and overlap-add, tf.signal-exact, in PyTorch
(follows deepxi_tpu/sig/stft.py).

  * Hamming window with ``periodic=False`` (symmetric). ``torch.hamming_window``
    defaults to the periodic window, so the window is built here on the host.
  * ``pad_end=True`` framing: ``ceil(len / N_s)`` frames, zero-padded so every
    frame is full.
  * The COLA-normalised synthesis window of
    ``tf.signal.inverse_stft_window_fn`` and shift-and-add overlap-add.
  * `stft` / `polar_analysis` on the exact FFT (``torch.fft.rfft``), the
    spectra of the training examples and the map statistics, and their
    inverse `inverse_stft` / `polar_synthesis` (``torch.fft.irfft``), the
    plain definition of the per-utterance synthesis.

Framing and overlap-add take any hop: Deep Xi's 50% overlap (N_d = 2 N_s)
as a reshape into hop rows (`hop_rows`, the layout the spectral kernels
read) and a shift-and-add, any other as a gather of the frames and a
scatter-add (``index_add_``) of them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _hamming_np(length: int) -> np.ndarray:
    """Symmetric Hamming window 0.54 - 0.46 cos(2 pi n / (length - 1))
    (float64 accumulation, float32 result)."""
    if length == 1:
        return np.ones((1,), np.float32)
    n = np.arange(length, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / (length - 1))).astype(np.float32)


def n_frames(n_samples: int, N_s: int) -> int:
    """Frame count for ``pad_end=True`` framing: ``ceil(n_samples / N_s)``."""
    return -(-int(n_samples) // int(N_s))


def hop_rows(x: torch.Tensor, N_s: int) -> torch.Tensor:
    """[..., n] -> [..., T+1, N_s] hop rows, T = ceil(n / N_s), zero-padded
    to (T+1) N_s samples: with N_d = 2 N_s, frame i is rows (i, i+1)."""
    T = n_frames(x.shape[-1], N_s)
    x = F.pad(x, (0, (T + 1) * N_s - x.shape[-1]))
    return x.reshape(x.shape[:-1] + (T + 1, N_s))


def frame(x: torch.Tensor, N_d: int, N_s: int) -> torch.Tensor:
    """[..., n] -> [..., T, N_d] frames with ``pad_end=True``
    (``tf.signal.frame``), T = ceil(n / N_s), zero-padded to (T-1) N_s + N_d
    samples. With N_d = 2 N_s frame i is rows (i, i+1) of `hop_rows`; any
    other hop gathers samples i N_s .. i N_s + N_d - 1."""
    if N_d == 2 * N_s:
        x2 = hop_rows(x, N_s)
        return torch.cat([x2[..., :-1, :], x2[..., 1:, :]], dim=-1)
    T = n_frames(x.shape[-1], N_s)
    x = F.pad(x, (0, max((T - 1) * N_s + N_d - x.shape[-1], 0)))
    idx = (torch.arange(T, device=x.device)[:, None] * N_s
           + torch.arange(N_d, device=x.device)[None, :])
    return x[..., idx]


@functools.lru_cache(maxsize=None)
def _synthesis_window_np(N_d: int, N_s: int) -> np.ndarray:
    """COLA-normalised synthesis window of ``tf.signal.inverse_stft_window_fn``:
    w_syn[n] = w[n] / sum_k w[n mod N_s + k N_s]^2, in float64 then cast."""
    w = _hamming_np(N_d).astype(np.float64)
    overlaps = -(-N_d // N_s)
    denom = np.pad(np.square(w), (0, overlaps * N_s - N_d))
    denom = np.tile(denom.reshape(overlaps, N_s).sum(axis=0), overlaps)[:N_d]
    return (w / denom).astype(np.float32)


def overlap_and_add(frames: torch.Tensor, N_s: int) -> torch.Tensor:
    """[..., T, N_d] -> [..., (T-1)*N_s + N_d], ``tf.signal.overlap_and_add``."""
    T, N_d = frames.shape[-2], frames.shape[-1]
    n_out = (T - 1) * N_s + N_d
    if N_d == 2 * N_s:
        # out row i = first half of frame i + second half of frame i-1
        h1 = F.pad(frames[..., :N_s], (0, 0, 0, 1))
        h2 = F.pad(frames[..., N_s:], (0, 0, 1, 0))
        return (h1 + h2).reshape(frames.shape[:-2] + (n_out,))
    # any other hop: each frame's samples added in at its offset
    lead = frames.shape[:-2]
    flat = frames.reshape(-1, T * N_d)
    idx = (torch.arange(T, device=frames.device)[:, None] * N_s
           + torch.arange(N_d, device=frames.device)[None, :]).reshape(-1)
    out = torch.zeros(flat.shape[0], n_out, dtype=frames.dtype, device=frames.device)
    return out.index_add_(1, idx, flat).reshape(lead + (n_out,))


def stft(x: torch.Tensor, N_d: int, N_s: int, K: int) -> torch.Tensor:
    """Complex STFT [..., T, K//2+1]: frame (pad_end) -> symmetric Hamming
    window -> rFFT of length K, as ``tf.signal.stft``. Training takes this
    exact FFT, not the matmul DFT of `ops/kernels/spectral.py`."""
    w = torch.as_tensor(_hamming_np(N_d), device=x.device)
    frames = frame(x, N_d, N_s) * w
    return torch.fft.rfft(frames, n=K, dim=-1)


def polar_analysis(x: torch.Tensor, N_d: int, N_s: int,
                   K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Short-time magnitude and phase spectra."""
    X = stft(x, N_d, N_s, K)
    return torch.abs(X), torch.angle(X)


def inverse_stft(X: torch.Tensor, N_d: int, N_s: int, K: int) -> torch.Tensor:
    """Inverse of `stft`, ``tf.signal.inverse_stft`` with the
    ``inverse_stft_window_fn`` synthesis window: [..., T, K//2+1] complex ->
    [..., (T-1)*N_s + N_d] waveform."""
    frames = torch.fft.irfft(X, n=K, dim=-1)[..., :N_d]
    w_syn = torch.as_tensor(_synthesis_window_np(N_d, N_s), device=X.device)
    return overlap_and_add(frames * w_syn, N_s)


def polar_synthesis(STMS: torch.Tensor, STPS: torch.Tensor, N_d: int, N_s: int,
                    K: int) -> torch.Tensor:
    """Waveform from short-time magnitude and phase spectra."""
    return inverse_stft(torch.polar(STMS, STPS), N_d, N_s, K)
