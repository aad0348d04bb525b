"""Short-time discrete cosine transform in tf.signal's unnormalised
convention (follows deepxi_tpu/sig/stdct.py).

Analysis: frame (pad_end) -> symmetric Hamming window -> DCT-II of length K
(``tf.signal.dct``, unnormalised). Synthesis: DCT-III (``tf.signal.idct``,
unnormalised, so ``idct(dct(x)) == 2K x``) -> truncate or zero-pad to N_d
-> COLA synthesis window -> overlap-add. Each DCT is a product with a
coefficient matrix built in float64 on the host and cast to float32.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepxi_tpu_torch.sig.stft import (_hamming_np, _synthesis_window_np,
                                       frame, overlap_and_add)


@functools.lru_cache(maxsize=None)
def _dct2_matrix(N: int) -> np.ndarray:
    """Unnormalised DCT-II matrix M, y = x @ M: M[n, k] = 2 cos(pi k (2n+1) / 2N)."""
    n = np.arange(N, dtype=np.float64)[:, None]
    k = np.arange(N, dtype=np.float64)[None, :]
    return (2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * N))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct3_matrix(N: int) -> np.ndarray:
    """Unnormalised DCT-III matrix M, y = x @ M:
    y[n] = x[0] + 2 sum_{k>=1} x[k] cos(pi (2n+1) k / 2N)."""
    n = np.arange(N, dtype=np.float64)[None, :]
    k = np.arange(N, dtype=np.float64)[:, None]
    M = 2.0 * np.cos(np.pi * (2.0 * n + 1.0) * k / (2.0 * N))
    M[0, :] = 1.0
    return M.astype(np.float32)


def _to_length(x: torch.Tensor, N: int) -> torch.Tensor:
    """The last axis cut or zero-padded to N."""
    return x[..., :N] if N <= x.shape[-1] else F.pad(x, (0, N - x.shape[-1]))


def dct2(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Type-II DCT over the last axis, ``tf.signal.dct(x, type=2, n=n)``."""
    N = x.shape[-1] if n is None else n
    return _to_length(x, N) @ torch.as_tensor(_dct2_matrix(N), device=x.device)


def dct3(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Type-III DCT (``tf.signal.idct(x, type=2)``): the inverse of `dct2`
    up to 2N."""
    N = x.shape[-1] if n is None else n
    return _to_length(x, N) @ torch.as_tensor(_dct3_matrix(N), device=x.device)


def stdct(x: torch.Tensor, N_d: int, N_s: int, K: int) -> torch.Tensor:
    """[..., n] -> [..., T, K] real coefficients: frame (pad_end), Hamming
    window, DCT-II of length K."""
    w = torch.as_tensor(_hamming_np(N_d), device=x.device)
    return dct2(frame(x, N_d, N_s) * w, n=K)


def inverse_stdct(S: torch.Tensor, N_d: int, N_s: int, K: int) -> torch.Tensor:
    """[..., T, K] -> [..., (T-1) N_s + N_d]: DCT-III, cut (or zero-padded)
    to N_d, the COLA synthesis window, overlap-add. The round trip carries
    tf.signal's 2K scale."""
    frames = _to_length(dct3(S, n=K), N_d)
    w_syn = torch.as_tensor(_synthesis_window_np(N_d, N_s), device=S.device)
    return overlap_and_add(frames * w_syn, N_s)
