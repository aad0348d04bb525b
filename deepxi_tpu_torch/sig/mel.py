"""Mel-scaled triangular filter bank (follows deepxi_tpu/sig/mel.py).

Each filter sums to unity, so that it weights the a priori SNR into subband
SNRs for the ``subband_ibm_hat`` output. Host numpy, float32, cached per
(M, K, f_s).
"""

from __future__ import annotations

import functools

import numpy as np


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filter_bank(M: int, K: int, f_s: int) -> np.ndarray:
    """[M, K//2+1] float32 bank of M triangular filters over the K//2+1 bins
    of an FFT of size K at f_s Hz, each summing to unity. Boundary points
    follow Huang et al. (2001, p. 315)."""
    f_l, f_h = 0.0, f_s / 2.0
    n_bins = K // 2 + 1

    def bpoint(m: int) -> float:
        return ((2.0 * n_bins) / f_s) * mel_to_hz(
            hz_to_mel(f_l) + m * ((hz_to_mel(f_h) - hz_to_mel(f_l)) / (M + 1)))

    H = np.zeros([M, n_bins], dtype=np.float32)
    k = np.arange(n_bins, dtype=np.float64)
    for m in range(1, M + 1):
        bl, c, bh = bpoint(m - 1), bpoint(m), bpoint(m + 1)
        up = (2.0 * (k - bl)) / ((bh - bl) * (c - bl))
        down = (2.0 * (bh - k)) / ((bh - bl) * (bh - c))
        H[m - 1] = np.where((k >= bl) & (k <= c), up, H[m - 1])
        H[m - 1] = np.where((k >= c) & (k <= bh), down, H[m - 1])
    return H
