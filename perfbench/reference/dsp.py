"""Deep Xi's signal chain, written plainly: framing with the end padded
(tf.signal.frame), the symmetric Hamming window and the exact real FFT,
the COLA synthesis window and overlap-add, the exponential integral the
gains use, and SNR mixing (anicolson/DeepXi deepxi/sig.py,
deepxi/utils.py). The family, map and gain are the configuration's
(`perfbench/reference/__init__.py`)."""

from __future__ import annotations

import numpy as np
import torch

import perfbench.reference as ref

XI_MAX = 1e12   # the gains clamp ξ and γ here


def hamming(N: int, device) -> torch.Tensor:
    n = np.arange(N, dtype=np.float64)
    return torch.as_tensor(0.54 - 0.46 * np.cos(2 * np.pi * n / (N - 1)), dtype=torch.float32,
                           device=device)


def synthesis_window(N_d: int, N_s: int, device) -> torch.Tensor:
    """w / sum_k w[n mod N_s + k N_s]^2 (tf.signal.inverse_stft_window_fn)."""
    n = np.arange(N_d, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2 * np.pi * n / (N_d - 1))
    denom = np.zeros(N_d)
    for i in range(N_d):
        denom[i] = sum(w[j] ** 2 for j in range(i % N_s, N_d, N_s))
    return torch.as_tensor(w / denom, dtype=torch.float32, device=device)


def frames(x: torch.Tensor, N_d: int, N_s: int) -> torch.Tensor:
    """[B, L] -> [B, ceil(L / N_s), N_d], the end zero-padded."""
    T = -(-x.shape[-1] // N_s)
    x = torch.nn.functional.pad(x, (0, (T - 1) * N_s + N_d - x.shape[-1]))
    return x.unfold(-1, N_d, N_s)


def stft(x: torch.Tensor, N_d: int, N_s: int, K: int) -> torch.Tensor:
    return torch.fft.rfft(frames(x, N_d, N_s) * hamming(N_d, x.device), n=K)


def istft(X: torch.Tensor, N_d: int, N_s: int, K: int) -> torch.Tensor:
    """[B, T, K/2+1] -> [B, (T-1) N_s + N_d] by overlap-add."""
    f = torch.fft.irfft(X, n=K)[..., :N_d] * synthesis_window(N_d, N_s, X.device)
    B, T, _ = f.shape
    out = torch.zeros(B, (T - 1) * N_s + N_d, device=X.device)
    for j in range(N_d // N_s):
        part = f[..., j * N_s:(j + 1) * N_s].reshape(B, T * N_s)
        out[:, j * N_s:j * N_s + T * N_s] += part
    return out


def exp1(x: torch.Tensor) -> torch.Tensor:
    """E1(x), x > 0, in float64: the power series to x = 1, beyond it the
    continued fraction (modified Lentz)."""
    x = x.double()
    small = x <= 1.0
    xs = torch.where(small, x, torch.ones_like(x)).clamp(min=1e-300)
    term, series = torch.ones_like(xs), torch.zeros_like(xs)
    for k in range(1, 30):
        term = term * (-xs) / k
        series = series - term / k
    e_small = -0.5772156649015329 - torch.log(xs) + series
    xl = torch.where(small, torch.full_like(x, 2.0), x)
    b = xl + 1.0
    c = torch.full_like(xl, 1e300)
    d = 1.0 / b
    h = d
    for i in range(1, 200):
        a = -float(i * i)
        b = b + 2.0
        d = 1.0 / (a * d + b)
        c = b + a / c
        h = h * c * d
    e_large = h * torch.exp(-xl)
    return torch.where(small, e_small, e_large)


def enhance(net, x_int16: torch.Tensor, cfg: dict, stats: dict) -> torch.Tensor:
    """The enhanced waveform [B, (T-1) N_s + N_d] of int16 rows: the
    family's features to the network `net`, its output to the enhanced
    spectrum, the inverse FFT and overlap-add."""
    N_d, N_s, K = cfg["N_d"], cfg["N_s"], cfg["K"]
    fam = ref.family(cfg)
    X = stft(x_int16.float() / 32768.0, N_d, N_s, K)
    return istft(fam.enhance_spectrum(X, net(fam.features(X)), cfg, stats), N_d, N_s, K)


def add_noise(s, d, s_len, offsets, snr_db):
    """Deep Xi's mixing of float rows: the noise segment d[i : i + L]
    (wrapping) at each row's offset, both cut to the speech's length, the
    noise scaled to the SNR over the valid samples. Returns (x, s, d)."""
    L, L_d = s.shape[-1], d.shape[-1]
    idx = (torch.arange(L, device=s.device)[None, :] + offsets[:, None]) % L_d
    mask = (torch.arange(L, device=s.device)[None, :] < s_len[:, None]).float()
    s, d = s * mask, torch.gather(d, 1, idx) * mask
    n = s_len.float().clamp(min=1.0)
    p_s, p_d = s.square().sum(1) / n, d.square().sum(1) / n
    alpha = torch.sqrt(p_s / (p_d * 10.0 ** (snr_db / 10.0)).clamp(min=1e-12))
    d = d * alpha[:, None]
    return s + d, s, d
