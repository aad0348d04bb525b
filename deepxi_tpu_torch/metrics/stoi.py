"""STOI and extended STOI (eSTOI) intelligibility measures, pure numpy.

Implemented from the published algorithms (Taal et al., "An Algorithm for
Intelligibility Prediction of Time-Frequency Weighted Noisy Speech", IEEE
TASLP 2011; Jensen & Taal, "An Algorithm for Predicting the Intelligibility
of Speech Masked by Modulated Noise Maskers", IEEE TASLP 2016).

The reference evaluates with the `pystoi` package inside DeepXi.test
(ref: deepxi/model.py:1854-1857); this environment has no pystoi, so the
measure is implemented natively with the canonical constants (10 kHz, 256/512
frames, 15 third-octave bands from 150 Hz, 40 dB silence range, N=30 segment
length, -15 dB clipping). Every framing/band/silence-removal convention is
transcribed from the reference's MATLAB scorer
(ref: demand_voice_bank_objective_scoring/stoi.m:30-190): MATLAB
hanning(256) window, 1:hop:(L-N) frame starts (final exactly-fitting frame
dropped), snapped third-octave edges, un-normalised windowed overlap-add
silence reconstruction, per-band taa_corr.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.signal import resample_poly

FS = 10000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150.0
N_SEG = 30
BETA = -15.0
DYN_RANGE = 40.0


@functools.lru_cache(maxsize=None)
def _third_octave_matrix() -> np.ndarray:
    """[NUMBAND, NFFT//2+1] one-third-octave band membership matrix."""
    f = np.linspace(0, FS, NFFT, endpoint=False)[: NFFT // 2 + 1]
    cfs = MINFREQ * np.power(2.0, np.arange(NUMBAND) / 3.0)
    f_lo = cfs / (2.0 ** (1.0 / 6.0))
    f_hi = cfs * (2.0 ** (1.0 / 6.0))
    obm = np.zeros((NUMBAND, len(f)))
    for j in range(NUMBAND):
        lo = int(np.argmin(np.square(f - f_lo[j])))
        hi = int(np.argmin(np.square(f - f_hi[j])))
        obm[j, lo:hi] = 1.0
    return obm


def _frames(x: np.ndarray, win: np.ndarray, hop: int) -> np.ndarray:
    # frame starts 1:hop:(L-N) like the MATLAB scorer (stoi.m:151): the
    # final exactly-fitting window is dropped
    n = 1 + max(0, (len(x) - len(win) - 1) // hop)
    idx = np.arange(n)[:, None] * hop + np.arange(len(win))[None, :]
    return x[idx] * win


def _remove_silent_frames(x: np.ndarray, y: np.ndarray) -> tuple:
    """Drop frames whose clean energy is >40 dB below the loudest frame,
    reconstructing both signals by windowed overlap-add with no weight
    normalisation, exactly like the MATLAB scorer (stoi.m:141-177)."""
    win = np.hanning(N_FRAME + 2)[1:-1]
    hop = N_FRAME // 2
    xf = _frames(x, win, hop)
    yf = _frames(y, win, hop)
    e = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = e > (e.max() - DYN_RANGE)
    xf, yf = xf[keep], yf[keep]
    n_out = (len(xf) - 1) * hop + N_FRAME if len(xf) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(xf)):
        sl = slice(i * hop, i * hop + N_FRAME)
        xs[sl] += xf[i]
        ys[sl] += yf[i]
    return xs, ys


def _band_spectrogram(x: np.ndarray) -> np.ndarray:
    """[NUMBAND, n_frames] third-octave band magnitudes of hann STFT."""
    win = np.hanning(N_FRAME + 2)[1:-1]
    hop = N_FRAME // 2
    fr = _frames(x, win, hop)
    X = np.abs(np.fft.rfft(fr, NFFT, axis=1)) ** 2
    return np.sqrt(_third_octave_matrix() @ X.T)


def _resample(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return x.astype(np.float64)
    g = np.gcd(fs, FS)
    return resample_poly(x.astype(np.float64), FS // g, fs // g)


def stoi(x: np.ndarray, y: np.ndarray, fs: int, extended: bool = False) -> float:
    """Short-time objective intelligibility of degraded y vs clean x in [~0, 1].

    Args:
      x: clean reference waveform.
      y: degraded/processed waveform (same length).
      fs: sampling rate of the inputs.
      extended: compute eSTOI instead.
    """
    n = min(len(x), len(y))
    x = _resample(np.asarray(x[:n], np.float64), fs)
    y = _resample(np.asarray(y[:n], np.float64), fs)
    x, y = _remove_silent_frames(x, y)
    X = _band_spectrogram(x)
    Y = _band_spectrogram(y)
    M = X.shape[1] - N_SEG + 1
    if M <= 0:
        raise ValueError("signal too short for STOI after silence removal")

    if not extended:
        c = 10.0 ** (-BETA / 20.0)
        total = 0.0
        for m in range(M):
            Xs = X[:, m:m + N_SEG]
            Ys = Y[:, m:m + N_SEG]
            alpha = (np.linalg.norm(Xs, axis=1, keepdims=True)
                     / (np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-12))
            Yp = np.minimum(Ys * alpha, Xs * (1.0 + c))
            xn = Xs - Xs.mean(axis=1, keepdims=True)
            yn = Yp - Yp.mean(axis=1, keepdims=True)
            denom = (np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1) + 1e-12)
            total += np.sum((xn * yn).sum(axis=1) / denom)
        return float(total / (NUMBAND * M))

    # eSTOI: per-segment row then column mean/variance normalisation, then
    # average column correlation.
    total = 0.0
    for m in range(M):
        Xs = X[:, m:m + N_SEG]
        Ys = Y[:, m:m + N_SEG]

        def rcnorm(A):
            A = A - A.mean(axis=1, keepdims=True)
            A = A / (np.linalg.norm(A, axis=1, keepdims=True) + 1e-12)
            A = A - A.mean(axis=0, keepdims=True)
            A = A / (np.linalg.norm(A, axis=0, keepdims=True) + 1e-12)
            return A

        total += np.sum(rcnorm(Xs) * rcnorm(Ys)) / N_SEG
    return float(total / M)
