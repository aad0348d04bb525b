"""ASR front-end features: MFCC, (log) mel filterbank energies and
spectral subband centroids (follows deepxi_tpu/dsp/features.py), with
python_speech_features' conventions: preemphasis 0.97, 25 ms / 10 ms frames
with ceil framing and zero padding, HTK mel points, |rfft|^2 / nfft power
spectrum, DCT-II (ortho) cepstra with sinusoidal liftering, c0 optionally
replaced by the log frame energy.

Tensor functions on the caller's device and in its dtype; the filterbank
and DCT matrices are built in numpy (float32, as in the JAX package) and
cast to the signal's dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

TINY = float(np.finfo(np.float32).tiny)


def preemphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """y[0] = x[0]; y[n] = x[n] - coeff x[n-1]."""
    return torch.cat([x[..., :1], x[..., 1:] - coeff * x[..., :-1]], dim=-1)


def framesig(x: torch.Tensor, frame_len: int, frame_step: int) -> torch.Tensor:
    """python_speech_features framing: ceil count, zero pad at the end."""
    n = x.shape[-1]
    T = 1 if n <= frame_len else 1 + math.ceil((n - frame_len) / frame_step)
    pad = (T - 1) * frame_step + frame_len - n
    x = F.pad(x, (0, max(pad, 0)))
    idx = (torch.arange(T, device=x.device)[:, None] * frame_step
           + torch.arange(frame_len, device=x.device)[None, :])
    return x[..., idx]


def powspec(frames: torch.Tensor, nfft: int) -> torch.Tensor:
    """|rfft|^2 / nfft power spectrum."""
    return torch.abs(torch.fft.rfft(frames, n=nfft, dim=-1)) ** 2 / nfft


def hz2mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel2hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def get_filterbanks(nfilt: int, nfft: int, samplerate: int, lowfreq: float = 0.0,
                    highfreq: Optional[float] = None) -> np.ndarray:
    """[nfilt, nfft//2+1] HTK triangular mel bank."""
    highfreq = highfreq or samplerate / 2.0
    melpts = np.linspace(hz2mel(lowfreq), hz2mel(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * mel2hz(melpts) / samplerate).astype(int)
    fb = np.zeros([nfilt, nfft // 2 + 1], np.float32)
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fb


def _bank(like: torch.Tensor, nfilt, nfft, samplerate, lowfreq, highfreq) -> torch.Tensor:
    """The mel bank transposed, [nfft//2+1, nfilt], in `like`'s dtype and device."""
    fb = get_filterbanks(nfilt, nfft, samplerate, lowfreq, highfreq)
    return torch.as_tensor(fb.T.copy(), device=like.device).to(like.dtype)


def _frames(signal, samplerate, winlen, winstep, preemph):
    x = preemphasis(signal, preemph)
    return framesig(x, int(winlen * samplerate), int(winstep * samplerate))


def fbank(signal: torch.Tensor, samplerate: int = 16000, winlen: float = 0.025,
          winstep: float = 0.01, nfilt: int = 26, nfft: int = 512,
          lowfreq: float = 0.0, highfreq: Optional[float] = None,
          preemph: float = 0.97) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mel filterbank energies and frame energies: ([..., T, nfilt], [..., T])."""
    ps = powspec(_frames(signal, samplerate, winlen, winstep, preemph), nfft)
    energy = torch.clamp(ps.sum(dim=-1), min=TINY)
    feat = torch.clamp(ps @ _bank(ps, nfilt, nfft, samplerate, lowfreq, highfreq), min=TINY)
    return feat, energy


def logfbank(signal: torch.Tensor, **kwargs) -> torch.Tensor:
    """Log mel filterbank energies (the fork's `asr_mfcc.base.logfbank`)."""
    feat, _ = fbank(signal, **kwargs)
    return torch.log(feat)


@functools.lru_cache(maxsize=None)
def _dct2_ortho(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] orthonormal DCT-II matrix (scipy dct norm='ortho')."""
    k = np.arange(n_out)[None, :]
    n = np.arange(n_in)[:, None]
    M = 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    M *= np.sqrt(1.0 / (2.0 * n_in))
    M[:, 0] /= np.sqrt(2.0)
    return M.astype(np.float32)


def lifter(cepstra: torch.Tensor, L: int = 22) -> torch.Tensor:
    """Sinusoidal liftering."""
    if L <= 0:
        return cepstra
    n = np.arange(cepstra.shape[-1])
    lift = (1.0 + (L / 2.0) * np.sin(np.pi * n / L)).astype(np.float32)
    return cepstra * torch.as_tensor(lift, device=cepstra.device).to(cepstra.dtype)


def mfcc(signal: torch.Tensor, samplerate: int = 16000, winlen: float = 0.025,
         winstep: float = 0.01, numcep: int = 13, nfilt: int = 26, nfft: int = 512,
         lowfreq: float = 0.0, highfreq: Optional[float] = None, preemph: float = 0.97,
         ceplifter: int = 22, append_energy: bool = True) -> torch.Tensor:
    """[..., T, numcep] mel-frequency cepstral coefficients."""
    feat, energy = fbank(signal, samplerate, winlen, winstep, nfilt, nfft, lowfreq,
                         highfreq, preemph)
    M = torch.as_tensor(_dct2_ortho(nfilt, numcep), device=feat.device).to(feat.dtype)
    cep = lifter(torch.log(feat) @ M, ceplifter)
    if append_energy:
        cep = torch.cat([torch.log(energy)[..., None], cep[..., 1:]], dim=-1)
    return cep


def ssc(signal: torch.Tensor, samplerate: int = 16000, winlen: float = 0.025,
        winstep: float = 0.01, nfilt: int = 26, nfft: int = 512,
        lowfreq: float = 0.0, highfreq: Optional[float] = None,
        preemph: float = 0.97) -> torch.Tensor:
    """Spectral subband centroids."""
    ps = torch.clamp(powspec(_frames(signal, samplerate, winlen, winstep, preemph), nfft),
                     min=1e-30)
    fbT = _bank(ps, nfilt, nfft, samplerate, lowfreq, highfreq)
    # python_speech_features: bin centre frequencies linspace(1, fs/2)
    freqs = torch.as_tensor(np.linspace(1, samplerate / 2, ps.shape[-1], dtype=np.float32),
                            device=ps.device).to(ps.dtype)
    return (ps * freqs) @ fbT / (ps @ fbT)


def delta(feat: torch.Tensor, N: int = 2) -> torch.Tensor:
    """Delta features over the time axis (-2)."""
    denom = 2.0 * sum(i * i for i in range(1, N + 1))
    T = feat.shape[-2]
    padded = torch.cat([feat[..., :1, :].expand(*feat.shape[:-2], N, feat.shape[-1]), feat,
                        feat[..., -1:, :].expand(*feat.shape[:-2], N, feat.shape[-1])],
                       dim=-2)
    out = torch.zeros_like(feat)
    for i in range(1, N + 1):
        out = out + i * (padded[..., N + i:N + i + T, :] - padded[..., N - i:N - i + T, :])
    return out / denom
