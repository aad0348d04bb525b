"""Seeded speech-like signals, noise and mixtures, made in bulk on the
device from `--seed`.

The benchmark's audio follows the source-filter model of the repository's
corpus generator (`tools/synth_corpus.py`: a glottal source with drifting
pitch and jitter, gliding formant tracks through random vowel targets,
fricative noise segments, pauses, lip radiation, a syllabic envelope), but
shapes the source in the short-time spectrum, all rows at once, instead of
running time-varying resonators sample block by sample block on the host:
that generator takes ~3.5 s a 10 s utterance on one core, and a cell needs
hundreds of utterances in every run's set-up. Noise is white, pink, brown
or mains hum, as there.

Every draw comes from one `torch.Generator` on the signals' device and one
numpy `Generator` (segment plans), both seeded from the run's seed, so the
same seed gives the same signals on the same kind of device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FS = 16000
# (F1, F2, F3) Hz of common vowels, as in tools/synth_corpus.py
VOWELS = ((730, 1090, 2440), (270, 2290, 3010), (300, 870, 2240),
          (530, 1840, 2480), (640, 1190, 2390), (490, 1350, 1690),
          (390, 1990, 2550), (570, 840, 2410))
NOISE_KINDS = ("white", "pink", "brown", "hum")
_NFFT, _HOP = 512, 128


class Draws:
    """The run's random streams: `gen` on `device` for bulk draws, `rng`
    (numpy) for the small host-side plans. Seeds of any size are taken."""

    def __init__(self, seed: int, device, stream: int = 0):
        self.device = torch.device(device)
        self.rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, stream])
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(self.rng.integers(0, 2 ** 62)))

    def uniform(self, lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=self.gen, device=self.device)

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device)


def _segment_plan(rng: np.random.Generator, n_frames: int) -> np.ndarray:
    """[n_frames] segment kinds a spectral frame: 0 pause, 1 fricative,
    2 voiced; segments of 80-300 ms, pauses 18%, fricatives 22% of the
    rest, as tools/synth_corpus.py draws them."""
    kinds = np.empty(n_frames, np.int64)
    pos = 0
    while pos < n_frames:
        end = min(pos + int(rng.uniform(0.08, 0.3) * FS / _HOP), n_frames)
        kinds[pos:end] = 0 if rng.random() < 0.18 else 1 if rng.random() < 0.22 else 2
        pos = max(end, pos + 1)
    return kinds


def speech(draws: Draws, lengths, n: int, rows_a_call: int = 32) -> torch.Tensor:
    """int16 [len(lengths), n] utterances, row i of `lengths[i]` samples
    (zero after it), made `rows_a_call` rows at a time."""
    out = torch.zeros(len(lengths), n, dtype=torch.int16, device=draws.device)
    for r0 in range(0, len(lengths), rows_a_call):
        rows = list(lengths[r0:r0 + rows_a_call])
        out[r0:r0 + len(rows)] = _speech_rows(draws, rows, n)
    return out


def _speech_rows(draws: Draws, lengths, n: int) -> torch.Tensor:
    B, dev = len(lengths), draws.device
    t = torch.arange(n, device=dev, dtype=torch.float32) / FS
    pitch = draws.uniform(85.0, 230.0, (B, 1))
    rate = draws.uniform(0.3, 1.2, (B, 1))
    drift = torch.cumsum(draws.normal((B, n)), 1) * (0.05 / math.sqrt(n))
    f0 = pitch * (1.0 + 0.12 * torch.sin(2 * math.pi * rate * t) + drift)
    jitter = draws.normal((B, n // 160 + 1)).repeat_interleave(160, 1)[:, :n]
    f0 = f0 * (1.0 + 0.012 * jitter)
    cycles = torch.cumsum(f0.double() / FS, 1)
    source = (2.0 * torch.frac(cycles) - 1.0).float()   # a sawtooth: 1/k harmonics
    source = source + 0.1 * draws.normal((B, n))           # aspiration

    window = torch.hann_window(_NFFT, device=dev)
    spec = torch.stft(source, _NFFT, _HOP, window=window, return_complex=True)
    n_bins, n_frames = spec.shape[1], spec.shape[2]
    f = torch.linspace(0.0, FS / 2, n_bins, device=dev)[None, :, None]

    # formant tracks: linear glides through a random vowel every 0.12 s
    n_tg = max(int(n / FS / 0.12) + 2, 2)
    table = torch.tensor(VOWELS, dtype=torch.float32, device=dev)
    targets = table[torch.as_tensor(draws.rng.integers(0, len(VOWELS), (B, n_tg)),
                                    device=dev)]                       # [B, n_tg, 3]
    pos = torch.linspace(0.0, n_tg - 1.0, n_frames, device=dev)
    lo = pos.floor().long().clamp(max=n_tg - 2)
    w = (pos - lo)[None, :, None]
    tracks = targets[:, lo] * (1 - w) + targets[:, lo + 1] * w          # [B, F, 3]
    bws = torch.stack([draws.uniform(110.0, 200.0, (B,)), draws.uniform(140.0, 260.0, (B,)),
                       draws.uniform(180.0, 320.0, (B,))], 1)          # [B, 3]
    env = torch.zeros(B, n_bins, n_frames, device=dev)
    for i, gain in enumerate((1.0, 0.6, 0.35)):
        fc = tracks[:, None, :, i]
        env = env + gain / torch.sqrt(1.0 + ((f - fc) / (0.5 * bws[:, i, None, None])) ** 2)
    for fc, bw in ((3400.0, 350.0), (4500.0, 500.0)):                  # fixed F4, F5
        env = env + 0.25 / torch.sqrt(1.0 + ((f - fc) / (0.5 * bw)) ** 2)

    kinds = torch.as_tensor(np.stack([_segment_plan(draws.rng, n_frames) for _ in range(B)]),
                            device=dev)[:, None, :]
    hiss = torch.complex(draws.normal((B, n_bins, n_frames)),
                         draws.normal((B, n_bins, n_frames)))
    fric = hiss * (0.05 + f / (FS / 2)) * 0.02 * spec.abs().mean((1, 2), keepdim=True)
    shaped = torch.where(kinds == 2, spec * env, torch.where(kinds == 1, fric, spec * 1e-3))
    x = torch.istft(shaped, _NFFT, _HOP, window=window, length=n)
    x = torch.diff(x, dim=1, prepend=x[:, :1])                          # lip radiation
    syll = 0.55 + 0.45 * torch.sin(2 * math.pi * draws.uniform(2.5, 4.5, (B, 1)) * t
                                   + draws.uniform(0.0, 2 * math.pi, (B, 1)))
    x = x * syll
    valid = torch.arange(n, device=dev)[None, :] < torch.as_tensor(lengths, device=dev)[:, None]
    x = x * valid
    peak = x.abs().amax(1, keepdim=True).clamp(min=1e-9)
    level = draws.uniform(0.25, 0.45, (B, 1)) * 32767.0
    return torch.round(x / peak * level).to(torch.int16)


def noise(draws: Draws, kinds, n: int) -> torch.Tensor:
    """int16 [len(kinds), n] noise recordings, each of a kind in
    NOISE_KINDS, peak-normalised to 0.35 of full scale as
    tools/synth_corpus.py's."""
    rows = []
    t = torch.arange(n, device=draws.device, dtype=torch.float32) / FS
    for kind in kinds:
        z = draws.normal((n,))
        if kind == "white":
            x = z
        elif kind == "pink":
            f = torch.fft.rfftfreq(n, 1.0 / FS, device=draws.device).clamp(min=1.0)
            x = torch.fft.irfft(torch.fft.rfft(z) / torch.sqrt(f), n)
        elif kind == "brown":
            x = torch.cumsum(z.double(), 0)
            x = (x - torch.linspace(float(x[0]), float(x[-1]), n, dtype=torch.float64,
                                    device=draws.device)).float()
        elif kind == "hum":
            phases = draws.uniform(0.0, 6.0, (5,))
            x = sum(torch.sin(2 * math.pi * 50 * k * t + phases[k - 1]) / k
                    for k in range(1, 6)) + 0.2 * z
        else:
            raise ValueError(f"unknown noise kind {kind!r}")
        rows.append(torch.round(x / x.abs().max().clamp(min=1e-9) * 0.35 * 32767.0))
    return torch.stack(rows).to(torch.int16)


def mixture(s: torch.Tensor, d: torch.Tensor, snr_db: torch.Tensor) -> torch.Tensor:
    """int16 s + alpha d, alpha setting each row's SNR to `snr_db` (powers
    over the whole row), rounded and clipped to int16."""
    s, d = s.float(), d.float()
    p_s = s.square().mean(1, keepdim=True)
    p_d = d.square().mean(1, keepdim=True).clamp(min=1e-12)
    alpha = torch.sqrt(p_s / (p_d * 10.0 ** (snr_db.float()[:, None] / 10.0)))
    return torch.round(s + alpha * d).clamp(-32768, 32767).to(torch.int16)
