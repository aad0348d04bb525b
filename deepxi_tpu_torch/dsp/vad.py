"""Voice activity detection and speech segmenting (follows
deepxi_tpu/dsp/vad.py): an adaptive-threshold energy VAD with the P.862
hangover/join smoothing (MINSPEECHLGTH=4, JOINSPEECHLGTH=50 frames). The
frame energies are a tensor function on the caller's device; the
decisions, as in the JAX package, are numpy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def frame_energies(wav: torch.Tensor, fs: int, frame_ms: float = 10.0) -> torch.Tensor:
    """[..., T] mean-square energy of non-overlapping frames (float32)."""
    n = int(fs * frame_ms / 1000.0)
    T = wav.shape[-1] // n
    fr = wav[..., :T * n].reshape(wav.shape[:-1] + (T, n)).to(torch.float32)
    return torch.mean(torch.square(fr), dim=-1)


def energy_vad(wav, fs: int, frame_ms: float = 10.0, margin_db: float = 12.0,
               floor_quantile: float = 0.1) -> np.ndarray:
    """Adaptive energy VAD: a frame is speech if its energy exceeds the noise
    floor (a low quantile of the frame energies) by `margin_db`, shrunk to
    half the signal's floor-to-90th-percentile range (at least 3 dB) when
    that range is small. `wav`: a tensor or an array. Returns a [T] bool
    array at `frame_ms` resolution."""
    e = frame_energies(torch.as_tensor(np.asarray(wav) if not torch.is_tensor(wav) else wav),
                       fs, frame_ms).cpu().numpy()
    e = np.maximum(e, 1e-12)
    floor = np.quantile(e, floor_quantile)
    e_db = 10.0 * np.log10(e / max(floor, 1e-12))
    dyn = np.quantile(e_db, 0.9)
    margin = float(np.clip(0.5 * dyn, 3.0, margin_db))
    return e_db > margin


def _runs(v: np.ndarray, value: bool) -> List[Tuple[int, int]]:
    """(start, end) of each run of `value` in v."""
    out, t, T = [], 0, len(v)
    while t < T:
        if v[t] == value:
            t0 = t
            while t < T and v[t] == value:
                t += 1
            out.append((t0, t))
        else:
            t += 1
    return out


def smooth_vad(vad: np.ndarray, min_speech: int = 4, join: int = 50) -> np.ndarray:
    """Bridge gaps shorter than `join` frames, then drop speech runs
    shorter than `min_speech` frames."""
    v = np.asarray(vad).astype(bool).copy()
    for t0, t in _runs(v, False):
        if t0 > 0 and t < len(v) and (t - t0) < join:
            v[t0:t] = True
    for t0, t in _runs(v, True):
        if (t - t0) < min_speech:
            v[t0:t] = False
    return v


def speech_segments(wav, fs: int, frame_ms: float = 10.0,
                    **kwargs) -> List[Tuple[int, int]]:
    """Speech (start, end) sample ranges."""
    v = smooth_vad(energy_vad(wav, fs, frame_ms, **kwargs))
    n = int(fs * frame_ms / 1000.0)
    return [(t0 * n, t * n) for t0, t in _runs(v, True)]
