"""Wav I/O on the stdlib `wave` module (follows deepxi_tpu/data/wavio.py,
without its native decoder and its resampling): `read_wav`, `save_wav`,
`wav_length`."""

from __future__ import annotations

import os
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str, f_s: int = 16000) -> Tuple[np.ndarray, int]:
    """Read a 16-bit PCM mono wav file at ``f_s`` Hz as int16. Other sample
    widths, channel counts and rates raise (no resampling yet)."""
    with wave.open(path, "rb") as w:
        n_ch, sw, rate = w.getnchannels(), w.getsampwidth(), w.getframerate()
        raw = w.readframes(w.getnframes())
    if (n_ch, sw, rate) != (1, 2, f_s):
        raise ValueError(f"{path}: {n_ch} channel(s), {8 * sw}-bit, {rate} Hz; "
                         f"read_wav takes mono 16-bit at {f_s} Hz")
    return np.frombuffer(raw, dtype="<i2").astype(np.int16), f_s


def save_wav(path: str, wav: np.ndarray, f_s: int) -> None:
    """Write a waveform as 16-bit PCM: float inputs are scaled by 32768 and
    truncated to int16."""
    wav = np.squeeze(np.asarray(wav))
    if wav.dtype in (np.float32, np.float64):
        wav = np.asarray(wav * 32768.0, dtype=np.int16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(f_s)
        w.writeframes(wav.astype("<i2").tobytes())


def wav_length(path: str, f_s: int = 16000) -> int:
    """Sample count of a wav file without reading its samples. Rates other
    than ``f_s`` raise, as in `read_wav`."""
    with wave.open(path, "rb") as w:
        n, rate = w.getnframes(), w.getframerate()
    if rate != f_s:
        raise ValueError(f"{path}: {rate} Hz; wav_length takes {f_s} Hz")
    return n
