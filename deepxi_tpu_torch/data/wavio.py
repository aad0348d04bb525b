"""Wav I/O (follows deepxi_tpu/data/wavio.py): `read_wav` (8-, 16- and
32-bit PCM, downmixed to mono and resampled to ``f_s`` with scipy's
polyphase filter), `save_wav`, `wav_length`.

Each function goes through the native decoder (`deepxi_tpu_torch.native`)
first and takes the stdlib `wave` module path below where it reports
"use the Python path" (another rate, a float or malformed wav, or native
off); that path is the semantic definition, and the two give the same
samples on every format the native decoder takes."""

from __future__ import annotations

import os
import wave
from typing import Tuple

import numpy as np
from scipy.signal import resample_poly

from deepxi_tpu_torch import native


def read_wav(path: str, f_s: int = 16000) -> Tuple[np.ndarray, int]:
    """Read a PCM wav file as int16 mono at ``f_s`` Hz: samples scaled to
    [-1, 1), channels averaged, the rate converted by `resample_poly` when
    it differs, then clipped to [-1, 1 - 2^-15] and scaled by 32768."""
    y = native.read_wav_i16(path, f_s)
    if y is not None:
        return y, f_s
    with wave.open(path, "rb") as w:
        n_ch, sw, rate, n = w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes()
        raw = w.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width {sw} in {path}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    if rate != f_s:
        g = np.gcd(rate, f_s)
        x = resample_poly(x, f_s // g, rate // g).astype(np.float32)
    return (np.clip(x, -1.0, 1.0 - 1.0 / 32768.0) * 32768.0).astype(np.int16), f_s


def save_wav(path: str, wav: np.ndarray, f_s: int) -> None:
    """Write a waveform as 16-bit PCM: float inputs are scaled by 32768 and
    truncated to int16."""
    wav = np.squeeze(np.asarray(wav))
    if wav.dtype in (np.float32, np.float64):
        wav = np.asarray(wav * 32768.0, dtype=np.int16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if native.save_wav_i16(path, wav.astype("<i2"), f_s):
        return
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(f_s)
        w.writeframes(wav.astype("<i2").tobytes())


def wav_length(path: str, f_s: int = 16000) -> int:
    """Sample count of a wav file at ``f_s`` Hz, without reading its samples:
    `read_wav`'s resampled length, ceil(n * f_s / rate)."""
    n_native = native.wav_len(path, f_s)
    if n_native is not None:
        return n_native
    with wave.open(path, "rb") as w:
        n, rate = w.getnframes(), w.getframerate()
    if rate == f_s:
        return n
    g = np.gcd(rate, f_s)
    return int(np.ceil(n * (f_s // g) / (rate // g)))
