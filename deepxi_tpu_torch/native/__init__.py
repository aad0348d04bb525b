"""The native (C++) wav decoder: ctypes bindings and the build at first use
(follows deepxi_tpu/native/__init__.py).

`src/wavio.cc` decodes RIFF PCM wavs straight into preallocated int16 batch
buffers with a GIL-free thread pool. `data/wavio` (`read_wav`, `save_wav`,
`wav_length`) and the training loader (`data/loader.MiniBatchLoader`) go
through it first; the pure-Python path in `data/wavio` stays the semantic
definition, and the two decode the same samples on every format the
native decoder takes. A file it does not take (a rate other than the
target's, which needs the polyphase resampler; a float wav) reports
FALLBACK and goes to the Python decoder; a malformed or unreadable one
reports ERR, and the Python decoder raises on it.

The library is built at first use with the C++ compiler (`$CXX`, default
`g++`) and the JAX package's flags into `build/libdeepxi_native-<digest>.so`,
the digest covering the source, the compiler and the flags, so an edited
source never loads a stale library. `build/` is listed in `.gitignore`.

One difference from the JAX package: a build or load that fails raises
RuntimeError with the compiler's output, where the JAX package quietly takes
the Python path for the rest of the process. ``DEEPXI_TORCH_NO_NATIVE=1`` in
the environment (the counterpart of ``DEEPXI_TPU_NO_NATIVE``) turns the
native decoder off: every entry point then reports "use the Python path".
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "src", "wavio.cc")
BUILD_DIR = os.path.join(_DIR, "build")
# deepxi_tpu/native/Makefile's CXXFLAGS, and a shared library
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

ERR = -1        # unreadable/malformed
FALLBACK = -2   # valid but needs the Python decoder

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> str:
    """The library's path in `BUILD_DIR`, keyed on a digest of the source,
    the compiler and the flags."""
    digest = hashlib.sha256(" ".join((_compiler(),) + CXXFLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libdeepxi_native-{digest.hexdigest()[:12]}.so")


def build() -> float:
    """Compile the library unless it is built; returns the seconds it took
    (0.0 when up to date). Raises RuntimeError with the compiler's output
    when the build fails or the compiler cannot be run."""
    out = library_path()
    if os.path.exists(out):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_compiler(), *CXXFLAGS, "-o", tmp, SRC]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"could not run the C++ compiler for the native wav decoder "
                           f"({' '.join(cmd)}): {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"building the native wav decoder failed ({' '.join(cmd)}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library (built first if need be), or None when
    DEEPXI_TORCH_NO_NATIVE is set."""
    global _lib
    if os.environ.get("DEEPXI_TORCH_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(library_path())
        lib.dxt_read_wav_i16.restype = ctypes.c_long
        lib.dxt_read_wav_i16.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int16), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long)]
        lib.dxt_wav_len.restype = ctypes.c_long
        lib.dxt_wav_len.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.dxt_save_wav_i16.restype = ctypes.c_int
        lib.dxt_save_wav_i16.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16), ctypes.c_long]
        lib.dxt_load_batch.restype = None
        lib.dxt_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_long), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """True unless DEEPXI_TORCH_NO_NATIVE is set (building the library if
    needed; a failed build raises)."""
    return _load() is not None


def read_wav_i16(path: str, f_s: int = 16000,
                 offset: int = 0) -> Optional[np.ndarray]:
    """Decode ``path`` as int16 mono at ``f_s`` natively, or None to signal
    the caller to use the Python decoder (FALLBACK, ERR, or native off)."""
    lib = _load()
    if lib is None:
        return None
    n_total = lib.dxt_wav_len(path.encode(), f_s)
    if n_total < 0:
        return None
    out = np.empty(max(int(n_total) - max(offset, 0), 0), np.int16)
    total = ctypes.c_long(0)
    r = lib.dxt_read_wav_i16(
        path.encode(), f_s, offset,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out.size, ctypes.byref(total))
    if r < 0:
        return None
    return out[: int(r)]


def wav_len(path: str, f_s: int = 16000) -> Optional[int]:
    """Sample count at the target rate, or None when native is off or the
    file is malformed (the caller takes the Python path)."""
    lib = _load()
    if lib is None:
        return None
    n = lib.dxt_wav_len(path.encode(), f_s)
    return None if n < 0 else int(n)


def save_wav_i16(path: str, wav: np.ndarray, f_s: int) -> bool:
    """Write mono 16-bit PCM natively; False -> the caller takes the Python
    path."""
    lib = _load()
    if lib is None:
        return False
    wav = np.ascontiguousarray(wav, np.int16)
    ok = lib.dxt_save_wav_i16(
        path.encode(), f_s,
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), wav.size)
    return ok == 0


def load_batch(paths: Sequence[str], L: int, f_s: int = 16000,
               offsets: Optional[Sequence[int]] = None,
               out: Optional[np.ndarray] = None, n_threads: int = 0,
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Thread-pooled decode of ``paths`` into a zero-padded int16 [B, L]
    buffer, starting each file at ``offsets[i]`` samples.

    Returns (out, lens, status) where status[i] is 0 (ok), ERR, or FALLBACK
    (row zeroed; the caller decodes that file in Python). None when native
    is off.
    """
    lib = _load()
    if lib is None:
        return None
    B = len(paths)
    if out is None:
        out = np.empty((B, L), np.int16)  # the native layer fills every row
    if out.shape != (B, L) or out.dtype != np.int16 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous int16 [{B}, {L}] array, not "
                         f"{out.dtype} {out.shape}")
    lens = np.zeros(B, np.int32)
    status = np.zeros(B, np.int32)
    c_paths = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    offs = np.asarray(offsets if offsets is not None else np.zeros(B), np.int64)
    lib.dxt_load_batch(
        c_paths, B, f_s,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), L,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    return out, lens, status
