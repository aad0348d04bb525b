"""Builds the CUDA sources in `csrc/` with nvcc at first use and binds them
with ctypes (a plain C interface: no PyTorch headers, so a build takes
seconds, not minutes).

Each source `csrc/<name>.cu` becomes `build/lib<name>-<digest>.so`, where the
digest covers the source, the shared headers `csrc/*.cuh` and the flags, so an
edited source never loads a stale library. `build/` is listed in
`.gitignore`. Only sources in the repository are built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def library_path(name: str) -> str:
    """The library's path; its digest covers the source, every shared header
    in `csrc/` and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def log_path(name: str) -> str:
    """nvcc's output for the last build of `name` (ptxas register and
    shared-memory report included)."""
    return os.path.join(BUILD_DIR, f"{name}.log")


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source not built yet, one nvcc each, all started
    together. Returns the seconds each build took (0.0 when up to date);
    raises with nvcc's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    running = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(log_path(name), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        running[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                         log, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, out, t0) in running.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        msgs = "\n".join(f"--- {n} ---\n{open(log_path(n)).read()}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it on first use."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(library_path(name))
    return _LIBS[name]
