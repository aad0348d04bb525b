"""Builds the CUDA sources in `csrc/` with nvcc at first use and binds them
with ctypes (a plain C interface: no PyTorch headers, so a build takes
seconds, not minutes).

A build is a source name and, for the kernels whose widths are compile-time
constants, the widths as preprocessor defines: `("tcn_fused", {"TCN_C": 32,
"TCN_DF": 16, "TCN_KS": 3})`. Each becomes `build/lib<name>[-<widths>]-
<digest>.so`, where the digest covers the source, the shared headers
`csrc/*.cuh`, the defines and the flags, so an edited source never loads a
stale library and every set of widths has its own. `build/` is listed in
`.gitignore`. Only sources in the repository are built.

`load` hands back the library with every entry point of `ENTRY_POINTS`
typed for ctypes, and `check` raises on a launch's return code with the
text of `deepxi_error_string`, which every library exports
(`csrc/deepxi_error.cuh`): binding a kernel is one entry in the table.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Mapping, Optional, Tuple, Union

from deepxi_tpu_torch.utils.profiling import annotate

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

Spec = Union[str, Tuple[str, Mapping[str, int]]]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP = ctypes.POINTER(_I)

# What each csrc/<name>.cu exports, as (restype, argtypes): the C signatures
# in ctypes' words. An entry point that a build leaves out (masked_lstm_phases
# outside LSTM_PHASES builds) stays untyped there.
ENTRY_POINTS: Dict[str, Dict[str, Tuple[type, List[type]]]] = {
    "lstm": {
        "masked_lstm_grid": (_I, [_I] * 4 + [_IP] * 2),
        "masked_lstm_forward": (_I, [_P] * 6 + [_I] * 7 + [_P, _IP]),
        "masked_lstm_backward_scratch": (_LL, [_I] * 5),
        "masked_lstm_backward": (_I, [_P] * 7 + [_I] * 7 + [_P]),
        "masked_lstm_phases": (_I, [_P]),
        "masked_lstm_plan": (_I, [_I] * 6 + [_IP] * 3 + [ctypes.POINTER(_LL)]),
    },
    "lstm_input_proj": {
        "lstm_input_proj_split": (_I, [_P] * 5 + [_I] * 2 + [_P]),
        "lstm_input_proj_forward": (_I, [_P] * 4 + [_I] * 4 + [_P]),
        "lstm_input_proj_f64": (_I, [_P] * 7 + [_I] * 4 + [_P]),
    },
    "mha_attention": {
        "mha_attention_forward": (_I, [_P] * 5 + [_I] * 6 + [_P]),
    },
    "mha_block_fused": {
        "mha_block_grid": (_I, [_I, _I, _IP]),
        "mha_block_forward": (_I, [_P] * 19 + [_I] * 3 + [ctypes.c_float, _P]),
    },
    "mha_cache": {
        "mha_cache_forward": (_I, [_P] * 7 + [_I] * 4 + [_P]),
    },
    "spectral": {
        "stft_mag_forward": (_I, [_P] * 4 + [_I] * 5 + [_P]),
        "enhance_frames_forward": (_I, [_P] * 5 + [_I] * 4 + [_P]),
    },
    "tcn_fused": {
        "tcn_max_window_rows": (_I, [_I]),
        "tcn_block_floats": (_I, []),
        "tcn_block_forward": (_I, [_P] * 3 + [_I] * 4 + [_P]),
        "tcn_block_forward_pack2": (_I, [_P] * 3 + [_I] * 5 + [_P]),
        "tcn_group_forward": (_I, [_P] * 3 + [_IP] + [_I] * 5 + [_P]),
    },
    "tcn_fused_train": {
        "tcn_train_block_floats": (_I, []),
        "tcn_train_block_t_floats": (_I, []),
        "tcn_train_wgrad_tiles": (_I, []),
        "tcn_train_max_window_rows": (_I, [_I]),
        "tcn_group_backward": (_I, [ctypes.POINTER(_P)] + [_P] * 5 + [_IP] + [_I] * 5
                               + [_P] * 10 + [_IP]),
    },
}
# every library's decoder of its return codes (csrc/deepxi_error.cuh)
_DECODER = {"deepxi_error_string": (ctypes.c_char_p, [_I])}

# the typed libraries, by `load`'s arguments
_LIBS: Dict[Union[str, tuple], ctypes.CDLL] = {}


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


def _split(spec: Spec) -> Tuple[str, Tuple[Tuple[str, int], ...]]:
    if isinstance(spec, str):
        return spec, ()
    name, defines = spec
    return name, tuple(sorted((k, int(v)) for k, v in defines.items()))


def tag(spec: Spec) -> str:
    """The build's name: the source, then its defines, e.g.
    `tcn_fused-TCN_C32-TCN_DF16-TCN_KS3`."""
    name, defines = _split(spec)
    return "".join([name, *(f"-{k}{v}" for k, v in defines)])


def _flags(spec: Spec) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{k}={v}" for k, v in _split(spec)[1])


def library_path(spec: Spec) -> str:
    """The library's path; its digest covers the source, every shared header
    in `csrc/`, the defines and the flags."""
    name = _split(spec)[0]
    digest = hashlib.sha256(" ".join(_flags(spec)).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{tag(spec)}-{digest.hexdigest()[:12]}.so")


def log_path(spec: Spec) -> str:
    """nvcc's output for the last build of `spec` (ptxas register and
    shared-memory report included)."""
    return os.path.join(BUILD_DIR, f"{tag(spec)}.log")


def build(specs: Iterable[Spec]) -> Dict[str, float]:
    """Compile every build not made yet, one nvcc each, all started
    together. Returns the seconds each took by `tag` (0.0 when up to date);
    raises with nvcc's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    specs = list(specs)
    running = {}
    for spec in specs:
        out = library_path(spec)
        if os.path.exists(out) or tag(spec) in running:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(log_path(spec), "w")
        src = os.path.join(CSRC_DIR, _split(spec)[0] + ".cu")
        cmd = [nvcc, *_flags(spec), "-o", tmp, src]
        running[tag(spec)] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                              log, tmp, out, time.perf_counter())
    seconds = {tag(spec): 0.0 for spec in specs}
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
        msgs = "\n".join(f"--- {n} ---\n{open(os.path.join(BUILD_DIR, n + '.log')).read()}"
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return seconds


def load(name: str, defines: Optional[Mapping[str, int]] = None) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu` with `defines`, building it on
    first use, every entry point it has typed. A hit is one lookup."""
    key = (name, *defines.items()) if defines else name
    lib = _LIBS.get(key)
    if lib is None:
        spec: Spec = (name, defines) if defines else name
        with annotate("deepxi.kernels.build"):
            build([spec])
            lib = ctypes.CDLL(library_path(spec))
        for fn_name, (restype, argtypes) in {**_DECODER, **ENTRY_POINTS[name]}.items():
            fn = getattr(lib, fn_name, None)
            if fn is not None:
                fn.restype, fn.argtypes = restype, argtypes
        _LIBS[key] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise RuntimeError unless `rc`, what an entry point of `lib` returned,
    is 0: naming `what`, the code and its text."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: error {rc} "
                           f"({lib.deepxi_error_string(rc).decode()})")
