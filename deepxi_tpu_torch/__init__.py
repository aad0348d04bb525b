"""Deep Xi in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The layout mirrors `deepxi_tpu/`: each module names the module it follows.
The package imports nothing of `deepxi_tpu` and no JAX; it keeps its own copy
of what it needs.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
With no card and no explicit CPU request they raise instead of carrying on
quietly on the CPU.
"""

from __future__ import annotations

import torch

# The plain path is the f32 reference for the kernels: keep float32 products
# and convolutions out of TF32 (cuDNN defaults convolutions to TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The CPU path's elementwise functions that ATen hands to MKL's VML (sqrt,
# exp, log, tanh, erfinv, ...), run once here on this thread. MKL sets VML
# up lazily at its first call; where that first call comes from several
# OpenMP threads at once, as a large tensor's first `torch.sqrt` in a fresh
# process does, one thread now and then computes its whole chunk at VML's
# lower accuracy (one utterance of a served batch off by up to ~1e-4 of its
# scale; tests/test_torch_serving.py shows it). A call on one thread first
# leaves the parallel ones exact.
_VML_FUNCTIONS = (torch.acos, torch.asin, torch.atan, torch.cos, torch.erf, torch.erfc,
                  torch.erfinv, torch.exp, torch.log, torch.log10, torch.log2, torch.sin,
                  torch.sqrt, torch.tan, torch.tanh, torch.trunc)
for _dtype in (torch.float32, torch.float64):
    for _fn in _VML_FUNCTIONS:
        _fn(torch.full((8,), 0.5, dtype=_dtype))
del _dtype, _fn


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises when CUDA is wanted and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
