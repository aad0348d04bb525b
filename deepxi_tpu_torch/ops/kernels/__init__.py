"""Spectral products and hand-written CUDA kernels
(follows deepxi_tpu/ops/kernels/).

The inference kernels that an exported program can reach are registered as
`torch.library` ops in one namespace, `deepxi::` (`kernel_op`): the CUDA
implementation launches the hand-written kernel, the CPU one is the plain
version, and a fake one gives only the output's shape and dtype, so
`torch.export` traces through them and CUDA graph capture records their
launches. Each public wrapper calls its op, so eager calls, capture and an
exported program take one path. A program exported with these ops loads only
in a process that has registered them: `load_ops()` does that.
"""

import torch

OP_NAMESPACE = "deepxi"
# The modules that register `deepxi::` ops, as `load_ops` imports them.
OP_MODULES = ("tcn_fused", "mha_block_fused", "mha_fused", "mha_flash_stream",
              "mha_cache", "lstm")


def kernel_op(name: str, cuda_fn, cpu_fn, fake=None):
    """Register `deepxi::<name>` with `cuda_fn` (whose annotations give the
    schema) for CUDA tensors and `cpu_fn` for CPU tensors; returns the op,
    called as a function. The fake implementation gives only the output's
    shape and dtype: `fake(*args)`, by default an empty tensor like the first
    input."""
    op = torch.library.custom_op(f"{OP_NAMESPACE}::{name}", cuda_fn, mutates_args=(),
                                 device_types="cuda")
    op.register_kernel("cpu")(cpu_fn)
    op.register_fake(fake or (lambda x, *args: torch.empty_like(x)))
    return op


def load_ops() -> None:
    """Register every `deepxi::` op in this process (importing the modules
    that define them)."""
    import importlib
    for name in OP_MODULES:
        importlib.import_module(f"{__name__}.{name}")


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records through an op on these tensors: training
    takes the autograd routes, inference and export the ops."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_autograd(tensors, what: str, alternative: str = "") -> None:
    """Raise when autograd would record through an inference kernel (as
    `pallas_call`, it has no backward); `alternative` names a route that
    has one."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{what} has no backward (as the Pallas kernel it replaces); run it "
            "under torch.no_grad()" + (f", or train through {alternative}"
                                       if alternative else ""))


def launch_context(device):
    """What a ctypes launch on `device` runs under: `device` made current,
    or nothing when it already is, which spares the host the switch and
    its undo on every launch."""
    import contextlib

    if torch._C._cuda_getDevice() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device) -> int:
    """`device`'s current stream as the integer a ctypes launch takes, read
    without building a `torch.cuda.Stream` object."""
    return torch._C._cuda_getCurrentRawStream(device.index)
