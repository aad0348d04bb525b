"""Spectral products and hand-written CUDA kernels
(follows deepxi_tpu/ops/kernels/)."""


def refuse_autograd(tensors, what: str, alternative: str = "") -> None:
    """Raise when autograd would record through an inference kernel (as
    `pallas_call`, it has no backward); `alternative` names a route that
    has one."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward (as the Pallas kernel it replaces); run it "
            "under torch.no_grad()" + (f", or train through {alternative}"
                                       if alternative else ""))


def launch_context(device):
    """What a ctypes launch on `device` runs under: `device` made current,
    or nothing when it already is, which spares the host the switch and
    its undo on every launch."""
    import contextlib

    import torch
    if torch._C._cuda_getDevice() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device) -> int:
    """`device`'s current stream as the integer a ctypes launch takes, read
    without building a `torch.cuda.Stream` object."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)
