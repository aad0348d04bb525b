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
