"""Offline enhancement, int16 waveforms to enhanced float waveforms, and
the a priori SNR estimate alone (follows deepxi_tpu/enhance.py; the MagXi
family, the port's only input/target family):

    normalise -> frame -> windowed real DFT (matmul) -> |X| -> network
    -> inverse xi map -> gain -> gain * [re || im] -> inverse DFT (matmul,
    COLA window folded in) -> overlap-add

No complex dtypes and no phase: a real gain times [re || im] equals the
polar resynthesis of the gained magnitude with the noisy phase. The
estimator stops at the inverse xi map and takes |X| from the fused
`stft_mag_fused` kernel. The gain synthesiser, the per-utterance route of
`DeepXiTorch.infer` (out_types `y` with ``fast=False`` and `d_hat`), takes
the gain product and the inverse DFT from the fused `enhance_frames_fused`
kernel.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import functional_call

from deepxi_tpu_torch import resolve_device
from deepxi_tpu_torch.ops.gains import gfunc
from deepxi_tpu_torch.ops.kernels.spectral import (apply_gain_reim,
                                                   enhance_frames_fused,
                                                   stft_mag_fused, stft_reim,
                                                   synthesis_from_reim)
from deepxi_tpu_torch.sig.mix import normalise
from deepxi_tpu_torch.sig.stft import hop_rows, overlap_and_add


def make_enhancer(inp_tgt, network: torch.nn.Module, gtype: str = "mmse-lsa",
                  apply_fn: Optional[Callable] = None,
                  device=None) -> Callable:
    """Build `enhance(params, x_int16[B, L]) -> y[B, (T+1)*N_s]` for a
    `MagXi` `inp_tgt` on `device` (the card unless ``device="cpu"``).
    `params` is the network's state dict; `apply_fn(params, mag)` replaces
    the network's own forward, e.g. `tcn_fused.resnetv2_apply_fused`."""
    dev = resolve_device(device)
    N_d, N_s, K = inp_tgt.N_d, inp_tgt.N_s, inp_tgt.K
    nb = K // 2 + 1
    net_apply = apply_fn or (lambda p, m: functional_call(network, p, (m,)))

    @torch.no_grad()
    def enhance(params, x_int16) -> torch.Tensor:
        x = normalise(torch.as_tensor(x_int16, device=dev))
        Y = stft_reim(x, N_d, N_s, K)
        re, im = Y[..., :nb], Y[..., nb:]
        tgt_hat = net_apply(params, torch.sqrt(re * re + im * im))
        xi_hat = inp_tgt.xi_hat(tgt_hat)
        G = gfunc(xi_hat, xi_hat + 1.0, gtype)
        return synthesis_from_reim(apply_gain_reim(Y, G, K), N_d, N_s, K)

    return enhance


def make_xi_estimator(inp_tgt, network: torch.nn.Module,
                      apply_fn: Optional[Callable] = None,
                      device=None) -> Callable:
    """Build `estimate(params, x_int16[B, L], with_mag=False) ->
    xi_hat[B, T, K/2+1]` (and |X| with `with_mag`) for the xi_hat, gamma_hat,
    deepmmse and mask outputs, on `device` (the card unless
    ``device="cpu"``): |X| from the hop rows through `stft_mag_fused`, then
    the network (`apply_fn(params, mag)` in place of its own forward, as in
    `make_enhancer`) and the inverse xi map."""
    dev = resolve_device(device)
    N_d, N_s, K = inp_tgt.N_d, inp_tgt.N_s, inp_tgt.K
    net_apply = apply_fn or (lambda p, m: functional_call(network, p, (m,)))

    @torch.no_grad()
    def estimate(params, x_int16, with_mag: bool = False):
        """xi_hat, or (xi_hat, |X|) with `with_mag`."""
        x = normalise(torch.as_tensor(x_int16, device=dev))
        mag = stft_mag_fused(hop_rows(x, N_s), N_d, K)
        xi_hat = inp_tgt.xi_hat(net_apply(params, mag))
        return (xi_hat, mag) if with_mag else xi_hat

    return estimate


def noise_gain(xi_hat: torch.Tensor) -> torch.Tensor:
    """sqrt(max(G, 0)) of the DeepMMSE noise-periodogram gain G at
    (xi_hat, xi_hat + 1): times the noisy spectrum X it is the noise estimate
    sqrt(|X|^2 G) with the noisy phase (0 where |X| = 0)."""
    return torch.sqrt(torch.clamp(gfunc(xi_hat, xi_hat + 1.0, "deepmmse"), min=0.0))


def make_gain_synthesiser(inp_tgt, network: torch.nn.Module,
                          gain: Callable[[torch.Tensor], torch.Tensor],
                          apply_fn: Optional[Callable] = None,
                          device=None) -> Callable:
    """Build `synthesise(params, x_int16[B, L], n_frames=None) ->
    y[B, (n + 1) * N_s]` on `device` (the card unless ``device="cpu"``):
    [re || im] of the windowed DFT, |X|, the network (`apply_fn(params,
    mag)` in place of its own forward, as in `make_enhancer`), the inverse
    xi map, the real gain `gain(xi_hat)` (e.g. `noise_gain`), then the gain
    product and the inverse DFT in one `enhance_frames_fused` launch and the
    overlap-add. The frames past `n_frames` (default: all T) are cut before
    the synthesis."""
    dev = resolve_device(device)
    N_d, N_s, K = inp_tgt.N_d, inp_tgt.N_s, inp_tgt.K
    nb = K // 2 + 1
    net_apply = apply_fn or (lambda p, m: functional_call(network, p, (m,)))

    @torch.no_grad()
    def synthesise(params, x_int16, n_frames: Optional[int] = None) -> torch.Tensor:
        x = normalise(torch.as_tensor(x_int16, device=dev))
        Y = stft_reim(x, N_d, N_s, K)
        re, im = Y[..., :nb], Y[..., nb:]
        G = gain(inp_tgt.xi_hat(net_apply(params, torch.sqrt(re * re + im * im))))
        n = Y.shape[1] if n_frames is None else n_frames
        frames = enhance_frames_fused(Y[:, :n].contiguous(), G[:, :n].contiguous(),
                                      N_d, N_s, K)
        return overlap_and_add(frames, N_s)

    return synthesise
