"""Offline enhancement, int16 waveforms to enhanced float waveforms, and
the network's estimate alone (follows deepxi_tpu/enhance.py), for the
families whose synthesis is a real gain on the noisy spectrum (MagXi,
MagXiGamma, MagGain, MagSMM) or a new magnitude with the noisy phase
(MagMag):

    normalise -> frame -> windowed real DFT (matmul) -> |X| -> network
    -> the family's gain -> gain * [re || im] -> inverse DFT (matmul,
    COLA window folded in) -> overlap-add

No complex dtypes and no phase: a real gain times [re || im] equals the
polar resynthesis of the gained magnitude with the noisy phase. The
estimator stops at the network output and, for the families that read
|X|, takes |X| from the fused `stft_mag_fused` kernel. The gain
synthesiser, the per-utterance route of `DeepXiTorch.infer` (out_types `y`
with ``fast=False`` and `d_hat`), takes the gain product and the inverse
DFT from the fused `enhance_frames_fused` kernel. Both spectral kernels
read the hop-row layout of N_d = 2 N_s (`spectral.kernel_takes`); at any
other framing the estimator and the synthesiser take the matrix products,
a route chosen from the framing when they are made (``kernels=False``
takes the products at every framing: the plain route the kernels are held
to).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import functional_call

from deepxi_tpu_torch import resolve_device
from deepxi_tpu_torch.ops.gains import gfunc
from deepxi_tpu_torch.ops.kernels.spectral import (enhance_frames_fused,
                                                   gained_frames, kernel_takes,
                                                   stft_mag, stft_mag_fused,
                                                   stft_reim, synthesis_from_reim)
from deepxi_tpu_torch.sig.mix import normalise
from deepxi_tpu_torch.sig.stft import hop_rows, overlap_and_add
from deepxi_tpu_torch.utils.profiling import annotate


def make_enhancer(inp_tgt, network: torch.nn.Module, gtype: str = "mmse-lsa",
                  apply_fn: Optional[Callable] = None,
                  device=None) -> Callable:
    """Build `enhance(params, x_int16[B, L]) -> y[B, (T-1)*N_s + N_d]` for a
    gain-form family `inp_tgt` (MagXi, MagXiGamma, MagGain, MagSMM, MagMag)
    on `device` (the card unless ``device="cpu"``). `params` is the
    network's state dict; `apply_fn(params, mag)` replaces the network's own
    forward, e.g. `tcn_fused.resnetv2_apply_fused`. MagPhaXiPha, STDCTXiCD
    and MagGamma raise: they synthesise through `inp_tgt.enhanced_speech`."""
    if not inp_tgt.gain_form:
        raise ValueError(f"{type(inp_tgt).__name__} has no gain-form synthesis; use "
                         "inp_tgt.enhanced_speech")
    dev = resolve_device(device)
    N_d, N_s, K = inp_tgt.N_d, inp_tgt.N_s, inp_tgt.K
    nb = K // 2 + 1
    net_apply = apply_fn or (lambda p, m: functional_call(network, p, (m,)))

    @torch.no_grad()
    def enhance(params, x_int16) -> torch.Tensor:
        with annotate("deepxi.enhance"):
            with annotate("deepxi.enhance.input"):
                x = normalise(torch.as_tensor(x_int16, device=dev))
            Y = stft_reim(x, N_d, N_s, K)
            re, im = Y[..., :nb], Y[..., nb:]
            mag = torch.sqrt(re * re + im * im)
            Y_hat = inp_tgt.spectrum_hat(Y, mag, net_apply(params, mag), gtype)
            return synthesis_from_reim(Y_hat, N_d, N_s, K)

    return enhance


def make_estimator(inp_tgt, network: torch.nn.Module,
                   apply_fn: Optional[Callable] = None,
                   device=None, kernels: bool = True) -> Callable:
    """Build `estimate(params, x_int16[B, L]) -> (network output, network
    input)` on `device` (the card unless ``device="cpu"``). A family that
    reads |X| takes it from the hop rows through `stft_mag_fused` where the
    kernel takes the framing and `kernels` is set, else from the matmul DFT
    (`stft_mag`); the others read their own `observation`. The network is
    `apply_fn(params, inp)` in place of its own forward, as in
    `make_enhancer`."""
    dev = resolve_device(device)
    N_d, N_s, K = inp_tgt.N_d, inp_tgt.N_s, inp_tgt.K
    net_apply = apply_fn or (lambda p, m: functional_call(network, p, (m,)))
    kernel = kernels and kernel_takes(N_d, N_s, K)

    @torch.no_grad()
    def estimate(params, x_int16):
        x_int16 = torch.as_tensor(x_int16, device=dev)
        if not inp_tgt.mag_input:
            inp = inp_tgt.observation(x_int16)[0]
        elif kernel:
            inp = stft_mag_fused(hop_rows(normalise(x_int16), N_s), N_d, K)
        else:
            inp = stft_mag(normalise(x_int16), N_d, N_s, K)
        return net_apply(params, inp), inp

    return estimate


def make_xi_estimator(inp_tgt, network: torch.nn.Module,
                      apply_fn: Optional[Callable] = None,
                      device=None, kernels: bool = True) -> Callable:
    """Build `estimate(params, x_int16[B, L], with_mag=False) ->
    xi_hat[B, T, bins]` (and the network input, |X|, with `with_mag`) for
    the xi_hat, gamma_hat, deepmmse and mask outputs: `make_estimator`, then
    the family's a priori SNR estimate."""
    est = make_estimator(inp_tgt, network, apply_fn, device, kernels)

    def estimate(params, x_int16, with_mag: bool = False):
        """xi_hat, or (xi_hat, |X|) with `with_mag`."""
        tgt_hat, mag = est(params, x_int16)
        xi_hat = inp_tgt.xi_hat(tgt_hat)
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
                          device=None, reader: Optional[Callable] = None,
                          kernels: bool = True) -> Callable:
    """Build `synthesise(params, x_int16[B, L], n_frames=None) ->
    y[B, (n - 1) * N_s + N_d]` on `device` (the card unless
    ``device="cpu"``): [re || im] of the windowed DFT, |X|, the network
    (`apply_fn(params, mag)` in place of its own forward, as in
    `make_enhancer`), `reader` of its output (default the family's
    `xi_hat`), the real gain `gain(read)` (e.g. `noise_gain`), then the gain
    product and the inverse DFT in one `enhance_frames_fused` launch (the
    matrix products, `gained_frames`, where the kernel does not take the
    framing or `kernels` is not set) and the overlap-add. The frames past
    `n_frames` (default: all T) are cut before the synthesis."""
    dev = resolve_device(device)
    N_d, N_s, K = inp_tgt.N_d, inp_tgt.N_s, inp_tgt.K
    nb = K // 2 + 1
    net_apply = apply_fn or (lambda p, m: functional_call(network, p, (m,)))
    read = reader or inp_tgt.xi_hat
    frames_of = enhance_frames_fused if kernels and kernel_takes(N_d, N_s, K) \
        else gained_frames

    @torch.no_grad()
    def synthesise(params, x_int16, n_frames: Optional[int] = None) -> torch.Tensor:
        x = normalise(torch.as_tensor(x_int16, device=dev))
        Y = stft_reim(x, N_d, N_s, K)
        re, im = Y[..., :nb], Y[..., nb:]
        G = gain(read(net_apply(params, torch.sqrt(re * re + im * im))))
        n = Y.shape[1] if n_frames is None else n_frames
        frames = frames_of(Y[:, :n].contiguous(), G[:, :n].contiguous(), N_d, N_s, K)
        return overlap_and_add(frames, N_s)

    return synthesise
