"""The hybrid and classical enhancement modes (follows
deepxi_tpu/hybrid_infer.py): each takes one waveform, runs the polar
analysis, one of the classical DSP estimators of `dsp/` and the polar
synthesis, and returns the enhanced waveform, on the device the waveform
is on.

An int16 waveform is normalised to float32 as in the JAX package; a float
waveform is taken as it is, in its own dtype (float64 runs the whole mode
in float64, where the JAX package casts every input to float32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deepxi_tpu_torch.dsp.histnoise import HistParams, histogram_track
from deepxi_tpu_torch.dsp.mixmax import MixMaxModel
from deepxi_tpu_torch.dsp.mixmax import enhance as mixmax_enhance
from deepxi_tpu_torch.dsp.trackers import MCRAParams, omlsa_enhance
from deepxi_tpu_torch.dsp.vts import VTSModel, vts_enhance
from deepxi_tpu_torch.sig import stft
from deepxi_tpu_torch.sig.mix import normalise

_EPS32 = float(np.finfo(np.float32).eps)


def _analysis(wav: torch.Tensor, N_d: int, N_s: int, K: int):
    x = wav if wav.is_floating_point() else normalise(wav)
    return stft.polar_analysis(x, N_d, N_s, K)


def _log_mag(mag: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(mag, min=_EPS32))


def enhance_omlsa(wav: torch.Tensor, params: MCRAParams = MCRAParams(),
                  tracker: str = "mcra", N_d=512, N_s=256, K=512) -> torch.Tensor:
    """Classical OM-LSA enhancement with an MCRA-family tracker ("mcra",
    "mcra2" or "imcra")."""
    mag, pha = _analysis(wav, N_d, N_s, K)
    return stft.polar_synthesis(omlsa_enhance(mag, params, tracker), pha, N_d, N_s, K)


def enhance_mixmax(wav: torch.Tensor, model: MixMaxModel,
                   posteriors: Optional[torch.Tensor] = None, track_noise: bool = True,
                   N_d=512, N_s=256, K=512) -> torch.Tensor:
    """MixMax enhancement with per-phoneme Gaussians and, optionally, [T, P]
    phoneme posteriors (the MagPhonemes network's)."""
    mag, pha = _analysis(wav, N_d, N_s, K)
    x_hat = mixmax_enhance(model, _log_mag(mag), posteriors=posteriors,
                           track_noise=track_noise)
    return stft.polar_synthesis(torch.exp(x_hat), pha, N_d, N_s, K)


def enhance_tracking_histogram(wav: torch.Tensor, params: HistParams = HistParams(),
                               variant: int = 1, floor: float = 0.1,
                               N_d=512, N_s=256, K=512) -> torch.Tensor:
    """Spectral subtraction driven by the histogram-mode noise tracker: the
    noise PSD of `variant` (0 plain, 1 SNR-masked, 2 threshold-masked) and a
    Wiener-style gain clipped to [floor, 1]."""
    mag, pha = _analysis(wav, N_d, N_s, K)
    pwr = torch.square(mag)
    outs = histogram_track(pwr, params)
    noise = (outs.noise, outs.noise1, outs.noise2)[variant]
    gain = torch.clamp(1.0 - noise / torch.clamp(pwr, min=1e-12), floor, 1.0)
    return stft.polar_synthesis(mag * gain, pha, N_d, N_s, K)


def enhance_vts(wav: torch.Tensor, model: VTSModel, n_iter: int = 3,
                spp: Optional[torch.Tensor] = None,
                N_d=512, N_s=256, K=512) -> torch.Tensor:
    """VTS/GMM model-compensation enhancement: `n_iter` batch EM iterations
    over every frame of the waveform."""
    mag, pha = _analysis(wav, N_d, N_s, K)
    x_hat, _ = vts_enhance(model, _log_mag(mag), n_iter=n_iter, spp=spp)
    return stft.polar_synthesis(torch.exp(x_hat), pha, N_d, N_s, K)
