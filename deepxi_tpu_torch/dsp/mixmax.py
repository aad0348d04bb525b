"""Log-spectral MixMax speech estimator with per-phoneme clean Gaussians and
an adaptive noise Gaussian (follows deepxi_tpu/dsp/mixmax.py).

The MixMax observation model: the noisy log-spectrum is z = max(x, g), with
clean x ~ N(mu_i, sigma_i) for phoneme class i and noise g ~ N(mu_g,
sigma_g). The clean estimate mixes z with the class-conditional mean through
the posterior rho = f G / (f G + F g):
x_hat = sum_i p_i [rho_i z + beta_i (1 - rho_i)], floored at z + delta.

Without noise tracking every frame is estimated at once ([T, P, F]); with
it the noise Gaussian adapts frame by frame in a Python loop, each frame's
[P, F] estimate one set of tensor operations. The Normal pdf is the JAX
package's exp(logpdf), the cdf its erf/erfc form (`ndtr`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

_TINY32 = float(np.finfo(np.float32).tiny)
_SQRT_HALF = math.sqrt(0.5)


class MixMaxModel(NamedTuple):
    """Per-phoneme clean-speech Gaussians and a noise Gaussian in the
    log-STMS domain. Shapes: x_mu/x_sigma [P, F]; g_mu/g_sigma [F];
    prio_p [P]."""
    x_mu: torch.Tensor
    x_sigma: torch.Tensor
    g_mu: torch.Tensor
    g_sigma: torch.Tensor
    prio_p: torch.Tensor
    alpha: float = 0.01
    beta: float = 0.99

    def to(self, *args, **kwargs) -> "MixMaxModel":
        """The model with every tensor moved or cast (`Tensor.to`'s
        arguments)."""
        return self._replace(**{k: getattr(self, k).to(*args, **kwargs)
                                for k in ("x_mu", "x_sigma", "g_mu", "g_sigma", "prio_p")})


def default_delta(n_bins: int = 257, device=None) -> torch.Tensor:
    """Spectral floor offset (float32): log(0.03) on the low 185 bins,
    log(0.01) above. Filled on the device (no host-to-device copy)."""
    out = torch.full((n_bins,), float(np.log(0.03)), dtype=torch.float32, device=device)
    out[185:] = float(np.log(0.01))
    return out


def _norm_pdf(x, loc, scale):
    """exp of the Normal log-density, as jax.scipy.stats.norm.pdf."""
    scale_sq = torch.square(scale)
    return torch.exp((torch.log(2.0 * math.pi * scale_sq)
                      + torch.square(x - loc) / scale_sq) / -2.0)


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """The standard Normal cdf as the JAX package computes it: 1 + erf near
    0, erfc in the tails. (`torch.special.ndtr` takes (1 + erf) / 2
    everywhere, which cancels in the left tail: 0 below -8.3 in float64
    and below -5.4 in float32.)"""
    h = x * _SQRT_HALF
    z = torch.abs(h)
    return 0.5 * torch.where(z < _SQRT_HALF, 1.0 + torch.erf(h),
                             torch.where(h > 0, 2.0 - torch.erfc(z), torch.erfc(z)))


def _norm_cdf(x, loc, scale):
    return ndtr((x - loc) / scale)


def _posteriors(model: MixMaxModel, p_prior: torch.Tensor, z: torch.Tensor):
    """rho_ik, R_ik and the class posteriors p_mm of log-magnitude frames
    z [..., F] with class weights p_prior [..., P]: ([..., P, F],
    [..., P, F], [..., P])."""
    zc = z[..., None, :]
    f_ik = _norm_pdf(zc, model.x_mu, model.x_sigma)
    F_ik = _norm_cdf(zc, model.x_mu, model.x_sigma)
    g_k = _norm_pdf(z, model.g_mu, model.g_sigma)[..., None, :]
    G_k = _norm_cdf(z, model.g_mu, model.g_sigma)[..., None, :]
    h_ik = torch.clamp(f_ik * G_k + F_ik * g_k, min=_TINY32)
    log_h_i = torch.sum(torch.log(h_ik), dim=-1)
    # normalised in log space
    log_w = torch.log(torch.clamp(p_prior, min=_TINY32)) + log_h_i
    p_mm = torch.softmax(log_w, dim=-1)
    f_G = f_ik * G_k
    F_g = torch.clamp(F_ik * g_k, min=_TINY32)
    rho = f_G / (f_G + F_g)
    R = f_ik / torch.clamp(F_ik, min=_TINY32)
    return rho, R, p_mm


def estimate_frame(model: MixMaxModel, p_post: torch.Tensor, z: torch.Tensor,
                   delta: torch.Tensor,
                   nn_weighted: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """MixMax clean log-spectrum estimate of frames z [..., F] (one frame or
    many): (x_hat [..., F], rho_bar [..., F]).

    With ``nn_weighted=False`` the class posteriors come from the model's
    static prior and `p_post` [..., P] only weights the returned presence
    rho_bar; with ``nn_weighted=True`` `p_post` drives the estimate, and
    rho_bar is weighted by the resulting MixMax posteriors."""
    rho, R, p_mm_prior = _posteriors(model, model.prio_p, z)
    p_mm = _posteriors(model, p_post, z)[2] if nn_weighted else p_mm_prior
    beta_ik = model.x_mu - torch.square(model.x_sigma) * R
    o = rho * z[..., None, :] + beta_ik * (1.0 - rho)
    x_hat = torch.sum(p_mm[..., None] * o, dim=-2)
    x_hat = torch.maximum(z + delta, x_hat)
    rho_w = p_mm if nn_weighted else p_post
    rho_bar = torch.clamp(torch.sum(rho_w[..., None] * rho, dim=-2), min=_TINY32)
    return x_hat, rho_bar


def enhance(model: MixMaxModel, log_mag: torch.Tensor,
            posteriors: Optional[torch.Tensor] = None,
            track_noise: bool = True,
            nn_weighted: bool = False) -> torch.Tensor:
    """Clean log-magnitude estimate [T, F] of a [T, F] log-magnitude
    spectrogram. `posteriors` are [T, P] phoneme posteriors (e.g. the
    MagPhonemes network's), by default the model's prior in every frame;
    `track_noise` adapts the noise Gaussian frame by frame, weighted by the
    presence."""
    T, n_bins = log_mag.shape
    delta = default_delta(n_bins, log_mag.device)
    if posteriors is None:
        posteriors = model.prio_p.expand((T,) + tuple(model.prio_p.shape))
    if not track_noise:
        return estimate_frame(model, posteriors, log_mag, delta, nn_weighted)[0]
    g_mu, g_sigma = model.g_mu, model.g_sigma
    out = []
    for t in range(T):
        z = log_mag[t]
        x_hat, rho = estimate_frame(model._replace(g_mu=g_mu, g_sigma=g_sigma),
                                    posteriors[t], z, delta, nn_weighted)
        # presence-weighted noise adaptation
        g_mu = rho * g_mu + (1 - rho) * (model.alpha * z + (1 - model.alpha) * g_mu)
        dev = torch.abs(z - g_mu)
        g_sigma = rho * g_sigma + (1 - rho) * (model.alpha * dev
                                               + (1 - model.alpha) * g_sigma)
        g_sigma = torch.clamp(g_sigma, min=1e-6)
        out.append(x_hat)
    return torch.stack(out)


def gaussians_from_stats(means, stds, probs, device=None) -> MixMaxModel:
    """A float32 model from per-class statistics (arrays), the noise
    Gaussian initialised from class 0."""
    means = torch.as_tensor(np.asarray(means, np.float32), device=device)
    stds = torch.clamp(torch.as_tensor(np.asarray(stds, np.float32), device=device),
                       min=1e-6)
    return MixMaxModel(x_mu=means, x_sigma=stds, g_mu=means[0], g_sigma=stds[0],
                       prio_p=torch.as_tensor(np.asarray(probs, np.float32), device=device))
