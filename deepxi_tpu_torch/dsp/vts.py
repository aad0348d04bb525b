"""Vector-Taylor-Series (VTS) GMM noise model (follows
deepxi_tpu/dsp/vts.py).

In the log-magnitude domain the noisy observation is
o = x + log(1 + exp(n - x - b)) + b, with clean speech x from a K-component
(per-phoneme) diagonal GMM, noise n from an L-component diagonal GMM and a
channel bias b. First-order VTS compensation gives per-(l, k) observation
Gaussians:

    mu_o    = mu_x + g(mu_n, mu_x, b) + b,    g = log(1 + exp(mu_n - mu_x - b))
    J       = 1 - 1 / (1 + exp(mu_n - mu_x - b))          (d o / d n)
    Sigma_o = (1 - J)^2 Sigma_x + J^2 Sigma_n

EM re-estimates the noise GMM and the bias from posterior-weighted
pseudo-noise observations, optionally gated by a speech-presence
probability. Posteriors are computed in log space. Batch EM is one set of
[T, L, K, F] tensor operations an iteration; `rt_vts_track` adapts the
noise means frame by frame in a Python loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

_TINY32 = float(np.finfo(np.float32).tiny)
_FIELDS = ("x_mu", "x_var", "w_k", "g_mu", "g_var", "w_l", "bias")


class VTSModel(NamedTuple):
    """Diagonal-covariance GMMs in the log-magnitude domain: x_mu/x_var
    [K, F] clean speech; g_mu/g_var [L, F] noise; w_k [K]; w_l [L]; bias
    [F]."""
    x_mu: torch.Tensor
    x_var: torch.Tensor
    w_k: torch.Tensor
    g_mu: torch.Tensor
    g_var: torch.Tensor
    w_l: torch.Tensor
    bias: torch.Tensor

    def to(self, *args, **kwargs) -> "VTSModel":
        """The model with every tensor moved or cast (`Tensor.to`'s
        arguments)."""
        return VTSModel(*(getattr(self, k).to(*args, **kwargs) for k in _FIELDS))


def make_model(x_mu, x_sigma, prio_p, g_mu, g_sigma, n_noise_comp: int = 2,
               jitter: float = 0.1, seed: int = 0, device=None) -> VTSModel:
    """A float32 model from per-phoneme statistics (arrays): the noise
    components are copies of the initial noise Gaussian with their means
    jittered by `jitter` standard deviations of
    `np.random.RandomState(seed)` draws (the JAX package's draws)."""
    x_mu = np.asarray(x_mu, np.float32)
    x_var = np.square(np.maximum(np.asarray(x_sigma, np.float32), np.float32(1e-3)))
    n_bins = x_mu.shape[-1]
    rng = np.random.RandomState(seed)
    g_mu0 = np.asarray(g_mu, np.float32).reshape(1, n_bins)
    g_var0 = np.square(np.maximum(np.asarray(g_sigma, np.float32),
                                  np.float32(1e-3))).reshape(1, n_bins)
    g_mu_l = g_mu0 + jitter * rng.randn(n_noise_comp, n_bins).astype(np.float32) \
        * np.sqrt(g_var0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return VTSModel(x_mu=t(x_mu), x_var=t(x_var), w_k=t(prio_p), g_mu=t(g_mu_l),
                    g_var=t(np.tile(g_var0, (n_noise_comp, 1))),
                    w_l=t(np.full((n_noise_comp,), 1.0 / n_noise_comp)),
                    bias=t(np.zeros((n_bins,))))


def _default_alpha_d(n_bins: int, device=None) -> torch.Tensor:
    """Frequency-dependent subtraction damping: 0.3 on the lowest 7 bins,
    0.5 on the next 10, 0.65 on the next 48, 0.78 above (float32, filled on
    the device)."""
    out = torch.full((n_bins,), 0.78, dtype=torch.float32, device=device)
    i = 0
    for n, v in ((7, 0.3), (10, 0.5), (48, 0.65)):
        out[i:i + n] = v
        i += n
    return out


class Compensated(NamedTuple):
    mu_o: torch.Tensor             # [L, K, F]
    var_o: torch.Tensor            # [L, K, F]
    log_w: torch.Tensor            # [L, K]
    mismatch_signal: torch.Tensor  # [L, K, F]  g + b   (o - x)
    mismatch_noise: torch.Tensor   # [L, K, F]  log(1 + exp(-(n - x - b)))   (o - n)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|)) (jax.nn.softplus;
    `F.softplus` returns x itself above its threshold)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def compensate(model: VTSModel) -> Compensated:
    """First-order VTS model compensation."""
    d = model.g_mu[:, None, :] - model.x_mu[None, :, :] - model.bias
    g = _softplus(d)
    mu_o = model.x_mu[None] + g + model.bias
    J = torch.sigmoid(d)
    var_o = (torch.square(1.0 - J) * model.x_var[None]
             + torch.square(J) * model.g_var[:, None, :])
    log_w = (torch.log(torch.clamp(model.w_l, min=1e-12))[:, None]
             + torch.log(torch.clamp(model.w_k, min=1e-12))[None, :])
    return Compensated(mu_o, torch.clamp(var_o, min=1e-8), log_w,
                       torch.clamp(g + model.bias, min=_TINY32), _softplus(-d))


def posteriors(comp: Compensated, O: torch.Tensor) -> torch.Tensor:
    """[T, L, K] joint component posteriors of log-observations O [T, F],
    in log space."""
    diff = O[:, None, None, :] - comp.mu_o[None]
    log_pdf = -0.5 * torch.sum(torch.square(diff) / comp.var_o[None]
                               + torch.log(2.0 * math.pi * comp.var_o[None]), dim=-1)
    log_p = comp.log_w[None] + log_pdf
    log_p = log_p - torch.logsumexp(log_p, dim=(1, 2), keepdim=True)
    return torch.exp(log_p)


def em_step(model: VTSModel, O: torch.Tensor, spp: Optional[torch.Tensor] = None,
            phoneme_post: Optional[torch.Tensor] = None,
            update_bias: bool = True) -> Tuple[VTSModel, torch.Tensor, torch.Tensor]:
    """One EM iteration over log-observations O [T, F]: (the updated model,
    signal_hat [T, F], noise_hat [T, F]). `spp` [T, F] is a speech-presence
    probability gating the noise update (with the frequency-dependent
    damping of the subtraction); `phoneme_post` [T, K] external phoneme
    posteriors replacing the model's speech posteriors; `update_bias=False`
    pins the channel bias (on noise-dominated input bias and noise level are
    not jointly identifiable)."""
    comp = compensate(model)
    p = posteriors(comp, O)                       # [T, L, K]
    if phoneme_post is not None:
        p = torch.sum(p, dim=2)[:, :, None] * phoneme_post[:, None, :]
    p_ntl = torch.sum(p, dim=2)                   # [T, L]
    p_stk = torch.sum(p, dim=1)                   # [T, K]
    exp_sig = torch.einsum("tlk,lkf->tf", p, comp.mismatch_signal)
    exp_noi = torch.einsum("tlk,lkf->tf", p, comp.mismatch_noise)
    if spp is None:
        signal_hat = O - exp_sig
        noise_hat = O - exp_noi
    else:
        sap = 1.0 - spp
        alpha_d = _default_alpha_d(O.shape[-1], O.device)
        signal_hat = O - alpha_d * (sap * O + spp * exp_sig)
        noise_hat = O - spp * exp_noi
    n_l = torch.clamp(torch.sum(p_ntl, dim=0), min=1e-8)   # [L]
    w_l = n_l / torch.sum(n_l)
    g_mu = torch.einsum("tl,tf->lf", p_ntl, noise_hat) / n_l[:, None]
    ex2 = torch.einsum("tl,tf->lf", p_ntl, torch.square(noise_hat)) / n_l[:, None]
    g_var = torch.clamp(ex2 - torch.square(g_mu), min=1e-6)
    if update_bias:
        prec = p_stk[:, :, None] / model.x_var[None]        # [T, K, F]
        num = torch.sum(prec * (O[:, None, :] - model.x_mu[None]), dim=(0, 1))
        den = torch.clamp(torch.sum(prec, dim=(0, 1)), min=1e-8)
        bias = num / den
    else:
        bias = model.bias
    return model._replace(g_mu=g_mu, g_var=g_var, w_l=w_l, bias=bias), signal_hat, noise_hat


def vts_enhance(model: VTSModel, O: torch.Tensor, n_iter: int = 3,
                spp: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, VTSModel]:
    """Batch VTS enhancement: `n_iter` EM iterations on the utterance's
    log-magnitudes O [T, F]; (clean log-magnitude estimate [T, F], the
    refined model). Every frame enters the sums, padded ones too."""
    signal_hat = O
    for _ in range(n_iter):
        model, signal_hat, _ = em_step(model, O, spp=spp)
    return signal_hat, model


def rt_vts_track(model: VTSModel, O: torch.Tensor, alpha: float = 0.9
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-recursive VTS: the noise GMM adapts with an exponential
    recursion on each frame's noise pseudo-observation, at the rate
    (1 - alpha) times the component's posterior. Returns (signal_hat
    [T, F], the posterior-weighted noise mean of every frame [T, F])."""
    sig, noi = [], []
    m = model
    for t in range(O.shape[0]):
        o = O[t]
        comp = compensate(m)
        p = posteriors(comp, o[None])[0]                   # [L, K]
        signal_hat = o - torch.einsum("lk,lkf->f", p, comp.mismatch_signal)
        noise_hat = o - torch.einsum("lk,lkf->f", p, comp.mismatch_noise)
        p_l = torch.sum(p, dim=1)[:, None]                  # [L, 1]
        rate = (1 - alpha) * p_l
        g_mu = (1 - rate) * m.g_mu + rate * noise_hat[None]
        dev = torch.square(noise_hat[None] - g_mu)
        g_var = torch.clamp((1 - rate) * m.g_var + rate * dev, min=1e-6)
        m = m._replace(g_mu=g_mu, g_var=g_var)
        sig.append(signal_hat)
        noi.append(torch.sum(p_l * g_mu, dim=0))
    return torch.stack(sig), torch.stack(noi)
