"""MMSE, Wiener and mask gain functions (follows deepxi_tpu/ops/gains.py):
wf, srwf, cwf, irm, ibm, mmse-stsa, mmse-lsa, deepmmse and dgwf, elementwise
on tensors of any device."""

from __future__ import annotations

import math

import torch

from deepxi_tpu_torch.ops.special import exp1

_GAIN_FNS = {}

# Upper clamp for SNR inputs: a saturated sigmoid (xi_bar = 1) inverts to
# xi = +inf through erfinv, which gives inf/inf = NaN in the Wiener-family
# gains; clamping keeps the gain finite and within 1e-12 of 1.
XI_MAX = 1e12


def _register(name):
    def deco(fn):
        _GAIN_FNS[name] = fn
        return fn
    return deco


@_register("wf")
def wf(xi: torch.Tensor, gamma: torch.Tensor = None) -> torch.Tensor:
    """Wiener filter gain xi / (xi + 1)."""
    xi = torch.clamp(xi, max=XI_MAX)
    return xi / (xi + 1.0)


@_register("srwf")
def srwf(xi: torch.Tensor, gamma: torch.Tensor = None) -> torch.Tensor:
    """Square-root Wiener filter."""
    return torch.sqrt(wf(xi))


@_register("cwf")
def cwf(xi: torch.Tensor, gamma: torch.Tensor = None) -> torch.Tensor:
    """Constrained Wiener filter: the Wiener gain at sqrt(xi)."""
    return wf(torch.sqrt(xi))


@_register("irm")
def irm(xi: torch.Tensor, gamma: torch.Tensor = None) -> torch.Tensor:
    """Ideal ratio mask (the square-root Wiener filter)."""
    return srwf(xi)


@_register("ibm")
def ibm(xi: torch.Tensor, gamma: torch.Tensor = None) -> torch.Tensor:
    """Ideal binary mask with a 0 dB threshold."""
    return (xi > 1.0).to(torch.float32)


@_register("mmse-stsa")
def mmse_stsa(xi: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """MMSE short-time spectral amplitude estimator (Ephraim-Malah), with the
    Wiener gain where the Bessel terms overflow (G inf or NaN)."""
    xi = torch.clamp(xi, 1e-12, XI_MAX)
    gamma = torch.clamp(gamma, 1e-12, XI_MAX)
    nu = xi * (gamma / (1.0 + xi))
    G = ((math.sqrt(math.pi) / 2.0)
         * (torch.sqrt(nu) / gamma)
         * torch.exp(-nu / 2.0)
         * ((1.0 + nu) * torch.special.i0(nu / 2.0)
            + nu * torch.special.i1(nu / 2.0)))
    bad = torch.isnan(G) | torch.isinf(G)
    return torch.where(bad, wf(xi), G)


@_register("mmse-lsa")
def mmse_lsa(xi: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """MMSE log-spectral amplitude estimator (Ephraim-Malah)."""
    xi = torch.clamp(xi, 1e-12, XI_MAX)
    gamma = torch.clamp(gamma, 1e-12, XI_MAX)
    v = xi / (1.0 + xi)
    return v * torch.exp(0.5 * exp1(v * gamma))


@_register("deepmmse")
def deepmmse(xi: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """MMSE noise-periodogram gain 1/(1+xi) + xi/(gamma(1+xi)) (DeepMMSE):
    |X|^2 times it is the noise PSD estimate."""
    xi = torch.clamp(xi, max=XI_MAX)
    gamma = torch.clamp(gamma, max=XI_MAX)
    return 1.0 / (1.0 + xi) + xi / (gamma * (1.0 + xi))


@_register("dgwf")
def dgwf(xi: torch.Tensor, gamma: torch.Tensor = None,
         cdm: torch.Tensor = None) -> torch.Tensor:
    """Dual-gain Wiener filter over a constructive/destructive mask `cdm`
    (bool, broadcast against xi): the constructive gain where it is true."""
    if cdm is None:
        raise ValueError("gain 'dgwf' needs the constructive/destructive mask "
                         "cdm, which the MagXi family does not estimate")
    v1 = 2.0 / math.pi
    v2 = 2.0 * v1
    r = torch.sqrt(xi)
    den = xi + 1.0
    g_minus = (xi - v1 * r) / (den - v2 * r)
    g_plus = (xi + v1 * r) / (den + v2 * r)
    return torch.where(cdm, g_plus, g_minus)


def gfunc(xi: torch.Tensor, gamma: torch.Tensor = None,
          gtype: str = "mmse-lsa", cdm: torch.Tensor = None) -> torch.Tensor:
    """Gain dispatcher: `gtype` one of `GAIN_TYPES`; `cdm` is dgwf's mask."""
    if gtype == "dgwf":
        return dgwf(xi, gamma, cdm)
    try:
        fn = _GAIN_FNS[gtype]
    except KeyError:
        raise ValueError(f"Invalid gain function type: {gtype!r} "
                         f"(known: {', '.join(GAIN_TYPES)})") from None
    return fn(xi, gamma)


GAIN_TYPES = tuple(sorted(_GAIN_FNS))
