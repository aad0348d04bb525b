"""Ephraim and Malah's log-spectral amplitude gain (anicolson/DeepXi
deepxi/gain.py), xi and gamma clamped to [1e-12, 1e12] as there."""

from __future__ import annotations

import torch

from perfbench.reference.dsp import XI_MAX, exp1


def gain(xi: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    xi = xi.clamp(1e-12, XI_MAX)
    gamma = gamma.clamp(1e-12, XI_MAX)
    v = xi / (1.0 + xi)
    return (v.double() * torch.exp(0.5 * exp1(v * gamma))).float()
