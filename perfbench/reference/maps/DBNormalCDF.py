"""Deep Xi's DBNormalCDF map: xi in dB through the normal CDF of each
bin's mean and standard deviation (the statistics file's `xi_map.mu`,
`xi_map.sigma`), and its inverse (anicolson/DeepXi deepxi/map.py)."""

from __future__ import annotations

import math

import torch


def forward(xi: torch.Tensor, stats: dict) -> torch.Tensor:
    mu, sigma = stats["xi_map.mu"], stats["xi_map.sigma"]
    x = 10.0 * torch.log10(xi.clamp(min=1e-12))
    return 0.5 * (1.0 + torch.erf((x - mu) / (sigma * math.sqrt(2.0))))


def inverse(x_bar: torch.Tensor, stats: dict) -> torch.Tensor:
    mu, sigma = stats["xi_map.mu"], stats["xi_map.sigma"]
    x = mu + sigma * math.sqrt(2.0) * torch.erfinv(2.0 * x_bar - 1.0)
    return torch.pow(10.0, x / 10.0)
