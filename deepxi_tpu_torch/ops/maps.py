"""Invertible target maps (follows deepxi_tpu/ops/maps.py; so far the
decibel helpers and `NormalCDF`, which with ``use_db`` is the published
`DBNormalCDF` xi map, with its statistics fit `with_stats`)."""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch


def db(x: torch.Tensor) -> torch.Tensor:
    """Power -> decibels with a 1e-12 floor."""
    return 10.0 * torch.log10(torch.clamp(x, min=1e-12))


def db_inverse(x_db: torch.Tensor) -> torch.Tensor:
    """Decibels -> power."""
    return torch.pow(10.0, x_db / 10.0)


@dataclass(frozen=True)
class NormalCDF:
    """Forward 0.5(1 + erf((x-mu)/(sigma sqrt 2))); inverse
    mu + sigma sqrt(2) erfinv(2 x_bar - 1). ``use_db`` takes x to decibels
    before the forward map and back after the inverse."""
    use_db: bool = False
    mu: Optional[torch.Tensor] = None
    sigma: Optional[torch.Tensor] = None

    def _pre(self, x: torch.Tensor) -> torch.Tensor:
        return db(x) if self.use_db else x

    def with_stats(self, sample: torch.Tensor) -> "NormalCDF":
        """Per-bin mean and population std (ddof 0, as ``jnp.std``) of the
        pre-transformed sample [N, bins]."""
        t = self._pre(sample)
        return replace(self, mu=t.mean(dim=0),
                       sigma=t.std(dim=0, unbiased=False))

    def map(self, x: torch.Tensor) -> torch.Tensor:
        x = self._pre(x)
        return 0.5 * (1.0 + torch.special.erf(
            (x - self.mu) / (self.sigma * math.sqrt(2.0))))

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        x = self.mu + self.sigma * math.sqrt(2.0) * torch.special.erfinv(
            2.0 * x_bar - 1.0)
        if self.use_db:
            x = db_inverse(x)
        return x
