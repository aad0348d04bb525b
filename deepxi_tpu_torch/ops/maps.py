"""Invertible target maps (follows deepxi_tpu/ops/maps.py).

Each map is a frozen dataclass: its statistics (per-bin mu/sigma, min/max,
the Laplace scale b) are tensors on the device the family is used on, fit by
`with_stats` from a [N, bins] sample; `map` and `inverse` are plain tensor
functions. A map type string embeds the `Square` and/or `DB` pre-transforms
by substring (the published `DBNormalCDF` xi map), applied Square -> DB on
the forward pass and undone in reverse (`map_selector`).

Statistics take the population standard deviation (ddof 0, as ``jnp.std``),
not ``torch.std``'s default.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import torch


def db(x: torch.Tensor) -> torch.Tensor:
    """Power -> decibels with a 1e-12 floor."""
    return 10.0 * torch.log10(torch.clamp(x, min=1e-12))


def db_inverse(x_db: torch.Tensor) -> torch.Tensor:
    """Decibels -> power."""
    return torch.pow(10.0, x_db / 10.0)


class _PreTransform:
    """The Square/DB pre-transform: x^2, then decibels; undone in reverse."""

    def _pre(self, x: torch.Tensor) -> torch.Tensor:
        if self.square:
            x = torch.square(x)
        if self.use_db:
            x = db(x)
        return x

    def _post_inverse(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_db:
            x = db_inverse(x)
        if self.square:
            x = torch.sqrt(x)
        return x

    def with_stats(self, sample: torch.Tensor):
        """A map without statistics is its own fit."""
        return self


@dataclass(frozen=True)
class Linear(_PreTransform):
    """The identity."""
    square: bool = False
    use_db: bool = False

    def map(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        return x_bar


@dataclass(frozen=True)
class Square(_PreTransform):
    """x^2 (in decibels with `use_db`)."""
    square: bool = True
    use_db: bool = False

    def map(self, x: torch.Tensor) -> torch.Tensor:
        return self._pre(x)

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        return self._post_inverse(x_bar)


@dataclass(frozen=True)
class DB(_PreTransform):
    """Decibels."""
    square: bool = False
    use_db: bool = True

    def map(self, x: torch.Tensor) -> torch.Tensor:
        return self._pre(x)

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        return self._post_inverse(x_bar)


@dataclass(frozen=True)
class Clip(_PreTransform):
    """Clip to [min, max], then Square/DB."""
    square: bool = False
    use_db: bool = False
    min: float = 0.0
    max: float = 1.0

    def map(self, x: torch.Tensor) -> torch.Tensor:
        x_bar = torch.clamp(x, self.min, self.max)
        if self.square:
            x_bar = torch.square(x_bar)
        if self.use_db:
            x_bar = db(x_bar)
        return x_bar

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        return self._post_inverse(x_bar)


@dataclass(frozen=True)
class Logistic(_PreTransform):
    """1 / (1 + exp(-k (x - x_0))) of the pre-transformed x."""
    square: bool = False
    use_db: bool = False
    k: float = 1.0
    x_0: float = 0.0

    def map(self, x: torch.Tensor) -> torch.Tensor:
        x = self._pre(x)
        return 1.0 / (1.0 + torch.exp(-self.k * (x - self.x_0)))

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        v = torch.log(torch.clamp(1.0 / x_bar - 1.0, min=1e-12))
        return self._post_inverse(self.x_0 - v / self.k)


@dataclass(frozen=True)
class Standardise(_PreTransform):
    """(x - mu) / sigma with per-bin statistics."""
    square: bool = False
    use_db: bool = False
    mu: Optional[torch.Tensor] = None
    sigma: Optional[torch.Tensor] = None

    def map(self, x: torch.Tensor) -> torch.Tensor:
        return (self._pre(x) - self.mu) / self.sigma

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        return self._post_inverse(x_bar * self.sigma + self.mu)

    def with_stats(self, sample: torch.Tensor) -> "Standardise":
        t = self._pre(sample)
        return replace(self, mu=t.mean(dim=0), sigma=t.std(dim=0, unbiased=False))


@dataclass(frozen=True)
class MinMaxScaling(_PreTransform):
    """(x - min) / (max - min) with per-bin statistics, clipped to [0, 1]."""
    square: bool = False
    use_db: bool = False
    min: Optional[torch.Tensor] = None
    max: Optional[torch.Tensor] = None

    def map(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp((self._pre(x) - self.min) / (self.max - self.min), 0.0, 1.0)

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        return self._post_inverse(x_bar * (self.max - self.min) + self.min)

    def with_stats(self, sample: torch.Tensor) -> "MinMaxScaling":
        t = self._pre(sample)
        return replace(self, min=t.amin(dim=0), max=t.amax(dim=0))


@dataclass(frozen=True)
class NormalCDF(_PreTransform):
    """Forward 0.5(1 + erf((x-mu)/(sigma sqrt 2))); inverse
    mu + sigma sqrt(2) erfinv(2 x_bar - 1). With ``use_db`` it is the
    published `DBNormalCDF` xi map."""
    square: bool = False
    use_db: bool = False
    mu: Optional[torch.Tensor] = None
    sigma: Optional[torch.Tensor] = None

    def with_stats(self, sample: torch.Tensor) -> "NormalCDF":
        """Per-bin mean and population std (ddof 0, as ``jnp.std``) of the
        pre-transformed sample [N, bins]."""
        t = self._pre(sample)
        return replace(self, mu=t.mean(dim=0), sigma=t.std(dim=0, unbiased=False))

    def map(self, x: torch.Tensor) -> torch.Tensor:
        x = self._pre(x)
        return 0.5 * (1.0 + torch.special.erf(
            (x - self.mu) / (self.sigma * math.sqrt(2.0))))

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        x = self.mu + self.sigma * math.sqrt(2.0) * torch.special.erfinv(
            2.0 * x_bar - 1.0)
        return self._post_inverse(x)


def _laplace_cdf(x, loc, b):
    v = x - loc
    return 0.5 + 0.5 * torch.sign(v) * (1.0 - torch.exp(-torch.abs(v) / b))


def _laplace_cdf_inverse(c, loc, b):
    v = c - 0.5
    return loc - b * torch.sign(v) * torch.log(1.0 - 2.0 * torch.abs(v))


def _tail_mean(t: torch.Tensor, mask: torch.Tensor, loc: float) -> torch.Tensor:
    """Per-bin mean of t - loc over the masked entries (at least one)."""
    tail_sum = torch.where(mask, t - loc, torch.zeros_like(t)).sum(dim=0)
    return tail_sum / torch.clamp(mask.sum(dim=0), min=1)


@dataclass(frozen=True)
class LaplaceCDF(_PreTransform):
    """Laplace CDF at location `loc` with a per-bin scale b: the mean of the
    right tail above `loc`."""
    square: bool = False
    use_db: bool = False
    loc: float = 0.0
    b: Optional[torch.Tensor] = None

    def map(self, x: torch.Tensor) -> torch.Tensor:
        return _laplace_cdf(self._pre(x), self.loc, self.b)

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        return self._post_inverse(_laplace_cdf_inverse(x_bar, self.loc, self.b))

    def with_stats(self, sample: torch.Tensor) -> "LaplaceCDF":
        t = self._pre(sample)
        return replace(self, b=_tail_mean(t, t > self.loc, self.loc))


@dataclass(frozen=True)
class TruncatedLaplaceCDF(_PreTransform):
    """The Laplace CDF renormalised to [lower, upper] (0 below, 1 above); b
    is the mean of the tail between `loc` and `upper`."""
    square: bool = False
    use_db: bool = False
    loc: float = 0.0
    lower: float = -40.0
    upper: float = 40.0
    b: Optional[torch.Tensor] = None

    def _ends(self):
        """The CDF at `lower` and at `upper`, per bin."""
        lo, up = (torch.full_like(self.b, v) for v in (self.lower, self.upper))
        return _laplace_cdf(lo, self.loc, self.b), _laplace_cdf(up, self.loc, self.b)

    def map(self, x: torch.Tensor) -> torch.Tensor:
        x = self._pre(x)
        c_l, c_u = self._ends()
        x_bar = (_laplace_cdf(x, self.loc, self.b) - c_l) / (c_u - c_l)
        x_bar = torch.where(x < self.lower, torch.zeros_like(x), x_bar)
        return torch.where(x > self.upper, torch.ones_like(x), x_bar)

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        c_l, c_u = self._ends()
        c = x_bar * (c_u - c_l) + c_l
        return self._post_inverse(_laplace_cdf_inverse(c, self.loc, self.b))

    def with_stats(self, sample: torch.Tensor) -> "TruncatedLaplaceCDF":
        t = self._pre(sample)
        return replace(self, b=_tail_mean(t, (t > self.loc) & (t < self.upper), self.loc))


@dataclass(frozen=True)
class UniformCDF(_PreTransform):
    """(x - a) / (b - a): the uniform CDF on [a, b] (no pre-transform is
    applied, as in the JAX package)."""
    square: bool = False
    use_db: bool = False
    a: float = 0.0
    b: float = 1.0

    def map(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.a) / (self.b - self.a)

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        return x_bar * (self.b - self.a) + self.a


# The statistics fields a map may carry, under the stats file's keys
# `<map attribute>.<field>`.
STATS_FIELDS = ("mu", "sigma", "b", "min", "max")


def map_selector(map_type, params: Optional[Sequence] = None):
    """A map from its type string (or list of names, matched by membership
    as in the JAX package): `DB`/`Square` substrings select the
    pre-transforms; `params` carries the map's parameters in the
    reference's order (Clip: min, max; Logistic: k, x_0; LaplaceCDF: loc;
    TruncatedLaplaceCDF: loc, lower, upper; UniformCDF: a, b, else [0, 1])."""
    square = "Square" in map_type
    use_db = "DB" in map_type
    p = params if params is not None else []
    if not isinstance(p, (list, tuple)):
        p = [p]

    if map_type == "Linear":
        return Linear()
    if map_type == "DB":
        return DB()
    if "Clip" in map_type:
        return Clip(square=square, use_db=use_db, min=float(p[0]), max=float(p[1]))
    if "Logistic" in map_type:
        return Logistic(square=square, use_db=use_db, k=float(p[0]), x_0=float(p[1]))
    if "Standardise" in map_type:
        return Standardise(square=square, use_db=use_db)
    if "MinMaxScaling" in map_type:
        return MinMaxScaling(square=square, use_db=use_db)
    if "NormalCDF" in map_type:
        return NormalCDF(square=square, use_db=use_db)
    if "TruncatedLaplaceCDF" in map_type:
        return TruncatedLaplaceCDF(square=square, use_db=use_db, loc=float(p[0]),
                                   lower=float(p[1]), upper=float(p[2]))
    if "LaplaceCDF" in map_type:
        return LaplaceCDF(square=square, use_db=use_db, loc=float(p[0]))
    if "UniformCDF" in map_type:
        if len(p) >= 2:
            return UniformCDF(square=square, use_db=use_db, a=float(p[0]), b=float(p[1]))
        return UniformCDF(square=square, use_db=use_db)
    if "Square" in map_type:
        return Square(use_db=use_db)
    raise ValueError(f"Invalid map_type: {map_type!r}")
