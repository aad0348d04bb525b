"""Deep Xi's MagXi family: the noisy magnitude spectrum in; out, the a
priori SNR xi = |S|^2 / |D|^2 through the configuration's map. To enhance:
xi from the map's inverse, gamma = xi + 1, the configuration's gain on the
noisy spectrum."""

from __future__ import annotations

import perfbench.reference as ref


def n_feat(cfg: dict) -> int:
    return cfg["K"] // 2 + 1


def n_outp(cfg: dict) -> int:
    return cfg["K"] // 2 + 1


def features(X):
    return X.abs()


def target(S, D, cfg: dict, stats: dict):
    """The training target from the clean and noise spectra."""
    return ref.map_(cfg).forward(S.abs().square() / D.abs().square().clamp(min=1e-12), stats)


def enhance_spectrum(X, out, cfg: dict, stats: dict):
    """The enhanced spectrum from the noisy one and the network's output."""
    xi = ref.map_(cfg).inverse(out, stats)
    return X * ref.gain(cfg)(xi, xi + 1.0)
