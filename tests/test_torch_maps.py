"""Every target map (`deepxi_tpu_torch.ops.maps`) against the JAX package's
(`deepxi_tpu.ops.maps`) on the CPU: `with_stats` on a seeded sample, `map`
and `inverse` on fresh data, for each map type with and without its Square
and DB pre-transforms; `map_selector` on every type string the JAX package
parses (and the list form); and the statistics crossing between the
packages through the stats file's keys in both directions. Tolerance:
float32 rounding, 1e-5 relative (1e-4 through the pre-transforms' log and
power)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.framework import DeepXiTPU
from deepxi_tpu.inp_tgt import inp_tgt_selector as inp_tgt_selector_j
from deepxi_tpu.ops.maps import map_selector as map_selector_j
from deepxi_tpu_torch.framework import DeepXiTorch
from deepxi_tpu_torch.inp_tgt import inp_tgt_selector
from deepxi_tpu_torch.ops.maps import STATS_FIELDS, map_selector

# (type string, params): every map, with and without its pre-transforms
MAPS = [("Linear", None), ("DB", None), ("Square", None), ("SquareDB", None),
        ("Clip", [0.1, 3.0]), ("ClipSquare", [0.1, 3.0]), ("DBClip", [0.1, 3.0]),
        ("Logistic", [0.5, 1.0]), ("DBLogistic", [0.2, 3.0]),
        ("Standardise", None), ("DBStandardise", None), ("SquareDBStandardise", None),
        ("MinMaxScaling", None), ("DBMinMaxScaling", None),
        ("NormalCDF", None), ("DBNormalCDF", None), ("SquareNormalCDF", None),
        ("SquareDBNormalCDF", None),
        ("LaplaceCDF", [1.0]), ("DBLaplaceCDF", [0.0]), ("SquareDBLaplaceCDF", [5.0]),
        ("TruncatedLaplaceCDF", [0.5, 0.0, 4.0]), ("DBTruncatedLaplaceCDF", [0.0, -30.0, 30.0]),
        ("UniformCDF", [-np.pi, np.pi]), ("UniformCDF", None)]
IDS = [f"{t}-{i}" for i, (t, _) in enumerate(MAPS)]


def _sample(shape=(300, 17), seed=0):
    """Positive, power-like data over six decades, with a few values below
    the maps' ranges."""
    rng = np.random.RandomState(seed)
    return (np.abs(rng.randn(*shape)) * 10 ** rng.uniform(-3, 3, shape)).astype(np.float32)


def _fields(m):
    return {k: v for k, v in vars(m).items()}


def _close(a, b, rtol, scale=None):
    """Elementwise within rtol of max(|b|, 1), or of `scale` when given
    (an inverse map's values: erfinv near 0 and 1 is ill-conditioned, so
    its float32 error is relative to the data's spread, not to each
    value); NaN and inf where both have them."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    if scale is not None:
        # sqrt of a value within rounding of 0 is NaN on one side only
        a, b = np.nan_to_num(a, nan=0.0), np.nan_to_num(b, nan=0.0)
    same_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    same_nan = np.isnan(a) & np.isnan(b)
    ref = np.maximum(np.abs(b), 1.0) if scale is None else scale
    ok = same_inf | same_nan | (np.abs(a - b) <= rtol * ref)
    assert ok.all(), float(np.nanmax(np.abs(a - b)[~ok]))


@pytest.mark.parametrize("map_type,params", MAPS, ids=IDS)
def test_map_matches_jax(map_type, params):
    """with_stats, map and inverse of the same sample and data."""
    m, m_j = map_selector(map_type, params), map_selector_j(map_type, params)
    sample, x = _sample(), _sample(seed=1)
    m, m_j = m.with_stats(torch.as_tensor(sample)), m_j.with_stats(jnp.asarray(sample))
    for f in STATS_FIELDS:
        v, v_j = getattr(m, f, None), getattr(m_j, f, None)
        assert (v is None) == (v_j is None)
        if torch.is_tensor(v):
            _close(v, v_j, 1e-5)
    rtol = 1e-4 if ("DB" in map_type or "Square" in map_type) else 1e-5
    x_bar, x_bar_j = m.map(torch.as_tensor(x)), np.asarray(m_j.map(jnp.asarray(x)))
    _close(x_bar, x_bar_j, rtol)
    # the inverse of the JAX map's values, cut off the saturated ends
    x_in = np.clip(x_bar_j, 1e-4, 1 - 1e-4) if "CDF" in map_type or "Logistic" in map_type \
        or "MinMax" in map_type else x_bar_j
    inv_j = np.asarray(m_j.inverse(jnp.asarray(x_in)))
    _close(m.inverse(torch.as_tensor(x_in)), inv_j, 1e-4,
           scale=max(np.nanmax(np.abs(inv_j[np.isfinite(inv_j)]), initial=1.0), 1.0))


JAX_STRINGS = sorted({t for t, _ in MAPS} | {"DBSquareNormalCDF", "ClipDB"})


@pytest.mark.parametrize("map_type", JAX_STRINGS)
def test_map_selector_parses_as_jax(map_type):
    """The same class and fields for every type string, with the
    parameters each needs (and the UniformCDF default [0, 1])."""
    params = dict(MAPS).get(map_type) or ([0.1, 3.0] if "Clip" in map_type else None)
    m, m_j = map_selector(map_type, params), map_selector_j(map_type, params)
    assert type(m).__name__ == type(m_j).__name__
    assert _fields(m) == {k: getattr(m_j, k) for k in _fields(m)}


def test_map_selector_list_form_and_errors():
    """A list of names matches by membership, as in the JAX package; an
    unknown type raises in both."""
    for mt in (["DB", "NormalCDF"], ["UniformCDF"], ["Square", "DB", "Standardise"]):
        m, m_j = map_selector(mt, None), map_selector_j(mt, None)
        assert type(m).__name__ == type(m_j).__name__
        assert (m.square, m.use_db) == (m_j.square, m_j.use_db)
    with pytest.raises(ValueError):
        map_selector("Gaussian")
    with pytest.raises(ValueError):
        map_selector_j("Gaussian")


# (family, map_type, map_params) whose statistics cross between packages
STATS_FAMILIES = [("MagXi", "DBLaplaceCDF", [0.0]), ("MagXiGamma",
                  ["DBNormalCDF", "DBMinMaxScaling"], None),
                  ("STDCTXiCD", ["DBStandardise", "TruncatedLaplaceCDF"],
                   [None, [0.0, -1.0, 1.0]]), ("MagMag", "ClipSquare", [0.0, 2.0])]


def _family_pair(inp_tgt_type, map_type, map_params, fit=True):
    """The family in both packages, fitted on the same seeded sample."""
    dims = dict(N_d=512, N_s=256, K=512, f_s=16000)
    it = inp_tgt_selector(inp_tgt_type, **dims, map_type=map_type, map_params=map_params)
    it_j = inp_tgt_selector_j(inp_tgt_type, **dims, map_type=map_type, map_params=map_params)
    if not fit:
        return it, it_j
    rng = np.random.RandomState(4)
    wav = [rng.randn(3, 4000).astype(np.float32) * a for a in (0.3, 0.1, 0.35)]
    lens = np.array([4000, 3000, 2100], np.int32)
    return it.with_stats(*wav, lens), it_j.with_stats(*wav, lens)


@pytest.mark.parametrize("family,map_type,map_params", STATS_FAMILIES,
                         ids=[f[0] for f in STATS_FAMILIES])
def test_stats_files_cross_between_packages(tmp_path, family, map_type, map_params):
    """The JAX package's stats file loads in the port and gives the same
    maps, and the port's loads in the JAX package (keys `<map>.<field>`)."""
    it, it_j = _family_pair(family, map_type, map_params)
    fresh, fresh_j = _family_pair(family, map_type, map_params, fit=False)
    ns_j = types.SimpleNamespace(inp_tgt=it_j)
    ns_j._map_attrs = lambda: DeepXiTPU._map_attrs(ns_j)
    DeepXiTPU._save_stats(ns_j, str(tmp_path / "j" / "stats.npz"))
    ns = types.SimpleNamespace(inp_tgt=fresh, device=torch.device("cpu"))
    ns._map_attrs = lambda: DeepXiTorch._map_attrs(ns)
    got = DeepXiTorch._load_stats(ns, str(tmp_path / "j" / "stats.npz"))

    ns = types.SimpleNamespace(inp_tgt=it)
    ns._map_attrs = lambda: DeepXiTorch._map_attrs(ns)
    DeepXiTorch._save_stats(ns, str(tmp_path / "t" / "stats.npz"))
    ns_j = types.SimpleNamespace(inp_tgt=fresh_j)
    ns_j._map_attrs = lambda: DeepXiTPU._map_attrs(ns_j)
    got_j = DeepXiTPU._load_stats(ns_j, str(tmp_path / "t" / "stats.npz"))
    assert sorted(np.load(tmp_path / "j" / "stats.npz").files) == \
        sorted(np.load(tmp_path / "t" / "stats.npz").files)

    x = _sample((5, it.n_outp // (2 if family in ("MagXiGamma", "STDCTXiCD") else 1)), 7)
    for attr in ("xi_map", "gamma_map", "mag_map", "cd_map"):
        if getattr(it, attr, None) is None:
            continue
        # each package's statistics give the same map in the other
        _close(getattr(got, attr).map(torch.as_tensor(x)),
               getattr(it_j, attr).map(jnp.asarray(x)), 1e-5)
        _close(getattr(got_j, attr).map(jnp.asarray(x)),
               getattr(it, attr).map(torch.as_tensor(x)), 1e-5)
