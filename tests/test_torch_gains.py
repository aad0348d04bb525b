"""The port's gain functions against the JAX package's `gfunc` on the CPU:
every name in the JAX `GAIN_TYPES` on a grid of (xi, gamma) that takes in
0, 1e-12, XI_MAX and beyond, and +inf; MMSE-STSA through the region where
its Bessel terms overflow; the dual-gain Wiener filter with a mask and its
errors; and `StreamingEnhancer` with MMSE-STSA against the JAX one on a
small net."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.inp_tgt import inp_tgt_selector
from deepxi_tpu.models import network_selector
from deepxi_tpu.ops import gains as gains_j
from deepxi_tpu.streaming import StreamingEnhancer as StreamingEnhancerJ
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models.tcn import ResNetV2
from deepxi_tpu_torch.ops import gains
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.streaming import StreamingEnhancer

VALUES = np.array([0.0, 1e-12, 1e-6, 1e-3, 0.1, 0.5, 1.0, 2.0, 10.0, 1e3, 1e6, 1e12,
                   1e15, np.inf], np.float32)


def _both(xi, gamma, gtype, cdm=None):
    g = gains.gfunc(torch.as_tensor(xi), torch.as_tensor(gamma), gtype,
                    None if cdm is None else torch.as_tensor(cdm)).numpy()
    g_j = np.asarray(gains_j.gfunc(jnp.asarray(xi), jnp.asarray(gamma), gtype,
                                   None if cdm is None else jnp.asarray(cdm)))
    return g, g_j


def test_gain_types_are_the_jax_packages():
    assert gains.GAIN_TYPES == gains_j.GAIN_TYPES
    assert gains.XI_MAX == gains_j.XI_MAX


# Measured on the CPU: 0 for the Wiener family, ibm and deepmmse (the same
# float32 operations), 1.5e-7 (mmse-lsa) and 2.5e-7 (mmse-stsa); NaN exactly
# where JAX gives NaN (deepmmse at xi = gamma = 0). Held to 1e-5 relative.
@pytest.mark.parametrize("gtype", [g for g in gains_j.GAIN_TYPES if g != "dgwf"])
def test_gain_matches_jax_on_the_grid(gtype):
    xi, gamma = (a.ravel() for a in np.meshgrid(VALUES, VALUES, indexing="ij"))
    g, g_j = _both(xi, gamma, gtype)
    assert g.dtype == np.float32 and g.shape == xi.shape
    np.testing.assert_allclose(g, g_j, rtol=1e-5, atol=0, equal_nan=True)


def _mmse_stsa_flushed(xi, gamma):
    """The port's MMSE-STSA with the JAX package's CPU arithmetic: its
    prefactor sqrt(pi)/2 sqrt(nu)/gamma exp(-nu/2) flushed to zero where it
    is subnormal."""
    xi = torch.clamp(xi, 1e-12, gains.XI_MAX)
    gamma = torch.clamp(gamma, 1e-12, gains.XI_MAX)
    nu = xi * (gamma / (1.0 + xi))
    pre = (np.sqrt(np.pi) / 2.0) * (torch.sqrt(nu) / gamma) * torch.exp(-nu / 2.0)
    pre = torch.where(pre < torch.finfo(torch.float32).tiny, 0.0, pre)
    G = pre * ((1.0 + nu) * torch.special.i0(nu / 2.0) + nu * torch.special.i1(nu / 2.0))
    return torch.where(torch.isnan(G) | torch.isinf(G), gains.wf(xi), G)


def test_mmse_stsa_through_the_bessel_overflow():
    """At xi = 1e3, nu / 2 from 40 to 120: (1 + nu) i0(nu / 2) overflows
    float32 from nu / 2 = 86.03 on in both packages (torch.special.i0/i1 and
    jax.scipy.special.i0/i1 agree to 2e-7 and overflow at the same point),
    and both take the Wiener fallback there. The two branches lie 1.45e-3
    apart at the switch (G 1.000454 just before it, the Wiener gain
    0.999001). Just below it, for 84.65 <= nu / 2 <= 86.02, the prefactor
    is subnormal: the JAX package's CPU backend flushes it to zero and
    returns G = 0 (a fault of the JAX package, ROADMAP.md queue C), while
    the port keeps the subnormal and returns the estimator's value, within
    2e-3 of the fallback. With the prefactor flushed as JAX does, the port
    gives JAX's gain everywhere. Elsewhere: 1e-5."""
    xi = np.float32(1e3)
    half_nu = np.linspace(40.0, 120.0, 8001).astype(np.float32)
    gamma = (2.0 * half_nu * (1.0 + xi) / xi).astype(np.float32)
    g, g_j = _both(np.full_like(gamma, xi), gamma, "mmse-stsa")
    wf = np.float32(xi / (1.0 + xi))
    flushed = g_j == 0.0
    assert half_nu[flushed].min() >= 84.6 and half_nu[flushed].max() <= 86.05
    assert np.all(np.abs(g[flushed] - wf) <= 2e-3)
    np.testing.assert_allclose(g[~flushed], g_j[~flushed], rtol=1e-5, atol=0)
    fallback = g == wf
    switch = np.argmax(fallback)
    assert fallback[switch:].all() and (g_j[switch:] == wf).all()
    assert 86.0 <= half_nu[switch] <= 86.1
    assert abs(g[switch - 1] - wf) <= 2e-3
    g_f = _mmse_stsa_flushed(torch.full((gamma.size,), xi), torch.as_tensor(gamma))
    np.testing.assert_allclose(g_f.numpy(), g_j, rtol=1e-5, atol=0)


def test_dgwf_with_a_mask_matches_jax():
    """The constructive gain where the mask is true, the destructive one
    elsewhere; NaN where JAX gives NaN (xi = +inf: inf - inf)."""
    xi, gamma = (a.ravel() for a in np.meshgrid(VALUES, VALUES, indexing="ij"))
    cdm = np.random.RandomState(0).rand(xi.size) > 0.5
    g, g_j = _both(xi, gamma, "dgwf", cdm)
    np.testing.assert_allclose(g, g_j, rtol=1e-5, atol=1e-7, equal_nan=True)
    assert np.isfinite(g[xi < np.inf]).all()


def test_dgwf_without_a_mask_and_unknown_gains_raise():
    """JAX's dgwf without a mask fails in jnp.where (TypeError); the port
    says what is missing."""
    xi = np.ones(3, np.float32)
    with pytest.raises(TypeError):
        gains_j.gfunc(jnp.asarray(xi), jnp.asarray(xi), "dgwf")
    with pytest.raises(ValueError, match="cdm"):
        gains.gfunc(torch.as_tensor(xi), torch.as_tensor(xi), "dgwf")
    with pytest.raises(ValueError, match="Invalid gain"):
        gains.gfunc(torch.as_tensor(xi), torch.as_tensor(xi), "mmse")


# Measured on the CPU: with the JAX package's flushed prefactor, 1.7e-7 max
# abs against JAX's `stream`; held to 1e-5, as tests/test_torch_streaming.py
# holds the MMSE-LSA stream. With the port's own gain, up to 9.0e-3 on 3.3%
# of the samples: this input's xi_hat enters the band (xi about 170 at
# gamma = xi + 1) where the JAX gain is 0.
def test_streaming_enhancer_mmse_stsa_matches_jax(monkeypatch):
    kw = dict(d_model=32, n_blocks=5, d_f=16, k=3, max_d_rate=4)
    it_j = inp_tgt_selector("MagXi", N_d=512, N_s=256, K=512, f_s=16000,
                            map_type="DBNormalCDF", map_params=None)
    sample = (np.abs(np.random.RandomState(0).randn(64, 257)) ** 2).astype(np.float32)
    it_j = it_j.replace(xi_map=it_j.xi_map.with_stats(jnp.asarray(sample)))
    it = MagXi(xi_map=NormalCDF(use_db=True, **{
        k: torch.tensor(np.asarray(getattr(it_j.xi_map, k))) for k in ("mu", "sigma")}))
    net_j = network_selector("ResNetV2", 257, causal=True, unit_type="ReLU->LN->W+b",
                             outp_act="Sigmoid", **kw)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
        net_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 257))))
    x = (np.random.RandomState(2).randn(2, 256 * 30) * 3000).astype(np.int16)
    y_j = np.asarray(StreamingEnhancerJ(it_j, net_j, params, "mmse-stsa").stream(
        jnp.asarray(x)))
    se = StreamingEnhancer(it, ResNetV2(257, 257, **kw), from_flax_params(params),
                           "mmse-stsa", device="cpu")
    y = se.stream(x).numpy()
    assert np.abs(y).max() > 1e-3 and np.abs(y - y_j).max() > 1e-5
    monkeypatch.setitem(gains._GAIN_FNS, "mmse-stsa", _mmse_stsa_flushed)
    np.testing.assert_allclose(se.stream(x).numpy(), y_j, rtol=0, atol=1e-5)
