"""The port's spectral kernels' plain versions and its a priori SNR
estimator against the JAX package on the CPU: `stft_mag_fused` against
`stft_mag_pallas` (Pallas interpret mode) and JAX `stft_mag`,
`enhance_frames_fused` plus overlap-add against `enhance_frames_pallas` plus
overlap-add, and `make_xi_estimator` against JAX `make_xi_estimator` on a
small ResNetV2 (biases moved off zero) and on the trained resnet-1.1c
artifact. Inputs are drawn by numpy from a seed. The kernels against their
plain versions on the card are in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.compat.artifact import load_flagship_artifact as load_flagship_j
from deepxi_tpu.enhance import make_xi_estimator as make_xi_estimator_j
from deepxi_tpu.inp_tgt import inp_tgt_selector
from deepxi_tpu.models import network_selector
from deepxi_tpu.ops.kernels import spectral as spectral_j
from deepxi_tpu.ops.kernels.spectral import enhance_frames_pallas, stft_mag_pallas
from deepxi_tpu.sig.mix import normalise as normalise_j
from deepxi_tpu.sig.stft import overlap_and_add as overlap_and_add_j
from deepxi_tpu_torch.compat.artifact import (from_flax_params,
                                              load_flagship_artifact)
from deepxi_tpu_torch.enhance import make_xi_estimator
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models.tcn import ResNetV2
from deepxi_tpu_torch.ops.kernels import spectral
from deepxi_tpu_torch.ops.kernels.tcn_fused import resnetv2_apply_fused
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.sig.stft import hop_rows, overlap_and_add

N_d, N_s, K = 512, 256, 512
# (N_s, K) of the kernels' domain: the main path's; 8 kHz; N_d = 400 < K
# with 32 not dividing N_s; a 48 ms hop
SHAPES = [(256, 512), (128, 256), (200, 512), (768, 2048)]


@pytest.fixture(scope="module", params=[20000, 200], ids=["T79", "T1"])
def wav(request):
    """tests/test_kernels.py's [2, 20000] waveform, and a 200-sample one
    (T = 1 frame at N_s >= 200)."""
    rng = np.random.RandomState(0)
    return (rng.randn(2, request.param) * 0.1).astype(np.float32)


def _x2d_j(wav, N_s):
    """The hop rows as tests/test_kernels.py builds them for the kernel."""
    T = -(-wav.shape[-1] // N_s)
    pad = (T + 1) * N_s - wav.shape[-1]
    return jnp.pad(jnp.asarray(wav), ((0, 0), (0, pad))).reshape(wav.shape[0], T + 1, N_s)


# Measured on the CPU: 8.9e-7 of the output's max abs at most over the four
# shapes, against the Pallas kernel and against JAX stft_mag; held to 1e-5.
@pytest.mark.parametrize("N_s,K", SHAPES)
def test_stft_mag_fused_matches_jax(wav, N_s, K):
    N_d = 2 * N_s
    x2d = hop_rows(torch.as_tensor(wav), N_s)
    np.testing.assert_array_equal(x2d.numpy(), np.asarray(_x2d_j(wav, N_s)))
    out = spectral.stft_mag_fused(x2d, N_d, K).numpy()
    for ref in (stft_mag_pallas(_x2d_j(wav, N_s), N_d, K),
                spectral_j.stft_mag(jnp.asarray(wav), N_d, N_s, K, "highest")):
        ref = np.asarray(ref)
        assert out.shape == ref.shape == (2, x2d.shape[1] - 1, K // 2 + 1)
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


# Measured on the CPU: 2.2e-7 abs at most over the four shapes; held to
# 2e-6, the limit of tests/test_kernels.py for the JAX pair against polar
# synthesis.
@pytest.mark.parametrize("N_s,K", SHAPES)
def test_enhance_frames_fused_matches_jax(wav, N_s, K):
    N_d = 2 * N_s
    Y = np.array(spectral_j.stft_reim(jnp.asarray(wav), N_d, N_s, K, "highest"))
    G = np.random.RandomState(2).uniform(0.1, 1.0, Y.shape[:2] + (K // 2 + 1,)
                                         ).astype(np.float32)
    ref = np.asarray(overlap_and_add_j(
        enhance_frames_pallas(jnp.asarray(Y), jnp.asarray(G), N_d, N_s, K), N_s))
    fr = spectral.enhance_frames_fused(torch.as_tensor(Y), torch.as_tensor(G), N_d, N_s, K)
    assert fr.shape == Y.shape[:2] + (N_d,)
    y = overlap_and_add(fr, N_s).numpy()
    assert y.shape == ref.shape
    np.testing.assert_allclose(y, ref, rtol=0, atol=2e-6)


def test_wrappers_take_plain_version_on_cpu():
    rng = np.random.RandomState(3)
    x2d = torch.as_tensor(rng.randn(2, 6, N_s).astype(np.float32))
    Y = torch.as_tensor(rng.randn(2, 5, 2 * (K // 2 + 1)).astype(np.float32))
    G = torch.as_tensor(rng.rand(2, 5, K // 2 + 1).astype(np.float32))
    counts = (spectral.stft_mag_fused.launches, spectral.enhance_frames_fused.launches)
    torch.testing.assert_close(spectral.stft_mag_fused(x2d, N_d, K),
                               spectral.stft_mag_fused_ref(x2d, N_d, K), rtol=0, atol=0)
    torch.testing.assert_close(spectral.enhance_frames_fused(Y, G, N_d, N_s, K),
                               spectral.enhance_frames_fused_ref(Y, G, N_d, N_s, K),
                               rtol=0, atol=0)
    assert counts == (spectral.stft_mag_fused.launches, spectral.enhance_frames_fused.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        spectral.stft_mag_fused(x2d.clone().requires_grad_(True), N_d, K)


def test_bad_input_raises():
    """N_d != 2 N_s, widths that do not match N_s or K, a dtype, fewer
    than two hop rows, and a K outside the kernels' domain (not a power of
    two, or under N_d) raise on the CPU as on the card."""
    x2d = torch.zeros(1, 4, N_s)
    Y, G = torch.zeros(1, 3, 2 * (K // 2 + 1)), torch.zeros(1, 3, K // 2 + 1)
    for call in (lambda: spectral.stft_mag_fused(x2d, 400, K),
                 lambda: spectral.stft_mag_fused(x2d, N_d, 500),
                 lambda: spectral.stft_mag_fused(x2d, N_d, 256),
                 lambda: spectral.enhance_frames_fused(Y[..., :502], G[..., :251],
                                                       N_d, N_s, 500),
                 lambda: spectral.stft_mag_fused(x2d[:, :, :128], N_d, K),
                 lambda: spectral.stft_mag_fused(x2d.double(), N_d, K),
                 lambda: spectral.stft_mag_fused(x2d[:, :1], N_d, K),
                 lambda: spectral.enhance_frames_fused(Y, G, N_d, 200, K),
                 lambda: spectral.enhance_frames_fused(Y[..., :500], G, N_d, N_s, K),
                 lambda: spectral.enhance_frames_fused(Y, G[:, :2], N_d, N_s, K)):
        with pytest.raises(ValueError):
            call()


# -- the xi-hat estimator ------------------------------------------------------

def _capture(apply):
    """apply_fn that keeps the network output it returns."""
    seen = {}

    def fn(p, m):
        seen["tgt"] = apply(p, m)
        return seen["tgt"]
    return fn, seen


def _xi_db_err(xi, xi_j, tgt_j):
    """Largest ξ̂ difference in dB over bins whose network output lies in
    [1e-3, 1 - 1e-3] (nearer 0 and 1 the inverse map magnifies rounding)."""
    keep = (tgt_j >= 1e-3) & (tgt_j <= 1 - 1e-3)
    return np.abs(10 * np.log10(xi[keep]) - 10 * np.log10(xi_j[keep])).max()


# Measured on the CPU: network output 4.7e-6 abs, ξ̂ 1.5e-4 dB. The output
# is held to 1e-4, as tests/test_torch_tcn_fused.py holds the plain ResNetV2
# to flax on small random nets (flax's one-pass LayerNorm variance: up to
# 3.2e-5 there), and ξ̂ to 1e-2 dB.
def test_xi_estimator_matches_jax_small():
    it_j = inp_tgt_selector("MagXi", N_d=N_d, N_s=N_s, K=K, f_s=16000,
                            map_type="DBNormalCDF", map_params=None)
    sample = (np.abs(np.random.RandomState(0).randn(64, 257)) ** 2).astype(np.float32)
    it_j = it_j.replace(xi_map=it_j.xi_map.with_stats(jnp.asarray(sample)))
    it = MagXi(xi_map=NormalCDF(use_db=True, **{
        k: torch.as_tensor(np.array(getattr(it_j.xi_map, k))) for k in ("mu", "sigma")}))
    small = dict(d_model=32, n_blocks=3, d_f=16, k=3, max_d_rate=2)
    net_j = network_selector("ResNetV2", 257, causal=True, unit_type="ReLU->LN->W+b",
                             outp_act="Sigmoid", **small)
    params = net_j.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 257)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
                                    params)
    x = (np.random.RandomState(1).randn(2, 8192) * 3000).astype(np.int16)
    xi_j = np.asarray(make_xi_estimator_j(it_j, net_j)(params, jnp.asarray(x)))
    tgt_j = np.asarray(net_j.apply(params, spectral_j.stft_mag(
        normalise_j(jnp.asarray(x)), N_d, N_s, K, "highest")))
    net = ResNetV2(257, 257, **small)
    apply, seen = _capture(lambda p, m: torch.func.functional_call(net, p, (m,)))
    xi = make_xi_estimator(it, net, apply_fn=apply, device="cpu")(
        from_flax_params(params), x).numpy()
    assert xi.shape == xi_j.shape == (2, 32, 257)
    assert np.abs(seen["tgt"].numpy() - tgt_j).max() <= 1e-4
    assert _xi_db_err(xi, xi_j, tgt_j) <= 1e-2


@pytest.fixture(scope="module")
def artifact_j():
    it, net, params, noisy, _ = load_flagship_j()
    x = jnp.asarray(noisy[None])
    xi = np.asarray(make_xi_estimator_j(it, net)(params, x))
    tgt = np.asarray(net.apply(params, spectral_j.stft_mag(normalise_j(x), N_d, N_s, K,
                                                           "highest")))
    return xi, tgt


# Measured on the CPU: network output 1.3e-6 (plain) and 1.2e-6 (fused
# route's plain versions) abs, ξ̂ 1.9e-4 dB; held to 1e-5 and 1e-2 dB.
@pytest.mark.parametrize("route", ["plain", "fused"])
def test_xi_estimator_matches_jax_on_trained_artifact(artifact_j, route):
    xi_j, tgt_j = artifact_j
    art = load_flagship_artifact(device="cpu")
    apply, seen = _capture({
        "plain": lambda p, m: torch.func.functional_call(art.net, p, (m,)),
        "fused": lambda p, m: resnetv2_apply_fused(p, m)}[route])
    xi = make_xi_estimator(art.inp_tgt, art.net, apply_fn=apply, device="cpu")(
        art.params, art.noisy[None]).numpy()
    assert xi.shape == xi_j.shape == (1, 250, 257)
    assert np.isfinite(xi).all()
    assert np.abs(seen["tgt"].numpy() - tgt_j).max() <= 1e-5
    assert _xi_db_err(xi, xi_j, tgt_j) <= 1e-2
