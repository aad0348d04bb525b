"""The port's signal chain, maps and gains against the JAX package and the
tf.signal golden fixture. Inputs are made with numpy and cross between the
frameworks as numpy arrays; JAX runs on the CPU."""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.ops import gains as gains_j
from deepxi_tpu.ops import maps as maps_j
from deepxi_tpu.ops import special as special_j
from deepxi_tpu.ops.kernels import spectral as spectral_j
from deepxi_tpu_torch.ops import gains, maps, special
from deepxi_tpu_torch.ops.kernels import spectral
from deepxi_tpu_torch.sig import mix, stft

# deepxi_tpu.sig re-exports functions named `stft` and `mix`
stft_j = importlib.import_module("deepxi_tpu.sig.stft")
mix_j = importlib.import_module("deepxi_tpu.sig.mix")
GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden", "stft.npz"))


def _t(a):
    return torch.as_tensor(np.array(a))


def test_hamming_is_symmetric_and_matches_jax():
    w = stft._hamming_np(512)
    np.testing.assert_array_equal(w, stft_j._hamming_np(512))
    np.testing.assert_allclose(w, GOLDEN["window"], rtol=0, atol=1e-6)
    assert w[0] == w[-1]  # periodic=False


@pytest.mark.parametrize("n", [7001, 7168, 100])
def test_frame_and_overlap_add_match_jax(n):
    """pad_end framing (ragged, whole-hop and sub-frame lengths) is exact;
    overlap-add agrees to f32 rounding."""
    N_d, N_s = 512, 256
    x = np.random.RandomState(0).randn(2, n).astype(np.float32)
    fr = stft.frame(_t(x), N_d, N_s).numpy()
    fr_j = np.asarray(stft_j.frame(jnp.asarray(x), N_d, N_s))
    np.testing.assert_array_equal(fr, fr_j)
    assert fr.shape[-2] == stft.n_frames(n, N_s) == stft_j.n_frames(n, N_s)
    y = stft.overlap_and_add(_t(fr_j), N_s).numpy()
    y_j = np.asarray(stft_j.overlap_and_add(jnp.asarray(fr_j), N_s))
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(stft._synthesis_window_np(N_d, N_s),
                                  stft_j._synthesis_window_np(N_d, N_s))


def test_framing_takes_half_overlap_only():
    """Half overlap takes the hop-row reshape; any other hop (here 400/160,
    where N_d is no multiple of N_s) the gather and scatter-add, which agree
    with the JAX package's (tests/test_torch_framing.py covers the rest)."""
    x = np.random.RandomState(1).randn(1000).astype(np.float32)
    fr = stft.frame(_t(x), 400, 160).numpy()
    np.testing.assert_array_equal(fr, np.asarray(stft_j.frame(jnp.asarray(x), 400, 160)))
    y = stft.overlap_and_add(_t(fr), 160).numpy()
    np.testing.assert_allclose(y, np.asarray(stft_j.overlap_and_add(jnp.asarray(fr), 160)),
                               rtol=0, atol=1e-6)


def test_wav_round_trip(tmp_path):
    """save_wav/read_wav on the stdlib: float input is scaled by 32768 and
    truncated to int16; the JAX package reads the file identically."""
    from deepxi_tpu.data.wavio import read_wav as read_wav_j
    from deepxi_tpu_torch.data.wavio import read_wav, save_wav
    y = np.random.RandomState(7).uniform(-0.9, 0.9, 3000).astype(np.float32)
    path = str(tmp_path / "a" / "y.wav")
    save_wav(path, y, 16000)
    x, f_s = read_wav(path)
    assert f_s == 16000 and x.dtype == np.int16
    np.testing.assert_array_equal(x, (y * 32768.0).astype(np.int16))
    np.testing.assert_array_equal(x, read_wav_j(path)[0])
    # another rate is resampled, as the JAX package does (its native
    # decoder, where built, rounds within one int16 step of scipy's filter)
    x8, f_s8 = read_wav(path, f_s=8000)
    x8_j = read_wav_j(path, f_s=8000)[0]
    assert f_s8 == 8000 and x8.shape == x8_j.shape == (1500,)
    assert np.abs(x8.astype(np.int32) - x8_j).max() <= 1


@pytest.mark.parametrize("key", ["1", "2"])
def test_stft_reim_matches_jax_and_golden(key):
    x = GOLDEN[f"x{key}"]
    Y = spectral.stft_reim(_t(x), 512, 256, 512).numpy()
    Y_j = np.asarray(spectral_j.stft_reim(jnp.asarray(x), 512, 256, 512))
    # f32 products of 512 terms in another order: 1e-5 absolute on |X| ~ 10
    np.testing.assert_allclose(Y, Y_j, rtol=0, atol=1e-4)
    ref = np.concatenate([GOLDEN[f"X{key}_re"], GOLDEN[f"X{key}_im"]], -1)
    np.testing.assert_allclose(Y, ref, rtol=0, atol=2e-3)  # golden's own tol
    mag = spectral.stft_mag(_t(x), 512, 256, 512).numpy()
    np.testing.assert_allclose(mag, np.abs(ref[..., :257] + 1j * ref[..., 257:]),
                               rtol=0, atol=2e-3)


def test_synthesis_from_reim_matches_jax_and_golden():
    Y = np.concatenate([GOLDEN["X1_re"], GOLDEN["X1_im"]], -1)
    y = spectral.synthesis_from_reim(_t(Y), 512, 256, 512).numpy()
    y_j = np.asarray(spectral_j.synthesis_from_reim(jnp.asarray(Y), 512, 256, 512))
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(y, GOLDEN["y1"], rtol=0, atol=1e-5)
    G = np.random.RandomState(1).rand(28, 257).astype(np.float32)
    np.testing.assert_allclose(
        spectral.apply_gain_reim(_t(Y), _t(G), 512).numpy(),
        np.asarray(spectral_j.apply_gain_reim(jnp.asarray(Y), jnp.asarray(G), 512)),
        rtol=0, atol=0)


def test_normalise_matches_jax():
    x = (np.random.RandomState(2).randn(3, 100) * 8000).astype(np.int16)
    np.testing.assert_array_equal(mix.normalise(_t(x)).numpy(),
                                  np.asarray(mix_j.normalise(jnp.asarray(x))))


def test_exp1_matches_jax_including_edges():
    x = np.concatenate([[0.0, 1e-30, 1e-12, 1e-6, 1.0, np.inf],
                        np.logspace(-8, 2.5, 200)]).astype(np.float32)
    e = special.exp1(_t(x)).numpy()
    e_j = np.asarray(special_j.exp1(jnp.asarray(x)))
    assert np.isfinite(e[1:]).all() and e[-1 - 200] == 0.0  # E1(inf) = 0
    # same float32 formula: 1e-6 relative (log/exp rounding differs); the
    # atol only covers subnormal results (x > 87), which one side flushes
    np.testing.assert_allclose(e, e_j, rtol=1e-6, atol=1e-37)


def _normal_cdf_pair():
    rng = np.random.RandomState(3)
    mu = rng.randn(257).astype(np.float32) * 10
    sigma = (np.abs(rng.randn(257)) * 5 + 1).astype(np.float32)
    return (maps.NormalCDF(use_db=True, mu=_t(mu), sigma=_t(sigma)),
            maps_j.NormalCDF(use_db=True, mu=jnp.asarray(mu),
                             sigma=jnp.asarray(sigma)))


def test_normal_cdf_inverse_matches_jax_including_one():
    m, m_j = _normal_cdf_pair()
    xb = np.random.RandomState(4).rand(10, 257).astype(np.float32)
    xb[0] = 1.0  # saturated sigmoid: erfinv(1) = inf
    xb[1] = 0.0
    xi = m.inverse(_t(xb)).numpy()
    xi_j = np.asarray(m_j.inverse(jnp.asarray(xb)))
    assert np.isposinf(xi[0]).all() and np.isposinf(xi_j[0]).all()
    np.testing.assert_array_equal(xi[1], xi_j[1])  # 0 both
    # erfinv then 10^(x/10): 1e-5 relative (a dB rounding of 4e-6 dB)
    np.testing.assert_allclose(xi[2:], xi_j[2:], rtol=1e-5, atol=0)
    x = (np.abs(np.random.RandomState(5).randn(10, 257)) * 3).astype(np.float32)
    np.testing.assert_allclose(m.map(_t(x)).numpy(),
                               np.asarray(m_j.map(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


def test_mmse_lsa_matches_jax():
    rng = np.random.RandomState(6)
    xi = np.concatenate([[0.0, 1e-13, 1e12, np.inf],
                         10 ** rng.uniform(-4, 6, 400)]).astype(np.float32)
    gamma = xi + 1.0
    g = gains.gfunc(_t(xi), _t(gamma), "mmse-lsa").numpy()
    g_j = np.asarray(gains_j.gfunc(jnp.asarray(xi), jnp.asarray(gamma), "mmse-lsa"))
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, g_j, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        gains.gfunc(_t(xi), _t(gamma), "no-such-gain")
