"""Framing and overlap-add at any hop (`deepxi_tpu_torch.sig.stft`,
`ops.kernels.spectral`) against the JAX package's, on the CPU: half overlap
(512/256), 75% overlap (512/128), N_d no multiple of N_s (512/192, 400/160)
and a zero-padded FFT (K > N_d), with lengths whose last frame runs past the
padded end. The same numpy inputs go to both; tolerance 1e-5 of the
waveform's scale (float32 sums in another order). The route the spectral
estimator and synthesiser take by framing is checked here with a spy (the
card's launch counts are in tests/test_torch_cuda.py)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.ops.kernels import spectral as spectral_j
from deepxi_tpu_torch import enhance
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models.tcn import ResNetV2, init_flax_like
from deepxi_tpu_torch.ops.kernels import spectral
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.sig import stft

# the module (the package's `sig.stft` name is its function)
stft_j = importlib.import_module("deepxi_tpu.sig.stft")
TOL = 1e-5
# (N_d, N_s, K)
FRAMINGS = [(512, 256, 512), (512, 128, 512), (512, 192, 512), (400, 160, 400),
            (400, 160, 512), (512, 128, 1024)]
IDS = [f"{a}-{b}-{c}" for a, b, c in FRAMINGS]


def _signal(n=3001, seed=0):
    return np.random.RandomState(seed).randn(2, n).astype(np.float32)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("N_d,N_s,K", FRAMINGS, ids=IDS)
def test_frame_and_overlap_add_match_jax(N_d, N_s, K):
    """Frames are the same samples (bitwise); overlap-add of the same frames
    agrees; a length one past a hop and a length under one frame too."""
    for n in (3001, N_s * 7 + 1, N_d - 5):
        x = _signal(n)
        fr = stft.frame(torch.as_tensor(x), N_d, N_s).numpy()
        np.testing.assert_array_equal(fr, np.asarray(stft_j.frame(jnp.asarray(x), N_d, N_s)))
        assert fr.shape[-2] == stft.n_frames(n, N_s)
        y = stft.overlap_and_add(torch.as_tensor(fr), N_s)
        _close(y, stft_j.overlap_and_add(jnp.asarray(fr), N_s))


@pytest.mark.parametrize("N_d,N_s,K", FRAMINGS, ids=IDS)
def test_stft_and_inverse_match_jax(N_d, N_s, K):
    """The FFT STFT, its magnitude and phase, and the inverse STFT and polar
    synthesis of the JAX spectra."""
    x = _signal()
    X = stft.stft(torch.as_tensor(x), N_d, N_s, K)
    X_j = np.asarray(stft_j.stft(jnp.asarray(x), N_d, N_s, K))
    _close(X.real, X_j.real)
    _close(X.imag, X_j.imag)
    y = stft.inverse_stft(torch.as_tensor(X_j), N_d, N_s, K)
    _close(y, stft_j.inverse_stft(jnp.asarray(X_j), N_d, N_s, K))
    mag, pha = np.abs(X_j), np.angle(X_j)
    y = stft.polar_synthesis(torch.as_tensor(mag), torch.as_tensor(pha), N_d, N_s, K)
    _close(y, stft_j.polar_synthesis(jnp.asarray(mag), jnp.asarray(pha), N_d, N_s, K))


@pytest.mark.parametrize("N_d,N_s,K", FRAMINGS, ids=IDS)
def test_matmul_dft_matches_jax(N_d, N_s, K):
    """`stft_reim`, `stft_mag` and `synthesis_from_reim` against the JAX
    package's at precision "highest"; a round trip gives the signal back
    where its frames overlap fully."""
    x = _signal()
    Y = spectral.stft_reim(torch.as_tensor(x), N_d, N_s, K)
    Y_j = np.asarray(spectral_j.stft_reim(jnp.asarray(x), N_d, N_s, K, "highest"))
    _close(Y, Y_j)
    _close(spectral.stft_mag(torch.as_tensor(x), N_d, N_s, K),
           spectral_j.stft_mag(jnp.asarray(x), N_d, N_s, K, "highest"))
    y = spectral.synthesis_from_reim(torch.as_tensor(Y_j), N_d, N_s, K)
    _close(y, spectral_j.synthesis_from_reim(jnp.asarray(Y_j), N_d, N_s, K, "highest"))
    inner = slice(N_d, x.shape[-1] - N_d)
    np.testing.assert_allclose(y.numpy()[:, inner], x[:, inner], rtol=0, atol=1e-4)


@pytest.mark.parametrize("N_s,kernel", [(256, True), (128, False), (192, False)])
def test_spectral_route_is_chosen_by_framing(monkeypatch, N_s, kernel):
    """The estimator and the gain synthesiser call the spectral kernels'
    wrappers only where `kernel_takes` the framing (N_d = 2 N_s); at any
    other they take the matrix products, with the same results as the
    kernels' plain versions would give."""
    calls = []

    def spy(fn):
        def wrapped(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(enhance, "stft_mag_fused", spy(spectral.stft_mag_fused))
    monkeypatch.setattr(enhance, "enhance_frames_fused", spy(spectral.enhance_frames_fused))
    assert spectral.kernel_takes(512, N_s, 512) == kernel
    net = ResNetV2(257, 257, n_blocks=2, d_model=16, d_f=8, k=3, max_d_rate=2)
    init_flax_like(net, torch.Generator().manual_seed(0))
    params = dict(net.state_dict())
    it = MagXi(N_s=N_s, xi_map=NormalCDF(use_db=True, mu=torch.zeros(257),
                                         sigma=torch.full((257,), 10.0)))
    x = (np.random.RandomState(1).randn(1, 4000) * 3000).astype(np.int16)
    xi, mag = enhance.make_xi_estimator(it, net, device="cpu")(params, x, with_mag=True)
    y = enhance.make_gain_synthesiser(it, net, enhance.noise_gain, device="cpu")(params, x)
    assert calls == (["stft_mag_fused", "enhance_frames_fused"] if kernel else [])
    T = stft.n_frames(4000, N_s)
    assert xi.shape == mag.shape == (1, T, 257) and y.shape == (1, (T - 1) * N_s + 512)
    mag_j = spectral_j.stft_mag(jnp.asarray(x / 32768.0, jnp.float32), 512, N_s, 512,
                                "highest")
    _close(mag, mag_j)
