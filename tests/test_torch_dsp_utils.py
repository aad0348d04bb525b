"""The port's DSP utilities against the JAX package's on the CPU: the ASR
features (`dsp.features`), the adaptive filters (`dsp.adaptive`) and the
energy VAD (`dsp.vad`), on 2,000-sample signals with 16 taps (and a 3 s
signal of speech bursts for the VAD's segments). The recursions are held
to JAX in float64 first (JAX under `jax_enable_x64`, restored after), to
1e-9 of the output's scale; then each package's float32 run is held to its
own float64 run, the port no further than twice JAX's distance. The
features agree to 1e-5 of their scale, the VAD decisions exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.dsp import adaptive as adaptive_j
from deepxi_tpu.dsp import features as features_j
from deepxi_tpu.dsp import vad as vad_j
from deepxi_tpu_torch.dsp import adaptive, features, vad

N, TAPS = 2000, 16


@pytest.fixture()
def x64():
    """JAX in float64 for one test, restored afterwards."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def signals():
    """Excitation x and desired d = an FIR of x plus noise, float64."""
    rng = np.random.RandomState(0)
    x = rng.randn(N)
    h = rng.randn(TAPS) * np.exp(-np.arange(TAPS) / 4.0)
    d = np.convolve(x, h)[:N] + 0.05 * rng.randn(N)
    return x, d


FILTERS = {
    "nlms": lambda m, x, d: m.nlms(x, d, n_taps=TAPS, mu=0.5),
    "lms": lambda m, x, d: m.lms(x, d, n_taps=TAPS, mu=0.01),
    "block_nlms": lambda m, x, d: m.block_nlms(x, d, n_taps=TAPS, mu=0.5, block=256),
    "cancel_noise": lambda m, x, d: (m.cancel_noise(d, x, n_taps=TAPS, mu=0.5),),
}


def _run(name, x, d, dtype):
    """(port outputs, JAX outputs) of filter `name` in `dtype`, float64 arrays."""
    out = FILTERS[name](adaptive, torch.as_tensor(x.astype(dtype)),
                        torch.as_tensor(d.astype(dtype)))
    out_j = FILTERS[name](adaptive_j, jnp.asarray(x.astype(dtype)), jnp.asarray(d.astype(dtype)))
    return ([t.numpy().astype(np.float64) for t in out],
            [np.asarray(a).astype(np.float64) for a in out_j])


def _dist(a, ref):
    return max(np.abs(u - v).max() / max(np.abs(v).max(), 1e-30) for u, v in zip(a, ref))


@pytest.mark.parametrize("name", FILTERS)
def test_recursion_float64_matches_jax(x64, signals, name):
    out, out_j = _run(name, *signals, np.float64)
    assert out[0].dtype == np.float64 and len(out) == len(out_j)
    for a, b in zip(out, out_j):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), name


@pytest.mark.parametrize("name", FILTERS)
def test_recursion_float32_near_float64(signals, name):
    """Each package's float32 run against its own float64 run (float64 run
    under the x64 flag, restored): the port at most twice JAX's distance."""
    jax.config.update("jax_enable_x64", True)
    try:
        ref, ref_j = _run(name, *signals, np.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    out, out_j = _run(name, *signals, np.float32)
    d_port, d_jax = _dist(out, ref), _dist(out_j, ref_j)
    assert 0.0 < d_jax < 1e-3
    assert d_port <= 2.0 * d_jax, (d_port, d_jax)


@pytest.fixture(scope="module")
def speechy():
    """[2, 2000] float32 frames of int16-scale noise and tones."""
    rng = np.random.RandomState(1)
    t = np.arange(N) / 16000.0
    x = np.stack([3000 * np.sin(2 * np.pi * 440 * t) + 300 * rng.randn(N),
                  2000 * rng.randn(N)])
    return x.astype(np.float32)


FEATURES = {
    "preemphasis": lambda m, x: m.preemphasis(x),
    "framesig": lambda m, x: m.framesig(x, 400, 160),
    "powspec": lambda m, x: m.powspec(m.framesig(x, 400, 160), 512),
    "fbank": lambda m, x: m.fbank(x)[0],
    "fbank_energy": lambda m, x: m.fbank(x, nfilt=40, lowfreq=100, highfreq=7000)[1],
    "logfbank": lambda m, x: m.logfbank(x),
    "mfcc": lambda m, x: m.mfcc(x),
    "mfcc_no_energy": lambda m, x: m.mfcc(x, numcep=20, ceplifter=0, append_energy=False),
    "ssc": lambda m, x: m.ssc(x),
    "delta": lambda m, x: m.delta(m.mfcc(x), N=2),
}


@pytest.mark.parametrize("name", FEATURES)
def test_features_match_jax(speechy, name):
    y = FEATURES[name](features, torch.as_tensor(speechy)).numpy()
    y_j = np.asarray(FEATURES[name](features_j, jnp.asarray(speechy)))
    assert y.shape == y_j.shape and y.dtype == np.float32
    assert np.abs(y - y_j).max() <= 1e-5 * np.abs(y_j).max(), name


def test_filterbank_and_dct_tables_match_jax():
    for args in ((26, 512, 16000), (40, 512, 16000, 100.0, 7000.0), (20, 256, 8000)):
        np.testing.assert_array_equal(features.get_filterbanks(*args),
                                      features_j.get_filterbanks(*args))
    np.testing.assert_array_equal(features._dct2_ortho(26, 13), features_j._dct2_ortho(26, 13))


@pytest.fixture(scope="module")
def bursts():
    """3 s at 16 kHz: noise with three tone bursts and a short click, int16
    scale; and the first 2,000 samples."""
    rng = np.random.RandomState(2)
    fs = 16000
    t = np.arange(3 * fs) / fs
    x = 100 * rng.randn(3 * fs)
    for a, b in ((0.3, 0.9), (1.0, 1.2), (1.9, 2.6)):
        sl = slice(int(a * fs), int(b * fs))
        x[sl] += 4000 * np.sin(2 * np.pi * 300 * t[sl])
    x[int(2.8 * fs):int(2.8 * fs) + 300] += 5000
    return x.astype(np.float32)


@pytest.mark.parametrize("n", [N, 3 * 16000])
def test_vad_matches_jax(bursts, n):
    x = bursts[:n]
    e = vad.frame_energies(torch.as_tensor(x), 16000).numpy()
    e_j = np.asarray(vad_j.frame_energies(jnp.asarray(x), 16000))
    assert np.abs(e - e_j).max() <= 1e-6 * np.abs(e_j).max()
    for kw in ({}, {"margin_db": 6.0, "floor_quantile": 0.2}, {"frame_ms": 20.0}):
        v = vad.energy_vad(x, 16000, **kw)
        np.testing.assert_array_equal(v, vad_j.energy_vad(x, 16000, **kw))
        for sm in ({}, {"min_speech": 2, "join": 5}):
            np.testing.assert_array_equal(vad.smooth_vad(v, **sm), vad_j.smooth_vad(v, **sm))
        assert vad.speech_segments(x, 16000, **kw) == vad_j.speech_segments(x, 16000, **kw)


def test_vad_segments_find_the_bursts(bursts):
    """Two segments in both packages: the bursts at 0.3-0.9 s and 1.0-1.2 s
    joined across their 10-frame gap (under 50), and the third burst with
    the click 0.2 s after it."""
    seg = vad.speech_segments(torch.as_tensor(bursts), 16000)
    assert seg == vad_j.speech_segments(bursts, 16000)
    assert seg == [(4800, 19200), (30400, 45120)]
