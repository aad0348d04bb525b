"""Objective testing and the spectral-distortion study of the port against
the JAX package on the CPU: `DeepXiTorch.test` against `DeepXiTPU.test`
(per-condition scores, the CSV, `average.csv` and `results.txt` layouts, an
unmatched noisy file skipped), `spectral_distortion` for the xi and gamma
targets, and `read_wav`/`wav_length` on 8-, 16- and 32-bit, stereo, 8 kHz
and 44.1 kHz files. A tiny dataset laid out as tests/test_framework.py's;
a small ResNetV2 and a small MHANetV3 with the same seeded weights in both
packages (biases moved off zero, crossing through the bridge) and the same
map statistics. The JAX package runs its plain flax network and
`make_enhancer` at "highest" precision; the port runs `fast_apply()` (the
kernel wrappers' plain versions here)."""

import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepxi_tpu.config import Config as ConfigJ
from deepxi_tpu.data.wavio import read_wav as read_wav_j
from deepxi_tpu.data.wavio import wav_length as wav_length_j
from deepxi_tpu.framework import DeepXiTPU
from deepxi_tpu.inp_tgt import inp_tgt_selector
from deepxi_tpu.models import network_selector
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.config import Config
from deepxi_tpu_torch.data.wavio import read_wav, save_wav, wav_length
from deepxi_tpu_torch.framework import DeepXiTorch

NETS = {
    "resnet": dict(network_type="ResNetV2", k=3, max_d_rate=2,
                   unit_type="ReLU->LN->W+b", d_model=32, n_blocks=3, d_f=16),
    "mhanet": dict(network_type="MHANetV3", max_len=128, d_model=32, n_blocks=2,
                   n_heads=4),
}
# Measured on the CPU (both nets): per-condition scores within 3e-7 (PESQ,
# MOS-LQO, composites), 1.3e-6 % (STOI, eSTOI) and 2e-7 dB (SegSNR, SNR);
# spectral distortion within 3e-6 dB. Held to the limits below.
SCORE_TOL = {"STOI": 0.1, "eSTOI": 0.1, "SegSNR": 1e-2, "SNR": 1e-2}
SCORE_TOL_OTHER = 1e-3
SD_TOL_DB = 1e-3


def speechlike(n, seed, fs=16000):
    """Broadband noise under a 4 Hz envelope (tests/test_metrics.py's): no
    spectral bin near 0, where the dB of an SNR is rounding noise (a pure
    tone's sidelobes put whole bins there)."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / fs
    return (rng.randn(n) * (0.55 + 0.45 * np.sin(2 * np.pi * 4.0 * t)) * 6000
            ).astype(np.int16)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Test clean speech, noisy speech named `<clean>_<noise>_<snr>dB`
    (and one noisy file no clean name matches), and noise clips exactly as
    long as the speech."""
    root = tmp_path_factory.mktemp("set")
    rng = np.random.RandomState(0)
    for i, (noise, snr) in enumerate((("white", 5), ("babble", 0))):
        s = speechlike(24000 + 4000 * i, 10 + i)
        d = (rng.randn(len(s)) * 2000).astype(np.int16)
        x = (s.astype(np.int32) + d).clip(-32768, 32767).astype(np.int16)
        save_wav(str(root / "test_clean_speech" / f"c{i}.wav"), s, 16000)
        save_wav(str(root / "test_noisy_speech" / f"c{i}_{noise}_{snr}dB.wav"), x, 16000)
        save_wav(str(root / "test_noise" / f"n{i}.wav"),
                 (rng.randn(len(s)) * 2000).astype(np.int16), 16000)
    save_wav(str(root / "test_noisy_speech" / "zz_white_5dB.wav"),
             (rng.randn(20000) * 2000).astype(np.int16), 16000)
    return root


@pytest.fixture(scope="module", params=sorted(NETS))
def frameworks(request, dataset, tmp_path_factory):
    """(port's DeepXiTorch, its params, JAX's DeepXiTPU, its params) for one
    net, each with its own log directory, `metric_workers` 1."""
    tmp = tmp_path_factory.mktemp(request.param)
    net_kw = NETS[request.param]
    paths = dict(data_path=str(tmp / "data"), model_path=str(tmp / "model"),
                 test_x_path=str(dataset / "test_noisy_speech"),
                 test_s_path=str(dataset / "test_clean_speech"),
                 test_d_path=str(dataset / "test_noise"), metric_workers=1,
                 min_snr=0, max_snr=5, sd_snr_levels=[-5, 5])
    dx_j = DeepXiTPU.__new__(DeepXiTPU)
    dx_j.cfg = ConfigJ(ver="tiny", causal=True, log_path=str(tmp / "log_j"), **paths,
                       **net_kw)
    it_j = inp_tgt_selector("MagXi", N_d=512, N_s=256, K=512, f_s=16000,
                            map_type="DBNormalCDF", map_params=None)
    rng = np.random.RandomState(1)
    sample = (np.abs(rng.randn(32, 257)) ** 2).astype(np.float32)
    dx_j.inp_tgt = it_j.replace(xi_map=it_j.xi_map.with_stats(jnp.asarray(sample)))
    dx_j.network = network_selector(net_kw["network_type"], 257,
                                    **dx_j.cfg.network_kwargs())
    params = dx_j.network.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 257)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
                                    params)
    (tmp / "data").mkdir()
    np.savez(tmp / "data" / "tiny_stats.npz",
             **{f"xi_map.{k}": np.asarray(getattr(dx_j.inp_tgt.xi_map, k))
                for k in ("mu", "sigma")})
    dx = DeepXiTorch(Config(ver="tiny", causal=True, log_path=str(tmp / "log"), **paths,
                            **net_kw), device="cpu")
    return dx, from_flax_params(params), dx_j, params


@pytest.fixture(scope="module")
def tested(frameworks):
    """Both packages' test() results on the same set."""
    dx, p, dx_j, p_j = frameworks
    kw = dict(epochs=[1], gains=["mmse-lsa"])
    return dx.test(params=p, **kw), dx_j.test(params=p_j, **kw)


def test_test_scores_match_jax(tested, capsys):
    ours, theirs = (r[(1, "mmse-lsa")] for r in tested)
    assert set(ours) == set(theirs)
    metrics = {k[2] for k in ours}
    assert metrics == {"STOI", "eSTOI", "PESQ", "MOS-LQO", "CSIG", "CBAK", "COVL",
                       "SegSNR", "SNR"}
    # the unmatched noisy file is skipped: one utterance a condition
    assert {(k[0], k[1]) for k in ours} == {("white", 5), ("babble", 0)}
    for k, v in ours.items():
        assert len(v) == 1 and np.isfinite(v[0])
        assert abs(v[0] - theirs[k][0]) <= SCORE_TOL.get(k[2], SCORE_TOL_OTHER), \
            (k, v, theirs[k])


def test_unmatched_noisy_file_warns(frameworks, capsys, tmp_path):
    dx, p, _, _ = frameworks
    old = dx.cfg
    try:
        dx.cfg = dx.cfg.replace(log_path=str(tmp_path))
        dx.test(params=p, epochs=[1], gains=["mmse-lsa"])
    finally:
        dx.cfg = old
    out = capsys.readouterr().out
    assert "no clean reference matches 'zz_white_5dB'; skipping" in out


def _rows(log_path, name):
    with open(os.path.join(log_path, "results", name)) as f:
        return [line.rstrip("\n").split(",") for line in f]


@pytest.mark.parametrize("name", ["tiny_e1_mmse-lsa.csv", "average.csv", "results.txt"])
def test_results_files_match_jax_layout(tested, frameworks, name):
    """The same header, the same rows by condition and version, the same
    columns; each value within the score tolerance of the JAX package's
    (written with two decimals)."""
    dx, _, dx_j, _ = frameworks
    rows, rows_j = _rows(dx.cfg.log_path, name), _rows(dx_j.cfg.log_path, name)
    assert rows[0] == rows_j[0] and len(rows) == len(rows_j)
    if name == "results.txt":
        assert rows[0] == ["ver", " CSIG", " CBAK", " COVL", " PESQ", " STOI",
                           " SegSNR", " SNR"]
    key = 1 if name == "average.csv" or name == "results.txt" else 2
    for r, r_j in zip(rows[1:], rows_j[1:]):
        assert r[:key] == r_j[:key] and len(r) == len(r_j) == len(rows[0])
        for v, v_j in zip(r[key:], r_j[key:]):  # an absent condition: empty cells
            assert (v == v_j == "") or abs(float(v) - float(v_j)) <= 0.1 + 1e-9


@pytest.mark.parametrize("target", ["xi", "gamma"])
def test_spectral_distortion_matches_jax(frameworks, target):
    """Noise clips as long as the speech: both packages mix at offset 0."""
    dx, p, dx_j, p_j = frameworks
    ours = dx.spectral_distortion(params=p, epochs=[1], target=target)
    theirs = dx_j.spectral_distortion(params=p_j, epochs=[1], target=target)
    assert set(ours) == set(theirs) == {(1, -5), (1, 5)}
    for k in ours:
        assert np.isfinite(ours[k]) and abs(ours[k] - theirs[k]) <= SD_TOL_DB, \
            (k, ours[k], theirs[k])
    suffix = "spect_dist" if target == "xi" else "spect_dist_gamma"
    rows = _rows(dx.cfg.log_path, f"tiny_e1_{suffix}.csv")
    assert rows == [r for r in _rows(dx_j.cfg.log_path, f"tiny_e1_{suffix}.csv")][:1] + \
        rows[1:] and rows[0] == ["snr_db", f"{target}_spectral_distortion_db"]
    assert [r[0] for r in rows[1:]] == ["-5", "5"]


def test_spectral_distortion_refuses_bogus_target_and_short_noise(frameworks, tmp_path):
    dx, p, _, _ = frameworks
    with pytest.raises(ValueError, match="xi|gamma"):
        dx.spectral_distortion(params=p, epochs=[1], target="bogus")
    save_wav(str(tmp_path / "short.wav"), np.ones(1000, np.int16), 16000)
    old = dx.cfg
    try:
        dx.cfg = dx.cfg.replace(test_d_path=str(tmp_path))
        with pytest.raises(ValueError, match="shorter than speech"):
            dx.spectral_distortion(params=p, epochs=[1])
    finally:
        dx.cfg = old


def _write_pcm(path, samples, rate, width):
    """A PCM wav of `width` bytes a sample from float samples [n, channels]
    in [-1, 1)."""
    if width == 1:
        raw = np.clip(samples * 128.0 + 128.0, 0, 255).astype(np.uint8)
    elif width == 2:
        raw = (samples * 32768.0).astype("<i2")
    else:
        raw = (samples * 2147483648.0).astype("<i4")
    with wave.open(path, "wb") as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw.tobytes())


@pytest.mark.parametrize("width,channels,rate", [(1, 1, 16000), (2, 1, 16000), (4, 1, 16000),
                                                 (2, 2, 16000), (2, 1, 8000), (4, 2, 44100),
                                                 (1, 1, 44100)])
def test_read_wav_matches_jax(tmp_path, width, channels, rate):
    """8-, 16- and 32-bit PCM, stereo (averaged), 8 kHz and 44.1 kHz
    (resampled to 16 kHz): the same length as the JAX package's reader and
    the samples within one int16 step (its native decoder rounds its own
    resampler's output)."""
    rng = np.random.RandomState(width * 10 + channels)
    n = rate // 4 + 7
    samples = np.clip(rng.randn(n, channels) * 0.2, -0.99, 0.99)
    path = str(tmp_path / "x.wav")
    _write_pcm(path, samples, rate, width)
    x, f_s = read_wav(path, 16000)
    x_j, _ = read_wav_j(path, 16000)
    assert f_s == 16000 and x.dtype == np.int16 and x.shape == x_j.shape
    assert np.abs(x.astype(np.int32) - x_j).max() <= 1
    assert wav_length(path, 16000) == wav_length_j(path, 16000) == len(x)
