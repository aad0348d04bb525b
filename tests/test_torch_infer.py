"""`DeepXiTorch.infer` for every MagXi out_type against the JAX package's
`DeepXiTPU.infer` on the CPU, on a small ResNetV2 and a small MHANetV3 with
biases moved off zero (weights crossing through the bridge) and two test
utterances; plus the pieces of the per-utterance route: the mel filter bank,
`inverse_stft`/`polar_synthesis`, the noise-estimate synthesis through
`enhance_frames_fused`'s plain version, `MagXi`'s observation and synthesis,
and the `-vb` presets. The JAX package's per-utterance route runs its plain
flax network and the exact FFT; the port's runs `fast_apply()` (the kernel
wrappers' plain versions here), |X| from `stft_mag_fused`'s plain version
and the synthesis from `enhance_frames_fused`'s."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import loadmat

from deepxi_tpu import sig as sig_j
from deepxi_tpu.config import VERSION_PRESETS as PRESETS_J
from deepxi_tpu.config import Config as ConfigJ
from deepxi_tpu.framework import DeepXiTPU
from deepxi_tpu.inp_tgt import inp_tgt_selector
from deepxi_tpu.models import network_selector
from deepxi_tpu.sig.mel import mel_filter_bank as mel_filter_bank_j
from deepxi_tpu_torch.compat.artifact import FLAGSHIP_ROOT, from_flax_params
from deepxi_tpu_torch.config import Config, preset
from deepxi_tpu_torch.data.wavio import read_wav, save_wav
from deepxi_tpu_torch.enhance import noise_gain
from deepxi_tpu_torch.framework import HYBRID_OUT_TYPES, OUT_TYPES, DeepXiTorch
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.ops.kernels.spectral import enhance_frames_fused_ref, stft_reim
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.sig import stft
from deepxi_tpu_torch.sig.mel import mel_filter_bank
from deepxi_tpu_torch.sig.mix import normalise

NETS = {
    "resnet": dict(network_type="ResNetV2", k=3, max_d_rate=2,
                   unit_type="ReLU->LN->W+b", d_model=32, n_blocks=3, d_f=16),
    "mhanet": dict(network_type="MHANetV3", max_len=128, d_model=32, n_blocks=2,
                   n_heads=4),
}
MAT_KEYS = {"xi_hat": "xi_hat", "gamma_hat": "gamma_hat", "deepmmse": "d_psd_hat",
            "ibm_hat": "ibm_hat", "subband_ibm_hat": "subband_ibm_hat"}
# the out_types both packages write, and the port's `y` through the
# per-utterance route ("y slow")
RUNS = [("y", False), ("d_hat", True)] + [(t, True) for t in MAT_KEYS]


@pytest.fixture(scope="module", params=sorted(NETS))
def written(request, tmp_path_factory):
    """{(out_type, fast): (port's paths, JAX's paths)} for one net, the
    port's `y` with fast=True too, and the JAX xi map."""
    tmp = tmp_path_factory.mktemp(request.param)
    rng = np.random.RandomState(0)
    test_dir = tmp / "test"
    # 28 and 20 frames, each padded to a bucket of 32 (one shape a route)
    for name, n in (("a_white_5dB", 7000), ("b_babble_0dB", 5000)):
        save_wav(str(test_dir / f"{name}.wav"), (rng.randn(n) * 3000).astype(np.int16),
                 16000)
    net_kw = NETS[request.param]
    paths = dict(data_path=str(tmp / "data"), model_path=str(tmp / "model"),
                 log_path=str(tmp / "log"), test_x_path=str(test_dir))
    dx_j = DeepXiTPU.__new__(DeepXiTPU)
    dx_j.cfg = ConfigJ(ver="tiny", causal=True, out_path=str(tmp / "out_j"), **paths,
                       **net_kw)
    it_j = inp_tgt_selector("MagXi", N_d=512, N_s=256, K=512, f_s=16000,
                            map_type="DBNormalCDF", map_params=None)
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
    dx = DeepXiTorch(Config(ver="tiny", causal=True, out_path=str(tmp / "out"), **paths,
                            **net_kw), device="cpu")
    p = from_flax_params(params)
    out = {}
    for out_type, fast in RUNS:
        kw = dict(out_type=out_type, epochs=[1], gains=["mmse-lsa"], fast=fast)
        out[out_type, fast] = (dx.infer(params=p, **kw),
                               dx_j.infer(params=params, **kw))
    root = dx.cfg.out_path
    dx.cfg = dx.cfg.replace(out_path=str(tmp / "out_fast"))
    out["y", True] = (dx.infer(params=p, epochs=[1], gains=["mmse-lsa"]), None)
    return out, dx_j.inp_tgt.xi_map, root, dx_j.cfg.out_path


def _pairs(written, key):
    out, _, root, root_j = written
    ours, theirs = out[key]
    assert [os.path.relpath(p, root) for p in ours] == \
        [os.path.relpath(p, root_j) for p in theirs]
    assert all(os.path.exists(p) for p in ours)
    return list(zip(ours, theirs))


def _db(x):
    return 10.0 * np.log10(np.asarray(x, np.float64))


# Measured on the CPU: the written wavs at most 1 int16 step apart (y and
# d_hat, both nets). Held to 2 steps.
@pytest.mark.parametrize("out_type,fast", [("y", False), ("d_hat", True)])
def test_waveform_outputs_match_jax(written, out_type, fast):
    for path, path_j in _pairs(written, (out_type, fast)):
        y, y_j = read_wav(path)[0], read_wav(path_j)[0]
        assert y.shape == y_j.shape and np.abs(y).max() > 100
        assert np.abs(y.astype(np.int32) - y_j).max() <= 2


# Measured on the CPU: the same int16 samples. Held to 2 steps.
def test_y_per_utterance_matches_the_batched_route(written):
    """`y` with fast=False (per utterance, the synthesis kernel's plain
    version) against fast=True (length buckets, the matmul synthesis)."""
    out = written[0]
    slow, fast = out["y", False][0], out["y", True][0]
    assert [os.path.basename(p) for p in slow] == [os.path.basename(p) for p in fast]
    for p_slow, p_fast in zip(slow, fast):
        y, y_fast = read_wav(p_slow)[0], read_wav(p_fast)[0]
        assert y.shape == y_fast.shape
        assert np.abs(y.astype(np.int32) - y_fast).max() <= 2


# Measured on the CPU: xi_hat and gamma_hat 3.5e-4 dB (resnet) and 2.4e-5 dB
# (mhanet) at most on the bins whose network output lies in [1e-3, 1 - 1e-3]
# (over 99.9% of them); d_psd_hat 1.5e-6 of each utterance's largest value.
# Held to 1e-3 dB and 1e-5.
@pytest.mark.parametrize("out_type", ["xi_hat", "gamma_hat", "deepmmse"])
def test_snr_and_noise_psd_outputs_match_jax(written, out_type):
    xi_map = written[1]
    key = MAT_KEYS[out_type]
    for path, path_j in _pairs(written, (out_type, True)):
        a, a_j = loadmat(path)[key], loadmat(path_j)[key]
        assert a.dtype == np.float32 and a.shape == a_j.shape and a.shape[1] == 257
        if out_type == "deepmmse":
            assert np.abs(a - a_j).max() <= 1e-5 * np.abs(a_j).max()
            continue
        xi_j = a_j - 1.0 if out_type == "gamma_hat" else a_j
        bar = np.asarray(xi_map.map(jnp.asarray(xi_j)))
        mid = (bar >= 1e-3) & (bar <= 1 - 1e-3)
        assert mid.mean() > 0.5
        assert np.abs(_db(a) - _db(a_j))[mid].max() <= 1e-3


# Measured on the CPU: the masks equal on both nets (20-35% of the bins and
# 16-76% of the bands set). Held to: a bin (or mel band) may differ only
# where JAX's xi_hat (or subband SNR) lies within 1e-3 dB of 0 dB.
@pytest.mark.parametrize("out_type", ["ibm_hat", "subband_ibm_hat"])
def test_mask_outputs_match_jax(written, out_type):
    key = MAT_KEYS[out_type]
    paths_xi = dict(_pairs(written, ("xi_hat", True)))
    for path, path_j in _pairs(written, (out_type, True)):
        m, m_j = loadmat(path)[key], loadmat(path_j)[key]
        assert m.dtype == np.uint8 and m.shape == m_j.shape  # .mat stores bool as uint8
        assert m.shape[1] == (257 if out_type == "ibm_hat" else 40)
        xi_j = loadmat(paths_xi[path.replace(out_type, "xi_hat")])["xi_hat"]
        if out_type == "subband_ibm_hat":
            xi_j = xi_j @ mel_filter_bank(40, 512, 16000).T
        assert 0.05 < m_j.mean() < 0.95
        assert np.all(np.abs(_db(xi_j))[m != m_j] <= 1e-3)


def test_unported_and_unknown_out_types_raise(tmp_path):
    """Every out_type is ported (the hybrid modes and `pho` since A11):
    MagXi refuses MagPhonemes' `pho`, the hybrid modes ask for their
    Gaussians, and an unknown name raises."""
    np.savez(tmp_path / "tiny_stats.npz", **{"xi_map.mu": np.zeros(257, np.float32),
                                             "xi_map.sigma": np.ones(257, np.float32)})
    dx = DeepXiTorch(Config(ver="tiny", d_model=32, n_blocks=3, d_f=16, k=3,
                            max_d_rate=2, unit_type="ReLU->LN->W+b",
                            data_path=str(tmp_path),
                            test_x_path=FLAGSHIP_ROOT), device="cpu")
    with pytest.raises(ValueError, match="MagXi has no out_type 'pho'"):
        dx.infer(params={}, out_type="pho")
    for out_type, flag in (("hybrid_mixmax", "--mixmax_stats"), ("tracking_vts", "--vts_stats")):
        with pytest.raises(ValueError, match=flag):
            dx.infer(params={}, out_type=out_type)
    assert set(HYBRID_OUT_TYPES) == {"hybrid_omlsa", "hybrid_mixmax", "tracking_hist",
                                     "tracking_vts"}
    with pytest.raises(ValueError, match="Invalid output type"):
        dx.infer(params={}, out_type="x_hat")
    assert OUT_TYPES == ("y", "xi_hat", "gamma_hat", "deepmmse", "ibm_hat",
                         "subband_ibm_hat", "d_hat")


@pytest.mark.parametrize("M,K,f_s", [(40, 512, 16000), (26, 256, 8000), (64, 1024, 16000)])
def test_mel_filter_bank_matches_jax_exactly(M, K, f_s):
    H = mel_filter_bank(M, K, f_s)
    assert H.dtype == np.float32 and H.shape == (M, K // 2 + 1)
    np.testing.assert_array_equal(H, mel_filter_bank_j(M, K, f_s))


def _speech(seed, n):
    return (np.random.RandomState(seed).randn(2, n) * 3000).astype(np.int16)


# Measured on the CPU: 6.0e-8 max abs (inverse_stft, polar_synthesis and the
# round trip) and 7.2e-7 (the magnitude of `observation`, 1e-7 of its
# largest value). Held to 1e-6 (the magnitude: 1e-6 of its largest value).
def test_synthesis_and_observation_match_jax():
    x = _speech(3, 5000)
    it = MagXi(xi_map=NormalCDF(use_db=True, mu=torch.zeros(257), sigma=torch.ones(257)))
    mag, pha = it.observation(torch.as_tensor(x))
    mag_j, pha_j = sig_j.polar_analysis(sig_j.normalise(jnp.asarray(x)), 512, 256, 512)
    assert it.n_frames(5000) == mag.shape[1] == 20
    assert np.abs(mag.numpy() - np.asarray(mag_j)).max() <= 1e-6 * np.abs(mag_j).max()
    X = np.array(sig_j.stft(sig_j.normalise(jnp.asarray(x)), 512, 256, 512))
    y = stft.inverse_stft(torch.as_tensor(X), 512, 256, 512).numpy()
    np.testing.assert_allclose(y, np.asarray(sig_j.inverse_stft(jnp.asarray(X), 512, 256,
                                                                512)), rtol=0, atol=1e-6)
    y = it.polar_synthesis(mag, pha).numpy()
    y_j = np.asarray(sig_j.polar_synthesis(mag_j, pha_j, 512, 256, 512))
    assert y.shape == y_j.shape == (2, 21 * 256)
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-6)
    # the noisy waveform back where two frames overlap
    np.testing.assert_allclose(y[:, 256:5000], x[:, 256:] / 32768.0, rtol=0, atol=1e-6)


def test_magxi_enhanced_speech_and_gamma_hat_match_jax():
    """MagXi's plain definitions of the per-utterance outputs: gamma_hat and
    the waveform of a gain on the noisy STMS with the noisy phase.
    Measured on the CPU: gamma_hat 1.6e-6 relative (erfinv), waveforms 3.0e-8
    max abs. Held to 1e-5 relative and 1e-6."""
    rng = np.random.RandomState(6)
    it_j = inp_tgt_selector("MagXi", N_d=512, N_s=256, K=512, f_s=16000,
                            map_type="DBNormalCDF", map_params=None)
    sample = (np.abs(rng.randn(64, 257)) ** 2).astype(np.float32)
    it_j = it_j.replace(xi_map=it_j.xi_map.with_stats(jnp.asarray(sample)))
    it = MagXi(xi_map=NormalCDF(use_db=True, **{
        k: torch.tensor(np.asarray(getattr(it_j.xi_map, k))) for k in ("mu", "sigma")}))
    x = _speech(7, 4000)
    mag_j, pha_j = it_j.observation(jnp.asarray(x))
    mag, pha = it.observation(torch.as_tensor(x))
    tgt = rng.uniform(0.01, 0.99, mag.shape).astype(np.float32)
    g = it.gamma_hat(torch.as_tensor(tgt)).numpy()
    np.testing.assert_allclose(g, np.asarray(it_j.gamma_hat(jnp.asarray(tgt))), rtol=1e-5)
    for gtype in ("wf", "mmse-lsa"):
        y = it.enhanced_speech(mag, pha, torch.as_tensor(tgt), gtype).numpy()
        y_j = np.asarray(it_j.enhanced_speech(mag_j, pha_j, jnp.asarray(tgt), gtype))
        assert y.shape == y_j.shape == (2, 17 * 256)
        np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-6)


# Measured on the CPU: 1.0e-7 to 1.5e-7 max abs on waveforms whose largest
# sample is 0.23 to 0.27. Held to 1e-6.
@pytest.mark.parametrize("gain", ["d_hat", "mmse-lsa", "srwf"])
def test_gain_synthesis_equals_polar_synthesis(gain):
    """The per-utterance route's synthesis, the gain times [re || im] through
    `enhance_frames_fused`'s plain version and overlap-add, equals the JAX
    package's polar synthesis of the gained magnitude with the noisy phase:
    for the noise estimate sqrt(max(|X|^2 G_dmmse, 0)) (0 where |X| = 0: the
    zero frames past the end)."""
    x = np.zeros((2, 6000), np.int16)
    x[:, :4000] = _speech(4, 4000)
    rng = np.random.RandomState(5)
    it = MagXi(xi_map=NormalCDF(use_db=True, mu=torch.zeros(257), sigma=torch.ones(257)))
    mag, pha = it.observation(torch.as_tensor(x))
    xi = torch.as_tensor(10.0 ** rng.uniform(-2, 3, mag.shape).astype(np.float32))
    if gain == "d_hat":
        G = noise_gain(xi)
        stms = torch.sqrt(torch.clamp(torch.square(mag) * torch.square(G), min=0.0))
    else:
        from deepxi_tpu_torch.ops.gains import gfunc
        G = gfunc(xi, xi + 1.0, gain)
        stms = mag * G
    Y = stft_reim(normalise(torch.as_tensor(x)), 512, 256, 512)
    y = stft.overlap_and_add(enhance_frames_fused_ref(Y, G, 512, 256, 512), 256).numpy()
    y_j = np.asarray(sig_j.polar_synthesis(jnp.asarray(stms.numpy()), jnp.asarray(pha.numpy()),
                                           512, 256, 512))
    assert y.shape == y_j.shape and np.abs(y_j).max() > 1e-3
    assert np.abs(y - y_j).max() <= 1e-6 * max(np.abs(y_j).max(), 1.0)


@pytest.mark.parametrize("ver", ["resnet-1.1c", "mhanet-1.1c", "mhanet-1.0c"])
def test_vb_presets_match_jax(ver):
    cfg = preset(ver + "-vb")
    cfg_j = ConfigJ(ver=ver + "-vb", **PRESETS_J[ver + "-vb"])
    for f in ("min_snr", "max_snr", "snr_inter", "val_flag", "test_epoch", "network_type",
              "d_model", "n_blocks", "n_heads", "d_f", "k", "max_d_rate", "max_len",
              "causal", "warmup_steps", "mbatch_size", "n_filters", "f_s"):
        assert getattr(cfg, f) == getattr(cfg_j, f), f
    assert (cfg.min_snr, cfg.max_snr, cfg.snr_inter, cfg.val_flag, cfg.test_epoch) == \
        (0, 15, 5, False, 125)
    assert cfg.snr_levels == [0, 5, 10, 15]
