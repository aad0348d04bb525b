"""The hybrid and classical enhancement modes and the phoneme classifier of
the port against the JAX package's, on the CPU:

  * each `hybrid_infer` mode (OM-LSA with MCRA, MCRA-2 and IMCRA; MixMax
    with and without posteriors and noise tracking; the histogram
    tracker's three variants; VTS) on the same waveform, in float32 from
    int16 and in float64 (the JAX function body run on a float64 waveform:
    its float32 cast in `normalise` and its complex64 synthesis replaced
    by float64 ones, nothing else);
  * `MagPhonemes.example`, and one phoneme train step's loss, gradients
    (against `jax.grad`) and updated parameters on a small net with nonzero
    biases;
  * `DeepXiTorch.train` of one MagPhonemes epoch against `DeepXiTPU.train`
    from the same initial weights, then `infer` of `pho` (with the token
    CSV), MagPhonemes' `y` with OM-LSA, `hybrid_mixmax` with the network's
    posteriors, and the classical modes of another family, against
    `DeepXiTPU.infer`;
  * `tools/torch_build_gaussians.py` against `tools/build_gaussians.py`.

Limits are relative to each output's largest magnitude unless stated."""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import loadmat

from deepxi_tpu import hybrid_infer as hybrid_j
from deepxi_tpu import sig as sig_j
from deepxi_tpu.dsp.histnoise import HistParams as HistParamsJ
from deepxi_tpu.dsp.mixmax import MixMaxModel as MixMaxJ
from deepxi_tpu.dsp.vts import VTSModel as VTSModelJ
from deepxi_tpu.dsp.vts import make_model as make_model_j
from deepxi_tpu.inp_tgt import inp_tgt_selector as inp_tgt_selector_j
from deepxi_tpu.models import network_selector as network_selector_j
from deepxi_tpu.training import TrainState as TrainStateJ
from deepxi_tpu.training import make_optimizer as make_optimizer_j
from deepxi_tpu.training import make_phoneme_train_step as make_phoneme_train_step_j
from deepxi_tpu.training import masked_loss as masked_loss_j
from deepxi_tpu_torch import hybrid_infer
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.dsp.histnoise import HistParams
from deepxi_tpu_torch.dsp.mixmax import MixMaxModel
from deepxi_tpu_torch.dsp.vts import make_model
from deepxi_tpu_torch.inp_tgt import MagPhonemes, inp_tgt_selector
from deepxi_tpu_torch.models.tcn import ResNetV2
from deepxi_tpu_torch.ops.kernels.tcn_fused_train import resnetv2_apply_fused_train
from deepxi_tpu_torch.training import (TrainState, frame_mask, make_optimizer,
                                       make_phoneme_train_step, masked_loss)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from torch_hybrid import write_phoneme_corpus  # noqa: E402

DIMS = dict(N_d=512, N_s=256, K=512)
T = torch.as_tensor
# float32 against float64 and against JAX's float32: measured up to 4.3e-6
# of the waveform's scale (IMCRA), and 2.3e-5 for VTS, whose EM sums
# posteriors over every frame and subtracts E[x]^2 from E[x^2]; float64
# against JAX's float64: up to 5.9e-8 (the float32 exp1 inside both
# packages' MMSE-LSA gain), 3.5e-14 without it
WAVE_TOL32, WAVE_TOL32_VTS, WAVE_TOL64 = 2e-5, 1e-4, 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def noisy():
    """2 s of a gated 300 Hz tone in white noise, int16."""
    rng = np.random.RandomState(0)
    t = np.arange(32000) / 16000
    s = 0.4 * np.sin(2 * np.pi * 300 * t) * (np.sin(2 * np.pi * 2 * t) > 0)
    return ((s + rng.randn(len(s)) * 0.05) * 20000).clip(-32767, 32767).astype(np.int16)


P_CLASSES = 5
_rng = np.random.RandomState(1)
MEANS = _rng.randn(P_CLASSES, 257) - 3.0
STDS = 0.6 + _rng.rand(P_CLASSES, 257)
PROBS = np.full(P_CLASSES, 1.0 / P_CLASSES)


def _posteriors(n_frames):
    p = np.random.RandomState(2).rand(n_frames, P_CLASSES)
    return p / p.sum(1, keepdims=True)


def _models(dtype):
    """(JAX, port) MixMax and VTS models of MEANS/STDS at `dtype`."""
    arrays = (MEANS, STDS, MEANS[0], STDS[0], PROBS)
    jd = jnp.float64 if dtype == "float64" else jnp.float32
    td = torch.float64 if dtype == "float64" else torch.float32
    mm_j = MixMaxJ(*(jnp.asarray(a, jd) for a in arrays))
    mm_p = MixMaxModel(*(T(a, dtype=td) for a in arrays))
    v_j = make_model_j(MEANS, STDS, PROBS, MEANS[0] - 1.0, STDS[0], seed=4)
    v_p = make_model(MEANS, STDS, PROBS, MEANS[0] - 1.0, STDS[0], seed=4)
    if dtype == "float64":
        v_j = VTSModelJ(*(jnp.asarray(np.asarray(a), jnp.float64) for a in v_j))
        v_p = v_p.to(torch.float64)
    return mm_j, mm_p, v_j, v_p


MODES = ["omlsa-mcra", "omlsa-mcra2", "omlsa-imcra", "mixmax", "mixmax-posteriors",
         "mixmax-static", "hist-0", "hist-1", "hist-2", "vts"]


def _mode(pkg, name, wav, models, n_frames):
    """Mode `name` of `pkg` (the JAX or the port's hybrid_infer) on `wav`."""
    mm, vm = models
    kind, _, arg = name.partition("-")
    if kind == "omlsa":
        return pkg.enhance_omlsa(wav, tracker=arg, **DIMS)
    if kind == "mixmax":
        post = None
        if arg == "posteriors":
            post = _posteriors(n_frames).astype(np.float64 if wav.dtype in (
                jnp.float64, torch.float64) else np.float32)
            post = jnp.asarray(post) if pkg is hybrid_j else T(post)
        return pkg.enhance_mixmax(wav, mm, posteriors=post,
                                  track_noise=arg != "static", **DIMS)
    if kind == "hist":
        params = (HistParamsJ if pkg is hybrid_j else HistParams)(frame_L=20)
        return pkg.enhance_tracking_histogram(wav, params, variant=int(arg), **DIMS)
    return pkg.enhance_vts(wav, vm, **DIMS)


@pytest.fixture()
def jax_float64(monkeypatch):
    """JAX's hybrid_infer in float64: x64 on; `normalise` passes a float
    waveform through and the synthesis keeps complex128 (restored
    afterwards)."""
    jax.config.update("jax_enable_x64", True)

    def synthesis(STMS, STPS, N_d, N_s, K):
        return sig_j.inverse_stft(STMS * jnp.exp(1j * STPS), N_d, N_s, K)

    monkeypatch.setattr(hybrid_j, "normalise", lambda w: w)
    monkeypatch.setattr(hybrid_j, "sig", types.SimpleNamespace(
        polar_analysis=sig_j.polar_analysis, polar_synthesis=synthesis))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _float64_modes(name, noisy):
    """(JAX, port) float64 waveforms of mode `name`; call under
    `jax_float64`."""
    x = noisy.astype(np.float64) / 32768.0
    n_frames = -(-len(x) // 256)
    mm_j, mm_p, v_j, v_p = _models("float64")
    y_j = np.asarray(_mode(hybrid_j, name, jnp.asarray(x), (mm_j, v_j), n_frames))
    y_p = _mode(hybrid_infer, name, T(x), (mm_p, v_p), n_frames)
    assert y_j.dtype == np.float64 and y_p.dtype == torch.float64
    return y_j, y_p.numpy()


@pytest.mark.parametrize("name", MODES)
def test_hybrid_modes_match_jax_float64(name, noisy, jax_float64):
    y_j, y_p = _float64_modes(name, noisy)
    assert y_p.shape == y_j.shape == ((-(-len(noisy) // 256) - 1) * 256 + 512,)
    assert _rel(y_p, y_j) <= WAVE_TOL64


@pytest.mark.parametrize("name", MODES)
def test_hybrid_modes_match_jax_float32(name, noisy, monkeypatch):
    """From int16, as `infer` runs them: each package's float32 waveform
    within WAVE_TOL32 of its float64 one (no decision flipped), then the
    two float32 waveforms within WAVE_TOL32."""
    n_frames = -(-len(noisy) // 256)
    mm_j, mm_p, v_j, v_p = _models("float32")
    y_j = np.asarray(_mode(hybrid_j, name, jnp.asarray(noisy), (mm_j, v_j), n_frames))
    y_p = _mode(hybrid_infer, name, T(noisy), (mm_p, v_p), n_frames)
    assert y_p.dtype == torch.float32 and y_j.dtype == np.float32
    with monkeypatch.context() as m:
        jax.config.update("jax_enable_x64", True)
        try:
            m.setattr(hybrid_j, "normalise", lambda w: w)
            m.setattr(hybrid_j, "sig", types.SimpleNamespace(
                polar_analysis=sig_j.polar_analysis,
                polar_synthesis=lambda S, P, *a: sig_j.inverse_stft(S * jnp.exp(1j * P), *a)))
            y_j64, y_p64 = _float64_modes(name, noisy)
        finally:
            jax.config.update("jax_enable_x64", False)
    tol = WAVE_TOL32_VTS if name == "vts" else WAVE_TOL32
    assert _rel(y_j, y_j64) <= tol and _rel(y_p.numpy(), y_p64) <= tol
    assert _rel(y_p.numpy(), y_j) <= tol


SMALL = dict(n_blocks=2, d_model=16, d_f=8, k=3, max_d_rate=2)


def _waves(seed, B=2, n=8192):
    rng = np.random.RandomState(seed)
    s = (rng.randn(B, n) * 3000).astype(np.int16)
    d = (rng.randn(B, n) * 2000).astype(np.int16)
    return s, d, np.array([n, n - 1500], np.int32)[:B], np.array([0.0, 5.0], np.float32)[:B]


def test_magphonemes_example_matches_jax():
    """Noise as long as the speech (both offsets 0); labels past the 98
    classes give an all-zero row in both, and labels run past T frames."""
    s, d, lens, snr = _waves(3)
    labels = np.random.RandomState(4).randint(0, 101, (2, 40)).astype(np.int32)
    it, it_j = (sel("MagPhonme", **DIMS, f_s=16000, Noutp=98)
                for sel in (inp_tgt_selector, inp_tgt_selector_j))
    assert isinstance(it, MagPhonemes) and it.n_outp == it_j.n_outp == 98
    inp, tgt, nf = it.example(T(s), T(d), T(lens), T(lens), T(snr),
                              offsets=torch.zeros(2, dtype=torch.int64), labels=T(labels))
    inp_j, tgt_j, nf_j = it_j.example(jax.random.PRNGKey(0), jnp.asarray(s), jnp.asarray(d),
                                      jnp.asarray(lens), jnp.asarray(lens), jnp.asarray(snr),
                                      labels=jnp.asarray(labels))
    assert tgt.shape == (2, 32, 98) and tgt.dtype == torch.float32
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(tgt_j))
    assert (tgt.sum(-1) == 0).any()
    np.testing.assert_array_equal(nf.numpy(), np.asarray(nf_j))
    assert _rel(inp, inp_j) <= 1e-6


def test_phoneme_train_step_matches_jax():
    """One step at B=2 on a small ResNetV2 with nonzero biases: the loss
    within 1e-5 relative of JAX's; its gradients (the step's composition:
    example, the fused stack's plain versions, masked BCE) within 1e-5 of
    each leaf's scale of `jax.grad` of JAX's loss; the updated parameters
    within 2e-5 of the leaf's scale of the JAX step's (Adam's first step
    is lr g / (|g| + 1e-8): where |g| is near 1e-8 it carries the
    gradients' last bits into the update; measured 5.8e-6)."""
    s, d, lens, snr = _waves(5)
    n_pho = 12
    labels = np.random.RandomState(6).randint(0, n_pho, (2, 32)).astype(np.int32)
    net_j = network_selector_j("ResNetV2", n_pho, causal=True, unit_type="ReLU->LN->W+b",
                               outp_act="Sigmoid", **SMALL)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
        net_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 257))))
    it_j = inp_tgt_selector_j("MagPhonemes", **DIMS, f_s=16000, Noutp=n_pho)
    it = inp_tgt_selector("MagPhonemes", **DIMS, f_s=16000, Noutp=n_pho)
    tx_j = make_optimizer_j("ResNetV2")
    st_j, m_j = jax.jit(make_phoneme_train_step_j(net_j, it_j, tx_j))(
        TrainStateJ.create(jax.tree_util.tree_map(jnp.asarray, params), tx_j),
        jax.random.PRNGKey(1), jnp.asarray(s), jnp.asarray(d), jnp.asarray(lens),
        jnp.asarray(lens), jnp.asarray(snr), jnp.asarray(labels))

    def loss_j(p):
        inp, tgt, nf = it_j.example(jax.random.PRNGKey(1), jnp.asarray(s), jnp.asarray(d),
                                    jnp.asarray(lens), jnp.asarray(lens), jnp.asarray(snr),
                                    labels=jnp.asarray(labels))
        mask = (jnp.arange(inp.shape[1])[None] < nf[:, None]).astype(jnp.float32)
        return masked_loss_j(net_j.apply(p, inp), tgt, mask, "BinaryCrossentropy")
    g_j = from_flax_params(jax.grad(loss_j)(jax.tree_util.tree_map(jnp.asarray, params)))

    def apply(p, m):
        return resnetv2_apply_fused_train(p, m, n_blocks=2, max_d_rate=2, k=3,
                                          save_acts=True)
    p0 = from_flax_params(params)
    tx = make_optimizer("ResNetV2")
    zeros = torch.zeros(2, dtype=torch.int64)
    st, m = make_phoneme_train_step(ResNetV2(257, n_pho, **SMALL), it, tx, apply_fn=apply)(
        TrainState.create(p0, tx), T(s), T(d), T(lens), T(lens), T(snr), T(labels),
        offsets=zeros)
    assert abs(float(m["loss"]) / float(m_j["loss"]) - 1.0) <= 1e-5
    inp, tgt, nf = it.example(T(s), T(d), T(lens), T(lens), T(snr), offsets=zeros,
                              labels=T(labels))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    loss = masked_loss(apply(leaves, inp), tgt, frame_mask(inp.shape[1], nf, "cpu"),
                       "BinaryCrossentropy")
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert max(_rel(grads[k], g_j[k]) for k in g_j) <= 1e-5
    new_j = from_flax_params(st_j.params)
    assert st.step == 1 and max(_rel(st.params[k], new_j[k]) for k in new_j) <= 2e-5


def _flax_params(p):
    tree = {}
    for k, v in p.items():
        mod, leaf = k.rsplit(".", 1)
        tree.setdefault(mod, {})[leaf] = jnp.asarray(v.numpy())
    return {"params": tree}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 clean utterances of 8192 samples (one bucket: the noise offsets are
    0 in both packages), 2 noise files of 3 x 8192, their alignment and the
    98-token lexicon, 2 noisy test utterances (0.7 s, 1.1 s), and the
    Gaussians of `tools/torch_build_gaussians.py` on the CPU."""
    import torch_build_gaussians
    root = tmp_path_factory.mktemp("pho")
    write_phoneme_corpus(str(root))
    assert torch_build_gaussians.main([
        "--clean", str(root / "set" / "train_clean_speech"), "--ali", str(root / "train.ali"),
        "--lexicon", str(root / "lexicon.txt"), "--noise", str(root / "set" / "train_noise"),
        "--out", str(root / "gaussians.npz"), "--platform", "cpu"]) == 0
    return root


def test_build_gaussians_matches_jax(corpus, tmp_path, monkeypatch):
    """The same corpus and alignment through tools/build_gaussians.py: the
    class probabilities (frame counts) equal, the log-magnitude statistics
    within 2e-3 (measured 3.2e-4 for the means, 6.5e-4 for the stds, 4.8e-7
    for the noise Gaussian: a bin far below its frame's peak carries float32
    FFT rounding, which the log magnifies). The JAX tool's list
    caches are sent to a temporary directory."""
    import build_gaussians

    import deepxi_tpu.data as data_j
    bl, bll = data_j.batch_list, data_j.batch_list_labelled
    monkeypatch.setattr(data_j, "batch_list", lambda d, name, data_path, make_new: bl(
        d, name, str(tmp_path), make_new))
    monkeypatch.setattr(data_j, "batch_list_labelled", lambda *a, **k: bll(
        *a, **dict(k, data_path=str(tmp_path))))
    out = str(tmp_path / "g_jax.npz")
    assert build_gaussians.main([
        "--clean", str(corpus / "set" / "train_clean_speech"), "--ali",
        str(corpus / "train.ali"), "--lexicon", str(corpus / "lexicon.txt"), "--noise",
        str(corpus / "set" / "train_noise"), "--out", out]) == 0
    z, z_j = np.load(corpus / "gaussians.npz"), np.load(out)
    assert sorted(z.files) == sorted(z_j.files)
    for k in z_j.files:
        assert z[k].dtype == np.float32 and z[k].shape == z_j[k].shape
        if k in ("probs", "prio_p"):
            np.testing.assert_array_equal(z[k], z_j[k])
        else:
            np.testing.assert_allclose(z[k], z_j[k], rtol=0, atol=2e-3, err_msg=k)
    assert z["means"].shape == (98, 257)


_BUILT = {}


def _configs(corpus, tmp, inp_tgt_type="MagPhonemes"):
    """(port Config, JAX Config) of the small phoneme classifier (or another
    family's) with the corpus's alignment, lexicon and Gaussians."""
    from deepxi_tpu.config import Config as ConfigJ
    from deepxi_tpu_torch.config import Config
    kw = dict(ver=f"tiny-{inp_tgt_type.lower()}", inp_tgt_type=inp_tgt_type,
              network_type="ResNetV2", unit_type="ReLU->LN->W+b", causal=True, **SMALL,
              mbatch_size=2, max_epochs=1, val_flag=False, seed=1, min_snr=0, max_snr=10,
              snr_inter=5, tcn_fused_train=True, set_path=str(corpus / "set"),
              ali_path=str(corpus / "train.ali"), lexicon_path=str(corpus / "lexicon.txt"),
              mixmax_stats=str(corpus / "gaussians.npz"),
              vts_stats=str(corpus / "gaussians.npz"), test_x_path=str(corpus / "test"),
              data_path=str(tmp / "data"), log_path=str(tmp / "log"))
    return (Config(out_path=str(tmp / "out"), model_path=str(tmp / "model"), **kw),
            ConfigJ(out_path=str(tmp / "out_j"), model_path=str(tmp / "model_j"), **kw))


def _phoneme_frameworks(corpus, tmp):
    """One epoch of the phoneme classifier in each package from JAX's
    initial weights: (port framework, JAX framework, the losses of each)."""
    if "pho" in _BUILT:
        return _BUILT["pho"]
    from deepxi_tpu.data import batch_list as batch_list_j
    from deepxi_tpu.data import batch_list_labelled as batch_list_labelled_j
    from deepxi_tpu.framework import DeepXiTPU
    from deepxi_tpu_torch.data.listing import batch_list, batch_list_labelled
    from deepxi_tpu_torch.framework import DeepXiTorch
    cfg, cfg_j = _configs(corpus, tmp)
    clean, noise = str(corpus / "set" / "train_clean_speech"), str(corpus / "set" / "train_noise")
    s_list = batch_list_labelled(clean, cfg.ali_path, cfg.lexicon_path, "clean_speech",
                                 str(tmp / "lists"), frame_ms=cfg.T_s)
    s_list_j = batch_list_labelled_j(clean, cfg.ali_path, cfg.lexicon_path, "clean_speech",
                                     str(tmp / "lists_j"), frame_ms=cfg.T_s)
    assert len(s_list) == 4 and all(np.array_equal(a["labels"], b["labels"]) and
                                    a["wav_len"] == b["wav_len"] == 8192
                                    for a, b in zip(s_list, s_list_j))
    dx = DeepXiTorch(cfg, s_list, batch_list(noise, "noise", str(tmp / "lists")), device="cpu")
    dx_j = DeepXiTPU(cfg_j, s_list_j, batch_list_j(noise, "noise", str(tmp / "lists_j")))
    init = dx_j.network.init(jax.random.PRNGKey(cfg.seed), jnp.zeros((2, 32, 257)))
    dx.init_params = lambda: from_flax_params(init)
    out = (dx, dx_j, dx.train(verbose=False), dx_j.train(verbose=False))
    _BUILT["pho"] = out
    return out


def test_phoneme_training_matches_jax(corpus, tmp_path_factory):
    """One epoch of 2 steps (B=2, noise offsets 0): the mean loss within
    1e-5 relative of JAX's, each trained leaf within 1e-4 of its scale (two
    Adam steps; measured in the test's log), and the checkpoint written."""
    dx, dx_j, losses, losses_j = _phoneme_frameworks(corpus, tmp_path_factory.mktemp("t"))
    assert len(losses) == len(losses_j) == 1 and np.isfinite(losses).all()
    assert abs(losses[0] / losses_j[0] - 1.0) <= 1e-5
    p, p_j = dx._state.params, from_flax_params(dx_j._state.params)
    assert dx._state.step == 2 and max(_rel(p[k], p_j[k]) for k in p_j) <= 1e-4
    assert os.path.exists(os.path.join(dx.cfg.model_path, dx.cfg.ver, "epoch-0", "state.pt"))
    with pytest.raises(ValueError, match="labelled"):
        type(dx)(dx.cfg, [{"file_path": "x.wav", "wav_len": 8192}], [], device="cpu").train()


def _wav_steps(paths, paths_j):
    """Largest int16 difference between each pair of written wavs."""
    from deepxi_tpu_torch.data.wavio import read_wav
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in paths_j]
    worst = 0
    for a, b in zip(paths, paths_j):
        wa, wb = read_wav(a)[0].astype(np.int64), read_wav(b)[0].astype(np.int64)
        assert wa.shape == wb.shape
        worst = max(worst, int(np.abs(wa - wb).max()))
    return worst


# (out_type, family, gains): MagPhonemes' pho and y, hybrid_mixmax with the
# network's posteriors, the classical modes (any family; MixMax of MagXi
# without posteriors)
INFER_RUNS = [("pho", "MagPhonemes", None), ("y", "MagPhonemes", ["omlsa"]),
              ("y", "MagPhonemes", ["mixmax"]),
              ("hybrid_mixmax", "MagPhonemes", None), ("hybrid_omlsa", "MagPhonemes", None),
              ("tracking_hist", "MagPhonemes", None), ("tracking_vts", "MagPhonemes", None),
              ("hybrid_mixmax", "MagXi", None)]


@pytest.mark.parametrize("out_type,family,gains", INFER_RUNS,
                         ids=[f"{o}-{f}" + ("-mixmax" if g == ["mixmax"] else "")
                              for o, f, g in INFER_RUNS])
def test_infer_matches_jax(out_type, family, gains, corpus, tmp_path_factory):
    """The trained classifier's weights in both packages: `pho`'s posteriors
    within 3e-5 (measured 9.1e-6: the network reads |X| of the spectral
    kernel's plain version, JAX the FFT's) and its token CSV the same
    wherever JAX's two most likely classes are more than 3e-5 apart; every
    wav within 1 int16 step of JAX's; the float waveform of a hybrid mode
    (`hybrid_enhancer` against the function JAX's `infer` jitted) within
    WAVE_TOL32 of its scale (measured 5.8e-7), VTS within 2e-4 (its
    near-silent output here, peak 5.6e-4, carries the float32 rounding of
    its log-domain estimate: 7.0e-5 measured)."""
    from deepxi_tpu.framework import DeepXiTPU
    from deepxi_tpu_torch.framework import DeepXiTorch
    dx, dx_j, _, _ = _phoneme_frameworks(corpus, tmp_path_factory.mktemp("t"))
    params = dx._state.params
    if family != "MagPhonemes":
        tmp = tmp_path_factory.mktemp(family)
        cfg, cfg_j = _configs(corpus, tmp, family)
        os.makedirs(cfg.data_path)
        np.savez(os.path.join(cfg.data_path, f"{cfg.ver}_stats.npz"),
                 **{"xi_map.mu": np.zeros(257, np.float32),
                    "xi_map.sigma": np.ones(257, np.float32)})
        dx, dx_j = DeepXiTorch(cfg, device="cpu"), DeepXiTPU(cfg_j)
    kw = dict(out_type=out_type, epochs=[1], gains=gains)
    got = dx.infer(params=params, **kw)
    it_j = dx_j.inp_tgt
    if gains == ["mixmax"]:   # JAX's family takes its Gaussians as a field
        from deepxi_tpu.dsp.mixmax import gaussians_from_stats
        z = np.load(dx.cfg.mixmax_stats)
        dx_j.inp_tgt = it_j.replace(mixmax_model=gaussians_from_stats(
            z["means"], z["stds"], z["probs"]))
    try:
        ref = dx_j.infer(params=_flax_params(params), **kw)
    finally:
        dx_j.inp_tgt = it_j
    assert len(got) == len(ref) == 2
    sub = "classical" if out_type.startswith(("hybrid", "tracking")) and not (
        out_type == "hybrid_mixmax" and family == "MagPhonemes") else "e1"
    assert all(os.sep + sub + os.sep in p for p in got)
    if out_type != "pho":
        steps = _wav_steps(got, ref)
        print(f"{out_type} {family}: largest int16 difference {steps}")
        assert steps <= 1
        if out_type != "y":   # the float waveform of the longer utterance, padded
            from deepxi_tpu_torch.data.wavio import read_wav
            x = read_wav(str(corpus / "test" / "t1_white_0dB.wav"))[0]
            w = dx._padded(x, len(x))
            y = dx.hybrid_enhancer(out_type, params)(w).numpy()
            e = 1 if sub == "e1" else None
            y_j = np.asarray(dx_j._jit_cache[f"hyb_{out_type}_{e}"](jnp.asarray(w[0])))
            print(f"{out_type} {family}: float waveform {_rel(y, y_j):.3e} of its scale "
                  f"{np.abs(y_j).max():.3e}")
            assert y.shape == y_j.shape
            assert _rel(y, y_j) <= (2e-4 if out_type == "tracking_vts" else WAVE_TOL32)
        return
    for path, path_j in zip(got, ref):
        post, post_j = loadmat(path)["pho_post"], loadmat(path_j)["pho_post"]
        assert post.shape == post_j.shape and post.shape[1] == 98
        assert np.abs(post - post_j).max() <= 3e-5
        tok = open(path[:-4] + ".csv").read().split("\n")
        tok_j = open(path_j[:-4] + ".csv").read().split("\n")
        top2 = np.sort(post_j, axis=1)[:, -2:]
        clear = np.append(top2[:, 1] - top2[:, 0] > 3e-5, True)
        assert len(tok) == len(tok_j) == post.shape[0] + 1
        assert [a for a, c in zip(tok, clear) if c] == [b for b, c in zip(tok_j, clear) if c]


def test_importing_the_new_modules_pulls_in_no_jax():
    """A fresh interpreter importing the port's dsp package, every module of
    it, hybrid_infer and the two tools of this slice has neither JAX nor
    the JAX package (nor TensorFlow) loaded."""
    import subprocess
    code = ("import sys; sys.path.insert(0, 'tools'); import deepxi_tpu_torch.dsp, "
            "deepxi_tpu_torch.dsp.trackers, deepxi_tpu_torch.dsp.histnoise, "
            "deepxi_tpu_torch.dsp.mixmax, deepxi_tpu_torch.dsp.vts, "
            "deepxi_tpu_torch.dsp.labels, deepxi_tpu_torch.dsp.phoneme, "
            "deepxi_tpu_torch.hybrid_infer, torch_build_gaussians, torch_hybrid; "
            "print(sorted(m for m in ('tensorflow', 'jax', 'flax', 'deepxi_tpu') "
            "if m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
