"""The slice as a whole, on the CPU: for each input/target family (and for
MagXi at a 75%-overlap framing, N_s = 128), `DeepXiTorch` fits the map
statistics and trains a tiny ResNetV2 for one epoch on a synthetic corpus
(through the fused stack's plain versions), then `infer` writes every
out_type the family has; the JAX package's `DeepXiTPU.infer` writes the
same from the same weights (carried by `from_flax_params`' inverse) and
the statistics file the port wrote, read by `DeepXiTPU._load_stats`. The
written wavs and .mat files are held against each other. MagGamma's `y`
also runs through a saved xi_hat (`saved_data_path`)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.io import loadmat

from deepxi_tpu.config import Config as ConfigJ
from deepxi_tpu.data import test_batch as read_test_set
from deepxi_tpu.framework import DeepXiTPU
from deepxi_tpu.inp_tgt import inp_tgt_selector as inp_tgt_selector_j
from deepxi_tpu.models import network_selector
from deepxi_tpu_torch.config import Config
from deepxi_tpu_torch.data.listing import batch_list
from deepxi_tpu_torch.data.wavio import read_wav, save_wav
from deepxi_tpu_torch.framework import DeepXiTorch
from deepxi_tpu_torch.sig.mel import mel_filter_bank

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from synth_corpus import synth_noise, synth_utterance  # noqa: E402

NET = dict(network_type="ResNetV2", d_model=16, n_blocks=2, d_f=8, k=3, max_d_rate=2,
           unit_type="ReLU->LN->W+b", causal=True)
# case: (Config fields, the out_types the family writes)
XI_OUT = ("y", "xi_hat", "gamma_hat", "deepmmse", "ibm_hat", "subband_ibm_hat", "d_hat")
CASES = {
    "MagXi-LaplaceCDF": (dict(inp_tgt_type="MagXi", map_type="DBLaplaceCDF",
                              map_params=[0.0]), XI_OUT),
    "MagXi-T_s8": (dict(inp_tgt_type="MagXi", T_s=8), ("y", "xi_hat", "d_hat")),
    "MagGamma": (dict(inp_tgt_type="MagGamma"), XI_OUT),
    "MagXiGamma": (dict(inp_tgt_type="MagXiGamma", map_type=["DBNormalCDF", "DBNormalCDF"]),
                   XI_OUT),
    "MagGain": (dict(inp_tgt_type="MagGain", gain="mmse-lsa"), ("y",)),
    "MagGain-ibm": (dict(inp_tgt_type="MagGain", gain="ibm"), ("y",)),
    "MagMag": (dict(inp_tgt_type="MagMag"), ("y", "mag_hat")),
    "MagSMM": (dict(inp_tgt_type="MagSMM", loss_fnc="MeanSquaredError",
                    outp_act="Softplus"), ("y",)),
    "MagPhaXiPha": (dict(inp_tgt_type="MagPhaXiPha",
                         map_type=[["DB", "NormalCDF"], ["UniformCDF"]]),
                    ("y", "xi_hat", "ibm_hat", "subband_ibm_hat")),
    "STDCTXiCD": (dict(inp_tgt_type="STDCTXiCD", map_type=["DBNormalCDF", "NormalCDF"]),
                  ("y", "xi_hat", "deepmmse", "ibm_hat", "cd_hat")),
}
# (case, out_type, fast): `y` of a gain-form family both batched and per utterance
RUNS = [(c, o, True) for c, (_, outs) in CASES.items() for o in outs] + \
    [(c, "y", False) for c in ("MagXi-LaplaceCDF", "MagXiGamma", "MagGain", "MagSMM",
                               "MagMag")] + [("MagGamma", "y-saved", False)]
MAT_KEYS = {"deepmmse": "d_psd_hat"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    for i in range(4):
        save_wav(str(root / "train_clean_speech" / f"sp{i}.wav"),
                 synth_utterance(rng, 0.5 + 0.1 * i), 16000)
    for j in range(2):
        save_wav(str(root / "train_noise" / f"n{j}.wav"),
                 synth_noise(rng, ("white", "pink")[j], 3.0), 16000)
    s = synth_utterance(rng, 0.7)
    x = s.astype(np.float32) + 0.3 * synth_noise(rng, "pink", 0.7)[:len(s)]
    save_wav(str(root / "test" / "u1_pink_5dB.wav"),
             np.clip(x, -32768, 32767).astype(np.int16), 16000)
    return root


_BUILT = {}


def _flax_params(p):
    tree = {}
    for k, v in p.items():
        mod, leaf = k.rsplit(".", 1)
        tree.setdefault(mod, {})[leaf] = jnp.asarray(v.numpy())
    return {"params": tree}


def _frameworks(case, corpus, tmp):
    """The trained port framework, its parameters, and a JAX framework on
    the same weights and statistics (built once a case)."""
    if case in _BUILT:
        return _BUILT[case]
    fields, _ = CASES[case]
    kw = dict(NET, ver=f"tiny-{case.lower()}", mbatch_size=2, max_epochs=1, sample_size=6,
              val_flag=False, tcn_fused_train=True, seed=1, min_snr=0, max_snr=10,
              snr_inter=5, **fields)
    paths = dict(data_path=str(tmp / "data"), model_path=str(tmp / "model"),
                 log_path=str(tmp / "log"), test_x_path=str(corpus / "test"))
    cfg = Config(out_path=str(tmp / "out"), **paths, **kw)
    s_list = batch_list(str(corpus / "train_clean_speech"), "clean", cfg.data_path)
    d_list = batch_list(str(corpus / "train_noise"), "noise", cfg.data_path)
    dx = DeepXiTorch(cfg, s_list, d_list, device="cpu")
    losses = dx.train(verbose=False)
    assert len(losses) == 1 and np.isfinite(losses[0])
    params = dx.load_epoch(1)

    dx_j = DeepXiTPU.__new__(DeepXiTPU)
    dx_j.cfg = ConfigJ(out_path=str(tmp / "out_j"), **paths, **kw)
    c = dx_j.cfg
    dx_j.inp_tgt = inp_tgt_selector_j(c.inp_tgt_type, c.N_d, c.N_s, c.K, c.f_s,
                                      map_type=c.map_type, map_params=c.map_params,
                                      gain=c.gain)
    stats = os.path.join(c.data_path, f"{c.ver}_stats.npz")
    assert os.path.exists(stats) == dx_j._needs_stats()   # MagGain, MagSMM: no maps
    if os.path.exists(stats):
        dx_j.inp_tgt = dx_j._load_stats(stats)
    dx_j.network = network_selector(c.network_type, dx_j.inp_tgt.n_outp,
                                    **c.network_kwargs())
    _BUILT[case] = (dx, params, dx_j, _flax_params(params))
    return _BUILT[case]


def _db(x):
    return 10.0 * np.log10(np.maximum(np.asarray(x, np.float64), 1e-12))


@pytest.mark.parametrize("case,out_type,fast", RUNS,
                         ids=[f"{c}-{o}{'' if f else '-per_utterance'}" for c, o, f in RUNS])
def test_infer_matches_jax(corpus, tmp_path_factory, case, out_type, fast):
    """The written file of each out_type. Measured on the CPU: every wav
    within 1 int16 step (held to 2), but MagMag's, whose untrained
    magnitudes pass int16's range, so its float waveform is held to 1e-4
    of its scale; xi_hat and gamma_hat within 3.9e-4 of 1 + xi (held to
    2e-3: MagGamma's xi_hat = gamma_hat - 1 cancels); other .mat values
    within 1e-3 of their scale; masks differing only where JAX's estimate
    lies within 1e-2 dB of 0 dB."""
    dx, params, dx_j, params_j = _frameworks(case, corpus, tmp_path_factory.mktemp(case))
    kw = dict(epochs=[1], gains=["mmse-lsa"], fast=fast)
    if out_type == "y-saved":
        xi_dir = os.path.dirname(dx.infer(params=params, out_type="xi_hat", **kw)[0])
        dx.cfg = dx.cfg.replace(saved_data_path=xi_dir)
        dx_j.cfg = dx_j.cfg.replace(saved_data_path=xi_dir)
        out_type = "y"
    ours = dx.infer(params=params, out_type=out_type, **kw)
    theirs = dx_j.infer(params=params_j, out_type=out_type, **kw)
    dx.cfg = dx.cfg.replace(saved_data_path=None)
    dx_j.cfg = dx_j.cfg.replace(saved_data_path=None)
    rel = [os.path.relpath(p, dx.cfg.out_path) for p in ours]
    assert rel == [os.path.relpath(p, dx_j.cfg.out_path) for p in theirs]
    if out_type == "y":   # MagGain and MagMag write y/ with no gain directory
        assert (os.path.basename(os.path.dirname(rel[0])) == "y") == \
            (dx.cfg.inp_tgt_type in ("MagGain", "MagMag"))
    for path, path_j in zip(ours, theirs):
        if path.endswith(".wav"):
            y, y_j = read_wav(path)[0], read_wav(path_j)[0]
            assert y.shape == y_j.shape and np.abs(y_j).max() > 30
            if dx.cfg.inp_tgt_type != "MagMag":
                assert np.abs(y.astype(np.int32) - y_j).max() <= 2
            else:   # past int16's range the written samples wrap: the floats
                f, f_j = _float_y(dx, params, dx_j, params_j, fast)
                assert np.abs(f_j).max() > 1.0
                assert np.abs(f - f_j).max() <= 1e-4 * np.abs(f_j).max()
            continue
        key = MAT_KEYS.get(out_type, out_type)
        a, a_j = loadmat(path)[key], loadmat(path_j)[key]
        assert a.shape == a_j.shape
        if out_type in ("ibm_hat", "subband_ibm_hat"):
            xi_j = _jax_xi_hat(dx_j, params_j, path_j)
            if out_type == "subband_ibm_hat":
                xi_j = xi_j @ mel_filter_bank(40, dx.cfg.K, 16000).T
            assert np.all(np.abs(_db(xi_j))[a != a_j] <= 1e-2)
        elif out_type in ("xi_hat", "gamma_hat"):
            assert np.all(np.abs(a - a_j) <= 2e-3 * (1.0 + np.abs(a_j)))
        else:
            assert np.abs(a - a_j).max() <= 1e-3 * max(np.abs(a_j).max(), 1e-30)


def _float_y(dx, params, dx_j, params_j, fast):
    """The float waveform of the test utterance before it is written: the
    batched route (`enhance_all`, `_enhance_all`) or the per-utterance
    `enhanced_speech` route."""
    x, n, _, names = read_test_set(dx_j.cfg.test_x_path)
    if fast:
        return (dx.enhance_all(params, x, n, "mmse-lsa")[0],
                dx_j._enhance_all(params_j, x, n, names, "mmse-lsa")[0])
    inp, sup, nf = dx_j._observe(x[0], int(n[0]))
    tgt = dx_j.network.apply(params_j, inp[None])[0]
    y_j = dx_j.inp_tgt.enhanced_speech(inp[:nf], sup[:nf], tgt[:nf], "mmse-lsa")
    return dx._utterance_y(params, x[0], int(n[0]), "mmse-lsa"), np.asarray(y_j)


def _jax_xi_hat(dx_j, params_j, path_j):
    """The JAX route's xi_hat of the test utterance written at `path_j`."""
    name = os.path.splitext(os.path.basename(path_j))[0]
    x, n, _, names = read_test_set(dx_j.cfg.test_x_path)
    i = list(names).index(name)
    inp, _, nf = dx_j._observe(x[i], int(n[i]))
    return np.asarray(dx_j.inp_tgt.xi_hat(dx_j.network.apply(params_j, inp[None])[0][:nf]))
