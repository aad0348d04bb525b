"""The remaining networks through the framework, on the CPU: for rdlnet-1.0n
and reslstm-1.0c (and ResBiLSTM, MHANet V1 and mhanet-1.1c with the "block"
attention) at small widths, `DeepXiTorch` fits the map statistics and trains
one epoch on a synthetic corpus (the plain network under autograd), then
`infer` writes `y` (batched), `xi_hat` and `d_hat` (per utterance) and
`test()` scores the enhanced utterance; the JAX package's `DeepXiTPU` does
the same from the same checkpoint weights (the port's state dict nested
back into a flax tree at any depth) and the statistics file the port wrote.
The serving export of each network is loaded and run against the live
enhancer (the LSTMs' also through `--export 1`).

Measured on the CPU: every wav within 1 int16 step of the JAX package's
(held to 2), xi_hat within 1.8e-5 of 1 + xi (held to 2e-3, the families
slice's limit), every score within 1.9e-5 (held to 1e-3; STOI and eSTOI
0.1, SegSNR and SNR 0.01 dB, tests/test_torch_objective.py's limits)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.io import loadmat

from deepxi_tpu.config import Config as ConfigJ
from deepxi_tpu.config import preset as preset_j
from deepxi_tpu.framework import DeepXiTPU
from deepxi_tpu.inp_tgt import inp_tgt_selector as inp_tgt_selector_j
from deepxi_tpu.models import network_selector
from deepxi_tpu_torch.config import preset
from deepxi_tpu_torch.data.listing import batch_list
from deepxi_tpu_torch.data.wavio import read_wav, save_wav
from deepxi_tpu_torch.framework import DeepXiTorch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from synth_corpus import synth_noise, synth_utterance  # noqa: E402

# case: (preset, overrides to small widths)
CASES = {
    "rdlnet-1.0n": ("rdlnet-1.0n", dict(n_blocks=2, length=5, m_1=16)),
    "reslstm-1.0c": ("reslstm-1.0c", dict(d_model=16, n_blocks=2)),
    "ResBiLSTM": ("reslstm-1.0c", dict(network_type="ResBiLSTM", d_model=16, n_blocks=2)),
    "MHANet": ("mhanet-1.1c", dict(network_type="MHANet", d_model=32, n_blocks=2,
                                   n_heads=4)),
    "mhanet-1.1c-block": ("mhanet-1.1c", dict(d_model=32, n_blocks=2, n_heads=4,
                                              max_len=128, attention_impl="block",
                                              block_q=16)),
}
OUT_TYPES = ("y", "xi_hat", "d_hat")
SCORE_TOL = {"STOI": 0.1, "eSTOI": 0.1, "SegSNR": 1e-2, "SNR": 1e-2}
SCORE_TOL_OTHER = 1e-3


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
    s = synth_utterance(rng, 0.9)
    x = s.astype(np.float32) + 0.3 * synth_noise(rng, "pink", 0.9)[:len(s)]
    save_wav(str(root / "test_clean_speech" / "u1.wav"), s, 16000)
    save_wav(str(root / "test_noisy_speech" / "u1_pink_5dB.wav"),
             np.clip(x, -32768, 32767).astype(np.int16), 16000)
    return root


_BUILT = {}


def _flax_params(p):
    """The port's state dict as the flax tree, nested at every dot."""
    tree = {}
    for k, v in p.items():
        *mods, leaf = k.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(v.numpy())
    return {"params": tree}


def _frameworks(case, corpus, tmp):
    """The port's framework trained one epoch, its epoch-1 parameters, and
    a JAX framework on the same weights and statistics (built once a
    case)."""
    if case in _BUILT:
        return _BUILT[case]
    ver, over = CASES[case]
    kw = dict(over, mbatch_size=2, max_epochs=1, sample_size=6, val_flag=False, seed=1,
              min_snr=0, max_snr=10, snr_inter=5, metric_workers=1,
              data_path=str(tmp / "data"), model_path=str(tmp / "model"),
              test_x_path=str(corpus / "test_noisy_speech"),
              test_s_path=str(corpus / "test_clean_speech"))
    cfg = preset(ver, out_path=str(tmp / "out"), log_path=str(tmp / "log"), **kw)
    s_list = batch_list(str(corpus / "train_clean_speech"), "clean", cfg.data_path)
    d_list = batch_list(str(corpus / "train_noise"), "noise", cfg.data_path)
    dx = DeepXiTorch(cfg, s_list, d_list, device="cpu")
    losses = dx.train(verbose=False)
    params = dx.load_epoch(1)

    dx_j = DeepXiTPU.__new__(DeepXiTPU)
    dx_j.cfg = preset_j(ver, out_path=str(tmp / "out_j"), log_path=str(tmp / "log_j"), **kw)
    assert isinstance(dx_j.cfg, ConfigJ)
    c = dx_j.cfg
    dx_j.inp_tgt = inp_tgt_selector_j(c.inp_tgt_type, c.N_d, c.N_s, c.K, c.f_s,
                                      map_type=c.map_type, map_params=c.map_params,
                                      gain=c.gain)
    dx_j.inp_tgt = dx_j._load_stats(os.path.join(c.data_path, f"{c.ver}_stats.npz"))
    dx_j.network = network_selector(c.network_type, dx_j.inp_tgt.n_outp,
                                    **c.network_kwargs())
    _BUILT[case] = (dx, params, dx_j, _flax_params(params), losses)
    return _BUILT[case]


@pytest.mark.parametrize("case", list(CASES))
def test_trains_one_epoch(corpus, tmp_path_factory, case):
    """One epoch of two steps: a finite loss, the network of the preset's
    type, and a checkpoint whose leaves are the flax tree's."""
    dx, params, _, params_j, losses = _frameworks(case, corpus, tmp_path_factory.mktemp(case))
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert type(dx.network).__name__ == (CASES[case][1].get("network_type")
                                         or dx.cfg.network_type)
    assert set(params) == set(dx.network.state_dict())
    assert len(params) == len(jax.tree_util.tree_leaves(params_j))


@pytest.mark.parametrize("out_type", OUT_TYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_infer_matches_jax(corpus, tmp_path_factory, case, out_type):
    """The written wav within 2 int16 steps of the JAX package's; xi_hat
    within 2e-3 of 1 + xi."""
    dx, params, dx_j, params_j, _ = _frameworks(case, corpus, tmp_path_factory.mktemp(case))
    kw = dict(epochs=[1], gains=["mmse-lsa"], out_type=out_type)
    ours, theirs = dx.infer(params=params, **kw), dx_j.infer(params=params_j, **kw)
    assert [os.path.relpath(p, dx.cfg.out_path) for p in ours] == \
        [os.path.relpath(p, dx_j.cfg.out_path) for p in theirs]
    for path, path_j in zip(ours, theirs):
        if out_type == "xi_hat":
            a, a_j = loadmat(path)["xi_hat"], loadmat(path_j)["xi_hat"]
            assert a.shape == a_j.shape
            assert np.all(np.abs(a - a_j) <= 2e-3 * (1.0 + np.abs(a_j)))
        else:
            y, y_j = read_wav(path)[0], read_wav(path_j)[0]
            assert y.shape == y_j.shape and np.abs(y_j).max() > 30
            assert np.abs(y.astype(np.int32) - y_j).max() <= 2


@pytest.mark.parametrize("case", list(CASES))
def test_test_matches_jax(corpus, tmp_path_factory, case):
    """`test()` of the epoch: every metric of the one condition within the
    objective tests' limits of the JAX package's."""
    dx, params, dx_j, params_j, _ = _frameworks(case, corpus, tmp_path_factory.mktemp(case))
    kw = dict(epochs=[1], gains=["mmse-lsa"])
    ours = dx.test(params=params, **kw)[(1, "mmse-lsa")]
    theirs = dx_j.test(params=params_j, **kw)[(1, "mmse-lsa")]
    assert set(ours) == set(theirs) and {(k[0], k[1]) for k in ours} == {("pink", 5)}
    for k, v in ours.items():
        assert len(v) == 1 and np.isfinite(v[0])
        assert abs(v[0] - theirs[k][0]) <= SCORE_TOL.get(k[2], SCORE_TOL_OTHER), (k, v, theirs[k])


@pytest.mark.parametrize("case", list(CASES))
def test_export_serving(corpus, tmp_path_factory, case):
    """`DeepXiTorch.export_serving` of the epoch: every network exports
    (bucket 16,384, batch 1; a ResLSTM or ResBiLSTM through one
    `deepxi::masked_lstm` call a direction a block) and the loaded server
    gives the live enhancer's waveform on the utterance padded to the bucket
    (1e-6; a non-causal network's tail sees the padding). The LSTMs also
    export through `--export 1`, whose bundle (batch 32, every bucket) gives
    the same waveform."""
    from deepxi_tpu_torch import cli
    from deepxi_tpu_torch.serving import load_server

    dx, params, _, _, _ = _frameworks(case, corpus, tmp_path_factory.mktemp(case))
    out = str(tmp_path_factory.mktemp(case + "-serving"))
    written = dx.export_serving(out_dir=out, epoch=1, batch=1, buckets=(16384,))
    assert [os.path.basename(p) for p in written] == ["enhancer_L16384.pt2"]
    x = read_wav(os.path.join(dx.cfg.test_x_path, "u1_pink_5dB.wav"))[0][None]
    y = load_server(out)(x)
    xp = np.zeros((1, 16384), np.int16)
    xp[:, :x.shape[1]] = x
    y_live = dx.fast_enhancer("mmse-lsa")(params, xp).cpu().numpy()[:, :y.shape[1]]
    assert y.shape == y_live.shape and np.abs(y_live).max() > 1e-3
    assert np.abs(y - y_live).max() <= 1e-6
    if "LSTM" in type(dx.network).__name__:
        ver, over = CASES[case]
        out_cli = str(tmp_path_factory.mktemp(case + "-cli"))
        argv = ["--ver", ver, "--export", "1", "--test_epoch", "1", "--platform", "cpu",
                "--data_path", dx.cfg.data_path, "--model_path", dx.cfg.model_path,
                "--export_path", out_cli]
        argv += [a for k, v in over.items() for a in (f"--{k}", str(v))]
        assert cli.main(argv) == 0
        assert len(os.listdir(out_cli)) == 7  # the manifest and six buckets
        assert np.abs(load_server(out_cli)(x) - y_live).max() <= 1e-6
