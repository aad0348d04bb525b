"""The port's reference importers (`deepxi_tpu_torch.compat.tf_import`, its
own copy of the JAX package's) against `deepxi_tpu.compat` on the CPU: each
Keras checkpoint mapper on a synthetic `layer_with_weights` dict gives the
JAX package's tree, whose flattened leaves (`compat.artifact.from_flax_params`)
are the port network's state dict; a ResLSTM imported from a live Keras
model gives Keras' output (where TensorFlow is installed); a reference
statistics pickle adopted by `DeepXiTorch` (`import_stats`, and
`--import_stats` on the command line) gives `DeepXiTPU`'s statistics; and
importing the port pulls in neither TensorFlow nor JAX."""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from deepxi_tpu import cli as cli_j
from deepxi_tpu.compat import tf_import as tf_import_j
from deepxi_tpu.config import Config as ConfigJ
from deepxi_tpu.framework import DeepXiTPU
from deepxi_tpu_torch import cli
from deepxi_tpu_torch.compat import tf_import
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.config import Config
from deepxi_tpu_torch.data.wavio import save_wav
from deepxi_tpu_torch.framework import DeepXiTorch
from deepxi_tpu_torch.models import network_selector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_IN, N_OUTP = 40, 24


def _r(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _ln(rng, c):
    return {"gamma": _r(rng, c), "beta": _r(rng, c)}


def _resnet_layers(rng, version, n_blocks=2, d_model=16, d_f=8, k=3):
    """A ResNet (version 1) or ResNetV2/V3 checkpoint in Keras order."""
    layers = {0: {"kernel": _r(rng, 1, D_IN, d_model)}}
    if version == 1:
        layers[1] = _ln(rng, d_model)
    else:
        layers[0]["bias"] = _r(rng, d_model)
        layers[1] = {"gamma": _r(rng, d_model)}
    for _ in range(n_blocks):
        for u, (c_in, c_out, kk) in enumerate(((d_model, d_f, 1), (d_f, d_f, k),
                                              (d_f, d_model, 1)), start=1):
            if version == 1:
                layers[len(layers)] = _ln(rng, c_in)
            conv = {"kernel": _r(rng, kk, c_in, c_out)}
            if version != 1 or u == 3:
                conv["bias"] = _r(rng, c_out)
            layers[len(layers)] = conv
    layers[len(layers)] = {"kernel": _r(rng, 1, d_model, N_OUTP), "bias": _r(rng, N_OUTP)}
    return layers


def _mhanet_layers(rng, version, n_blocks=2, d_model=16, n_heads=4):
    """An MHANet V1, V2 or V3 checkpoint in Keras order."""
    d_k = d_model // n_heads
    layers = {0: {"kernel": _r(rng, 1, D_IN, d_model)}, 1: _ln(rng, d_model)}
    if version == 3:
        layers[2] = {"embeddings": _r(rng, 64, d_model)}
    for _ in range(n_blocks):
        if version == 1:
            mha = {f"linear_{n}/kernel": _r(rng, 1, d_model, d_model) for n in "qkvo"}
        else:
            mha = {f"{n}_kernel": _r(rng, n_heads, d_model, d_k)
                   for n in ("query", "key", "value")}
            mha["projection_kernel"] = _r(rng, n_heads, d_k, d_model)
        for entry in (mha, _ln(rng, d_model),
                      {"kernel": _r(rng, 1, d_model, 4 * d_model), "bias": _r(rng, 4 * d_model)},
                      {"kernel": _r(rng, 1, 4 * d_model, d_model), "bias": _r(rng, d_model)},
                      _ln(rng, d_model)):
            layers[len(layers)] = entry
    layers[len(layers)] = {"kernel": _r(rng, 1, d_model, N_OUTP), "bias": _r(rng, N_OUTP)}
    return layers


def _reslstm_layers(rng, n_blocks=2, d_model=8):
    layers = {0: {"kernel": _r(rng, D_IN, d_model)}, 1: _ln(rng, d_model)}
    for i in range(n_blocks):
        layers[2 + i] = {"cell/kernel": _r(rng, d_model, 4 * d_model),
                         "cell/recurrent_kernel": _r(rng, d_model, 4 * d_model),
                         "cell/bias": _r(rng, 4 * d_model)}
    layers[2 + n_blocks] = {"layer/kernel": _r(rng, d_model, N_OUTP),
                            "layer/bias": _r(rng, N_OUTP)}
    return layers


# case: (importer name, its keywords, layers, the port network and keywords)
IMPORTS = {
    "ResNetV2": ("import_resnet", dict(n_blocks=2, version=2),
                 lambda rng: _resnet_layers(rng, 2),
                 ("ResNetV2", dict(d_model=16, n_blocks=2, d_f=8, k=3, max_d_rate=2))),
    "ResNet": ("import_resnet", dict(n_blocks=2, version=1),
               lambda rng: _resnet_layers(rng, 1),
               ("ResNet", dict(d_model=16, n_blocks=2, d_f=8, k=3, max_d_rate=2))),
    "MHANet": ("import_mhanet_v1", dict(n_blocks=2), lambda rng: _mhanet_layers(rng, 1),
               ("MHANet", dict(d_model=16, n_blocks=2, n_heads=4))),
    "MHANetV2": ("import_mhanet_v2", dict(n_blocks=2), lambda rng: _mhanet_layers(rng, 2),
                 ("MHANetV2", dict(d_model=16, n_blocks=2, n_heads=4))),
    "MHANetV3": ("import_mhanet_v3", dict(n_blocks=2), lambda rng: _mhanet_layers(rng, 3),
                 ("MHANetV3", dict(d_model=16, n_blocks=2, n_heads=4, max_len=64))),
    "ResLSTM": ("import_reslstm", dict(n_blocks=2), lambda rng: _reslstm_layers(rng),
                ("ResLSTM", dict(d_model=8, n_blocks=2))),
}


@pytest.mark.parametrize("case", list(IMPORTS))
def test_importer_matches_jax(case):
    """The same tree, leaf for leaf, as the JAX importer's; flattened, the
    port network's state dict (keys and shapes), which then runs."""
    name, kw, make, (nt, net_kw) = IMPORTS[case]
    layers = make(np.random.RandomState(0))
    tree, tree_j = getattr(tf_import, name)(layers, **kw), getattr(tf_import_j, name)(layers, **kw)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(tree_j)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(tree_j)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    net = network_selector(nt, D_IN, N_OUTP, **net_kw)
    p = from_flax_params(tree)
    sd = net.state_dict()
    assert set(p) == set(sd) and all(p[k].shape == sd[k].shape for k in sd)
    x = torch.as_tensor(np.abs(_r(np.random.RandomState(1), 1, 12, D_IN)))
    assert torch.isfinite(functional_call(net, p, (x,))).all()


def test_reslstm_import_matches_a_live_keras_model():
    """A Keras model of the reference's ResLSTM structure (Masking(0.0),
    Dense without bias, LayerNormalization, ReLU, residual LSTMs, a
    TimeDistributed Dense) with random weights: the port's ResLSTM on the
    imported weights gives Keras' output on every valid frame (2e-5, the
    JAX package's oracle test's limit; measured 1.8e-7), a padded tail
    included."""
    tf = pytest.importorskip("tensorflow")
    from tensorflow.keras.layers import (LSTM, Add, Dense, Input, LayerNormalization,
                                         Masking, ReLU, TimeDistributed)
    d_in, d_model, n_blocks, n_outp = 5, 8, 2, 7
    inp = Input(shape=(None, d_in))
    mask = Masking(mask_value=0.0).compute_mask(inp)
    x = ReLU()(LayerNormalization(axis=2, epsilon=1e-6)(Dense(d_model, use_bias=False)(inp)))
    for _ in range(n_blocks):
        x = Add()([x, LSTM(d_model, return_sequences=True)(x, mask=mask)])
    kmodel = tf.keras.Model(inp, TimeDistributed(Dense(n_outp))(x))
    rng = np.random.RandomState(4)
    layers = {}
    for lyr in kmodel.layers:
        w = lyr.get_weights()
        if not w:
            continue
        w = [_r(rng, *a.shape) * 0.4 for a in w]
        lyr.set_weights(w)
        if isinstance(lyr, TimeDistributed):
            entry = {"layer/kernel": w[0], "layer/bias": w[1]}
        elif isinstance(lyr, LSTM):
            entry = {"cell/kernel": w[0], "cell/recurrent_kernel": w[1], "cell/bias": w[2]}
        elif isinstance(lyr, LayerNormalization):
            entry = {"gamma": w[0], "beta": w[1]}
        else:
            entry = {"kernel": w[0]}
        layers[len(layers)] = entry
    net = network_selector("ResLSTM", d_in, n_outp, d_model=d_model, n_blocks=n_blocks,
                           outp_act="Linear")
    p = from_flax_params(tf_import.import_reslstm(layers, n_blocks=n_blocks))
    x_in = _r(rng, 2, 12, d_in)
    x_in[1, 8:] = 0.0
    y_k = np.asarray(kmodel(x_in))
    y = functional_call(net, p, (torch.as_tensor(x_in),)).detach().numpy()
    np.testing.assert_allclose(y[0], y_k[0], atol=2e-5)
    np.testing.assert_allclose(y[1, :8], y_k[1, :8], atol=2e-5)


def _write_reference_pickle(path, mu, sigma):
    """A reference `<ver>_inp_tgt.p`: a `deepxi.inp_tgt.MagXi` whose
    `xi_map` is a `deepxi.map.NormalCDF` with mu and sigma (numpy, as a
    pickle without TF tensors holds them), pickled under the stub modules
    (`sys.modules` restored after)."""
    with tf_import._ref_stub_scope():
        magxi = sys.modules["deepxi.inp_tgt"].MagXi
        ncdf = sys.modules["deepxi.map"].NormalCDF
        magxi.__module__, ncdf.__module__ = "deepxi.inp_tgt", "deepxi.map"
        obj, m = magxi(), ncdf()
        m.__dict__.update(map_type="DBNormalCDF", mu=mu, sigma=sigma)
        obj.__dict__.update(N_d=512, N_s=256, K=512, f_s=16000, n_feat=257, n_outp=257,
                            xi_map=m)
        with open(path, "wb") as f:
            pickle.dump(obj, f)


@pytest.fixture(scope="module")
def reference_pickle(tmp_path_factory):
    rng = np.random.RandomState(5)
    mu, sigma = _r(rng, 257) * 5.0, np.abs(_r(rng, 257)) * 3.0 + 1.0
    path = str(tmp_path_factory.mktemp("ref") / "resnet-1.1c_inp_tgt.p")
    _write_reference_pickle(path, mu, sigma)
    return path, mu, sigma


def test_load_inp_tgt_stats_matches_jax(reference_pickle):
    path, mu, sigma = reference_pickle
    st, st_j = tf_import.load_inp_tgt_stats(path), tf_import_j.load_inp_tgt_stats(path)
    assert st.keys() == st_j.keys() and st["inp_tgt_type"] == "MagXi" and st["N_s"] == 256
    assert st["xi_map"]["map_type"] == st_j["xi_map"]["map_type"] == "DBNormalCDF"
    np.testing.assert_array_equal(st["xi_map"]["mu"], mu)
    np.testing.assert_array_equal(st["xi_map"]["sigma"], st_j["xi_map"]["sigma"])


def test_import_stats_adopts_the_jax_statistics(reference_pickle, tmp_path):
    """`Config.import_stats`: both frameworks adopt the pickle's statistics
    (no training sample drawn) and write them as the stats file."""
    path, mu, sigma = reference_pickle
    kw = dict(ver="tiny", import_stats=path, network_type="ResNetV2", d_model=16,
              n_blocks=2, d_f=8, k=3, max_d_rate=2)
    dx = DeepXiTorch(Config(data_path=str(tmp_path / "d"), **kw), device="cpu")
    dx_j = DeepXiTPU(ConfigJ(data_path=str(tmp_path / "dj"), **kw))
    for field, ref in (("mu", mu), ("sigma", sigma)):
        got = getattr(dx.inp_tgt.xi_map, field)
        assert torch.is_tensor(got) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(dx_j.inp_tgt.xi_map,
                                                                      field)))
    z, z_j = np.load(tmp_path / "d" / "tiny_stats.npz"), np.load(tmp_path / "dj" / "tiny_stats.npz")
    assert sorted(z.files) == sorted(z_j.files) == ["xi_map.mu", "xi_map.sigma"]
    for k in z.files:
        np.testing.assert_array_equal(z[k], z_j[k])


def test_import_stats_on_the_command_line(reference_pickle, tmp_path, capsys):
    """`--import_stats` with `--train 1` (zero epochs): both command lines
    adopt the pickle and write the same stats file."""
    path, _, _ = reference_pickle
    rng = np.random.RandomState(6)
    save_wav(str(tmp_path / "set" / "train_clean_speech" / "s.wav"),
             (rng.randn(8000) * 3000).astype(np.int16), 16000)
    save_wav(str(tmp_path / "set" / "train_noise" / "n.wav"),
             (rng.randn(16000) * 2000).astype(np.int16), 16000)
    argv = ["--ver", "tiny", "--network_type", "ResNetV2", "--d_model", "16", "--n_blocks",
            "2", "--d_f", "8", "--k", "3", "--max_d_rate", "2", "--train", "1",
            "--max_epochs", "0", "--import_stats", path, "--platform", "cpu",
            "--set_path", str(tmp_path / "set")]
    for name, main in (("port", cli.main), ("jax", cli_j.main)):
        assert main(argv + [f"--{k}_path={tmp_path / name / k}"
                            for k in ("data", "model", "log")]) == 0
        assert f"adopted reference statistics from {path}" in capsys.readouterr().out
    z, z_j = (np.load(tmp_path / n / "data" / "tiny_stats.npz") for n in ("port", "jax"))
    assert sorted(z.files) == sorted(z_j.files)
    for k in z.files:
        np.testing.assert_array_equal(z[k], z_j[k])


def test_importing_the_port_pulls_in_no_tensorflow():
    """A fresh interpreter importing the package, its importers and its
    entry points has neither TensorFlow nor JAX loaded."""
    code = ("import sys; import deepxi_tpu_torch, deepxi_tpu_torch.cli, "
            "deepxi_tpu_torch.framework, deepxi_tpu_torch.compat.tf_import; "
            "print(sorted(m for m in ('tensorflow', 'jax', 'flax', 'deepxi_tpu') "
            "if m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
