"""The port's main path at full width on the checked-in trained
resnet-1.1c artifact, against the JAX package on the CPU in float32; plus
the weight bridge, the device default and import hygiene."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.compat.artifact import load_flagship_artifact as load_j
from deepxi_tpu.enhance import make_enhancer as make_enhancer_j
from deepxi_tpu.metrics import stoi
from deepxi_tpu.metrics.pesq import pesq
from deepxi_tpu.ops.kernels.spectral import stft_mag as stft_mag_j
from deepxi_tpu.sig.mix import normalise as normalise_j
from deepxi_tpu_torch import resolve_device
from deepxi_tpu_torch.compat.artifact import (FLAGSHIP_PARAMS, flax_order,
                                              from_flax_params,
                                              load_flagship_artifact)
from deepxi_tpu_torch.enhance import (make_enhancer, make_gain_synthesiser,
                                      make_xi_estimator, noise_gain)
from deepxi_tpu_torch.ops.kernels.tcn_fused import resnetv2_apply_fused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_run():
    it, net, params, noisy, clean = load_j()
    x = jnp.asarray(noisy[None])
    y = np.asarray(make_enhancer_j(it, net, "mmse-lsa", precision="highest")(params, x))
    mag = stft_mag_j(normalise_j(x), 512, 256, 512, "highest")
    return params, np.asarray(net.apply(params, mag)), np.array(mag), y


@pytest.fixture(scope="module")
def port():
    return load_flagship_artifact(device="cpu")


def test_weight_bridge(jax_run, port):
    """p0..p244 land on the same modules as in the JAX package's tree; the
    flagship has 1,949,953 parameters."""
    params_j = from_flax_params(jax.tree_util.tree_map(np.asarray, jax_run[0]))
    assert flax_order(port.params) == flax_order(params_j)
    assert sum(v.numel() for v in port.params.values()) == FLAGSHIP_PARAMS
    for k, v in params_j.items():
        torch.testing.assert_close(port.params[k], v, rtol=0, atol=0)
    assert flax_order(port.params)[:2] == [
        "block0_u1_conv.bias", "block0_u1_conv.kernel"]
    assert flax_order(port.params)[240:] == [
        "ff_conv.bias", "ff_conv.kernel", "ff_ln.scale", "out_conv.bias",
        "out_conv.kernel"]


# Measured on the CPU, float32, against the JAX package: network output
# 8.0e-7 max abs (plain), 3.1e-7 (fused plain versions, both routes);
# waveform 1.7e-7 max abs, 5.4e-7 relative RMS. Held to 1e-4 / 1e-5 / 1e-5.
@pytest.mark.parametrize("route", ["plain", "whole", "tiled"])
def test_main_path_matches_jax(jax_run, port, route):
    _, tgt_j, mag_j, y_j = jax_run
    apply_fn = {
        "plain": None,
        "whole": lambda p, m: resnetv2_apply_fused(p, m),
        "tiled": lambda p, m: resnetv2_apply_fused(p, m, whole_max_t=0),
    }[route]
    with torch.no_grad():
        tgt = (apply_fn or (lambda p, m: port.net(m)))(port.params,
                                                      torch.as_tensor(mag_j))
    np.testing.assert_allclose(tgt.numpy(), tgt_j, rtol=0, atol=1e-4)
    y = make_enhancer(port.inp_tgt, port.net, "mmse-lsa", apply_fn=apply_fn,
                      device="cpu")(port.params, port.noisy[None]).numpy()
    assert y.shape == y_j.shape == (1, (250 + 1) * 256)
    assert np.abs(y - y_j).max() <= 1e-5
    assert np.sqrt(np.mean((y - y_j) ** 2) / np.mean(y_j ** 2)) <= 1e-5


def test_quality_matches_jax(jax_run, port):
    """PESQ/STOI of the port's main path (fused route, plain versions on the
    CPU) equal the JAX package's to 1e-3; enhancement beats the noisy input."""
    y_j = jax_run[3][0]
    y = make_enhancer(port.inp_tgt, port.net, "mmse-lsa",
                      apply_fn=lambda p, m: resnetv2_apply_fused(p, m),
                      device="cpu")(port.params, port.noisy[None]).numpy()[0]
    s = port.clean.astype(np.float64) / 32768.0
    n = len(s)
    scores = [(pesq(s, w[:n], 16000, "nb"), stoi(s, w[:n], 16000))
              for w in (y, y_j, port.noisy / 32768.0)]
    np.testing.assert_allclose(scores[0], scores[1], rtol=0, atol=1e-3)
    assert scores[0][0] > scores[2][0] + 0.3


def test_entry_points_default_to_the_card(port):
    """Without device="cpu" the entry points take the card, and raise when
    there is none instead of running on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        load_flagship_artifact()
    with pytest.raises(RuntimeError):
        make_enhancer(port.inp_tgt, port.net)
    with pytest.raises(RuntimeError):
        make_xi_estimator(port.inp_tgt, port.net)
    with pytest.raises(RuntimeError):
        make_gain_synthesiser(port.inp_tgt, port.net, noise_gain)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(REPO, "deepxi_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    bad = {(os.path.relpath(p, REPO), root) for p in paths
           for root in _imported_roots(p)
           if root in ("jax", "jaxlib", "flax", "deepxi_tpu")}
    assert not bad, bad
