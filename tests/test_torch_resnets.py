"""The rest of the TCN family (`deepxi_tpu_torch.models.tcn`): ResNet, the
non-causal and LN-first ResNetV2, and ResNetV3 against flax
(`deepxi_tpu.models.tcn`) on the same weights (the flax tree carried by
`compat.artifact.from_flax_params`, and leaf by leaf in flax order as
`load_artifact` reads params.npz) on the CPU; the presets resnet-1.1n,
resnet-1.0c and resnet-1.0n (and -vb) through `build_network` against the
JAX package's `network_selector`, their parameter counts at full width, and
the routes they take (their plain network: the fused kernels compute the
causal ReLU->LN->W+b ResNetV2 only). Tolerance 1e-4 on sigmoid outputs
(flax's LayerNorm takes the variance in one pass, the port in two)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from deepxi_tpu.config import preset as preset_j
from deepxi_tpu.models import network_selector
from deepxi_tpu_torch.compat.artifact import flax_order, from_flax_params
from deepxi_tpu_torch.config import preset
from deepxi_tpu_torch.framework import build_network, fast_apply_fn
from deepxi_tpu_torch.models.tcn import (AffineNorm, ResNet, ResNetV2, ResNetV3,
                                         init_flax_like)

SMALL = dict(d_model=32, n_blocks=5, d_f=16, k=3, max_d_rate=4)
# (network, causal, unit order)
NETS = [("ResNet", True, None), ("ResNet", False, None),
        ("ResNetV2", False, "ReLU->LN->W+b"), ("ResNetV2", True, "LN->ReLU->W+b"),
        ("ResNetV2", False, "LN->ReLU->W+b"), ("ResNetV3", True, "ReLU->LN->W+b"),
        ("ResNetV3", False, "LN->ReLU->W+b")]
IDS = [f"{n}-{'c' if c else 'n'}-{u or ''}" for n, c, u in NETS]


def _flax(network, causal, unit, n_feat=40, n_outp=24, seed=0):
    kw = dict(SMALL, causal=causal, outp_act="Sigmoid",
              **({"unit_type": unit} if unit else {}))
    net_j = network_selector(network, n_outp, **kw)
    params = net_j.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, n_feat)))
    # biases, LayerNorm scales and centres off their initial values
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + np.random.RandomState(a.size).uniform(-0.2, 0.2, a.shape)
                             .astype(np.float32) if a.ndim == 1 else a), params)
    return net_j, params


def _port(network, causal, unit, n_feat=40, n_outp=24):
    cls = {"ResNet": ResNet, "ResNetV2": ResNetV2, "ResNetV3": ResNetV3}[network]
    kw = dict(SMALL, causal=causal, **({"unit_type": unit} if unit else {}))
    return cls(n_feat, n_outp, **kw)


@pytest.mark.parametrize("network,causal,unit", NETS, ids=IDS)
def test_network_matches_flax(network, causal, unit):
    """The same output on the same weights, with padding 'causal' or
    'same'; a non-causal net sees the future (a causal one does not)."""
    net_j, params = _flax(network, causal, unit)
    net = _port(network, causal, unit)
    p = from_flax_params(params)
    assert set(p) == set(net.state_dict())
    x = np.abs(np.random.RandomState(1).randn(2, 30, 40)).astype(np.float32)
    y = functional_call(net, p, (torch.as_tensor(x),)).detach().numpy()
    y_j = np.asarray(net_j.apply(params, jnp.asarray(x)))
    assert np.abs(y - y_j).max() <= 1e-4
    x2 = x.copy()
    x2[:, 20:] += 1.0
    y2 = functional_call(net, p, (torch.as_tensor(x2),)).detach().numpy()
    assert (np.abs(y2[:, :20] - y[:, :20]).max() > 1e-6) != causal


@pytest.mark.parametrize("network,causal,unit", NETS[:1] + NETS[5:6], ids=IDS[:1] + IDS[5:6])
def test_leaves_load_in_flax_order(network, causal, unit):
    """params.npz's leaves p0..pN in flax tree-flatten order land on the
    port's state-dict keys sorted by `flax_order`, shape by shape."""
    net_j, params = _flax(network, causal, unit)
    leaves = jax.tree_util.tree_leaves(params)
    net = _port(network, causal, unit)
    keys = flax_order(net.state_dict())
    assert len(keys) == len(leaves)
    p = from_flax_params(params)
    for k, leaf in zip(keys, leaves):
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(leaf))


def test_init_flax_like_sets_the_layer_norms():
    """Seeded: conv kernels lecun-normal (std 1/sqrt(fan_in)), biases 0,
    LayerNorm scales 1 and centres 0 (ResNet's affine norms)."""
    net = init_flax_like(ResNet(257, 257, n_blocks=4, d_model=64, d_f=32, k=3,
                                max_d_rate=4), torch.Generator().manual_seed(0))
    norms = [m for m in net.modules() if isinstance(m, AffineNorm)]
    assert len(norms) == 1 + 3 * 4
    assert all((m.scale == 1).all() and (m.bias == 0).all() for m in norms)
    w = net.block1_u2_conv.kernel.detach()
    assert abs(float(w.std()) * (3 * 32) ** 0.5 - 1.0) < 0.1
    assert float(net.block0_u3_conv.bias.detach().abs().sum()) == 0.0


PRESETS = ["resnet-1.1n", "resnet-1.0c", "resnet-1.0n", "resnet-1.1n-vb", "resnet-1.0c-vb",
           "resnet-1.0n-vb"]


@pytest.mark.parametrize("ver", PRESETS)
def test_presets_build_the_jax_network(ver):
    """The preset's fields equal the JAX package's; at small widths its
    network matches flax's; at full width it has flax's parameter count;
    the inference and train routes take the plain network."""
    cfg, cfg_j = preset(ver), preset_j(ver)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(cfg_j, f.name), f.name
    assert fast_apply_fn(cfg) is None
    n_full = sum(v.numel() for v in build_network(cfg, 257, 257).state_dict().values())
    shapes = jax.eval_shape(lambda: network_selector(
        cfg_j.network_type, 257, **cfg_j.network_kwargs()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 257))))
    assert n_full == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    small = cfg.replace(**SMALL)
    net = build_network(small, 40, 24)
    net_j = network_selector(cfg_j.network_type, 24, **cfg_j.replace(**SMALL).network_kwargs())
    params = net_j.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 40)))
    x = np.abs(np.random.RandomState(3).randn(1, 25, 40)).astype(np.float32)
    y = functional_call(net, from_flax_params(params), (torch.as_tensor(x),)).detach()
    assert np.abs(y.numpy() - np.asarray(net_j.apply(params, jnp.asarray(x)))).max() <= 1e-4
