"""The remaining networks of the selector (`deepxi_tpu_torch.models`: MHANet
V1, ResLSTM, ResBiLSTM, RDLNet, and MHANetV2/V3 with the "block" attention)
against flax (`deepxi_tpu.models`) on the CPU, on the same weights (the flax
tree, nested to any depth, carried by `compat.artifact.from_flax_params`)
and the same numpy-seeded inputs: two rows of T = 70 frames, the second
padded with zero frames after 45, the first with one all-zero frame inside
(masked by every network that masks: the LSTMs keep their state over it).

Measured on the CPU: forwards within 4.8e-7 of flax (RDLNet's too: its
unit LayerNorms take the variance in one pass, as flax's do), held to 5e-5;
gradients of the masked BCE loss within 1.5e-6 of each leaf's scale of
`jax.grad`'s, held to 1e-4; "block" equal to "full" (0.0), held to 2e-5. Also: causality where a
network is causal, the state-dict keys and parameter counts at the presets'
widths against `jax.eval_shape` of the JAX selector, flax's leaf order at
depth four, the initialiser's distributions, and the selector's error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from deepxi_tpu.config import preset as preset_j
from deepxi_tpu.models import network_selector as selector_j
from deepxi_tpu.training import masked_loss as masked_loss_j
from deepxi_tpu_torch.compat.artifact import flax_order, from_flax_params
from deepxi_tpu_torch.config import preset
from deepxi_tpu_torch.framework import build_network, fast_apply_fn
from deepxi_tpu_torch.models import init_flax_like, network_selector
from deepxi_tpu_torch.models.attention import NEG_INF_V1, attention_masks
from deepxi_tpu_torch.models.rnn import LSTMCell
from deepxi_tpu_torch.training import masked_loss

N_FEAT, N_OUTP, T = 40, 24, 70
LENGTHS = (70, 45)
# case: (network type, selector keywords)
CASES = {
    "MHANet": ("MHANet", dict(d_model=32, n_blocks=2, n_heads=4, causal=True)),
    "ResLSTM": ("ResLSTM", dict(d_model=16, n_blocks=2)),
    "ResBiLSTM": ("ResBiLSTM", dict(d_model=16, n_blocks=2)),
    "RDLNet": ("RDLNet", dict(n_blocks=2, length=5, m_1=16, causal=False)),
    "MHANetV2-block": ("MHANetV2", dict(d_model=32, n_blocks=2, n_heads=4, causal=True,
                                        attention_impl="block", block_q=16)),
    "MHANetV3-block": ("MHANetV3", dict(d_model=32, n_blocks=2, n_heads=4, causal=False,
                                        max_len=128, attention_impl="block", block_q=16)),
}
FWD_TOL = 5e-5
GRAD_TOL_REL = 1e-4

_BUILT = {}


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    x = (np.abs(rng.randn(2, T, N_FEAT)) + 1e-3).astype(np.float32)
    x[1, LENGTHS[1]:] = 0.0
    x[0, 20] = 0.0            # an all-zero frame inside the utterance
    tgt = rng.uniform(0.05, 0.95, (2, T, N_OUTP)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array(LENGTHS)[:, None]).astype(np.float32)
    return x, tgt, mask


def _case(name):
    """(flax module, its parameters with biases, LayerNorm scales and LSTM
    biases moved off their initial values, the port's network)."""
    if name not in _BUILT:
        nt, kw = CASES[name]
        net_j = selector_j(nt, N_OUTP, **kw)
        params = net_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, N_FEAT)))
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a + np.random.RandomState(a.size).uniform(-0.2, 0.2, a.shape)
                                 .astype(np.float32) if a.ndim == 1 else a), params)
        _BUILT[name] = (net_j, params, network_selector(nt, N_FEAT, N_OUTP, **kw))
    return _BUILT[name]


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_flax(name):
    """The same output on the same weights and inputs; the state-dict keys
    are the flattened flax leaves."""
    net_j, params, net = _case(name)
    p = from_flax_params(params)
    assert set(p) == set(net.state_dict())
    x, _, _ = _inputs()
    y = functional_call(net, p, (torch.as_tensor(x),)).detach().numpy()
    y_j = np.asarray(net_j.apply(params, jnp.asarray(x)))
    assert np.isfinite(y).all() and y.shape == y_j.shape == (2, T, N_OUTP)
    assert np.abs(y - y_j).max() <= FWD_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(name):
    """Gradients of the masked BCE loss (the trainers' `masked_loss`) under
    autograd against `jax.grad`, each leaf within 1e-4 of its scale."""
    net_j, params, net = _case(name)
    x, tgt, mask = _inputs(2)
    g_j = from_flax_params(jax.grad(lambda p: masked_loss_j(
        net_j.apply(p, jnp.asarray(x)), jnp.asarray(tgt), jnp.asarray(mask),
        "BinaryCrossentropy"))(jax.tree_util.tree_map(jnp.asarray, params)))
    p = {k: v.requires_grad_(True) for k, v in from_flax_params(params).items()}
    loss = masked_loss(functional_call(net, p, (torch.as_tensor(x),)), torch.as_tensor(tgt),
                       torch.as_tensor(mask), "BinaryCrossentropy")
    g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    assert set(g) == set(g_j)
    for k in g:
        scale = g_j[k].abs().max().item()
        assert scale > 0, k
        assert (g[k] - g_j[k]).abs().max().item() <= GRAD_TOL_REL * scale, k


# (case, whether a frame's output may depend on later frames)
CAUSAL = [("MHANet", True), ("ResLSTM", True), ("MHANetV2-block", True),
          ("ResBiLSTM", False), ("RDLNet", False), ("MHANetV3-block", False)]


@pytest.mark.parametrize("name,causal", CAUSAL, ids=[c for c, _ in CAUSAL])
def test_causality(name, causal):
    """Changing frames from 40 on leaves the earlier valid frames' outputs
    of a causal network as they were (a non-causal one sees them); an
    RDLNet built causal is causal too. (A masked frame's V2/V3 attention
    row is -1e10 everywhere, which averages every key's value, later ones
    too, as in the JAX package; V1 zeroes it.)"""
    nets = [_case(name)[2]]
    if name == "RDLNet":
        nets.append(network_selector("RDLNet", N_FEAT, N_OUTP,
                                     **dict(CASES["RDLNet"][1], causal=True)))
    for i, net in enumerate(nets):
        init_flax_like(net, torch.Generator().manual_seed(3))
        x = torch.as_tensor(_inputs()[0])
        x2 = x.clone()
        x2[:, 40:] += 1.0
        valid = (x != 0).any(-1)[:, :40]
        with torch.no_grad():
            d = (net(x2)[:, :40] - net(x)[:, :40])[valid].abs().max().item()
        assert (d == 0.0) == (causal or i == 1), d


@pytest.mark.parametrize("nt", ["MHANetV2", "MHANetV3"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q", [16, 256])
def test_block_matches_full(nt, causal, block_q):
    """The "block" attention (blocks of 16 queries over T = 70, or one block
    larger than T) gives "full"'s output on the same weights, within 2e-5
    (tests/test_blockwise_attention.py's limit)."""
    kw = dict(d_model=32, n_blocks=2, n_heads=4, causal=causal,
              **({"max_len": 128} if nt == "MHANetV3" else {}))
    full = init_flax_like(network_selector(nt, N_FEAT, N_OUTP, **kw),
                          torch.Generator().manual_seed(4))
    block = network_selector(nt, N_FEAT, N_OUTP, attention_impl="block", block_q=block_q, **kw)
    block.load_state_dict(full.state_dict())
    x = torch.as_tensor(_inputs()[0])
    with torch.no_grad():
        assert (block(x) - full(x)).abs().max().item() <= 2e-5


def test_mhanet_v1_masks():
    """V1's additive mask is -1e9 off the valid causal triangle, and the
    sequence mask 1 where query and key are both valid."""
    x = torch.as_tensor(_inputs()[0][:, :50])
    att, seq = attention_masks(x, causal=True)
    assert att.dtype == seq.dtype == torch.float32 and att.shape == (2, 50, 50)
    assert set(att.unique().tolist()) == {0.0, NEG_INF_V1}
    assert att[1, 46, 3] == NEG_INF_V1 and att[1, 3, 4] == NEG_INF_V1 and att[1, 4, 3] == 0
    assert seq[0, 20].sum() == 0 and seq[0, 21, 20] == 0 and seq[0, 21, 19] == 1


# (preset or network, the widths' overrides, parameters, leaves): the JAX
# package's counts from jax.eval_shape at n_feat = n_outp = 257
SIZES = [("rdlnet-1.0n", {}, 1_373_466, 740), ("reslstm-1.0c", {}, 10_760_449, 65),
         ("reslstm-1.0c", dict(network_type="ResBiLSTM"), 21_256_449, 125),
         ("mhanet-1.1c", dict(network_type="MHANet"), 4_076_033, 65),
         ("mhanet-1.1c", dict(attention_impl="block"), 4_600_321, 66)]


@pytest.mark.parametrize("ver,over,n_params,n_leaves", SIZES,
                         ids=[f"{v}-{o.get('network_type', o.get('attention_impl', ''))}"
                              for v, o, _, _ in SIZES])
def test_sizes_at_the_presets_widths(ver, over, n_params, n_leaves):
    """`build_network` of the preset: every state-dict key and shape is a
    leaf of the JAX network's tree, the counts are the JAX package's, and
    the inference route is the network's own forward."""
    cfg, cfg_j = preset(ver, **over), preset_j(ver, **over)
    net = build_network(cfg, 257, 257)
    sd = net.state_dict()
    shapes = jax.eval_shape(lambda: selector_j(cfg_j.network_type, 257,
                                               **cfg_j.network_kwargs()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 257))))
    leaves = from_flax_params(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                                     shapes))
    assert set(sd) == set(leaves)
    assert all(tuple(sd[k].shape) == tuple(leaves[k].shape) for k in sd)
    assert (sum(v.numel() for v in sd.values()), len(sd)) == (n_params, n_leaves)
    assert fast_apply_fn(cfg) is None


def test_leaves_load_in_flax_order_at_depth_four():
    """ResLSTM's tree is four deep (block0_lstm/cell/hi/kernel): the leaves
    in flax tree-flatten order land on the state-dict keys sorted by
    `flax_order`, shape by shape, as `load_artifact` reads params.npz."""
    _, params, net = _case("ResLSTM")
    leaves = jax.tree_util.tree_leaves(params)
    keys = flax_order(net.state_dict())
    assert keys[:3] == ["block0_lstm.cell.hf.bias", "block0_lstm.cell.hf.kernel",
                        "block0_lstm.cell.hg.bias"]
    p = from_flax_params(params)
    assert len(keys) == len(leaves)
    for k, leaf in zip(keys, leaves):
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(leaf))


def test_init_flax_like_draws_flax_distributions():
    """LSTM recurrent kernels orthogonal, input kernels lecun-normal (std
    1/sqrt(C_in)), biases zero; MHANet V1's projections lecun-normal; the
    ResLSTM's LayerNorm scale one."""
    net = init_flax_like(network_selector("ResLSTM", 257, 257, d_model=128, n_blocks=2),
                         torch.Generator().manual_seed(0))
    cells = [m for m in net.modules() if isinstance(m, LSTMCell)]
    assert len(cells) == 2
    for g in "ifgo":
        w = getattr(cells[0], f"h{g}").kernel.detach()
        assert torch.allclose(w.T @ w, torch.eye(128), atol=1e-5)
        assert float(getattr(cells[0], f"h{g}").bias.detach().abs().sum()) == 0.0
        assert abs(float(getattr(cells[1], f"i{g}").kernel.detach().std()) * 128 ** 0.5 - 1.0) < 0.05
    assert (net.ff_ln.scale == 1).all() and net.out_dense.bias.abs().sum() == 0
    v1 = init_flax_like(network_selector("MHANet", 257, 257, d_model=64, n_blocks=1),
                        torch.Generator().manual_seed(0))
    assert abs(float(v1.block0_mha.linear_q.kernel.detach().std()) * 64 ** 0.5 - 1.0) < 0.05


def test_selector_builds_every_jax_network_and_refuses_others():
    """Every network type of the JAX selector builds in the port, and an
    unknown type raises the same ValueError in both."""
    for nt in ("MHANet", "MHANetV2", "MHANetV3", "ResNet", "ResNetV2", "ResNetV3",
               "ResLSTM", "ResBiLSTM", "RDLNet"):
        selector_j(nt, 8)
        assert isinstance(network_selector(nt, 8, 8, d_model=16, n_blocks=1, n_heads=4),
                          torch.nn.Module)
    for sel in (lambda: network_selector("ResNetV4", 8, 8), lambda: selector_j("ResNetV4", 8)):
        with pytest.raises(ValueError, match="Invalid network type: 'ResNetV4'"):
            sel()
