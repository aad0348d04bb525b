"""The port's fused-TCN module against the JAX package: the plain ResNetV2,
the weight bridge, and `resnetv2_apply_fused` on both routes against JAX
`resnetv2_apply_fused` run in Pallas interpret mode (as
tests/test_tcn_fused.py runs it), with and without `pack2` (whose plain
version is also held to the JAX kernel for both `ln_mode`s). Small widths, nonzero biases (zero biases
hid the pre-sequence halo bug). The kernels against their plain versions
on the card are in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.models import network_selector
from deepxi_tpu.ops.kernels import tcn_fused as tcn_fused_j
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.models.tcn import ResNetV2, cyclic_dilation
from deepxi_tpu_torch.ops.kernels import tcn_fused

SMALL = dict(n_blocks=10, d_model=32, d_f=16, k=3, max_d_rate=4)


@pytest.fixture(scope="module")
def small():
    net = network_selector("ResNetV2", 257, causal=True,
                           unit_type="ReLU->LN->W+b", outp_act="Sigmoid",
                           **SMALL)
    x = np.abs(np.random.RandomState(0).randn(2, 100, 257)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a), params)
    return net, params, x, from_flax_params(params)


def test_plain_resnetv2_matches_flax(small):
    """The bridge carries a random flax init into the port unchanged. Flax's
    LayerNorm takes the variance in one pass (E[x^2] - E[x]^2), the port in
    two, as the fused kernels do: measured 3.2e-5 at most, held to 1e-4."""
    net, params, x, p_t = small
    m = ResNetV2(257, 257, **SMALL)
    m.load_state_dict(p_t)
    assert sum(v.numel() for v in p_t.values()) == sum(
        a.size for a in jax.tree_util.tree_leaves(params))
    with torch.no_grad():
        y = m(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(net.apply(params, jnp.asarray(x))),
                               rtol=0, atol=1e-4)


# whole_max_t=0 forces the halo-tiled route; T=100 with tile 64 spans two
# tiles, so the halo crosses a tile boundary. Grouping does not change the
# function: every case is held to the same JAX output tolerance.
@pytest.mark.parametrize("whole_max_t", [1024, 0], ids=["whole", "tiled"])
@pytest.mark.parametrize("group", [2, 5, 10])
def test_apply_fused_matches_jax(small, group, whole_max_t):
    net, params, x, p_t = small
    kw = dict(n_blocks=10, max_d_rate=4, group=group, tile_t=64,
              whole_max_t=whole_max_t)
    y_j = np.asarray(tcn_fused_j.resnetv2_apply_fused(params, jnp.asarray(x), **kw))
    y = tcn_fused.resnetv2_apply_fused(p_t, torch.as_tensor(x), **kw).numpy()
    np.testing.assert_allclose(y, y_j, rtol=0, atol=5e-4)


def test_tiled_and_whole_plain_versions_agree(small):
    """The two plain versions compute one function (f32 rounding apart),
    whatever the group and tile."""
    _, _, x, p_t = small
    h = torch.as_tensor(np.random.RandomState(1).randn(2, 150, 32).astype(np.float32))
    w = [tcn_fused.block_weights(p_t, i) for i in range(5)]
    dil = [cyclic_dilation(i, 4) for i in range(5)]
    ref = tcn_fused.fused_block_group_whole_ref(h, w, dil)
    for tile in (24, 64, 200):
        np.testing.assert_allclose(
            tcn_fused.fused_block_group_ref(h, w, dil, tile_t=tile).numpy(),
            ref.numpy(), rtol=0, atol=1e-5)


def test_wrappers_take_plain_version_on_cpu(small):
    _, _, _, p_t = small
    h = torch.as_tensor(np.random.RandomState(2).randn(1, 40, 32).astype(np.float32))
    w = [tcn_fused.block_weights(p_t, i) for i in range(2)]
    counts = (tcn_fused.fused_block_group_whole.launches,
              tcn_fused.fused_block_group.launches)
    torch.testing.assert_close(tcn_fused.fused_block_group_whole(h, w, [1, 2]),
                               tcn_fused.fused_block_group_whole_ref(h, w, [1, 2]),
                               rtol=0, atol=0)
    torch.testing.assert_close(tcn_fused.fused_block_group(h, w, [1, 2], tile_t=16),
                               tcn_fused.fused_block_group_ref(h, w, [1, 2], tile_t=16),
                               rtol=0, atol=0)
    assert counts == (tcn_fused.fused_block_group_whole.launches,
                      tcn_fused.fused_block_group.launches)


def test_halo_guard(small):
    """As the JAX kernel: a group whose halo exceeds the tile raises."""
    _, _, x, p_t = small
    with pytest.raises(ValueError):
        tcn_fused.resnetv2_apply_fused(p_t, torch.as_tensor(x[:, :64]),
                                       n_blocks=10, max_d_rate=4, group=10,
                                       tile_t=16, whole_max_t=0)


def test_causality(small):
    _, _, x, p_t = small
    causal_pos = 60
    x2 = x.copy()
    x2[0, causal_pos] += 5.0
    for whole_max_t in (0, 1024):
        kw = dict(n_blocks=10, max_d_rate=4, tile_t=64, whole_max_t=whole_max_t)
        y = tcn_fused.resnetv2_apply_fused(p_t, torch.as_tensor(x), **kw).numpy()
        y2 = tcn_fused.resnetv2_apply_fused(p_t, torch.as_tensor(x2), **kw).numpy()
        np.testing.assert_array_equal(y2[0, :causal_pos], y[0, :causal_pos])
        assert np.abs(y2[0, causal_pos:] - y[0, causal_pos:]).max() > 1e-4


# -- pack2: two batch rows per grid cell ----------------------------------------

def _weights_j(params, idx):
    p = params["params"]
    return [tcn_fused_j.BlockWeights(*(p[f"block{i}_u{u}_conv"][leaf]
                                       for u in (1, 2, 3) for leaf in ("kernel", "bias")))
            for i in idx]


# Measured on the CPU: 7.9e-6 abs at most over the cases, the same with 1 or
# 3 threads; held to 1e-5. The
# JAX kernel runs in interpret mode at T <= 64 and 3 blocks (its own test, at
# T=100 with 10 blocks, is marked slow); T=45 is no multiple of its 8-row
# sublane padding.
@pytest.mark.parametrize("ln_mode", ["slice", "matmul"])
@pytest.mark.parametrize("B", [1, 2, 3])
def test_pack2_ref_matches_jax_kernel(small, ln_mode, B):
    _, params, _, p_t = small
    h = np.random.RandomState(B).randn(B, 45, 32).astype(np.float32)
    dil = [cyclic_dilation(i, 4) for i in range(3)]
    ref = np.asarray(tcn_fused_j.fused_block_group_whole_pack2(
        jnp.asarray(h), _weights_j(params, range(3)), dil, ln_mode=ln_mode,
        interpret=True))
    w = [tcn_fused.block_weights(p_t, i) for i in range(3)]
    out = tcn_fused.fused_block_group_whole_pack2_ref(torch.as_tensor(h), w, dil,
                                                      ln_mode=ln_mode).numpy()
    assert out.shape == ref.shape == (B, 45, 32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# Measured on the CPU: 4.4e-6 abs at most; held to 1e-5.
@pytest.mark.parametrize("ln_mode", ["slice", "matmul"])
def test_apply_fused_pack2_matches_jax(small, ln_mode):
    """resnetv2_apply_fused(pack2=True) on 3 blocks of the small net, B=3
    (an odd batch: the JAX kernel pads a zero row), T=64."""
    _, params, _, p_t = small
    x = np.abs(np.random.RandomState(4).randn(3, 64, 257)).astype(np.float32)
    kw = dict(n_blocks=3, max_d_rate=4, pack2=True, pack2_ln=ln_mode)
    y_j = np.asarray(tcn_fused_j.resnetv2_apply_fused(params, jnp.asarray(x), **kw))
    y = tcn_fused.resnetv2_apply_fused(p_t, torch.as_tensor(x), **kw).numpy()
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-5)


def test_pack2_wrapper_takes_plain_version_on_cpu(small):
    """On the CPU the wrapper is its plain version (launch counter still);
    pack2 leaves the tiled route as it is; an unknown ln_mode raises."""
    _, _, x, p_t = small
    h = torch.as_tensor(np.random.RandomState(5).randn(3, 40, 32).astype(np.float32))
    w = [tcn_fused.block_weights(p_t, i) for i in range(2)]
    n = tcn_fused.fused_block_group_whole_pack2.launches
    for ln_mode in ("slice", "matmul"):
        torch.testing.assert_close(
            tcn_fused.fused_block_group_whole_pack2(h, w, [1, 2], ln_mode=ln_mode),
            tcn_fused.fused_block_group_whole_pack2_ref(h, w, [1, 2], ln_mode=ln_mode),
            rtol=0, atol=0)
    assert tcn_fused.fused_block_group_whole_pack2.launches == n
    with pytest.raises(ValueError):
        tcn_fused.fused_block_group_whole_pack2(h, w, [1, 2], ln_mode="lanes")
    kw = dict(n_blocks=10, max_d_rate=4, tile_t=64, whole_max_t=0)
    xt = torch.as_tensor(x)
    torch.testing.assert_close(tcn_fused.resnetv2_apply_fused(p_t, xt, pack2=True, **kw),
                               tcn_fused.resnetv2_apply_fused(p_t, xt, **kw),
                               rtol=0, atol=0)
