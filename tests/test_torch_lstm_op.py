"""The masked LSTM recurrence as the op `deepxi::masked_lstm`
(`deepxi_tpu_torch.ops.kernels.lstm`) on the CPU, and the serving export of
ResLSTM and ResBiLSTM through it against the JAX package's.

The op's CPU implementation is its plain version, so it equals it bitwise;
its fake gives [T, B, H]; under autograd the network runs the plain loop
and elsewhere the op, with the same numbers. The networks (d_model 32, 2
blocks, biases moved off zero, the weights carried by `from_flax_params`)
export through the port's `export_enhancer` at bucket 8192, batch 2, with
one op call a direction a block; the loaded server gives the live
enhancer's output and the JAX package's `export_enhancer` -> `load_server`
bundle on the same weights. The kernel against its plain version on the
card is in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from deepxi_tpu.inp_tgt import inp_tgt_selector
from deepxi_tpu.models import network_selector as network_selector_j
from deepxi_tpu.serving import export_enhancer as export_enhancer_j
from deepxi_tpu.serving import load_server as load_server_j
from deepxi_tpu_torch import serving
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.enhance import make_enhancer
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models import network_selector
from deepxi_tpu_torch.models import rnn
from deepxi_tpu_torch.ops.kernels import OP_NAMESPACE, lstm
from deepxi_tpu_torch.ops.maps import NormalCDF

SMALL = dict(d_model=32, n_blocks=2)
BUCKET, BATCH, N_IN = 8192, 2, 7000
# Measured on the CPU: the port's server 1.04e-7 from the JAX server for
# both networks, at outputs of scale 0.13-0.14 (held to 1e-5, the other
# bundles' limit); the live enhancer gives the bundle's numbers exactly
# (held to 1e-6).
JAX_TOL, LIVE_TOL = 1e-5, 1e-6


def _inputs(T=37, B=3, H=16, seed=0):
    """xp [T, B, 4H], w_h [H, 4H] and the mask [T, B]: row 0 with an
    all-zero frame inside, row 2 padded after 25 frames (where T and B
    reach them)."""
    rng = np.random.RandomState(seed)
    xp = torch.as_tensor(rng.randn(T, B, 4 * H).astype(np.float32))
    w_h = torch.as_tensor((rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))
    mask = torch.ones(T, B, dtype=torch.bool)
    mask[10:11, 0] = False
    mask[25:, 2:3] = False
    return xp, w_h, mask


@pytest.mark.parametrize("reverse", [False, True])
def test_op_on_the_cpu_is_the_plain_loop(reverse):
    """Bitwise, with the masked frames keeping the state (the output
    repeated) and, in reverse, the padded tail leaving the carry at zero."""
    xp, w_h, mask = _inputs()
    ys = lstm.masked_lstm(xp, w_h, mask, reverse)
    ref = lstm.masked_lstm_plain(xp, w_h, mask, reverse)
    assert ys.shape == (37, 3, 16) and torch.equal(ys, ref)
    assert torch.equal(ys[10, 0], ys[9 if not reverse else 11, 0])
    if reverse:
        assert not ys[25:, 2].any()
    else:
        assert torch.equal(ys[25:, 2], ys[24:25, 2].expand(12, -1))
    assert lstm.masked_lstm.launches == lstm.masked_lstm.calls == 0  # the CPU launches none


def test_fake_gives_the_output_shape():
    """[T, B, H], not xp's shape, with xp's dtype, so torch.export traces
    the op."""
    xp, w_h, mask = _inputs(T=5, B=2, H=8)
    with FakeTensorMode() as mode:
        f = [mode.from_tensor(t) for t in (xp, w_h, mask)]
        out = getattr(torch.ops, OP_NAMESPACE).masked_lstm(*f, True)
    assert tuple(out.shape) == (5, 2, 8) and out.dtype == torch.float32


def test_autograd_takes_the_plain_loop_and_the_op_refuses_it():
    """With a weight that requires grad the network records through the
    plain loop (the same numbers as without); the op itself raises."""
    torch.manual_seed(0)
    net = rnn.ResBiLSTM(12, 7, n_blocks=1, d_model=8)
    x = torch.rand(2, 9, 12)
    y = net(x)
    assert y.requires_grad
    with torch.no_grad():
        assert torch.equal(net(x), y.detach())
    xp, w_h, mask = _inputs(T=12, B=1, H=8)
    with pytest.raises(RuntimeError, match="no backward"):
        lstm.masked_lstm(xp, w_h.requires_grad_(True), mask)


def test_kernel_takes_states_the_domain():
    assert lstm.kernel_takes(512, torch.float32) and lstm.kernel_takes(1, torch.float64)
    assert not lstm.kernel_takes(1025, torch.float32)
    assert not lstm.kernel_takes(64, torch.bfloat16)
    assert lstm.rows_a_block(1, 512) == 1 and lstm.rows_a_block(32, 512) == 8
    assert lstm.rows_a_block(96, 512) == 16


@pytest.fixture(scope="module")
def its():
    """The JAX tests' MagXi (DBNormalCDF stats of a seeded sample) and the
    port's with the same statistics."""
    it_j = inp_tgt_selector("MagXi", N_d=512, N_s=256, K=512, f_s=16000,
                            map_type="DBNormalCDF", map_params=None)
    sample = (np.abs(np.random.RandomState(0).randn(64, 257)) ** 2).astype(np.float32)
    it_j = it_j.replace(xi_map=it_j.xi_map.with_stats(jnp.asarray(sample)))
    stats = {k: torch.as_tensor(np.array(getattr(it_j.xi_map, k))) for k in ("mu", "sigma")}
    return it_j, MagXi(xi_map=NormalCDF(use_db=True, **stats))


@pytest.fixture(scope="module", params=["ResLSTM", "ResBiLSTM"])
def bundles(request, its, tmp_path_factory):
    """For each network: the port's and the JAX package's bundles of the same
    weights (biases moved off zero), the port's network and parameters."""
    nt = request.param
    it_j, it = its
    net_j = network_selector_j(nt, 257, **SMALL)
    params_j = net_j.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 257)))
    params_j = jax.tree_util.tree_map(
        lambda a: np.asarray(a + np.random.RandomState(a.size).uniform(-0.2, 0.2, a.shape)
                             .astype(np.float32) if a.ndim == 1 else a), params_j)
    net, params = network_selector(nt, 257, 257, **SMALL), from_flax_params(params_j)
    out, out_j = (str(tmp_path_factory.mktemp(f"{nt}-{n}")) for n in ("port", "jax"))
    (path,) = serving.export_enhancer(it, net, params, out, batch=BATCH, buckets=(BUCKET,),
                                      ver="test-lstm", device="cpu")
    export_enhancer_j(it_j, net_j, params_j, out_j, batch=BATCH, buckets=(BUCKET,),
                      ver="test-lstm")
    return nt, out, out_j, path, net, params


def _x():
    return (np.random.RandomState(5).randn(BATCH, N_IN) * 3000).astype(np.int16)


def test_export_holds_one_op_call_a_direction_a_block(bundles):
    nt, _, _, path, _, _ = bundles
    ep = torch.export.load(path)
    calls = [n for n in ep.graph.nodes
             if n.op == "call_function" and str(n.target).startswith(f"{OP_NAMESPACE}.")]
    assert [str(n.target) for n in calls] == \
        [f"{OP_NAMESPACE}.masked_lstm.default"] * (SMALL["n_blocks"] * (2 if "Bi" in nt else 1))


def test_bundle_matches_the_live_enhancer_and_the_jax_server(its, bundles):
    nt, out, out_j, _, net, params = bundles
    x = _x()
    y, y_j = serving.load_server(out)(x), load_server_j(out_j)(x)
    assert y.shape == y_j.shape == (BATCH, (-(-N_IN // 256) + 1) * 256)
    assert np.abs(y).max() > 1e-3
    assert np.abs(y - y_j).max() <= JAX_TOL
    xp = np.zeros((BATCH, BUCKET), np.int16)
    xp[:, :N_IN] = x
    with torch.no_grad():
        y_live = make_enhancer(its[1], net, device="cpu")(params, xp).numpy()[:, :y.shape[1]]
    assert np.abs(y - y_live).max() <= LIVE_TOL
