"""The masked LSTM recurrence as the op `deepxi::masked_lstm`
(`deepxi_tpu_torch.ops.kernels.lstm`) and its gradient on the CPU, and the
serving export of ResLSTM and ResBiLSTM through it against the JAX
package's.

The op's CPU implementation is its plain version, so it equals it bitwise;
its fake gives [T, B, H]. Under autograd the recurrence is a Function whose
CPU forward and backward are the kernels' plain versions: the backward
(`masked_lstm_backward_plain` and `recurrent_weight_grad`) is held to
autograd of the plain loop in float64 and float32, the networks' gradients
and one train step of a small ResLSTM to the JAX package's `jax.grad` and
train step. The networks (d_model 32, 2 blocks, biases moved off zero, the
weights carried by `from_flax_params`) export through the port's
`export_enhancer` at bucket 8192, batch 2, with one op call a direction a
block; the loaded server gives the live enhancer's output and the JAX
package's `export_enhancer` -> `load_server` bundle on the same weights.
The kernels against their plain versions on the card are in
tests/test_torch_cuda.py.
"""

import contextlib

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
from deepxi_tpu.training import TrainState as TrainState_j
from deepxi_tpu.training import make_optimizer as make_optimizer_j
from deepxi_tpu.training import make_train_step as make_train_step_j
from deepxi_tpu.training import masked_loss as masked_loss_j
from deepxi_tpu_torch import serving
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.enhance import make_enhancer
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models import network_selector
from deepxi_tpu_torch.models import rnn
from deepxi_tpu_torch.ops.kernels import OP_NAMESPACE, lstm
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.training import TrainState, make_optimizer, make_train_step, masked_loss

SMALL = dict(d_model=32, n_blocks=2)
BUCKET, BATCH, N_IN = 8192, 2, 7000
# Measured on the CPU: the port's server 1.04e-7 from the JAX server for
# both networks, at outputs of scale 0.13-0.14 (held to 1e-5, the other
# bundles' limit); the live enhancer gives the bundle's numbers exactly
# (held to 1e-6).
JAX_TOL, LIVE_TOL = 1e-5, 1e-6
# The plain backward against autograd of the plain loop, of each output's
# scale (float64, float32); the networks' gradients against jax.grad, of
# each leaf's scale; the train step's loss and parameters against JAX's.
BWD_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
GRAD_TOL_REL, STEP_TOL = 1e-4, 1e-5


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
    assert lstm.masked_lstm.launches == 0  # the CPU launches none


def test_fake_gives_the_output_shape():
    """[T, B, H], not xp's shape, with xp's dtype, so torch.export traces
    the op."""
    xp, w_h, mask = _inputs(T=5, B=2, H=8)
    with FakeTensorMode() as mode:
        f = [mode.from_tensor(t) for t in (xp, w_h, mask)]
        out = getattr(torch.ops, OP_NAMESPACE).masked_lstm(*f, True)
    assert tuple(out.shape) == (5, 2, 8) and out.dtype == torch.float32


def test_autograd_runs_the_recurrence_function(monkeypatch):
    """With a weight that requires grad the network records one Function a
    direction a block (the same numbers as without); its backward reaches
    the plain backward on the CPU, and the plain loop is taken only as the
    training forward's plain version."""
    torch.manual_seed(0)
    net = rnn.ResBiLSTM(12, 7, n_blocks=2, d_model=8)
    x = torch.rand(2, 9, 12)
    calls = []
    plain_bwd = lstm.masked_lstm_backward_plain
    monkeypatch.setattr(lstm, "masked_lstm_backward_plain",
                        lambda *a: calls.append(1) or plain_bwd(*a))
    y = net(x)
    assert y.requires_grad and y.grad_fn is not None
    with torch.no_grad():
        assert torch.equal(net(x), y.detach())
    y.sum().backward()
    assert len(calls) == 4
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in net.parameters())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,T,C,H", [(3, 37, 16, 8), (1, 25, 12, 4), (2, 1, 32, 16)])
def test_input_proj_on_the_cpu_is_addmm_transposed(B, T, C, H, dtype):
    """The op `deepxi::lstm_input_proj` on the CPU is its plain version, the
    block's former `addmm` of the concatenated gate kernels + `transpose` +
    `contiguous`, bitwise: xp [T, B, 4H] contiguous, no launch counted."""
    rng = np.random.RandomState(B + T)
    x, b, *w_x = (torch.as_tensor(rng.randn(*shape), dtype=dtype)
                  for shape in ((B, T, C), (4 * H,)) + ((C, H),) * 4)
    n0 = lstm.lstm_input_proj.launches
    xp = lstm.lstm_input_proj(x, w_x, b)
    ref = torch.addmm(b, x.reshape(B * T, -1), torch.cat(w_x, 1)).reshape(B, T, -1) \
        .transpose(0, 1)
    assert xp.shape == (T, B, 4 * H) and xp.dtype == dtype and xp.is_contiguous()
    assert torch.equal(xp, ref.contiguous())
    assert torch.equal(xp, getattr(torch.ops, OP_NAMESPACE).lstm_input_proj(x, w_x, b))
    assert lstm.lstm_input_proj.launches == n0


def test_input_proj_fake_gives_the_time_major_shape():
    """[T, B, 4H] for x [B, T, C], so torch.export traces the op."""
    x, b, w_x = torch.zeros(2, 5, 12), torch.zeros(32), [torch.zeros(12, 8)] * 4
    with FakeTensorMode() as mode:
        out = getattr(torch.ops, OP_NAMESPACE).lstm_input_proj(
            mode.from_tensor(x), [mode.from_tensor(w) for w in w_x], mode.from_tensor(b))
    assert tuple(out.shape) == (5, 2, 32) and out.dtype == torch.float32


@pytest.mark.parametrize("case", ["x 2-d", "three gates", "gate widths differ", "b", "C",
                                  "dtypes mixed", "float16", "C % 4"])
def test_input_proj_check_names_what_the_card_takes(case):
    """The card's kernels take x [B, T, C], four gate kernels [C, H] and b
    [4H], all float32 with C a multiple of 4 or all float64: anything else
    raises before a launch (checked here on the CPU tensors)."""
    x, b, w_x = torch.zeros(2, 5, 12), torch.zeros(32), [torch.zeros(12, 8) for _ in range(4)]
    lstm._check_proj(x, w_x, b)
    lstm._check_proj(x.double(), [w.double() for w in w_x], b.double())
    bad = {"x 2-d": (x[0], w_x, b), "three gates": (x, w_x[:3], b),
           "gate widths differ": (x, w_x[:3] + [torch.zeros(12, 4)], b),
           "b": (x, w_x, b[:16]), "C": (x[..., :8], w_x, b),
           "dtypes mixed": (x, w_x, b.double()),
           "float16": (x.half(), [w.half() for w in w_x], b.half()),
           "C % 4": (x[..., :6], [w[:6] for w in w_x], b)}[case]
    with pytest.raises(ValueError, match="float32 with C a multiple of 4 or float64"):
        lstm._check_proj(*bad)


def test_input_proj_keeps_the_split_while_the_weights_stay():
    """The float32 kernel's split of W_x is made once for a set of gate
    kernels and kept while they stay the same tensors unchanged on the same
    stream: made anew after an in-place update (an optimizer step, a
    `load_state_dict`), for other tensors or another stream, and every time
    for inference tensors; dropped with its first gate kernel."""
    made = []

    def split():
        made.append(1)
        return torch.full((1,), float(len(made)))

    w_x = [torch.nn.Parameter(torch.randn(8, 4)) for _ in range(4)]
    kept = [lstm._kept_split(w_x, 7, split) for _ in range(3)]
    assert len(made) == 1 and all(k is kept[0] for k in kept)
    with torch.no_grad():
        w_x[2].add_(1.0)
    assert lstm._kept_split(w_x, 7, split).item() == 2.0
    assert lstm._kept_split(w_x, 7, split).item() == 2.0 and len(made) == 2
    assert lstm._kept_split(w_x, 8, split).item() == 3.0
    assert lstm._kept_split(w_x[:3] + [torch.randn(8, 4)], 8, split).item() == 4.0
    with torch.inference_mode():
        w_inf = [torch.randn(8, 4) for _ in range(4)]
    lstm._kept_split(w_inf, 8, split)
    lstm._kept_split(w_inf, 8, split)
    assert len(made) == 6
    n = len(lstm._SPLITS)
    del w_x, kept
    assert len(lstm._SPLITS) == n - 1


@pytest.mark.parametrize("nt", ["ResLSTM", "ResBiLSTM"])
def test_autograd_keeps_addmm_and_inference_takes_the_projection_op(monkeypatch, nt):
    """Under autograd each LSTM block's input product is autograd's `addmm`
    (the op is never called and counts nothing); with grad off it is the op,
    once a direction a block, and the network's output is bitwise the
    same."""
    torch.manual_seed(1)
    net = network_selector(nt, 12, 7, d_model=8, n_blocks=2)
    x = torch.rand(2, 9, 12)
    calls = []
    op = rnn.lstm_input_proj
    monkeypatch.setattr(rnn, "lstm_input_proj", lambda *a: calls.append(1) or op(*a))
    y = net(x)
    assert y.requires_grad and not calls
    y.sum().backward()
    assert all(p.grad is not None for p in net.parameters())
    with torch.no_grad():
        y_op = net(x)
    assert len(calls) == 2 * (2 if "Bi" in nt else 1)
    assert torch.equal(y_op, y.detach())
    assert lstm.lstm_input_proj.launches == 0


def test_reslstm_exports_through_the_projection_op():
    """torch.export of ResLSTM with grad off traces the projection's fake:
    the program holds `lstm_input_proj` then `masked_lstm` a block, and
    gives the network's output."""
    torch.manual_seed(2)
    net = network_selector("ResLSTM", 12, 7, d_model=8, n_blocks=3).eval()
    x = torch.rand(2, 9, 12)
    with torch.no_grad():
        ep = torch.export.export(net, (x,))
        ops = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function" and str(n.target).startswith(f"{OP_NAMESPACE}.")]
        y = net(x)
        y_ep = ep.graph_module(*[ep.state_dict[s.target] if s.target in ep.state_dict
                                 else ep.constants[s.target]
                                 for s in ep.graph_signature.input_specs if s.target], x)[0]
    assert ops == [f"{OP_NAMESPACE}.lstm_input_proj.default",
                   f"{OP_NAMESPACE}.masked_lstm.default"] * 3
    assert torch.equal(y_ep, y)


def _grad_inputs(T, B, H, dtype, seed):
    """xp, w_h (both requiring grad), the upstream gradient and a mask with
    interior all-masked frames in row 0, an all-masked row 1 and row 2 padded
    after 60% (where B and T reach them)."""
    rng = np.random.RandomState(seed)
    xp = torch.as_tensor(rng.randn(T, B, 4 * H) * 0.8, dtype=dtype).requires_grad_(True)
    w_h = torch.as_tensor(rng.randn(H, 4 * H) / np.sqrt(H), dtype=dtype).requires_grad_(True)
    dys = torch.as_tensor(rng.randn(T, B, H), dtype=dtype)
    mask = torch.ones(T, B, dtype=torch.bool)
    mask[T // 4:T // 4 + 2, 0] = False
    if B > 1:
        mask[:, 1] = False
    if B > 2:
        mask[max(1, int(0.6 * T)):, 2] = False
    return xp, w_h, dys, mask


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T", [1, 23])
def test_backward_plain_matches_autograd_of_the_plain_loop(dtype, reverse, T):
    """dxp from `masked_lstm_backward_plain` on the training forward's saved
    state, and dW_h from `recurrent_weight_grad`, against autograd of
    `masked_lstm_plain` (B = 3, H = 6): within 1e-10 (float64) or 1e-5
    (float32) of each output's scale; the training forward's ys is the
    plain loop's bitwise, and a masked frame's dxp is exactly 0."""
    xp, w_h, dys, mask = _grad_inputs(T, 3, 6, dtype, T + reverse)
    ys = lstm.masked_lstm_plain(xp, w_h, mask, reverse)
    g_xp, g_w = torch.autograd.grad(ys, [xp, w_h], dys)
    with torch.no_grad():
        ys_t, gates, cs = lstm.masked_lstm_train_plain(xp, w_h, mask, reverse)
        dxp = lstm.masked_lstm_backward_plain(dys, gates, cs, w_h, mask, reverse)
        dw_h = lstm.recurrent_weight_grad(ys_t, dxp, reverse)
    assert torch.equal(ys_t, ys.detach())
    assert gates.shape == (T, 3, 24) and cs.shape == (T, 3, 6)
    assert not dxp[~mask].any()
    for got, ref in ((dxp, g_xp), (dw_h, g_w)):
        scale = ref.abs().max().item()
        assert scale > 0 or T == 1
        assert (got - ref).abs().max().item() <= BWD_TOL[dtype] * max(scale, 1e-30)


def test_function_gradient_is_the_plain_backward():
    """`masked_lstm` under autograd gives the plain backward's dxp and dW_h
    bitwise (the Function adds nothing on the CPU), both directions."""
    for reverse in (False, True):
        xp, w_h, dys, mask = _grad_inputs(17, 3, 5, torch.float32, 7)
        g_xp, g_w = torch.autograd.grad(lstm.masked_lstm(xp, w_h, mask, reverse), [xp, w_h],
                                        dys)
        with torch.no_grad():
            ys, gates, cs = lstm.masked_lstm_train_plain(xp, w_h, mask, reverse)
            dxp = lstm.masked_lstm_backward_plain(dys, gates, cs, w_h, mask, reverse)
        assert torch.equal(g_xp, dxp)
        assert torch.equal(g_w, lstm.recurrent_weight_grad(ys, dxp, reverse))


def _net_case(nt, d_model, n_blocks, n_feat, seed):
    """The JAX network, its parameters with biases moved off zero, and the
    port's network."""
    net_j = network_selector_j(nt, n_feat, d_model=d_model, n_blocks=n_blocks)
    params = net_j.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, n_feat)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + np.random.RandomState(a.size).uniform(-0.2, 0.2, a.shape)
                             .astype(np.float32) if a.ndim == 1 else a), params)
    return net_j, params, network_selector(nt, n_feat, n_feat, d_model=d_model,
                                           n_blocks=n_blocks)


@pytest.mark.parametrize("nt", ["ResLSTM", "ResBiLSTM"])
def test_network_gradients_match_jax(nt):
    """Gradients of the masked BCE loss through the Function (d_model 24, 3
    blocks, 3 rows of 50 frames: row 0 with two interior all-zero frames,
    row 1 padded after 31, row 2 whole) against `jax.grad` of the JAX
    network: each leaf within 1e-4 of its scale."""
    net_j, params, net = _net_case(nt, 24, 3, 20, 3)
    rng = np.random.RandomState(11)
    x = (np.abs(rng.randn(3, 50, 20)) + 1e-3).astype(np.float32)
    x[0, 12:14] = 0.0
    x[1, 31:] = 0.0
    tgt = rng.uniform(0.05, 0.95, (3, 50, 20)).astype(np.float32)
    mask = (np.arange(50)[None] < np.array([50, 31, 50])[:, None]).astype(np.float32)
    g_j = from_flax_params(jax.grad(lambda p: masked_loss_j(
        net_j.apply(p, jnp.asarray(x)), jnp.asarray(tgt), jnp.asarray(mask),
        "BinaryCrossentropy"))(jax.tree_util.tree_map(jnp.asarray, params)))
    p = {k: v.requires_grad_(True) for k, v in from_flax_params(params).items()}
    loss = masked_loss(torch.func.functional_call(net, p, (torch.as_tensor(x),)),
                       torch.as_tensor(tgt), torch.as_tensor(mask), "BinaryCrossentropy")
    g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    assert set(g) == set(g_j)
    for k in g:
        scale = g_j[k].abs().max().item()
        assert scale > 0, k
        assert (g[k] - g_j[k]).abs().max().item() <= GRAD_TOL_REL * scale, k


def test_train_step_matches_jax(its):
    """Three steps of a small ResLSTM (d_model 16, 2 blocks) through the
    trainers' `make_train_step` (example synthesis, forward, the Function's
    backward, clip and Adam) against the JAX package's on the same weights
    and batch (noise as long as the speech, so both offsets are 0; one row
    shorter, so the mask pads it): each step's loss within 1e-5 of JAX's
    (the second and third on the parameters the earlier steps updated).
    Parameters are not held elementwise: Adam's first update is lr g /
    (|g| + eps), so an element whose gradient is near eps moves by another
    fraction of lr in each package (1.1e-5 at one ff_dense.kernel element
    measured here); the gradients themselves are held above."""
    it_j, it = its
    net_j, params, net = _net_case("ResLSTM", 16, 2, 257, 6)
    rng = np.random.RandomState(8)
    s = (rng.randn(2, 8192) * 3000).astype(np.int16)
    d = (rng.randn(2, 8192) * 2000).astype(np.int16)
    lens = np.array([8192, 6000], np.int32)
    snr = np.array([0.0, 5.0], np.float32)
    tx_j = make_optimizer_j("ResLSTM")
    step_j = jax.jit(make_train_step_j(net_j, it_j, tx_j))
    st_j = TrainState_j.create(jax.tree_util.tree_map(jnp.asarray, params), tx_j)
    tx = make_optimizer("ResLSTM")
    step = make_train_step(net, it, tx)
    st = TrainState.create(from_flax_params(params), tx)
    zeros = torch.zeros(2, dtype=torch.int64)
    losses = []
    for i in range(3):
        st_j, m_j = step_j(st_j, jax.random.PRNGKey(i), jnp.asarray(s), jnp.asarray(d),
                           jnp.asarray(lens), jnp.asarray(lens), jnp.asarray(snr))
        st, m = step(st, torch.as_tensor(s), torch.as_tensor(d), torch.as_tensor(lens),
                     torch.as_tensor(lens), torch.as_tensor(snr), offsets=zeros)
        losses.append(float(m["loss"]))
        assert abs(losses[-1] - float(m_j["loss"])) <= STEP_TOL * abs(float(m_j["loss"])), i
    assert st.step == 3 and losses[2] < losses[0]


# The backward kernel's split-TF32 product (csrc/lstm.cu, its tensor-core
# route, from LSTM_TC_ROWS rows a CTA), emulated: w_h's hi is its bits
# with the low 13 cleared and lo = w - hi exactly, read by the tensor cores as
# TF32 (their top 19 bits); dz's hi and lo are rounded as
# csrc/mma_tf32x3.cuh's `tf32` rounds (+0x1000, then the low 13 cleared).
TF32_MASK = 0xFFFFE000
TC_TOL = 1e-4


@contextlib.contextmanager
def _one_thread():
    """Torch on one thread: a loop of ~100 small operations a frame, which
    threads only make contend under the suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) & TF32_MASK).view(torch.float32)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    return ((x.view(torch.int32) + 0x1000) & TF32_MASK).view(torch.float32)


def _tc_route(w_h: torch.Tensor, U: int, L: int):
    """dz [B, 4H] -> dz @ w_h.T as the tensor-core route sums it in f32: a CTA
    (U units) a partial dh over its 4U columns, in k-steps of 8 columns, each
    the three products lo.hi, hi.lo, hi.hi (8-term sums in f32) added to the
    fragment in f32; then the group's sum as the kernel folds it: lane l of L
    sums CTAs l, l + L, .., then a butterfly over the L lanes."""
    H = w_h.shape[0]
    nx, ks, c = H // U, U // 2, torch.arange(4 * U)
    cols = (c // U)[None] * H + (torch.arange(nx) * U)[:, None] + (c % U)[None]   # [NX, 4U]
    w = w_h[:, cols].reshape(H, nx, ks, 8).permute(2, 1, 3, 0)                   # [KS, NX, 8, H]
    w_hi = _tf32_trunc(w)
    w_lo = _tf32_trunc(w - w_hi)
    a = torch.stack([w_lo, w_hi, w_hi], 1)                                      # [KS, 3, NX, 8, H]

    def product(dz):
        z = dz[:, cols].reshape(dz.shape[0], nx, ks, 8).permute(2, 1, 0, 3)    # [KS, NX, B, 8]
        z_hi = _tf32_round(z)
        z_lo = _tf32_round(z - z_hi)
        p = torch.stack([z_hi, z_lo, z_hi], 1) @ a                              # [KS, 3, NX, B, H]
        p = p.reshape(3 * ks, nx, dz.shape[0], H)
        acc = p[0]
        for i in range(1, 3 * ks):
            acc = acc + p[i]
        s = acc[:L]
        for x0 in range(L, nx, L):
            s = s + acc[x0:x0 + L]
        while s.shape[0] > 1:            # lane 0's butterfly: a pairwise tree
            s = s[0::2] + s[1::2]
        return s[0]
    return product


def _bptt(dys, gates, cs, mask, product):
    """`masked_lstm_backward_plain` (forward order) with dz_t w_h^T taken by
    `product`."""
    T, B, h_size = dys.shape
    dh = dc = zero = dys.new_zeros(B, h_size)
    dxp = [None] * T
    for t in range(T - 1, -1, -1):
        m = mask[t][:, None]
        dh_tot = dh + dys[t]
        i, f, g, o = torch.split(gates[t], h_size, 1)
        tc = torch.tanh(cs[t])
        c_prev = cs[t - 1] if t > 0 else zero
        dc_tot = dc + dh_tot * o * (1 - tc * tc)
        dz = torch.cat([dc_tot * g * i * (1 - i), dc_tot * c_prev * f * (1 - f),
                        dc_tot * i * (1 - g * g), dh_tot * tc * o * (1 - o)], 1)
        dz = torch.where(m, dz, torch.zeros_like(dz))
        dxp[t] = dz
        dc = torch.where(m, dc_tot * f, dc)
        dh = torch.where(m, zero, dh_tot) + product(dz)
    return torch.stack(dxp, 0)


@pytest.fixture(scope="module")
def long_sequence():
    """T = 1025, B = 2, H = 512 from numpy: xp ~ N(0, 0.25), w_h ~ N(0, 1/H),
    dys ~ N(0, 1), and tests/test_torch_cuda.py::_lstm_inputs' mask (row 0
    masked at T // 3, row 1 padded over its last fifth); the f32 forward's
    saved state and the float64 forward and backward (the reference)."""
    T, B, H = 1025, 2, 512
    rng = np.random.RandomState(19)
    xp = torch.as_tensor((rng.randn(T, B, 4 * H) * 0.5).astype(np.float32))
    w_h = torch.as_tensor((rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))
    dys = torch.as_tensor(rng.randn(T, B, H).astype(np.float32))
    mask = torch.ones(T, B, dtype=torch.bool)
    mask[T // 3, 0] = False
    mask[T - T // 5:, B - 1] = False
    with _one_thread():
        _, gates, cs = lstm.masked_lstm_train_plain(xp, w_h, mask, False)
        _, g64, c64 = lstm.masked_lstm_train_plain(xp.double(), w_h.double(), mask, False)
        ref = lstm.masked_lstm_backward_plain(dys.double(), g64, c64, w_h.double(), mask, False)
    return dict(dys=dys, gates=gates, cs=cs, w_h=w_h, mask=mask, ref=ref)


def test_split_tf32_backward_holds_float64_over_1025_frames(long_sequence):
    """BPTT over 1,025 frames at H = 512, B = 2 with every dz_t w_h^T taken
    as the backward kernel's tensor-core route takes it (its grid at B = 2:
    U = 8 units a CTA, 64 CTAs a row group, folded over 32 lanes) stays
    within 1e-4 of the float64 backward's scale on every batch row, as the
    FMA route's f32 arithmetic does. Measured on the CPU: both 2.5e-07 of
    the scale on the worst row (the f32 saved state and cell dominate), the
    split-TF32 route 7.2e-08 from the f32 plain backward."""
    d = long_sequence
    ref = d["ref"]
    scale = ref.abs().max()

    def rel(a, b):
        return ((a.double() - b.double()).abs().amax(dim=(0, 2)) / scale).max().item()

    with _one_thread():
        tc = _bptt(d["dys"], d["gates"], d["cs"], d["mask"], _tc_route(d["w_h"], 8, 32))
        f32 = lstm.masked_lstm_backward_plain(d["dys"], d["gates"], d["cs"], d["w_h"],
                                              d["mask"], False)
    assert torch.isfinite(tc).all() and tc.shape == ref.shape
    assert rel(tc, ref) <= TC_TOL, (rel(tc, ref), rel(f32, ref))
    assert rel(f32, ref) <= TC_TOL, rel(f32, ref)
    assert 0 < rel(tc, f32) <= 1e-6, rel(tc, f32)


# The forward kernel's tensor-core route (csrc/lstm.cu `lstm_forward_kernel_tc`,
# from LSTM_FWD_TC_ROWS rows a CTA), emulated at its grid on an H100: U units
# a CTA (16 at H = 512, 4 at H = 100), 64 / U K-parts, 8 k-steps a fresh
# fragment; both operands split as csrc/mma_tf32x3.cuh's `split_tf32`.
TC_FWD_SHAPES = [(512, 96, 16), (512, 33, 16), (100, 33, 4)]
TC_FWD_FRAMES = 40


def _tc_forward(w_h: torch.Tensor, U: int):
    """h [B, H] -> h @ w_h as the forward's tensor-core route sums it in f32:
    K = H padded to KP (a multiple of 32) in k-steps of 8, S = 64 / U parts
    of them in order; a part sums groups of 8 k-steps, each k-step the three
    products w_lo.h_hi, w_hi.h_lo, w_hi.h_hi (8-term sums in f32) added to a
    fresh fragment, each group's fragment added to the part's sum in f32; the
    cell adds the parts in order."""
    H = w_h.shape[0]
    kp = -(-H // 32) * 32
    ks_n, parts = kp // 8, 64 // U
    w = torch.nn.functional.pad(w_h, (0, 0, 0, kp - H)).reshape(ks_n, 8, 4 * H)
    w_hi = _tf32_round(w)
    w_lo = _tf32_round(w - w_hi)

    def product(h):
        x = torch.nn.functional.pad(h, (0, kp - H)).reshape(h.shape[0], ks_n, 8).transpose(0, 1)
        x_hi = _tf32_round(x.contiguous())
        x_lo = _tf32_round(x - x_hi)
        total = None
        for q in range(parts):
            ks0, ks1 = q * ks_n // parts, (q + 1) * ks_n // parts
            acc = h.new_zeros(h.shape[0], 4 * H)
            for kg in range(ks0, ks1, 8):
                s = slice(kg, min(kg + 8, ks1))
                prods = (x_hi[s] @ w_lo[s], x_lo[s] @ w_hi[s], x_hi[s] @ w_hi[s])
                p = torch.zeros_like(acc)
                for k in range(s.stop - s.start):
                    for pr in prods:
                        p = p + pr[k]
                acc = acc + p
            total = acc if total is None else total + acc
        return total
    return product


def _forward_with(xp, mask, reverse, product):
    """`masked_lstm_plain` with h w_h taken by `product`."""
    T, B, H4 = xp.shape
    H = H4 // 4
    c = h = xp.new_zeros(B, H)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        z = xp[t] + product(h)
        i, f, g, o = torch.split(z, H, 1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[t][:, None]
        c, h = torch.where(m, c_new, c), torch.where(m, h_new, h)
        ys[t] = h
    return torch.stack(ys, 0)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H, B, U", TC_FWD_SHAPES)
def test_split_tf32_forward_holds_the_plain_recurrence(H, B, U, reverse):
    """The recurrence with every h_{t-1} w_h taken as the forward kernel's
    tensor-core route takes it, at its grid's U, stays within 1e-4 of
    `masked_lstm_plain`'s scale on every batch row over 40 frames, both
    directions, with tests/test_torch_cuda.py::_lstm_inputs' masks (an
    all-zero frame inside row 0, its first two frames masked, row 1 all
    masked, the last row padded over its last fifth): the route's sums in
    another order and split TF32 are f32's arithmetic, not TF32's. Measured
    on the CPU: 1.5e-7 to 3.0e-7, as far from float64 as the plain f32 loop
    (1.5e-7 to 2.2e-7 against 1.9e-7 to 2.4e-7); one TF32 product a
    k-step (the control) 1.3e-4 to 2.0e-4, past the limit."""
    T = TC_FWD_FRAMES
    rng = np.random.RandomState(H + B)
    xp = torch.as_tensor((rng.randn(T, B, 4 * H) * 0.5).astype(np.float32))
    w_h = torch.as_tensor((rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))
    mask = torch.ones(T, B, dtype=torch.bool)
    mask[T // 3, 0] = False
    mask[T - T // 5:, B - 1] = False
    mask[:, 1] = False
    mask[:2, 0] = False
    with _one_thread():
        tc = _forward_with(xp, mask, reverse, _tc_forward(w_h, U))
        ref = lstm.masked_lstm_plain(xp, w_h, mask, reverse)
        tf32 = _forward_with(xp, mask, reverse, lambda h: _tf32_round(h) @ _tf32_round(w_h))

    def rel(a):
        return ((a - ref).abs().amax(dim=(0, 2)) / ref.abs().max()).max().item()

    assert torch.isfinite(tc).all() and tc.shape == ref.shape
    assert 0 < rel(tc) <= TC_TOL, rel(tc)
    assert rel(tf32) > TC_TOL, rel(tf32)
    assert torch.equal(tc[:, 1], torch.zeros_like(tc[:, 1]))   # the all-masked row


def test_kernel_takes_states_the_domain():
    assert lstm.kernel_takes(512, torch.float32) and lstm.kernel_takes(1, torch.float64)
    assert not lstm.kernel_takes(1025, torch.float32)
    assert not lstm.kernel_takes(64, torch.bfloat16)


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
        [f"{OP_NAMESPACE}.lstm_input_proj.default", f"{OP_NAMESPACE}.masked_lstm.default"] * \
        (SMALL["n_blocks"] * (2 if "Bi" in nt else 1))


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
