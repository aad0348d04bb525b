"""MHANet training in the port against the JAX package on the CPU: one
train step's loss and gradients on a small MHANetV3 with padded frames
against `jax.grad`, three steps of parameters against the JAX train step
and optax (schedule from count 0), the flax-like initialiser against
flax's at full width, the attention routes that refuse training, and
`DeepXiTorch.train()` end to end on a tiny MHANetV3 and corpus. JAX's
noise offsets cannot be drawn in torch, so the noise is as long as the
speech and both packages' offsets are 0 (as in tests/test_torch_train.py)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.inp_tgt import inp_tgt_selector
from deepxi_tpu.models import network_selector
from deepxi_tpu.training import TrainState as TrainState_j
from deepxi_tpu.training import make_optimizer as make_optimizer_j
from deepxi_tpu.training import make_train_step as make_train_step_j
from deepxi_tpu.training import masked_loss as masked_loss_j
from deepxi_tpu_torch.compat.artifact import flax_order, from_flax_params
from deepxi_tpu_torch.config import preset
from deepxi_tpu_torch.data.listing import batch_list
from deepxi_tpu_torch.data.wavio import save_wav
from deepxi_tpu_torch.framework import DeepXiTorch, build_network
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models.attention import MHANetV3, init_flax_like
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.training import (TrainState, frame_mask, make_optimizer,
                                       make_train_step, masked_loss)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from synth_corpus import synth_noise, synth_utterance  # noqa: E402

SMALL = dict(d_model=32, n_blocks=2, n_heads=4, max_len=64)
T = torch.as_tensor


@pytest.fixture(scope="module")
def setup():
    """A small MHANetV3 (biases and LN terms moved off their init), the JAX
    MagXi with seeded statistics and the port's with the same, a batch of
    two utterances, the second 3000 samples shorter (12 padded frames), and
    JAX's first-step loss and gradients on it."""
    net_j = network_selector("MHANetV3", 257, causal=True, outp_act="Sigmoid", **SMALL)
    params = net_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 257)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
                                    params)
    it_j = inp_tgt_selector("MagXi", N_d=512, N_s=256, K=512, f_s=16000,
                            map_type="DBNormalCDF", map_params=None)
    sample = (np.abs(np.random.RandomState(3).randn(200, 257)) ** 2 + 1e-3
              ).astype(np.float32)
    it_j = it_j.replace(xi_map=it_j.xi_map.with_stats(jnp.asarray(sample)))
    it = MagXi(xi_map=NormalCDF(use_db=True, **{
        k: torch.tensor(np.asarray(getattr(it_j.xi_map, k))) for k in ("mu", "sigma")}))
    rng = np.random.RandomState(8)
    s = (rng.randn(2, 8192) * 3000).astype(np.int16)
    d = (rng.randn(2, 8192) * 2000).astype(np.int16)
    lens = np.array([8192, 5192], np.int32)
    s[1, 5192:] = 0
    snr = np.array([0.0, 5.0], np.float32)
    inp_j, tgt_j, nf_j = it_j.example(jax.random.PRNGKey(0), jnp.asarray(s),
                                      jnp.asarray(d), jnp.asarray(lens), jnp.asarray(lens),
                                      jnp.asarray(snr))
    mask_j = (jnp.arange(inp_j.shape[1])[None, :] < nf_j[:, None]).astype(jnp.float32)
    assert float(mask_j.sum()) < mask_j.size  # padded frames
    l_j, g_j = jax.jit(jax.value_and_grad(lambda p: masked_loss_j(
        net_j.apply(p, inp_j), tgt_j, mask_j, "BinaryCrossentropy")))(params)
    grads_j = from_flax_params(jax.tree_util.tree_map(np.asarray, g_j))
    return (net_j, params, it_j, it, (s, d, lens, snr),
            (float(l_j), grads_j, np.asarray(nf_j), inp_j.shape[1]))


# Measured on the CPU: loss 9.0e-8 relative; gradients 1.0e-6 of each leaf's
# largest value at most. Held to 1e-6 and 1e-4.
def test_one_step_loss_and_gradients_match_jax_grad(setup):
    _, params, _, it, (s, d, lens, snr), (l_j, g_ref, nf_j, Tn) = setup
    inp, tgt, nf = it.example(T(s), T(d), T(lens), T(lens), T(snr),
                              offsets=torch.zeros(2, dtype=torch.int64))
    np.testing.assert_array_equal(nf.numpy(), nf_j)
    net = MHANetV3(257, 257, causal=True, **SMALL)
    p = {k: v.clone().requires_grad_(True) for k, v in from_flax_params(params).items()}
    loss = masked_loss(torch.func.functional_call(net, p, (inp,)), tgt,
                       frame_mask(inp.shape[1], nf, "cpu"), "BinaryCrossentropy")
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    assert abs(loss.item() / l_j - 1.0) <= 1e-6
    assert flax_order(grads) == flax_order(g_ref)
    for k, g in grads.items():
        scale = max(float(g_ref[k].abs().max()), 1e-12)
        assert float((g - g_ref[k]).abs().max()) <= 1e-4 * scale, k
    # positions past the batch's frames get no gradient
    assert float(grads["pos_emb.embedding"][Tn:].abs().max()) == 0.0


# Measured on the CPU: losses 9.1e-8 relative; the parameters whose first
# gradient is at least 1e-3 of their leaf's largest (half of pos_emb, whose
# rows past the 33 frames get none, and most of every other leaf) 4.1e-8
# apart at most,
# after three updates summing to 7.1e-4 (warmup 100 at d_model 32: 1.77e-4,
# 1.77e-4, 3.54e-4). Below that, the gradient is within a few f32 roundings
# of 0 and Adam (eps 1e-9) scales its sign to a whole step: 4.6e-6 apart at
# most (out_conv.kernel, gradient 1e-9 of a leaf whose largest is 4e-3).
# Held to 1e-6 (losses), 1e-7 and 2 x 7.1e-4.
def test_three_steps_match_the_jax_train_step(setup):
    """The MHA optimizer (clip, Adam with beta2 0.98 and eps 1e-9, the
    Transformer schedule at warmup 100 from count 0) through three train
    steps of both packages."""
    net_j, params, it_j, it, (s, d, lens, snr), (_, g_ref, _, _) = setup
    tx_j = make_optimizer_j("MHANetV3", 32, 100)
    step_j = jax.jit(make_train_step_j(net_j, it_j, tx_j))
    st_j = TrainState_j.create(jax.tree_util.tree_map(jnp.asarray, params), tx_j)
    tx = make_optimizer("MHANetV3", 32, 100)
    step = make_train_step(MHANetV3(257, 257, causal=True, **SMALL), it, tx)
    st = TrainState.create(from_flax_params(params), tx)
    zeros = torch.zeros(2, dtype=torch.int64)
    for i in range(3):
        st_j, m_j = step_j(st_j, jax.random.PRNGKey(i), jnp.asarray(s), jnp.asarray(d),
                           jnp.asarray(lens), jnp.asarray(lens), jnp.asarray(snr))
        st, m = step(st, T(s), T(d), T(lens), T(lens), T(snr), offsets=zeros)
        assert abs(float(m["loss"]) / float(m_j["loss"]) - 1.0) <= 1e-6, i
    assert st.step == 3 and st.opt_state["count"] == 3
    lr = sum(tx.lr(c) for c in range(3))
    assert abs(lr - 7.07e-4) <= 1e-6
    p_j = from_flax_params(jax.tree_util.tree_map(np.asarray, st_j.params))
    p0 = from_flax_params(params)
    assert max(float((p_j[k] - p0[k]).abs().max()) for k in p0) > 0.5 * lr
    for k, v in st.params.items():
        diff = (v - p_j[k]).abs()
        firm = g_ref[k].abs() >= 1e-3 * g_ref[k].abs().max()
        assert firm.float().mean() > 0.4, k
        assert float(diff[firm].max()) <= 1e-7, k
        assert float(diff.max()) <= 2 * lr, k


@pytest.mark.parametrize("kind", ["MHANetV3", "MHANetV2"])
def test_initialiser_matches_flax_at_full_width(kind):
    """mhanet-1.1c's (and 1.0c's) widths: the same leaves in flax's tree
    order, the same shapes, and each leaf's standard deviation within 5% of
    flax's (zero for biases, one-valued scales)."""
    net_j = network_selector(kind, 257, d_model=256, n_blocks=5, n_heads=8, causal=True,
                             **({"max_len": 2048} if kind == "MHANetV3" else {}))
    ref = from_flax_params(jax.tree_util.tree_map(
        np.asarray, net_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 257)))))
    cfg = preset("mhanet-1.1c" if kind == "MHANetV3" else "mhanet-1.0c")
    net = init_flax_like(build_network(cfg, 257, 257), torch.Generator().manual_seed(0))
    p = net.state_dict()
    assert flax_order(p) == flax_order(ref)
    for k, v in p.items():
        assert v.shape == ref[k].shape, k
        sd, sd_ref = float(v.std()), float(ref[k].std())
        assert abs(sd - sd_ref) <= 0.05 * sd_ref, (k, sd, sd_ref)
        if k.endswith(("bias", "scale")):
            assert float(v.mean()) == float(ref[k].mean()), k
    for k in ("block0_mha.query_kernel", "block0_mha.projection_kernel", "in_conv.kernel"):
        assert float(p[k].abs().max()) <= float(ref[k].abs().max()) * 1.001 + 1e-6, k


def _corpus(root, n_clean=4, n_noise=2):
    rng = np.random.RandomState(0)
    dirs = {k: os.path.join(root, k) for k in ("train_clean_speech", "train_noise")}
    for p in dirs.values():
        os.makedirs(p, exist_ok=True)
    for i in range(n_clean):
        save_wav(os.path.join(dirs["train_clean_speech"], f"sp{i}.wav"),
                 synth_utterance(rng, 0.5 * (1.0 + 0.25 * (i % 3))), 16000)
    for j in range(n_noise):
        save_wav(os.path.join(dirs["train_noise"], f"n{j}.wav"),
                 synth_noise(rng, ("white", "pink")[j % 2], 1.5), 16000)
    return dirs


def test_deepxi_train_mhanet_end_to_end(tmp_path):
    """Two epochs of a tiny MHANetV3 through DeepXiTorch.train() on the
    CPU: flax-like initial parameters, finite losses, checkpoints that
    `load_epoch` reads, and a restored run that continues; "fused" and
    "stream" attention refuse to train."""
    dirs = _corpus(str(tmp_path / "set"))
    cfg = preset("mhanet-1.1c-vb", d_model=32, n_blocks=2, n_heads=4, max_len=128,
                 mbatch_size=2, sample_size=4, max_epochs=2, warmup_steps=100,
                 set_path=str(tmp_path / "set"), model_path=str(tmp_path / "model"),
                 log_path=str(tmp_path / "log"), data_path=str(tmp_path / "data"))
    s_list = batch_list(dirs["train_clean_speech"], "clean", cfg.data_path)
    d_list = batch_list(dirs["train_noise"], "noise", cfg.data_path)
    dx = DeepXiTorch(cfg, s_list, d_list, device="cpu")
    assert dx.apply_fn() is None
    losses = dx.train(verbose=False)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert dx._state.step == 4 and dx._state.opt_state["count"] == 4
    rows = open(tmp_path / "log" / "loss" / "mhanet-1.1c-vb.csv").read().split()
    assert rows[0] == "epoch,loss" and len(rows) == 3  # -vb: no validation set
    back = dx.load_epoch(2)
    assert all(torch.equal(back[k], v) for k, v in dx._state.params.items())
    resumed = DeepXiTorch(cfg.replace(resume_epoch=2, max_epochs=3), s_list, d_list,
                          device="cpu")
    assert np.isfinite(resumed.train(verbose=False)).all()
    assert resumed._state.step == 6
    for impl in ("fused", "stream"):
        with pytest.raises(ValueError, match="inference-only"):
            DeepXiTorch(cfg.replace(attention_impl=impl), s_list, d_list,
                        device="cpu").train(verbose=False)
