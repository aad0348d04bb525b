"""The port's training path against the JAX package on the CPU: mixing,
spectra, map statistics, the MagXi example, losses, the optimizer, the
loader, the fused training stack (its plain versions here; the kernels
against them on the card are in tests/test_torch_cuda.py), the train step,
checkpoints, and `DeepXiTorch.train()` end to end. Small widths, seeded
numpy inputs, flax-initialised weights with biases shifted off zero. JAX's
random draws cannot be reproduced in torch, so where JAX draws a noise
offset the test hands the port the same offset, or makes it 0 for both
(noise as long as the speech)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu import sig as sig_j
from deepxi_tpu.data import MiniBatchLoader as MiniBatchLoader_j
from deepxi_tpu.data import batch_list as batch_list_j
from deepxi_tpu.inp_tgt import inp_tgt_selector
from deepxi_tpu.models import network_selector
from deepxi_tpu.ops.kernels.tcn_fused_train import \
    resnetv2_apply_fused_train as apply_train_j
from deepxi_tpu.training import make_optimizer as make_optimizer_j
from deepxi_tpu.training import make_train_step as make_train_step_j
from deepxi_tpu.training import masked_loss as masked_loss_j
from deepxi_tpu.training import TrainState as TrainState_j
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.config import preset
from deepxi_tpu_torch.data.listing import batch_list
from deepxi_tpu_torch.data.loader import MiniBatchLoader
from deepxi_tpu_torch.data.wavio import save_wav
from deepxi_tpu_torch.enhance import make_enhancer
from deepxi_tpu_torch.framework import DeepXiTorch
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models.tcn import ResNetV2
from deepxi_tpu_torch.ops.kernels import tcn_fused
from deepxi_tpu_torch.ops.kernels.tcn_fused_train import \
    resnetv2_apply_fused_train
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.sig.mix import add_noise, add_noise_batch, snr_db
from deepxi_tpu_torch.sig.stft import polar_analysis
from deepxi_tpu_torch.training import (TrainState, make_optimizer,
                                       make_train_step, masked_loss,
                                       restore_checkpoint, save_checkpoint)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from synth_corpus import synth_noise, synth_utterance  # noqa: E402

SMALL = dict(n_blocks=3, d_model=32, d_f=16, k=3, max_d_rate=2)
DIMS = dict(N_d=512, N_s=256, K=512)
T = torch.as_tensor


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.fixture(scope="module")
def waves():
    """int16 speech [3, 8192] and noise [3, 12000] with lengths."""
    rng = np.random.RandomState(0)
    s = (rng.randn(3, 8192) * 3000).astype(np.int16)
    d = (rng.randn(3, 12000) * 2000).astype(np.int16)
    s_len = np.array([8192, 6000, 7000], np.int32)
    d_len = np.array([12000, 9000, 7000], np.int32)
    snr = np.array([-5.0, 0.0, 10.0], np.float32)
    return s, d, s_len, d_len, snr


@pytest.fixture(scope="module")
def xi_stats():
    sample = (np.abs(np.random.RandomState(3).randn(200, 257)) ** 2 + 1e-3
              ).astype(np.float32)
    it_j = inp_tgt_selector("MagXi", **DIMS, f_s=16000, map_type="DBNormalCDF",
                            map_params=None)
    it_j = it_j.replace(xi_map=it_j.xi_map.with_stats(jnp.asarray(sample)))
    it = MagXi(**DIMS, xi_map=NormalCDF(use_db=True, mu=T(np.asarray(it_j.xi_map.mu)),
                                        sigma=T(np.asarray(it_j.xi_map.sigma))))
    return sample, it_j, it


@pytest.fixture(scope="module")
def small_net():
    net = network_selector("ResNetV2", 257, causal=True,
                           unit_type="ReLU->LN->W+b", outp_act="Sigmoid", **SMALL)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 257)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a), params)
    return net, params


def test_add_noise_batch_with_jax_offsets(waves):
    s, d, s_len, d_len, snr = waves
    key = jax.random.PRNGKey(7)
    s_f, d_f = sig_j.normalise(jnp.asarray(s)), sig_j.normalise(jnp.asarray(d))
    x_j, sm_j, ds_j = sig_j.add_noise_batch(key, s_f, d_f, jnp.asarray(s_len),
                                            jnp.asarray(d_len), jnp.asarray(snr))
    # the offsets JAX drew: one randint per split key, as sig.add_noise does
    offs = [int(jax.random.randint(k, (), 0, max(1 + int(dl) - int(sl), 1)))
            for k, sl, dl in zip(jax.random.split(key, 3), s_len, d_len)]
    assert offs[0] > 0 and offs[2] == 0
    x, sm, ds = add_noise_batch(T(np.array(s_f)), T(np.array(d_f)), T(s_len),
                                T(d_len), T(snr), offsets=T(offs))
    for a, b in ((x, x_j), (sm, sm_j), (ds, ds_j)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-6


def test_add_noise_and_snr_db_match_jax(waves):
    """One waveform with JAX's offset handed in, and the SNR it reaches."""
    s, d, s_len, d_len, snr = waves
    s_f, d_f = s[0].astype(np.float32) / 32768.0, d[0].astype(np.float32) / 32768.0
    key = jax.random.PRNGKey(3)
    x_j, ds_j = sig_j.add_noise(key, jnp.asarray(s_f), jnp.asarray(d_f),
                                jnp.asarray(s_len[0]), jnp.asarray(d_len[0]),
                                jnp.asarray(snr[0]))
    off = int(jax.random.randint(key, (), 0, 1 + int(d_len[0]) - int(s_len[0])))
    x, ds = add_noise(T(s_f), T(d_f), int(s_len[0]), int(d_len[0]), float(snr[0]),
                      offset=off)
    assert np.abs(x.numpy() - np.asarray(x_j)).max() <= 1e-6
    assert np.abs(ds.numpy() - np.asarray(ds_j)).max() <= 1e-6
    got = float(snr_db(T(s_f), ds))
    assert abs(got - float(sig_j.snr_db(jnp.asarray(s_f), ds_j))) <= 1e-4
    assert abs(got - float(snr[0])) <= 1e-3


def test_noise_offsets_are_seeded_and_in_range(waves):
    s, d, s_len, d_len, snr = waves
    args = (T(s.astype(np.float32)), T(d.astype(np.float32)), T(s_len), T(d_len),
            T(snr))
    a = add_noise_batch(*args, generator=torch.Generator().manual_seed(1))
    b = add_noise_batch(*args, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    from deepxi_tpu_torch.sig.mix import noise_offsets
    o = noise_offsets(T(s_len), T(d_len), torch.Generator().manual_seed(2))
    assert (o >= 0).all() and (o <= T(np.maximum(d_len - s_len, 0))).all()


def test_polar_analysis_matches_jax(waves):
    x = waves[0].astype(np.float32) / 32768.0
    mag_j, pha_j = sig_j.polar_analysis(jnp.asarray(x), 512, 256, 512)
    mag, pha = polar_analysis(T(x), 512, 256, 512)
    assert mag.shape == mag_j.shape == (3, 32, 257)
    assert _rel(mag.numpy(), mag_j) <= 1e-5
    # phase where the magnitude is well above rounding, on the circle
    sel = np.asarray(mag_j) > 1e-3 * float(np.max(mag_j))
    dp = np.angle(np.exp(1j * (pha.numpy() - np.asarray(pha_j))))
    assert np.abs(dp[sel]).max() <= 1e-4


def test_normalcdf_with_stats_matches_jax(xi_stats):
    """Population std (ddof 0), as jnp.std: torch.std would be unbiased."""
    sample, it_j, _ = xi_stats
    m = NormalCDF(use_db=True).with_stats(T(sample))
    assert _rel(m.mu.numpy(), it_j.xi_map.mu) <= 1e-5
    assert _rel(m.sigma.numpy(), it_j.xi_map.sigma) <= 1e-5


def test_magxi_example_matches_jax(waves, xi_stats):
    """d_len == s_len: the noise offset is 0 in both packages."""
    s, d, s_len, _, snr = waves
    _, it_j, it = xi_stats
    d = d[:, :8192]
    inp_j, tgt_j, nf_j = it_j.example(jax.random.PRNGKey(0), jnp.asarray(s),
                                      jnp.asarray(d), jnp.asarray(s_len),
                                      jnp.asarray(s_len), jnp.asarray(snr))
    inp, tgt, nf = it.example(T(s), T(d), T(s_len), T(s_len), T(snr),
                              generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(nf.numpy(), np.asarray(nf_j))
    assert _rel(inp.numpy(), inp_j) <= 1e-5
    assert np.abs(tgt.numpy() - np.asarray(tgt_j)).max() <= 1e-5


def test_magxi_with_stats_matches_jax(waves):
    s, d, s_len, _, _ = waves
    s_f, d_f = s.astype(np.float32) / 32768.0, d[:, :8192].astype(np.float32) / 32768.0
    it_j = inp_tgt_selector("MagXi", **DIMS, f_s=16000, map_type="DBNormalCDF",
                            map_params=None).with_stats(s_f, d_f, s_f, s_len)
    it = MagXi(**DIMS, xi_map=NormalCDF(use_db=True)).with_stats(s_f, d_f, s_f, s_len)
    assert _rel(it.xi_map.mu.numpy(), it_j.xi_map.mu) <= 1e-5
    assert _rel(it.xi_map.sigma.numpy(), it_j.xi_map.sigma) <= 1e-5


@pytest.mark.parametrize("loss_fnc", ["BinaryCrossentropy", "MeanSquaredError"])
def test_masked_loss_matches_jax(loss_fnc):
    rng = np.random.RandomState(1)
    pred = rng.uniform(0, 1, (2, 6, 5)).astype(np.float32)
    pred[0, 0, :2] = (0.0, 1.0)  # Keras clips to [1e-7, 1 - 1e-7]
    tgt = rng.uniform(0, 1, (2, 6, 5)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0, 0], [1] * 6], np.float32)
    l_j = float(masked_loss_j(jnp.asarray(pred), jnp.asarray(tgt),
                              jnp.asarray(mask), loss_fnc))
    assert abs(float(masked_loss(T(pred), T(tgt), T(mask), loss_fnc)) - l_j) <= 1e-6
    with pytest.raises(ValueError):
        masked_loss(T(pred), T(tgt), T(mask), "Huber")


@pytest.mark.parametrize("network_type", ["ResNetV2", "MHANetV3"])
def test_optimizer_matches_optax(network_type):
    """Clip then Adam (MHA: transformer schedule, beta2 0.98, eps 1e-9), fed
    the same gradients (some beyond the clip) for three updates."""
    rng = np.random.RandomState(2)
    params = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    tx_j = make_optimizer_j(network_type, 256, 100)
    tx = make_optimizer(network_type, 256, 100)
    st_j = tx_j.init({k: jnp.asarray(v) for k, v in params.items()})
    st = tx.init({k: T(v) for k, v in params.items()})
    for _ in range(3):
        g = {k: (rng.randn(*v.shape) * 3).astype(np.float32) for k, v in params.items()}
        u_j, st_j = tx_j.update({k: jnp.asarray(v) for k, v in g.items()}, st_j)
        u, st = tx.update({k: T(v) for k, v in g.items()}, st)
        for k in params:
            assert np.abs(u[k].numpy() - np.asarray(u_j[k])).max() <= 1e-6


def _corpus(root, n_clean=4, seconds=1.0, n_noise=2, n_val=0):
    """A tiny synthetic corpus in the Deep Xi set layout."""
    rng = np.random.RandomState(0)
    dirs = {k: os.path.join(root, k) for k in
            ("train_clean_speech", "train_noise", "val_clean_speech", "val_noise")}
    for p in dirs.values():
        os.makedirs(p, exist_ok=True)
    for i in range(n_clean):
        save_wav(os.path.join(dirs["train_clean_speech"], f"sp{i}.wav"),
                 synth_utterance(rng, seconds * (1.0 + 0.25 * (i % 3))), 16000)
    for j in range(n_noise):
        save_wav(os.path.join(dirs["train_noise"], f"n{j}.wav"),
                 synth_noise(rng, ("white", "pink")[j % 2], 3.0 * seconds), 16000)
    for i in range(n_val):
        s = synth_utterance(rng, seconds)
        save_wav(os.path.join(dirs["val_clean_speech"], f"v{i}_5dB.wav"), s, 16000)
        save_wav(os.path.join(dirs["val_noise"], f"v{i}_5dB.wav"),
                 synth_noise(rng, "white", seconds)[:len(s)], 16000)
    return dirs


def test_minibatch_loader_identical_batches(tmp_path):
    dirs = _corpus(str(tmp_path), n_clean=7, seconds=0.5, n_noise=3)
    s_list = batch_list(dirs["train_clean_speech"], "clean", str(tmp_path / "d1"))
    d_list = batch_list(dirs["train_noise"], "noise", str(tmp_path / "d1"))
    assert s_list == batch_list_j(dirs["train_clean_speech"], "clean",
                                  str(tmp_path / "d2"))
    a = MiniBatchLoader(s_list, d_list, 3, [-5, 0, 5], seed=4)
    b = MiniBatchLoader_j(s_list, d_list, 3, [-5, 0, 5], seed=4)
    for epoch in range(2):
        ba, bb = list(a.epoch(epoch)), list(b.epoch(epoch))
        assert len(ba) == len(bb) == 3
        for x, y in zip(ba, bb):
            for u, v in zip(x, y):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


def _bce_grads_torch(apply, p_t, x, tgt, mask):
    params = {k: v.clone().requires_grad_(True) for k, v in p_t.items()}
    pred = apply(params, T(x))
    loss = masked_loss(pred, T(tgt), T(mask), "BinaryCrossentropy")
    return pred.detach(), loss.item(), dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


@pytest.mark.parametrize("save_acts", [True, False])
@pytest.mark.parametrize("group", [1, 2])
def test_apply_fused_train_matches_jax_grad(small_net, save_acts, group):
    """Forward <= 1e-4 and masked-BCE gradients <= 2e-4 of each leaf's scale
    against jax.grad of the flax net (the JAX package's own limits)."""
    net, params = small_net
    rng = np.random.RandomState(5)
    x = np.abs(rng.randn(2, 40, 257)).astype(np.float32)
    tgt = rng.uniform(0, 1, (2, 40, 257)).astype(np.float32)
    mask = np.ones((2, 40), np.float32)
    mask[1, 25:] = 0.0

    def loss_j(p):
        return masked_loss_j(net.apply(p, jnp.asarray(x)), jnp.asarray(tgt),
                             jnp.asarray(mask), "BinaryCrossentropy")

    l_j, g_j = jax.value_and_grad(loss_j)(params)
    apply = (lambda p, m: resnetv2_apply_fused_train(
        p, m, n_blocks=3, max_d_rate=2, group=group, save_acts=save_acts))
    pred, loss, grads = _bce_grads_torch(apply, from_flax_params(params), x, tgt, mask)
    assert np.abs(pred.numpy() - np.asarray(net.apply(params, jnp.asarray(x)))).max() <= 1e-4
    assert abs(loss - float(l_j)) <= 1e-6
    g_ref = from_flax_params(jax.tree_util.tree_map(np.asarray, g_j))
    assert grads.keys() == g_ref.keys()
    for k, g in grads.items():
        scale = max(float(g_ref[k].abs().max()), 1e-3)
        assert float((g - g_ref[k]).abs().max()) <= 2e-4 * scale, k


def test_inference_wrappers_refuse_autograd(small_net):
    """As pallas_call, the inference routes have no backward: under autograd
    with a weight or input that requires grad they raise on the CPU too;
    under torch.no_grad (as `enhance` runs) they work."""
    _, params = small_net
    p_t = from_flax_params(params)
    p_grad = {k: v.clone().requires_grad_(True) for k, v in p_t.items()}
    x = T(np.abs(np.random.RandomState(6).randn(1, 30, 257)).astype(np.float32))
    kw = dict(n_blocks=3, max_d_rate=2)
    with pytest.raises(RuntimeError, match="no backward"):
        tcn_fused.resnetv2_apply_fused(p_grad, x, **kw)
    h = torch.randn(1, 30, 32, requires_grad=True)
    w = [tcn_fused.block_weights(p_t, 0)]
    for fn, extra in ((tcn_fused.fused_block_group_whole, {}),
                      (tcn_fused.fused_block_group, {"tile_t": 16})):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(h, w, [1], **extra)
        with torch.no_grad():
            fn(h, w, [1], **extra)
    tcn_fused.resnetv2_apply_fused(p_t, x, **kw)  # nothing requires grad
    it = MagXi(**DIMS, xi_map=NormalCDF(use_db=True, mu=torch.zeros(257),
                                        sigma=torch.full((257,), 10.0)))
    net = ResNetV2(257, 257, **SMALL)
    enhance = make_enhancer(it, net, apply_fn=lambda p, m: tcn_fused.resnetv2_apply_fused(
        p, m, **kw), device="cpu")
    y = enhance(p_grad, (np.random.RandomState(7).randn(1, 4096) * 3000).astype(np.int16))
    assert y.shape == (1, 4352) and torch.isfinite(y).all()


def test_train_step_matches_jax(small_net, xi_stats):
    """Three steps through JAX's make_train_step with its fused apply
    (save_acts, Pallas interpret mode) and the port's: losses <= 1e-4
    relative. Noise as long as the speech, so both offsets are 0."""
    net, params = small_net
    _, it_j, it = xi_stats
    rng = np.random.RandomState(8)
    s = (rng.randn(2, 8192) * 3000).astype(np.int16)
    d = (rng.randn(2, 8192) * 2000).astype(np.int16)
    lens = np.array([8192, 7000], np.int32)
    snr = np.array([0.0, 5.0], np.float32)
    kw = dict(n_blocks=3, max_d_rate=2, k=3, group=2, save_acts=True)
    tx_j = make_optimizer_j("ResNetV2")
    step_j = jax.jit(make_train_step_j(net, it_j, tx_j, apply_fn=lambda p, m:
                                       apply_train_j(p, m, **kw)))
    st_j = TrainState_j.create(jax.tree_util.tree_map(jnp.asarray, params), tx_j)
    tx = make_optimizer("ResNetV2")
    step = make_train_step(ResNetV2(257, 257, **SMALL), it, tx, apply_fn=lambda p, m:
                           resnetv2_apply_fused_train(p, m, **kw))
    st = TrainState.create(from_flax_params(params), tx)
    zeros = torch.zeros(2, dtype=torch.int64)
    for i in range(3):
        st_j, m_j = step_j(st_j, jax.random.PRNGKey(i), jnp.asarray(s), jnp.asarray(d),
                           jnp.asarray(lens), jnp.asarray(lens), jnp.asarray(snr))
        st, m = step(st, T(s), T(d), T(lens), T(lens), T(snr), offsets=zeros)
        assert abs(float(m["loss"]) / float(m_j["loss"]) - 1.0) <= 1e-4, i
    assert st.step == 3


def test_checkpoint_roundtrip(tmp_path, small_net):
    _, params = small_net
    tx = make_optimizer("ResNetV2")
    st = TrainState.create(from_flax_params(params), tx)
    grads = {k: torch.ones_like(v) for k, v in st.params.items()}
    _, opt = tx.update(grads, st.opt_state)
    st = TrainState(7, st.params, opt)
    save_checkpoint(str(tmp_path), 3, st)
    assert os.path.exists(tmp_path / "epoch-3" / "state.pt")
    template = TrainState.create({k: torch.zeros_like(v) for k, v in st.params.items()}, tx)
    back = restore_checkpoint(str(tmp_path), 3, template)
    assert back.step == 7 and back.opt_state["count"] == 1
    for a, b in ((st.params, back.params), (opt["mu"], back.opt_state["mu"]),
                 (opt["nu"], back.opt_state["nu"])):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_deepxi_train_end_to_end(tmp_path):
    """Two epochs through DeepXiTorch.train() on the CPU (fused stack on its
    plain versions): stats, loss CSV with validation and checkpoints."""
    dirs = _corpus(str(tmp_path / "set"), n_clean=4, seconds=1.0, n_noise=2, n_val=2)
    cfg = preset("resnet-1.1c", **SMALL, mbatch_size=2, sample_size=4,
                 max_epochs=2, min_snr=0, max_snr=10, snr_inter=5,
                 set_path=str(tmp_path / "set"), model_path=str(tmp_path / "model"),
                 log_path=str(tmp_path / "log"), data_path=str(tmp_path / "data"))
    s_list = batch_list(dirs["train_clean_speech"], "clean", cfg.data_path)
    d_list = batch_list(dirs["train_noise"], "noise", cfg.data_path)
    dx = DeepXiTorch(cfg, s_list, d_list, device="cpu")
    assert os.path.exists(tmp_path / "data" / "resnet-1.1c_stats.npz")
    assert dx.inp_tgt.xi_map.sigma.shape == (257,)
    losses = dx.train(verbose=False)
    assert len(losses) == 2 and np.isfinite(losses).all()
    rows = open(tmp_path / "log" / "loss" / "resnet-1.1c.csv").read().split()
    assert rows[0] == "epoch,loss,val_loss" and len(rows) == 3
    for e in (0, 1):
        assert os.path.exists(tmp_path / "model" / "resnet-1.1c" / f"epoch-{e}" / "state.pt")
    assert dx._state.step == 4
    # stats are cached: a second instance loads them
    dx2 = DeepXiTorch(cfg, s_list, d_list, device="cpu")
    assert torch.equal(dx2.inp_tgt.xi_map.mu, dx.inp_tgt.xi_map.mu)
