"""The port's MHANet modules against the JAX package on the CPU: each
kernel's plain version against the JAX kernel in Pallas interpret mode on
every row (padded rows included), `mhanetv3_apply_fused` and the attention
routes of the MHANetV2/V3 module against JAX's `mhanetv3_apply_fused` and
flax `apply` on valid rows, and the trained mhanet-1.1c artifact at full
width through `DeepXiTorch.infer` against the JAX enhancer. Inputs are
drawn by numpy from a seed; small widths (d_model 32, 4 heads) except for
the artifact. The kernels against their plain versions on the card are in
tests/test_torch_cuda.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.compat.artifact import load_artifact as load_artifact_j
from deepxi_tpu.enhance import make_enhancer as make_enhancer_j
from deepxi_tpu.metrics import stoi
from deepxi_tpu.metrics.pesq import pesq
from deepxi_tpu.models import network_selector
from deepxi_tpu.ops.kernels import mha_block_fused as block_j
from deepxi_tpu.ops.kernels.mha_flash_stream import \
    flash_attention_streaming as stream_j
from deepxi_tpu.ops.kernels.mha_fused import flash_attention as fused_j
from deepxi_tpu.ops.kernels.spectral import stft_mag as stft_mag_j
from deepxi_tpu.sig.mix import normalise as normalise_j
from deepxi_tpu_torch.compat.artifact import (MHANET_ROOT, flax_order,
                                              from_flax_params, load_artifact)
from deepxi_tpu_torch.config import preset
from deepxi_tpu_torch.data.wavio import read_wav, save_wav
from deepxi_tpu_torch.framework import DeepXiTorch
from deepxi_tpu_torch.models.attention import MHANetV2, MHANetV3
from deepxi_tpu_torch.ops.kernels import (mha_block_fused, mha_flash_stream,
                                          mha_fused)
from deepxi_tpu_torch.ops.kernels.spectral import stft_mag
from deepxi_tpu_torch.sig.mix import normalise

SMALL = dict(d_model=32, n_blocks=2, n_heads=4, outp_act="Sigmoid")


def _heads(T=70, seed=1):
    """q, k, v [2, T, 4, 8] and valid rows [T, 50] (as tests/test_mha_fused.py)."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(2, T, 4, 8).astype(np.float32) for _ in range(3))
    valid = np.arange(T)[None, :] < np.array([[T], [50]])
    return q, k, v, valid


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


# Every row, padded ones included: the plain versions reproduce which keys
# a padded row averages. Measured on the CPU: 1.4e-6 at most (the block:
# 1.4e-6); held to 1e-5.
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_matches_jax_kernel(causal):
    q, k, v, valid = _heads()
    ref = np.asarray(fused_j(*map(jnp.asarray, (q, k, v, valid)), causal,
                             interpret=True))
    out = mha_fused.flash_attention(*_t(q, k, v, valid), causal)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q,block_k", [(256, 512), (32, 16)])
def test_flash_attention_streaming_ref_matches_jax_kernel(causal, block_q, block_k):
    q, k, v, valid = _heads()
    ref = np.asarray(stream_j(*map(jnp.asarray, (q, k, v, valid)), causal,
                              block_q, block_k, interpret=True))
    out = mha_flash_stream.flash_attention_streaming(*_t(q, k, v, valid), causal,
                                                     block_q, block_k)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # the plain versions of the two kernels differ on padded rows only
    other = mha_fused.flash_attention(*_t(q, k, v, valid), causal).numpy()
    np.testing.assert_allclose(out.numpy()[valid], other[valid], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def small_v3():
    """A small MHANetV3 (d_model 32, 2 blocks, 4 heads) with flax's init and
    biases moved off zero, and an input with padded tails (as
    tests/test_mha_block_fused.py)."""
    net = network_selector("MHANetV3", 17, causal=True, max_len=128, **SMALL)
    rng = np.random.RandomState(0)
    x = np.abs(rng.randn(3, 50, 17)).astype(np.float32)
    x[0, 40:] = 0.0
    x[2, 25:] = 0.0
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a), params)
    return params, x, [(0, 40), (1, 50), (2, 25)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tile_q", [1024, 64])
def test_fused_transformer_block_ref_matches_jax_kernel(small_v3, causal, tile_q):
    """Both blocks of the small net on the padded hidden state (Tp = 128,
    rows past each tail invalid), every row; tile_q 64 splits the JAX
    kernel's queries in two, which the port's untiled block must match."""
    params, x, _ = small_v3
    p = params["params"]
    rs = np.random.RandomState(2)
    h = rs.randn(3, 128, 32).astype(np.float32)
    valid = (np.abs(np.pad(x, ((0, 0), (0, 78), (0, 0)))).sum(-1) > 0)
    vf = valid.astype(np.float32)[:, None, :]
    h_j, h_t = jnp.asarray(h), torch.as_tensor(h)
    for i in range(2):
        bw = block_j.BlockWeights(
            qk=p[f"block{i}_mha"]["query_kernel"], kk=p[f"block{i}_mha"]["key_kernel"],
            vk=p[f"block{i}_mha"]["value_kernel"],
            ok=p[f"block{i}_mha"]["projection_kernel"],
            ln1_s=p[f"block{i}_ln1"]["scale"], ln1_b=p[f"block{i}_ln1"]["bias"],
            ff1_w=p[f"block{i}_ff1"]["kernel"], ff1_b=p[f"block{i}_ff1"]["bias"],
            ff2_w=p[f"block{i}_ff2"]["kernel"], ff2_b=p[f"block{i}_ff2"]["bias"],
            ln2_s=p[f"block{i}_ln2"]["scale"], ln2_b=p[f"block{i}_ln2"]["bias"])
        h_j = block_j.fused_transformer_block(h_j, jnp.asarray(vf), bw, causal,
                                              tile_q=tile_q, interpret=True)
        h_t = mha_block_fused.fused_transformer_block(
            h_t, torch.as_tensor(vf), mha_block_fused.BlockWeights(*_t(*bw)), causal)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0, atol=1e-5)


def _port_net(kind, params, **kw):
    cls = MHANetV3 if kind == "MHANetV3" else MHANetV2
    net = cls(17, 17, **kw)
    net.load_state_dict(from_flax_params(params))
    return net.eval()


# Valid rows, as tests/test_mha_block_fused.py holds the JAX function: 1e-4.
@pytest.mark.parametrize("case", ["causal", "non_causal", "v2", "long"])
def test_mhanetv3_apply_fused_matches_jax(small_v3, case):
    """The port's `mhanetv3_apply_fused` (plain versions on the CPU) against
    JAX's (interpret mode) and flax `apply`. "long": T = 40 frames past
    whole_max_t = 32 takes the streaming module, and positions wrap at
    max_len 32 (compared with flax only: JAX's long route is the flax module
    with streaming attention, which tests/test_mha_block_fused.py runs only
    under --slow)."""
    params, x, valid = small_v3
    causal = case != "non_causal"
    kind = "MHANetV2" if case == "v2" else "MHANetV3"
    max_len = 32 if case == "long" else 128
    kw = dict(causal=causal, **SMALL, **({} if kind == "MHANetV2" else {"max_len": max_len}))
    net_j = network_selector(kind, 17, **kw)
    if case == "long":
        x = np.abs(np.random.RandomState(3).randn(2, 40, 17)).astype(np.float32)
        x[1, 33:] = 0.0
        valid = [(0, 40), (1, 33)]
    if case != "causal":
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
            net_j.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    apply_kw = dict(n_blocks=2, n_heads=4, d_model=32, causal=causal,
                    positional=kind == "MHANetV3", max_len=max_len)
    if case == "long":
        apply_kw["whole_max_t"] = 32
    y_flax = np.asarray(net_j.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        y = mha_block_fused.mhanetv3_apply_fused(
            from_flax_params(params), torch.as_tensor(x), **apply_kw).numpy()
    if case == "long":
        refs = [y_flax]
    else:
        refs = [y_flax, np.asarray(block_j.mhanetv3_apply_fused(
            params, jnp.asarray(x), **apply_kw))]
    for ref in refs:
        for b, t in valid:
            np.testing.assert_allclose(y[b, :t], ref[b, :t], rtol=0, atol=1e-4)


@pytest.mark.parametrize("impl", ["full", "fused", "stream"])
def test_module_routes_match_flax(small_v3, impl):
    """The port's MHANetV3 module with each attention impl against flax's
    "full" module: every row for "full" (the plain reference, 1e-5), valid
    rows for the kernel routes (1e-4, as the JAX package's tests)."""
    params, x, valid = small_v3
    y_flax = np.asarray(network_selector("MHANetV3", 17, causal=True, max_len=128,
                                         **SMALL).apply(params, jnp.asarray(x)))
    net = _port_net("MHANetV3", params, max_len=128, attention_impl=impl, **SMALL)
    with torch.no_grad():
        y = net(torch.as_tensor(x)).numpy()
    if impl == "full":
        np.testing.assert_allclose(y, y_flax, rtol=0, atol=1e-5)
    for b, t in valid:
        np.testing.assert_allclose(y[b, :t], y_flax[b, :t], rtol=0, atol=1e-4)


def test_kernel_wrappers_refuse_autograd():
    """As `pallas_call`, the inference wrappers have no backward: they raise
    when an input or weight requires grad, and run under no_grad."""
    q, k, v, valid = _t(*_heads(T=20))
    q.requires_grad_(True)
    for fn in (mha_fused.flash_attention, mha_flash_stream.flash_attention_streaming):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(q, k, v, valid, True)
        with torch.no_grad():
            fn(q, k, v, valid, True)
    w = mha_block_fused.random_block_weights(torch.Generator().manual_seed(0), "cpu",
                                             d_model=32, n_heads=4, d_ff=128)
    x = torch.randn(1, 16, 32, requires_grad=True)
    vf = torch.ones(1, 1, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        mha_block_fused.fused_transformer_block(x, vf, w, True)
    with torch.no_grad():
        assert mha_block_fused.fused_transformer_block(x, vf, w, True).shape == x.shape


# -- the trained mhanet-1.1c artifact at full width ---------------------------

@pytest.fixture(scope="module")
def artifact_j():
    it, net, params, noisy, clean = load_artifact_j(MHANET_ROOT)
    x = jnp.asarray(noisy[None])
    mag = stft_mag_j(normalise_j(x), 512, 256, 512, "highest")
    y = make_enhancer_j(it, net, "mmse-lsa", precision="highest")(params, x)
    return params, np.asarray(net.apply(params, mag)), np.array(mag), np.asarray(y)


@pytest.fixture(scope="module")
def artifact():
    return load_artifact(device="cpu")


def test_artifact_weight_bridge(artifact_j, artifact):
    """66 leaves in Flax order (p0 = block0_ff1.bias, p60 = in_conv.kernel,
    p65 = pos_emb.embedding), 4,600,321 parameters, leaf for leaf the JAX
    package's."""
    params_j = from_flax_params(jax.tree_util.tree_map(np.asarray, artifact_j[0]))
    keys = flax_order(artifact.params)
    assert keys == flax_order(params_j) and len(keys) == 66
    assert (keys[0], keys[60], keys[65]) == (
        "block0_ff1.bias", "in_conv.kernel", "pos_emb.embedding")
    assert sum(v.numel() for v in artifact.params.values()) == 4_600_321
    for k, v in params_j.items():
        torch.testing.assert_close(artifact.params[k], v, rtol=0, atol=0)


@pytest.fixture(scope="module")
def exact_net(artifact_j, artifact):
    """The network output in float64, from flax (under jax.enable_x64) and
    from the port's plain MHANetV3; returns the port's."""
    params, _, mag_j, _ = artifact_j
    net_j = load_artifact_j(MHANET_ROOT)[1]
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
        y_flax = np.asarray(net_j.apply(p64, jnp.asarray(mag_j.astype(np.float64))))
    assert y_flax.dtype == np.float64
    net64 = load_artifact(device="cpu").net.double()
    with torch.no_grad():
        y = net64(torch.as_tensor(mag_j, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(y, y_flax, rtol=0, atol=1e-9)
    return y


# The trained net amplifies f32 rounding: on the 4 s utterance flax's own f32
# output is 1.3e-5 from the float64 network (measured on the CPU), so two f32
# implementations with other summation orders cannot agree to 1e-5. Measured
# against flax f32: plain 2.3e-5, fused route (the main path, plain versions)
# 1.1e-5; against float64: plain 1.8e-5, fused 7.7e-6. Held: each within
# 5e-5 of flax f32, and no further from float64 than twice flax f32 is.
@pytest.mark.parametrize("route", ["plain", "fused"])
def test_artifact_network_matches_flax(artifact_j, artifact, exact_net, route):
    _, tgt_j, mag_j, _ = artifact_j
    with torch.no_grad():
        m = torch.as_tensor(mag_j)
        tgt = (artifact.net(m) if route == "plain" else
               mha_block_fused.mhanetv3_apply_fused(artifact.params, m)).numpy()
    np.testing.assert_allclose(tgt, tgt_j, rtol=0, atol=5e-5)
    assert np.abs(tgt - exact_net).max() <= 2 * np.abs(tgt_j - exact_net).max()


@pytest.fixture(scope="module")
def infer_run(artifact, tmp_path_factory):
    """`DeepXiTorch.infer` on the 4 s utterance, with the artifact's map
    statistics as `data/<ver>_stats.npz`: (written wav, enhanced float
    waveform of the same fast path)."""
    root = tmp_path_factory.mktemp("mhanet_infer")
    test_dir = root / "test"
    save_wav(str(test_dir / "c012_white_5dB.wav"), artifact.noisy, 16000)
    os.makedirs(root / "data")
    stats = np.load(os.path.join(MHANET_ROOT, "stats.npz"))
    np.savez(root / "data" / "mhanet-1.1c_stats.npz", **stats)
    cfg = preset("mhanet-1.1c", data_path=str(root / "data"),
                 out_path=str(root / "out"), test_x_path=str(test_dir))
    dx = DeepXiTorch(cfg, device="cpu")
    written = dx.infer(params=artifact.params)
    ys = dx.enhance_all(artifact.params, artifact.noisy[None],
                        np.asarray([len(artifact.noisy)]), "mmse-lsa")
    return written, ys[0]


# Measured on the CPU against the JAX enhancer at precision "highest":
# 9.4e-8 max abs, 7.7e-7 relative RMS. Held to 1e-5.
def test_infer_matches_jax(artifact_j, infer_run):
    written, y = infer_run
    y_j = artifact_j[3][0]
    assert [os.path.relpath(p, os.path.dirname(os.path.dirname(p))) for p in written] \
        == [os.path.join("mmse-lsa", "c012_white_5dB.wav")]
    assert "e200" in written[0]
    assert y.shape == y_j.shape == ((250 + 1) * 256,)
    assert np.abs(y - y_j).max() <= 1e-5
    wav, _ = read_wav(written[0])
    np.testing.assert_array_equal(wav, np.asarray(y * 32768.0, np.int16))


def test_infer_quality_matches_jax(artifact_j, artifact, infer_run):
    """PESQ/STOI of the port's enhancement equal the JAX package's to 1e-3,
    and enhancement beats the noisy input."""
    y, y_j = infer_run[1], artifact_j[3][0]
    s = artifact.clean.astype(np.float64) / 32768.0
    n = len(s)
    scores = [(pesq(s, w[:n], 16000, "nb"), stoi(s, w[:n], 16000))
              for w in (y, y_j, artifact.noisy / 32768.0)]
    np.testing.assert_allclose(scores[0], scores[1], rtol=0, atol=1e-3)
    assert scores[0][0] > scores[2][0] + 0.3


def test_framework_routes_and_checkpoints(tmp_path):
    """`fast_apply` picks the fused block for mhanet-1.1c with "full"
    attention, the module itself for "fused", and the fused TCN groups for
    resnet-1.1c; `load_epoch` reads a `torch.save` checkpoint (1-indexed);
    MHANet training through the inference-only "fused" or "stream"
    attention is refused (it trains through "full" attention)."""
    from deepxi_tpu_torch.training import TrainState, make_optimizer, save_checkpoint
    np.savez(tmp_path / "mhanet-1.1c_stats.npz",
             **{"xi_map.mu": np.zeros(257, np.float32),
                "xi_map.sigma": np.ones(257, np.float32)})
    cfg = preset("mhanet-1.1c", data_path=str(tmp_path), model_path=str(tmp_path / "m"))
    dx = DeepXiTorch(cfg, device="cpu")
    assert dx.fast_apply() is not None
    assert DeepXiTorch(cfg.replace(attention_impl="fused"), device="cpu").fast_apply() is None
    np.savez(tmp_path / "resnet-1.1c_stats.npz", **np.load(tmp_path / "mhanet-1.1c_stats.npz"))
    resnet = DeepXiTorch(preset("resnet-1.1c", data_path=str(tmp_path)), device="cpu")
    assert resnet.fast_apply() is not None
    params = {k: torch.randn(v.shape) for k, v in dx.network.state_dict().items()}
    save_checkpoint(str(tmp_path / "m" / "mhanet-1.1c"), 2,
                    TrainState.create(params, make_optimizer("MHANetV3")))
    got = dx.load_epoch(3)
    assert all(torch.equal(got[k], params[k]) for k in params)
    assert dx.apply_fn() is None  # the plain network under autograd
    for impl in ("fused", "stream"):
        with pytest.raises(ValueError, match="inference-only"):
            DeepXiTorch(cfg.replace(attention_impl=impl), device="cpu").train()
