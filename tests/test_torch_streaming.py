"""The port's streaming path against the JAX package on the CPU: the plain
version of the KV-cache attention step against the JAX kernel in Pallas
interpret mode, `StreamingMHANet` (MHANetV2/V3) and `StreamingEnhancer`
against `deepxi_tpu.streaming` on the JAX tests' small nets (biases moved
off zero), past the positional cap included, the constructor guards, and
the trained mhanet-1.1c and resnet-1.1c artifacts at full width against
the port's offline enhancer and the JAX streaming classes. Inputs are drawn
by numpy from a seed; weights cross with `from_flax_params`. The kernel
against its plain version on the card is in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.compat.artifact import load_artifact as load_artifact_j
from deepxi_tpu.compat.artifact import load_flagship_artifact as load_flagship_j
from deepxi_tpu.inp_tgt import inp_tgt_selector
from deepxi_tpu.models import network_selector
from deepxi_tpu.ops.kernels.mha_cache import mha_cache_step as mha_cache_step_j
from deepxi_tpu.streaming import StreamingEnhancer as StreamingEnhancerJ
from deepxi_tpu.streaming import StreamingMHANet as StreamingMHANetJ
from deepxi_tpu_torch.compat.artifact import (MHANET_ROOT, from_flax_params,
                                              load_artifact,
                                              load_flagship_artifact)
from deepxi_tpu_torch.enhance import make_enhancer
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models.attention import MHANetV2, MHANetV3
from deepxi_tpu_torch.models.tcn import ResNetV2
from deepxi_tpu_torch.ops.kernels import mha_cache
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.streaming import StreamingEnhancer, StreamingMHANet

SMALL_MHA = dict(d_model=32, n_blocks=2, n_heads=4, causal=True, outp_act="Sigmoid")
SMALL_TCN = dict(d_model=32, n_blocks=5, d_f=16, k=3, max_d_rate=4)
CACHE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bits(a, dtype_j):
    """The same float32 numbers for both packages: a rounded to dtype_j by
    JAX, then the exact float32 values."""
    return np.array(jnp.asarray(a, dtype_j).astype(jnp.float32))


# -- the plain KV-cache step against the JAX kernel ----------------------------

# Measured on the CPU: 3.6e-7 at most over the cases; held to 1e-6.
@pytest.mark.parametrize("clock", ["int", "tensor"])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("t", [0, 30, 63, 80])
def test_mha_cache_step_ref_matches_jax_kernel(cache, t, clock):
    """B=2, L=64, 4 heads of 8; every cache row nonzero, so only the mask
    zeroes the unwritten ones; t = 80 is past the cap (all rows valid); the
    clock as an int and as the stream's 0-d int32 tensor."""
    dtype_j, dtype_t = CACHE[cache]
    rs = np.random.RandomState(t)
    q = (rs.randn(2, 4, 8) * 8 ** -0.5).astype(np.float32)
    kc, vc = (_bits(rs.randn(2, 64, 4, 8), dtype_j) for _ in range(2))
    valid = (np.arange(64) <= t).astype(np.float32)
    ref = np.asarray(mha_cache_step_j(jnp.asarray(q), jnp.asarray(kc, dtype_j),
                                      jnp.asarray(vc, dtype_j), jnp.asarray(valid),
                                      interpret=True))
    kc_t, vc_t = (torch.as_tensor(a).to(dtype_t) for a in (kc, vc))
    clock_t = t if clock == "int" else torch.tensor(t, dtype=torch.int32)
    out = mha_cache.mha_cache_step(torch.as_tensor(q), kc_t, vc_t, clock_t)
    assert out.dtype == torch.float32 and out.shape == (2, 4, 8)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_mha_cache_step_refuses_autograd():
    q = torch.randn(1, 8, 32, requires_grad=True)
    kc = vc = torch.randn(1, 16, 8, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        mha_cache.mha_cache_step(q, kc, vc, 3)
    with torch.no_grad():
        assert mha_cache.mha_cache_step(q, kc, vc, 3).shape == (1, 8, 32)


@pytest.mark.parametrize("L", [64, 300, 2048])
@pytest.mark.parametrize("B", [1, 3, 256, 1000])
def test_split_keys_cover_the_written_rows_once(B, L):
    """The kernel's split (its Python twin): the grid's splits depend on
    (B, L) only, and at every clock the CTAs' ranges start on 32-key
    chunks and cover each written row exactly once; every t in 0 .. L + 3
    at L = 64 and 300, the flagship's clocks at L = 2048."""
    S = mha_cache.key_splits(B, L)
    assert 1 <= S <= -(-L // mha_cache.CHUNK_KEYS)
    assert B * S >= min(mha_cache.SPLIT_CTAS, B * -(-L // mha_cache.CHUNK_KEYS)) or S == 1
    assert B * S <= max(B, mha_cache.SPLIT_CTAS)
    for t in (range(L + 4) if L < 2048 else (0, 1023, 2047, 2500)):
        seen = np.zeros(L, np.int64)
        for k0, k1 in mha_cache.split_keys(S, L, t):
            assert k0 % mha_cache.CHUNK_KEYS == 0
            seen[k0:max(k0, k1)] += 1
        assert (seen == (np.arange(L) <= t)).all(), t


# -- StreamingMHANet on the JAX tests' nets ------------------------------------

@pytest.fixture(scope="module")
def its():
    """The JAX tests' MagXi (DBNormalCDF stats of a seeded sample) and the
    port's with the same statistics."""
    it_j = inp_tgt_selector("MagXi", N_d=512, N_s=256, K=512, f_s=16000,
                            map_type="DBNormalCDF", map_params=None)
    sample = (np.abs(np.random.RandomState(0).randn(64, 257)) ** 2).astype(np.float32)
    it_j = it_j.replace(xi_map=it_j.xi_map.with_stats(jnp.asarray(sample)))
    stats = {k: torch.as_tensor(np.asarray(getattr(it_j.xi_map, k))) for k in ("mu", "sigma")}
    return it_j, MagXi(xi_map=NormalCDF(use_db=True, **stats))


def _shifted(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
                                  params)


def mha_nets(kind, max_len=64):
    """(JAX net, its params with biases and LN terms moved off their init,
    the port's net) for tests/test_streaming_mha.py's small MHANet."""
    kw = dict(SMALL_MHA, **({"max_len": max_len} if kind == "MHANetV3" else {}))
    net_j = network_selector(kind, 257, **kw)
    params = _shifted(net_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 257))))
    return net_j, params, (MHANetV3 if kind == "MHANetV3" else MHANetV2)(257, 257, **kw)


def _mha_pair(its, kind, max_len=64, cache="f32", **kw):
    it_j, it = its
    net_j, params, net = mha_nets(kind, max_len)
    dtype_j, dtype_t = CACHE[cache]
    return (StreamingMHANetJ(it_j, net_j, params, "mmse-lsa", cache_dtype=dtype_j),
            StreamingMHANet(it, net, from_flax_params(params), "mmse-lsa",
                            cache_dtype=dtype_t, device="cpu", **kw))


def _noisy(seed, B, n_hops):
    return (np.random.RandomState(seed).randn(B, 256 * n_hops) * 3000).astype(np.int16)


def _steps(sm, x):
    """prime, then `step` over the hops after the first and a zero int16
    chunk, one call each."""
    B = x.shape[0]
    state = sm.prime(sm.init_state(B), x[:, :256])
    outs = []
    for i in range(1, x.shape[1] // 256 + 1):
        chunk = x[:, i * 256:(i + 1) * 256] if (i + 1) * 256 <= x.shape[1] \
            else np.zeros((B, 256), np.int16)
        state, y = sm.step(state, chunk)
        outs.append(y)
    return state, torch.cat(outs, dim=1).numpy()


def _blocks(sm, x, H):
    """prime, then `step_block` over the hops after the first in blocks of
    H (the hop count after the first is a multiple of H)."""
    state = sm.prime(sm.init_state(x.shape[0]), x[:, :256])
    outs = []
    for i in range(256, x.shape[1], 256 * H):
        state, y = sm.step_block(state, x[:, i:i + 256 * H])
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)


# Measured on the CPU: 5.2e-8 (V2) and 6.0e-8 (V3) max abs against JAX's
# `stream`; the port's own steps equal its `stream`. Held to 1e-5, the JAX
# tests' limit against the offline enhancer.
@pytest.mark.parametrize("kind", ["MHANetV2", "MHANetV3"])
def test_streaming_mhanet_matches_jax(its, kind):
    sm_j, sm = _mha_pair(its, kind)
    x = _noisy(1, 2, 30)      # 30 frames < max_len 64
    y_j = np.asarray(sm_j.stream(jnp.asarray(x)))
    y = sm.stream(x).numpy()
    assert y.shape == y_j.shape == (2, 30 * 256)
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-5)
    state, y_steps = _steps(sm, x)
    assert state.t == 30
    np.testing.assert_allclose(y_steps, y, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hop_batch", [2, 4, 5])
def test_step_block_equals_sequential_steps(its, hop_batch):
    """As tests/test_streaming_mha.py: H hops a pass against H steps, 2e-5
    (measured 3.0e-8 to 3.7e-8)."""
    _, sm = _mha_pair(its, "MHANetV3")
    x = _noisy(4, 2, 3 * hop_batch + 1)
    state = sm.prime(sm.init_state(2), x[:, :256])
    outs = []
    for i in range(1, x.shape[1] // 256):
        state, y = sm.step(state, x[:, i * 256:(i + 1) * 256])
        outs.append(y.numpy())
    np.testing.assert_allclose(_blocks(sm, x, hop_batch), np.concatenate(outs, axis=1),
                               rtol=0, atol=2e-5)


def test_fused_step_matches_unfused(its):
    """fused=True calls `mha_cache_step` (on the CPU its plain version, the
    kernel's is on the card) where fused=False runs the einsum route."""
    _, sm = _mha_pair(its, "MHANetV3")
    _, smf = _mha_pair(its, "MHANetV3", fused=True)
    x = _noisy(3, 2, 20)
    n = mha_cache.mha_cache_step.launches
    np.testing.assert_allclose(smf.stream(x).numpy(), sm.stream(x).numpy(), rtol=0, atol=1e-6)
    assert mha_cache.mha_cache_step.launches == n  # the plain version launches nothing


def test_clock_is_a_device_int32_scalar(its):
    """state.t is a 0-d int32 tensor on the stream's device, as the JAX
    state's `[] int32` clock: zero at init, +1 a `step`, +Hn a `step_block`,
    and a step returns a new clock tensor (the input state's is unchanged)."""
    _, sm = _mha_pair(its, "MHANetV3")
    x = _noisy(7, 2, 8)
    state = sm.prime(sm.init_state(2), x[:, :256])
    t0 = state.t
    assert t0.dim() == 0 and t0.dtype == torch.int32 and t0.device == sm.device
    assert int(t0) == 0
    state, _ = sm.step(state, x[:, 256:512])
    assert state.t.dtype == torch.int32 and int(state.t) == 1 and int(t0) == 0
    state, _ = sm.step_block(state, x[:, 512:])
    assert state.t.dim() == 0 and state.t.dtype == torch.int32 and int(state.t) == 7


class _Unreadable(torch.Tensor):
    """A clock whose value the host cannot read: every conversion raises."""

    def _read(self, *args):
        raise AssertionError("a hop read the clock back to the host")

    item = tolist = __int__ = __index__ = __bool__ = __float__ = _read


@pytest.mark.parametrize("fused", [False, True])
def test_no_hop_reads_the_clock_back(its, fused):
    """`step` and `step_block` take their cache rows, positional rows and mask
    from the clock on the device: given a clock whose item, __int__,
    __index__ and __bool__ raise, both run (past the cap too) and give the
    outputs of the same hops from a plain clock."""
    _, sm = _mha_pair(its, "MHANetV3", max_len=16, fused=fused)
    x = _noisy(8, 2, 22)
    plain = sm.prime(sm.init_state(2), x[:, :256])
    hidden = sm.prime(sm.init_state(2), x[:, :256])
    hidden = hidden._replace(t=hidden.t.as_subclass(_Unreadable))
    with pytest.raises(AssertionError):
        int(hidden.t)
    for i in range(1, 22, 4):
        chunk = x[:, i * 256:(i + 4) * 256] if i < 20 else x[:, i * 256:]
        if i % 8 == 1:
            plain, y = sm.step(plain, chunk[:, :256])
            hidden, y_h = sm.step(hidden, chunk[:, :256])
            plain, y2 = sm.step_block(plain, chunk[:, 256:])
            hidden, y2_h = sm.step_block(hidden, chunk[:, 256:])
        else:
            plain, y = sm.step_block(plain, chunk)
            hidden, y_h = sm.step_block(hidden, chunk)
            y2 = y2_h = torch.zeros(0)
        assert isinstance(hidden.t, _Unreadable)
        np.testing.assert_array_equal(y_h.numpy(), y.numpy())
        np.testing.assert_array_equal(y2_h.numpy(), y2.numpy())
    assert int(plain.t) == 21


# Measured on the CPU: 5.3e-8 (V2) and 2.7e-7 (V3) from JAX with bf16 caches
# (both round k and v to bf16 the same way); held to 1e-4.
@pytest.mark.parametrize("kind", ["MHANetV2", "MHANetV3"])
def test_bf16_caches_match_jax(its, kind):
    sm_j, sm = _mha_pair(its, kind, cache="bf16")
    x = _noisy(3, 2, 20)
    state, y = _steps(sm, x)
    assert all(c.dtype == torch.bfloat16 for c in state.k_caches + state.v_caches)
    np.testing.assert_allclose(y, np.asarray(sm_j.stream(jnp.asarray(x))), rtol=0, atol=1e-4)


# Past the cap (max_len 16, 30 hops): the writes clamp to row 15 (`step`) or
# to rows 12..15 (`step_block`, H = 4) and positions wrap. Measured 5.2e-8
# (step) and 6.0e-8 (step_block); held to 1e-5.
def test_past_the_cap_matches_jax_step(its):
    sm_j, sm = _mha_pair(its, "MHANetV3", max_len=16)
    x = _noisy(5, 2, 30)
    state, y = _steps(sm, x)
    assert state.t == 30 and state.k_caches[0].shape == (2, 16, 4, 8)
    np.testing.assert_allclose(y, np.asarray(sm_j.stream(jnp.asarray(x))), rtol=0, atol=1e-5)


def test_past_the_cap_matches_jax_step_block(its):
    sm_j, sm = _mha_pair(its, "MHANetV3", max_len=16)
    x = _noisy(6, 2, 29)      # prime + 7 blocks of 4 hops
    step_j = jax.jit(sm_j.step_block)
    state_j = sm_j.prime(sm_j.init_state(2), jnp.asarray(x[:, :256]))
    outs = []
    for i in range(256, x.shape[1], 1024):
        state_j, y_j = step_j(state_j, jnp.asarray(x[:, i:i + 1024]))
        outs.append(np.asarray(y_j))
    np.testing.assert_allclose(_blocks(sm, x, 4), np.concatenate(outs, axis=1),
                               rtol=0, atol=1e-5)


# -- StreamingEnhancer on tests/test_streaming.py's net -------------------------

@pytest.fixture(scope="module")
def tcn(its):
    it_j, it = its
    net_j = network_selector("ResNetV2", 257, causal=True, unit_type="ReLU->LN->W+b",
                             outp_act="Sigmoid", **SMALL_TCN)
    params = _shifted(net_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 257))))
    se = StreamingEnhancer(it, ResNetV2(257, 257, **SMALL_TCN), from_flax_params(params),
                           device="cpu")
    return StreamingEnhancerJ(it_j, net_j, params), se


# Measured on the CPU: 1.4e-7 max abs; held to 1e-5.
def test_streaming_enhancer_matches_jax(tcn):
    se_j, se = tcn
    x = _noisy(1, 2, 40)
    y_j = np.asarray(se_j.stream(jnp.asarray(x)))
    y = se.stream(x).numpy()
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-5)
    _, y_steps = _steps(se, x)
    np.testing.assert_allclose(y_steps, y, rtol=0, atol=1e-6)


def test_streaming_enhancer_state_shapes(tcn):
    """As tests/test_streaming.py: one delay line a block, (k-1)*d frames of
    d_f, dilations 1, 2, 4, 1, 2; and a step keeps the shapes."""
    _, se = tcn
    st = se.init_state(3)
    assert len(st.conv_bufs) == 5
    for buf, d in zip(st.conv_bufs, [1, 2, 4, 1, 2]):
        assert buf.shape == (3, 2 * d, 16)
    assert st.wav_tail.shape == st.ola_tail.shape == (3, 256)
    st2, y = se.step(se.prime(st, np.zeros((3, 256), np.int16)),
                     np.ones((3, 256), np.int16))
    assert y.shape == (3, 256)
    assert [b.shape for b in st2.conv_bufs] == [b.shape for b in st.conv_bufs]


def test_float32_chunks_pass_through_unscaled(tcn):
    """As the JAX step: only non-float32 chunks are divided by 32768."""
    _, se = tcn
    x = _noisy(2, 1, 6)
    y_int = se.stream(x).numpy()
    y_f32 = se.stream(x.astype(np.float32) / 32768.0).numpy()
    np.testing.assert_allclose(y_f32, y_int, rtol=0, atol=1e-7)


# -- the constructor guards ----------------------------------------------------

def _resnet_pair(**kw):
    net_j = network_selector("ResNetV2", 257, **dict(
        dict(causal=True, unit_type="ReLU->LN->W+b", outp_act="Sigmoid", **SMALL_TCN), **kw))
    net = ResNetV2(257, 257, outp_act=net_j.outp_act, **SMALL_TCN)
    for attr in ("causal", "unit_type"):
        if attr in kw:   # what the port's ResNetV2 is by construction
            setattr(net, attr, kw[attr])
    return net_j, net


@pytest.mark.parametrize("case", ["non_causal", "unit_order", "outp_act", "overlap",
                                  "mha_on_resnet", "non_causal_mha", "mha_overlap"])
def test_guards_raise_for_the_same_inputs_as_jax(its, case):
    it_j, it = its
    if case == "overlap" or case == "mha_overlap":
        it_j = it_j.replace(N_s=128)
        it = MagXi(N_s=128, xi_map=it.xi_map)
    if case in ("mha_on_resnet", "non_causal_mha", "mha_overlap"):
        if case == "mha_on_resnet":
            net_j, net = _resnet_pair()
        else:
            kw = dict(SMALL_MHA, causal=case != "non_causal_mha")
            net_j, net = network_selector("MHANetV2", 257, **kw), MHANetV2(257, 257, **kw)
        classes = (StreamingMHANetJ, StreamingMHANet)
    else:
        kw = {"non_causal": {"causal": False}, "unit_order": {"unit_type": "LN->ReLU->W+b"},
              "outp_act": {"outp_act": "ReLU"}, "overlap": {}}[case]
        net_j, net = _resnet_pair(**kw)
        classes = (StreamingEnhancerJ, StreamingEnhancer)
    with pytest.raises(ValueError):
        classes[0](it_j, net_j, {"params": {}})
    with pytest.raises(ValueError):
        classes[1](it, net, {}, device="cpu")


def test_cache_dtype_and_block_length_are_checked(its):
    _, sm = _mha_pair(its, "MHANetV3", max_len=16)
    _, params, net = mha_nets("MHANetV3")
    with pytest.raises(ValueError):
        StreamingMHANet(its[1], net, from_flax_params(params), cache_dtype=torch.float16,
                        device="cpu")
    state = sm.prime(sm.init_state(1), np.zeros((1, 256), np.int16))
    with pytest.raises(ValueError):
        sm.step_block(state, np.zeros((1, 300), np.int16))
    with pytest.raises(ValueError):
        sm.step_block(state, np.zeros((1, 17 * 256), np.int16))


# -- the trained artifacts at full width ---------------------------------------
# Their noisy utterances are 64,000 samples, 250 hops: `stream` gives the
# offline enhancer's first 64,000 samples, and the white noise leaves no
# all-zero frame for offline MHANet to mask.

@pytest.fixture(scope="module")
def mhanet_artifact():
    art = load_artifact(device="cpu")
    y_off = make_enhancer(art.inp_tgt, art.net, device="cpu")(art.params, art.noisy[None])
    return art, y_off.numpy()


# Measured on the CPU: 2.1e-7 max abs, 7.2e-7 relative RMS from the port's
# offline enhancer (plain MHANetV3); 1.3e-7 / 6.6e-7 from JAX's streaming
# class. Held to 1e-5 and 1e-5.
def test_mhanet_artifact_stream_matches_offline_and_jax(mhanet_artifact):
    art, y_off = mhanet_artifact
    assert art.noisy.shape == (64000,)
    y = StreamingMHANet(art.inp_tgt, art.net, art.params, fused=True,
                        device="cpu").stream(art.noisy[None]).numpy()
    it_j, net_j, params_j, _, _ = load_artifact_j(MHANET_ROOT)
    y_j = np.asarray(StreamingMHANetJ(it_j, net_j, params_j).stream(
        jnp.asarray(art.noisy[None])))
    for ref in (y_off[:, :64000], y_j):
        assert y.shape == ref.shape == (1, 64000)
        assert np.abs(y - ref).max() <= 1e-5
        assert np.sqrt(np.mean((y - ref) ** 2) / np.mean(ref ** 2)) <= 1e-5


# bf16 caches on trained weights: measured 3.1e-5 max abs, 2.6e-4 relative
# RMS from the f32 stream; held to the JAX test's 2e-2 and 5%.
def test_mhanet_artifact_bf16_caches(mhanet_artifact):
    art, y_off = mhanet_artifact
    y = StreamingMHANet(art.inp_tgt, art.net, art.params, cache_dtype=torch.bfloat16,
                        device="cpu").stream(art.noisy[None]).numpy()
    ref = y_off[:, :64000]
    assert np.abs(y - ref).max() <= 2e-2
    assert np.sqrt(np.mean((y - ref) ** 2) / np.mean(ref ** 2)) <= 0.05


# Measured on the CPU: 1.3e-7 max abs, 4.5e-7 relative RMS from the port's
# offline enhancer; 1.2e-7 / 6.0e-7 from JAX's. Held to 1e-5 and 1e-5.
def test_resnet_artifact_stream_matches_offline_and_jax():
    art = load_flagship_artifact(device="cpu")
    x = art.noisy[None]
    y = StreamingEnhancer(art.inp_tgt, art.net, art.params, device="cpu").stream(x).numpy()
    y_off = make_enhancer(art.inp_tgt, art.net, device="cpu")(art.params, x).numpy()
    it_j, net_j, params_j, _, _ = load_flagship_j()
    y_j = np.asarray(StreamingEnhancerJ(it_j, net_j, params_j).stream(jnp.asarray(x)))
    for ref in (y_off[:, :64000], y_j):
        assert y.shape == ref.shape == (1, 64000)
        assert np.abs(y - ref).max() <= 1e-5
        assert np.sqrt(np.mean((y - ref) ** 2) / np.mean(ref ** 2)) <= 1e-5
