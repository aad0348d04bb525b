"""Every width runs the kernel routes: each kernel family's `kernel_takes`
on both sides of the widths its kernels can be built for;
`DeepXiTorch.fast_apply` and `apply_fn`, the attention module's "fused" and
"stream" routes and `StreamingMHANet(fused=True)` call the kernel wrappers
at the flagship widths and at d_model 32 alike (here, on the CPU, the
wrappers run their plain versions; on the card each width builds its own
kernels); and `DeepXiTorch.infer` at d_model 32 on the CPU against the JAX
package's `DeepXiTPU.infer` at the same widths (whose fast path runs its
Pallas kernels there, in interpret mode). The same routes on the card are
in tests/test_torch_cuda.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.config import Config as ConfigJ
from deepxi_tpu.framework import DeepXiTPU
from deepxi_tpu.inp_tgt import inp_tgt_selector
from deepxi_tpu.models import network_selector
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.config import Config, preset
from deepxi_tpu_torch.data import listing
from deepxi_tpu_torch.data.wavio import read_wav, save_wav
from deepxi_tpu_torch.framework import DeepXiTorch
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models.attention import MHANetV3, TFAMultiHeadAttention
from deepxi_tpu_torch.ops.kernels import (mha_block_fused, mha_flash_stream,
                                          mha_fused, tcn_fused)
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.streaming import StreamingMHANet

SMALL_RESNET = dict(d_model=32, n_blocks=3, d_f=16)
SMALL_MHANET = dict(d_model=32, n_blocks=2, n_heads=4)


@pytest.mark.parametrize("takes,widths,expected", [
    (tcn_fused.kernel_takes, (256, 64, 3), True),
    (tcn_fused.kernel_takes, (32, 16, 3), True),
    (tcn_fused.kernel_takes, (1024, 4, 5), True),
    (tcn_fused.kernel_takes, (30, 16, 3), False),
    (tcn_fused.kernel_takes, (32, 18, 3), False),
    (tcn_fused.kernel_takes, (2048, 64, 3), False),
    (tcn_fused.kernel_takes, (32, 16, 0), False),
    (mha_block_fused.kernel_takes, (256, 8, 1024), True),
    (mha_block_fused.kernel_takes, (32, 4, 128), True),
    (mha_block_fused.kernel_takes, (48, 12, 96), True),
    (mha_block_fused.kernel_takes, (32, 5, 128), False),
    (mha_block_fused.kernel_takes, (256, 2, 1024), False),
    (mha_block_fused.kernel_takes, (32, 4, 80), False),
    (mha_fused.kernel_takes, (8, 32), True),
    (mha_fused.kernel_takes, (4, 8), True),
    (mha_fused.kernel_takes, (16, 64), True),
    (mha_fused.kernel_takes, (4, 6), False),
    (mha_fused.kernel_takes, (2, 128), False),
    (mha_fused.kernel_takes, (64, 4), False),
])
def test_kernel_takes_both_sides_of_its_widths(takes, widths, expected):
    assert takes(*widths) is expected


def _stats(tmp_path, ver):
    np.savez(tmp_path / f"{ver}_stats.npz",
             **{"xi_map.mu": np.zeros(257, np.float32),
                "xi_map.sigma": np.ones(257, np.float32)})
    return str(tmp_path)


@pytest.mark.parametrize("ver,widths", [
    ("resnet-1.1c", {}),
    ("resnet-1.1c", SMALL_RESNET),
    ("resnet-1.1c", dict(d_f=16)),
    ("mhanet-1.1c", {}),
    ("mhanet-1.1c", SMALL_MHANET),
    ("mhanet-1.1c", dict(n_heads=4)),
])
def test_framework_routes_take_the_kernels_at_every_width(tmp_path, monkeypatch, ver,
                                                          widths):
    """`fast_apply()` (and, for resnet-1.1c, whose preset trains through the
    fused stack, `apply_fn()`) gives the kernel route at the flagship widths
    and at any other: the fused routes are the kernels' own functions."""
    dx = DeepXiTorch(preset(ver, data_path=_stats(tmp_path, ver), **widths), device="cpu")
    if ver == "resnet-1.1c":
        assert dx.apply_fn() is not None
    seen = []
    target = (tcn_fused, "resnetv2_apply_fused") if ver == "resnet-1.1c" \
        else (mha_block_fused, "mhanetv3_apply_fused")
    monkeypatch.setattr(*target, lambda p, m, **kw: seen.append(kw))
    fast = dx.fast_apply()
    assert fast is not None
    fast({}, None)
    assert seen and seen[0]["n_blocks"] == dx.cfg.n_blocks


def _spy(monkeypatch, module, name):
    """Replace module.name with a pass-through that records its calls."""
    calls, fn = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("impl", ["fused", "stream"])
@pytest.mark.parametrize("head,heads", [(32, 8), (8, 4)])
def test_attention_module_routes_take_the_kernel_at_every_width(monkeypatch, impl,
                                                                head, heads):
    """8 heads of 32 and 4 heads of 8 both call the kernel wrapper, and the
    output is the "full" route's on the valid rows."""
    module, name = {"fused": (mha_fused, "flash_attention"),
                    "stream": (mha_flash_stream, "flash_attention_streaming")}[impl]
    calls = _spy(monkeypatch, module, name)
    c = head * heads
    gen = torch.Generator().manual_seed(head)
    x = torch.randn(2, 20, c, generator=gen)
    valid = torch.arange(20)[None, :] < torch.tensor([[20], [13]])
    outs = {}
    for route in ("full", impl):
        att = TFAMultiHeadAttention(head, heads, c, c, route, block_q=16)
        for p in att.parameters():
            p.data = torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.2
        mask = (valid[:, None, :, None] & valid[:, None, None, :]
                & torch.ones(20, 20, dtype=torch.bool).tril()).float()
        with torch.no_grad():
            outs[route] = att(x, mask=mask, valid=valid, causal=True)
    assert len(calls) == 1 and calls[0][0].shape == (2, 20, heads, head)
    assert torch.allclose(outs[impl][valid], outs["full"][valid], atol=1e-5)


@pytest.mark.parametrize("widths", [{}, SMALL_MHANET])
def test_streaming_route_takes_the_kernel_at_every_width(monkeypatch, widths):
    """StreamingMHANet(fused=True) calls `mha_cache_step` once a block and
    hop at the flagship widths and at 4 heads of 8; fused=False does not."""
    from deepxi_tpu_torch import streaming
    calls = _spy(monkeypatch, streaming, "mha_cache_step")
    net = MHANetV3(257, 257, **widths)
    params = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(2)) * 0.05
              for k, v in net.state_dict().items()}
    it = MagXi(xi_map=NormalCDF(use_db=True, mu=torch.zeros(257), sigma=torch.ones(257)))
    wav = (torch.randn(1, 256 * 3, generator=torch.Generator().manual_seed(3)) * 3000
           ).to(torch.int16)
    y = {f: StreamingMHANet(it, net, params, fused=f, device="cpu").stream(wav)
         for f in (True, False)}
    heads, d_model = widths.get("n_heads", 8), widths.get("d_model", 256)
    assert len(calls) == 3 * net.n_blocks
    assert calls[0][0].shape[1:] == (heads, d_model // heads)
    assert torch.allclose(y[True], y[False], atol=1e-6)


def _jax_run(tmp_path, kind):
    """A small net's flax parameters (biases off zero) and the JAX
    package's `infer` on two utterances of a test directory."""
    rng = np.random.RandomState(0)
    test_dir = tmp_path / "test"
    for name, n in (("a_white_5dB", 9000), ("b_babble_0dB", 5000)):
        save_wav(str(test_dir / f"{name}.wav"), (rng.randn(n) * 3000).astype(np.int16), 16000)
    if kind == "resnet":
        net_kw = dict(network_type="ResNetV2", k=3, max_d_rate=2,
                      unit_type="ReLU->LN->W+b", **SMALL_RESNET)
    else:
        net_kw = dict(network_type="MHANetV3", max_len=128, **SMALL_MHANET)
    paths = dict(data_path=str(tmp_path / "data"), model_path=str(tmp_path / "model"),
                 log_path=str(tmp_path / "log"), test_x_path=str(test_dir))
    cfg_j = ConfigJ(ver="tiny", causal=True, tcn_fused=True,
                    out_path=str(tmp_path / "out_j"), **paths, **net_kw)
    dx_j = DeepXiTPU.__new__(DeepXiTPU)
    dx_j.cfg = cfg_j
    it_j = inp_tgt_selector("MagXi", N_d=512, N_s=256, K=512, f_s=16000,
                            map_type="DBNormalCDF", map_params=None)
    sample = (np.abs(rng.randn(32, 257)) ** 2).astype(np.float32)
    dx_j.inp_tgt = it_j.replace(xi_map=it_j.xi_map.with_stats(jnp.asarray(sample)))
    dx_j.network = network_selector(net_kw["network_type"], 257, **cfg_j.network_kwargs())
    params = dx_j.network.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 257)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
                                    params)
    written = dx_j.infer(params=params, out_type="y", epochs=[1], gains=["mmse-lsa"])
    (tmp_path / "data").mkdir()
    np.savez(tmp_path / "data" / "tiny_stats.npz",
             **{f"xi_map.{k}": np.asarray(getattr(dx_j.inp_tgt.xi_map, k))
                for k in ("mu", "sigma")})
    cfg = Config(ver="tiny", causal=True, out_path=str(tmp_path / "out"), **paths, **net_kw)
    return cfg, (dx_j, params), written


# Measured on the CPU: float waveforms 1.7e-7 (resnet) and 1.3e-7 (mhanet)
# max abs from the JAX package's; held to 1e-5, tests/test_torch_slice.py's
# limit, and the written wavs to 1 int16 step.
@pytest.mark.parametrize("kind", ["resnet", "mhanet"])
def test_small_width_infer_matches_jax(tmp_path, kind):
    """d_model 32: the JAX fast path runs its fused kernels (interpret mode),
    and so does the port's `fast_apply()`, here through the wrappers' plain
    versions (on the card, through kernels built for these widths)."""
    cfg, (dx_j, params_j), written_j = _jax_run(tmp_path, kind)
    params = from_flax_params(params_j)
    dx = DeepXiTorch(cfg, device="cpu")
    assert dx.fast_apply() is not None
    written = dx.infer(params=params, epochs=[1], gains=["mmse-lsa"])
    x, lens, _, names = listing.test_batch(cfg.test_x_path)
    for y, y_j in zip(dx.enhance_all(params, x, lens, "mmse-lsa"),
                      dx_j._enhance_all(params_j, x, lens, names, "mmse-lsa")):
        assert y.shape == y_j.shape and np.abs(y - y_j).max() <= 1e-5
    assert ([os.path.relpath(p, cfg.out_path) for p in written]
            == [os.path.relpath(p, dx_j.cfg.out_path) for p in written_j])
    for p, p_j in zip(written, written_j):
        y, y_j = read_wav(p)[0], read_wav(p_j)[0]
        assert y.shape == y_j.shape and np.abs(y).max() > 100
        assert np.abs(y.astype(np.int32) - y_j).max() <= 1
