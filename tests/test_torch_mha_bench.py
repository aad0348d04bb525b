"""mhanet-1.1c as the benchmark runs it, on the CPU. The port's inference
fast path (`mhanetv3_apply_fused`, every block one
`deepxi::fused_transformer_block` through its plain CPU route, and
`make_enhancer` with it) against the benchmark's plain reference,
`perfbench/reference/networks/MHANetV3.py`, at the configuration's small
widths (`tiny` in `perfbench/configs/mhanet-1.1c.json`: d_model 32, 2
blocks, 4 heads, max_len 48) on seeded weights, and on the trained
checkpoint at full width; the checkpoint as the benchmark loads it; the
reference's operation counts; the `deepxi.mha` span, the long-route
counter, and the span's reader. The card's run of the same comparison is
the cell `mhanet-1.1c.offline-b64` (`perfbench/run.py`)."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from deepxi_tpu_torch.compat.artifact import load_artifact
from deepxi_tpu_torch.enhance import make_enhancer
from deepxi_tpu_torch.ops.kernels import mha_block_fused
from deepxi_tpu_torch.ops.kernels.mha_block_fused import mhanetv3_apply_fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench import named  # noqa: E402
from perfbench.harness import cell as cells  # noqa: E402
from perfbench.harness import program  # noqa: E402
from perfbench.harness.trace import WINDOW, summarise  # noqa: E402
from perfbench.inputs import synth, weights  # noqa: E402
from perfbench.reference import dsp  # noqa: E402
from perfbench.reference.ops import matmul_tf32  # noqa: E402

FULL = cells.config("mhanet-1.1c")
TINY = dict(FULL, **FULL["tiny"])
REF = named.module("reference/networks", "MHANetV3")
N_FEAT = 257

# Network output (a sigmoid, in (0, 1)): the port and the reference are
# two float32 orders of the same sums (einsums against one [d, H d_k]
# product, the block's LayerNorms against the reference's); at these widths
# they differ by 3-4e-7, and 2e-6 leaves room for other CPUs' summation.
# The reference with its products' operands in TF32 reads past it (8e-4 to
# 1e-3).
NET_ATOL = 2e-6
# Waveform: the worst row's largest gap over its largest sample, as the
# cell's `wave_gap`; the same two orders through the gain, the inverse DFT
# and the overlap-add (8e-7 read; the TF32 control 8e-4).
WAVE_GAP = 1e-5


def _features(seed, B, T, valid=None):
    """|X|-like network input [B, T, 257]; row b zero from `valid[b]` on."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, N_FEAT, generator=g).abs() * 3.0
    for b, n in enumerate(valid or []):
        x[b, n:] = 0.0
    return x


@pytest.fixture(scope="module")
def tiny():
    """Seeded weights at the small widths, the biases and LayerNorm
    parameters moved off 0 and 1 so that they count; the port's fast
    path."""
    p = weights.seeded(TINY, synth.Draws(2_400_000_001, "cpu"))
    g = torch.Generator().manual_seed(1)
    p = {k: v + 0.1 * torch.randn(v.shape, generator=g)
         if k.endswith((".bias", ".scale")) else v for k, v in p.items()}
    return p, program.fast_apply(program.port_config(TINY))


def _gap(y, r):
    return float(((y - r).abs().amax(-1) / r.abs().amax(-1)).max())


@pytest.mark.parametrize("T", [40, 100, 128], ids=["T40", "T100-wraps", "T128-wraps"])
def test_fast_path_matches_the_reference(tiny, T):
    """T under max_len, past it and not a multiple of 128, and a whole
    128 past it: the positions wrap, the block route pads to 128."""
    p, apply = tiny
    x = _features(T, 2, T)
    with torch.no_grad():
        got = apply(p, x)
        want = REF.forward(p, x, TINY)
        control = REF.forward(p, x, TINY, matmul_tf32)
    assert got.shape == (2, T, N_FEAT)
    torch.testing.assert_close(got, want, rtol=0, atol=NET_ATOL)
    assert (control - want).abs().max() > 10 * NET_ATOL


def test_zero_padded_tail_on_valid_frames(tiny):
    """A row whose last frames are zero: its valid frames match the
    reference and the same row without the tail (a padded frame is no key
    of a valid one); the padded frames' own output is implementation-
    defined and left out."""
    p, apply = tiny
    x = _features(7, 2, 90, valid=[90, 61])
    with torch.no_grad():
        got, want = apply(p, x), REF.forward(p, x, TINY)
        alone = apply(p, x[1:, :61].contiguous())
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=NET_ATOL)
    torch.testing.assert_close(got[1, :61], want[1, :61], rtol=0, atol=NET_ATOL)
    torch.testing.assert_close(got[1, :61], alone[0], rtol=0, atol=NET_ATOL)


def test_causal_future_independence(tiny):
    """Frames after t0 changed: the output before t0 does not move, in the
    port or in the reference."""
    p, apply = tiny
    x = _features(11, 1, 100)
    y = x.clone()
    y[:, 70:] = _features(12, 1, 30)
    with torch.no_grad():
        for fn in (lambda v: apply(p, v), lambda v: REF.forward(p, v, TINY)):
            a, b = fn(x), fn(y)
            torch.testing.assert_close(a[:, :70], b[:, :70], rtol=0, atol=1e-7)
            assert (a[:, 70:] - b[:, 70:]).abs().max() > 1e-3


def test_enhancer_waveform_matches_the_reference(tiny):
    """`make_enhancer` with the fast path, as the cell calls it, against
    the reference's analysis, network, map, gain and synthesis."""
    p, apply = tiny
    stats = weights.stats(TINY, "cpu")
    pcfg = program.port_config(TINY)
    it = program.family(TINY, stats, "cpu")
    enhance = make_enhancer(it, program.network(pcfg, it, "cpu"), TINY["gain"],
                            apply_fn=apply, device="cpu")
    x = (np.random.default_rng(3).standard_normal((2, 16000)) * 3000).astype(np.int16)
    got = enhance(p, x)
    with torch.no_grad():
        want = dsp.enhance(lambda f: REF.forward(p, f, TINY), torch.as_tensor(x), TINY, stats)
    assert got.shape == want.shape
    assert _gap(got, want) < WAVE_GAP


def test_trained_checkpoint_matches_the_reference():
    """The checkpoint at full width, as the benchmark loads it, on 80
    frames of |X| of the artifact's noisy utterance. The trained weights
    amplify float32 rounding (1-2.3e-5 between flax's and the port's orders
    on the whole 4 s utterance); here 4.5e-7 read, so 1e-5, which the TF32
    control (1.8e-3) fails."""
    p = weights.artifact(FULL, "cpu")
    art = load_artifact(device="cpu")
    X = dsp.stft(torch.as_tensor(art.noisy[None, :80 * 256]).float() / 32768.0, 512, 256, 512)
    x = X.abs().float()
    apply = program.fast_apply(program.port_config(FULL))
    with torch.no_grad():
        got, want = apply(p, x), REF.forward(p, x, FULL)
        control = REF.forward(p, x, FULL, matmul_tf32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert (control - want).abs().max() > 1e-4


def test_checkpoint_loads_through_the_benchmark():
    """`weights.artifact` reads the checked-in checkpoint in Flax's leaf
    order (p60 = in_conv.kernel): 66 leaves, 4,600,321 parameters, each
    equal to the port's own loader's."""
    p = weights.artifact(FULL, "cpu")
    own = load_artifact(device="cpu").params
    assert len(p) == 66 and sum(v.numel() for v in p.values()) == 4_600_321
    assert set(p) == set(own)
    for k, v in p.items():
        assert torch.equal(v, own[k]), k
    z = np.load(os.path.join(ROOT, FULL["weights"]["params"]))
    assert np.array_equal(z["p60"], p["in_conv.kernel"].numpy())


def test_reference_counts():
    assert REF.flops_per_frame(FULL, N_FEAT, N_FEAT) == 8_127_488
    assert REF.block_flops_per_frame(FULL) == 1_572_864
    flops, _ = REF.block_work(FULL, 64, 625)
    assert flops == 75_735_040_000          # csrc/mha_block_fused.cu: 75.7 GFLOP
    att, att_bytes = REF.attention_work(FULL, 64, 625)
    assert att == 1024 * 64 * 625 * 626 // 2 and att_bytes == 4 * 4 * 64 * 625 * 256


def _names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("deepxi.")]


def test_mha_span_once_a_call(tiny):
    p, apply = tiny
    x = _features(5, 1, 50)
    with torch.no_grad():
        assert _names(lambda: apply(p, x)) == ["deepxi.mha"]
        long = lambda: mhanetv3_apply_fused(p, x, n_blocks=2, n_heads=4, d_model=32,  # noqa: E731
                                            max_len=48, whole_max_t=40)
        assert _names(long) == ["deepxi.mha"]


def test_long_route_counter(tiny):
    """Only a call past `whole_max_t` takes the long route and counts."""
    p, _ = tiny
    kw = dict(n_blocks=2, n_heads=4, d_model=32, max_len=48, whole_max_t=64)
    before = mhanetv3_apply_fused.long_route_calls
    launches = mha_block_fused.fused_transformer_block.launches
    with torch.no_grad():
        mhanetv3_apply_fused(p, _features(1, 1, 64), **kw)
        assert mhanetv3_apply_fused.long_route_calls == before
        x = _features(2, 1, 65)
        got = mhanetv3_apply_fused(p, x, **kw)
        assert mhanetv3_apply_fused.long_route_calls == before + 1
        torch.testing.assert_close(got, REF.forward(p, x, TINY), rtol=0, atol=NET_ATOL)
    # the CPU route is the plain version: no launch
    assert mha_block_fused.fused_transformer_block.launches == launches


def test_host_ms_reader_reads_the_span(tiny):
    """A profiled window of two `make_enhancer` calls through the fast
    path, reduced as the benchmark reduces it: `mha_host_ms.enhance` reads
    the `deepxi.mha` spans, inside `host_ms.enhance`'s."""
    p, apply = tiny
    stats = weights.stats(TINY, "cpu")
    pcfg = program.port_config(TINY)
    it = program.family(TINY, stats, "cpu")
    enhance = make_enhancer(it, program.network(pcfg, it, "cpu"), TINY["gain"],
                            apply_fn=apply, device="cpu")
    x = (np.random.default_rng(4).standard_normal((2, 8000)) * 3000).astype(np.int16)
    enhance(p, x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            enhance(p, x)
            enhance(p, x)
    summary = summarise(prof.profiler.kineto_results.events(), 0.0)

    class Ctx:
        trace, work = summary, {"calls": 2}
    mha = cells.reader("mha_host_ms.enhance")(Ctx)
    whole = cells.reader("host_ms.enhance")(Ctx)
    assert mha is not None and 0 < mha < whole
