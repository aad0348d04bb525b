"""mhanet-1.1c's parts of the benchmark: the reference's state dict at the
published widths, the three per-layer readers the cell
`mhanet-1.1c.offline-b64` adds on a hand-built trace (and None where the
trace lacks their kernels or span, as a program without them gives), and
on the card (marked `cuda`; skips without one) the cell at its own size:
five fused-block launches a call and no call on the long route."""

import pytest
import torch

import perfbench.reference as ref
from perfbench import named
from perfbench.harness import cell as cells
from perfbench.harness import peaks
from perfbench.harness.trace import Summary

CELL = "mhanet-1.1c.offline-b64"
CFG = cells.config("mhanet-1.1c")
REF = named.module("reference/networks", "MHANetV3")


def test_state_dict_at_the_published_widths():
    fam = ref.family(CFG)
    spec = REF.shapes(CFG, fam.n_feat(CFG), fam.n_outp(CFG))
    assert len(spec) == 66
    assert sum(torch.Size(s).numel() for s, _ in spec.values()) == 4_600_321
    assert spec["pos_emb.embedding"][0] == (2048, 256)
    assert spec["block4_mha.projection_kernel"][0] == (8, 32, 256)
    flax = sorted(spec, key=lambda k: tuple(k.split(".")))
    assert flax[60] == "in_conv.kernel" and flax[-1] == "pos_emb.embedding"


# Two calls of B=64 x T=625 in a 10 ms window: each block's three launches
# take 0.1 + 0.4 + 0.5 ms of device time, 5 blocks a call.
MS = 1e-3
KERNELS = {"mha_qkv_kernel<4>": 0.1, "mha_attention_kernel": 0.4, "mha_post_kernel<4, 1>": 0.5}


def _summary(with_block=True, with_span=True):
    ops, host, at = [], [], 0.0
    for _ in range(2 * 5):
        for name, ms in KERNELS.items():
            if with_block:
                ops.append((name, at, at + ms * MS))
            at += ms * MS
    ops.append(("Memcpy HtoD", 0.0, 0.2 * MS))
    if with_span:
        host = [("deepxi.mha", 0.5 * MS, 2.0 * MS), ("deepxi.mha", 6.0 * MS, 6.5 * MS)]
    return Summary(10 * MS, ops, host)


class _Ctx:
    def __init__(self, trace):
        self.trace, self.cfg = trace, CFG
        self.work = {"calls": 2, "rows": 64, "T": 625, "valid_frames": 64 * 625}


def test_block_roofline_reader():
    flops, nbytes = REF.block_work(CFG, 64, 625)
    assert flops / peaks.TF32_FLOP_S > nbytes / peaks.HBM_BYTE_S      # bound by operations
    want = 100.0 * 10 * (flops / peaks.TF32_FLOP_S) / (10 * 1.0 * MS)
    got = cells.reader("mha_block_roofline_pct")(_Ctx(_summary()))
    assert got == pytest.approx(want) and 5 < got < 100


def test_attention_roofline_reader():
    flops, nbytes = REF.attention_work(CFG, 64, 625)
    assert nbytes / peaks.HBM_BYTE_S > flops / peaks.TF32_FLOP_S      # bound by bytes
    want = 100.0 * 10 * (nbytes / peaks.HBM_BYTE_S) / (10 * 0.4 * MS)
    got = cells.reader("mha_attention_roofline_pct")(_Ctx(_summary()))
    assert got == pytest.approx(want) and 5 < got < 100


def test_host_ms_reader():
    assert cells.reader("mha_host_ms.enhance")(_Ctx(_summary())) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["mha_block_roofline_pct", "mha_attention_roofline_pct",
                                  "mha_host_ms.enhance"])
def test_readers_read_none_without_their_kernels_or_span(name):
    assert cells.reader(name)(_Ctx(_summary(with_block=False, with_span=False))) is None
    assert cells.reader(name)(_Ctx(Summary(0.01, [], []))) is None


def test_the_cell_reports_its_readers():
    names = {m["name"] for m in cells.load(CELL).per_layer}
    assert {"mha_block_roofline_pct", "mha_attention_roofline_pct",
            "mha_host_ms.enhance", "mfu_pct.enhance", "device_idle_pct.enhance"} <= names
    assert "tcn_roofline_pct" not in names


@pytest.mark.cuda
def test_the_cell_on_the_card_takes_the_block_route():
    """At the cell's own size: five `fused_transformer_block` launches a
    call, none on the long route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    from deepxi_tpu_torch.ops.kernels.mha_block_fused import (fused_transformer_block,
                                                              mhanetv3_apply_fused)
    c = cells.load(CELL)
    driver = cells.traffic(c.wl["kind"]).Driver(c, 2_400_000_007, torch.device("cuda"))
    launches, long_calls = fused_transformer_block.launches, mhanetv3_apply_fused.long_route_calls
    driver.window(1.0)
    calls = driver.work["calls"]
    assert calls > 0
    assert fused_transformer_block.launches - launches == 5 * calls
    assert mhanetv3_apply_fused.long_route_calls == long_calls
