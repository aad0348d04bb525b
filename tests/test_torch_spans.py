"""The port's host spans (`utils.profiling.annotate`) on the CPU, at small
widths: each hot path (`make_enhancer`'s call, `make_train_step`'s step,
`StreamingServer.step`, the build loader's miss path) records its spans
once a call under `torch.profiler`, each child inside its parent and on
the clock of the operations it wraps; with no profiler a span is one
shared no-op and leaves nothing behind; the exported enhancer and
streaming programs hold the same ops whether or not a profiler runs while
they are exported, and no profiler op. Then the benchmark's span
arithmetic (`perfbench/harness/spans.py`) and its six span readers on a
hand-built trace summary. The card's view (the spans on the device
trace's clock, none on the device's track) is in
perfbench/tests/test_perfbench_spans.py."""

import contextlib
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepxi_tpu_torch import enhance as enhance_mod
from deepxi_tpu_torch import serving
from deepxi_tpu_torch.enhance import make_enhancer
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models.tcn import ResNetV2
from deepxi_tpu_torch.ops.kernels import _build
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.streaming import StreamingEnhancer
from deepxi_tpu_torch.training import TrainState, make_optimizer, make_train_step
from deepxi_tpu_torch.utils import annotate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench.harness import spans  # noqa: E402
from perfbench.harness.cell import reader  # noqa: E402
from perfbench.harness.trace import Summary  # noqa: E402

SMALL = dict(d_model=32, n_blocks=2, d_f=16, k=3, max_d_rate=2)
SPANS = {
    "enhance": {"deepxi.enhance": 1, "deepxi.enhance.input": 1},
    "train": {"deepxi.train.step": 1, "deepxi.train.example": 1, "deepxi.train.update": 1},
    "stream": {"deepxi.stream.step": 1},
}
PARENT = {"deepxi.enhance.input": "deepxi.enhance", "deepxi.train.example": "deepxi.train.step",
          "deepxi.train.update": "deepxi.train.step"}


@pytest.fixture(scope="module")
def small():
    """MagXi on seeded DBNormalCDF statistics, a small causal ResNetV2 and
    its weights with the biases moved off zero."""
    rng = np.random.RandomState(0)
    sample = torch.as_tensor((np.abs(rng.randn(64, 257)) ** 2).astype(np.float32))
    db = 10.0 * torch.log10(sample)
    it = MagXi(xi_map=NormalCDF(use_db=True, mu=db.mean(0), sigma=db.std(0)))
    net = ResNetV2(257, 257, **SMALL)
    params = {k: v + 0.05 if v.ndim == 1 else v.clone() for k, v in net.state_dict().items()}
    return it, net, params


def _noisy(seed, B, n):
    return (np.random.RandomState(seed).randn(B, n) * 3000).astype(np.int16)


@pytest.fixture(scope="module")
def streaming_dir(small, tmp_path_factory):
    it, net, params = small
    out = str(tmp_path_factory.mktemp("stream"))
    serving.export_streaming(StreamingEnhancer(it, net, params, device="cpu"), out, batch=2)
    return out


def _calls(small, streaming_dir):
    """Each hot path's call, made ready outside the profiler."""
    it, net, params = small
    enh = make_enhancer(it, net, device="cpu")
    x = _noisy(1, 2, 4096)

    tx = make_optimizer("ResNetV2")
    step = make_train_step(net, it, tx)
    st = TrainState.create(params, tx)
    rng = np.random.RandomState(2)
    s = torch.as_tensor((rng.randn(2, 4096) * 3000).astype(np.int16))
    d = torch.as_tensor((rng.randn(2, 4096) * 2000).astype(np.int16))
    lens = torch.tensor([4096, 3000], dtype=torch.int32)
    snr = torch.tensor([0.0, 5.0])
    offsets = torch.zeros(2, dtype=torch.int64)

    srv = serving.load_streaming_server(streaming_dir)
    state = srv.init_state()
    chunk = _noisy(3, 2, 256)
    return {"enhance": lambda: enh(params, x),
            "train": lambda: step(st, s, d, lens, lens, snr, offsets=offsets),
            "stream": lambda: srv.step(state, chunk)}


def _events(prof):
    """(name, start ns, end ns) of every host event of the profile."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _events(prof)


@pytest.mark.parametrize("path", sorted(SPANS))
def test_each_hot_path_records_its_spans_once(small, streaming_dir, path):
    events = _profiled(_calls(small, streaming_dir)[path])
    names = [n for n, _, _ in events if n.startswith("deepxi.")]
    assert {n: names.count(n) for n in names} == SPANS[path]


@pytest.mark.parametrize("path", sorted(SPANS))
def test_spans_nest_and_hold_the_operations_they_wrap(small, streaming_dir, path):
    """Each child span inside its parent; the outermost span holds every
    `aten::` operation of the call (the same clock as the operations)."""
    events = _profiled(_calls(small, streaming_dir)[path])
    by = {n: (s, e) for n, s, e in events if n.startswith("deepxi.")}
    for child, parent in PARENT.items():
        if child in by:
            assert by[parent][0] <= by[child][0] <= by[child][1] <= by[parent][1]
    outer = by[min(SPANS[path], key=len)]
    aten = [(s, e) for n, s, e in events if n.startswith("aten::")]
    assert aten and all(outer[0] <= s <= e <= outer[1] for s, e in aten)


def test_the_enhancer_input_span_holds_the_copy_and_normalise(small):
    it, net, params = small
    enh = make_enhancer(it, net, device="cpu")
    events = _profiled(lambda: enh(params, _noisy(4, 2, 4096)))
    (s0, e0), = [(s, e) for n, s, e in events if n == "deepxi.enhance.input"]
    inside = {n for n, s, e in events if s0 <= s and e <= e0 and n.startswith("aten::")}
    assert "aten::div" in inside or "aten::mul" in inside, inside
    assert not {"aten::mm", "aten::matmul"} & inside


def test_without_a_profiler_a_span_is_one_shared_no_op(small, streaming_dir):
    """No profiler: every `annotate` is the same no-op context; the calls
    run and a profiler started after them finds no span of theirs."""
    assert not torch.autograd._profiler_enabled()
    assert annotate("deepxi.a") is annotate("deepxi.b")
    with annotate("deepxi.a") as got:
        assert got is None
    for call in _calls(small, streaming_dir).values():
        call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a, b = annotate("deepxi.a"), annotate("deepxi.b")
    assert a is not b
    assert not [n for n, _, _ in _events(prof) if n.startswith("deepxi.")]


def test_a_span_is_a_host_function_span_not_a_user_annotation():
    """A user annotation (`record_function`) is what the profiler copies
    onto the device's track; a span is not one."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("deepxi.span"):
            pass
        with torch.profiler.record_function("user.region"):
            pass
    kinds = {e.name(): (e.is_user_annotation(), e.device_type())
             for e in prof.profiler.kineto_results.events()}
    assert kinds["deepxi.span"] == (False, torch.autograd.DeviceType.CPU)
    assert kinds["user.region"][0] is True


def test_a_span_nests_and_survives_an_exception():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with annotate("deepxi.outer"):
                with annotate("deepxi.inner"):
                    raise ValueError("x")
        with annotate("deepxi.after"):
            torch.ones(2).sum()
    by = {n: (s, e) for n, s, e in _events(prof) if n.startswith("deepxi.")}
    assert set(by) == {"deepxi.outer", "deepxi.inner", "deepxi.after"}
    assert by["deepxi.outer"][0] <= by["deepxi.inner"][0] <= by["deepxi.inner"][1] \
        <= by["deepxi.outer"][1] <= by["deepxi.after"][0]


def test_the_build_loader_spans_its_miss_path_only(monkeypatch):
    built = []
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", lambda specs: built.extend(specs))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: mock.Mock())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lib = _build.load("spectral")
        assert _build.load("spectral") is lib
    names = [n for n, _, _ in _events(prof) if n.startswith("deepxi.")]
    assert names == ["deepxi.kernels.build"] and built == ["spectral"]


def _targets(path):
    """The call targets of an exported program's graph, in order."""
    ep = torch.export.load(path)
    return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]


def _no_spans(name):
    return contextlib.nullcontext()


@pytest.mark.parametrize("kind", ["enhancer", "streaming"])
def test_exported_programs_hold_the_same_ops_and_no_profiler_op(small, tmp_path,
                                                               monkeypatch, kind):
    """Exported with no profiler, under a running profiler (the spans
    live) and with the spans taken out of the enhancer: the same call
    targets, none of them the profiler's."""
    it, net, params = small

    def export(d):
        d = str(tmp_path / d)
        if kind == "enhancer":
            (path,) = serving.export_enhancer(it, net, params, d, batch=2, buckets=(8192,),
                                              device="cpu")
            return path
        serving.export_streaming(StreamingEnhancer(it, net, params, device="cpu"), d,
                                 batch=2)
        return os.path.join(d, "stream_step.pt2")

    plain = _targets(export("plain"))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _targets(export("traced"))
    monkeypatch.setattr(enhance_mod, "annotate", _no_spans)
    without = _targets(export("without"))
    assert plain == traced == without
    assert plain and not [t for t in plain if "profiler" in t or "record_function" in t]


# A hand-built window of 10 ms: device operations busy over [1, 3] and
# [4, 7] ms (two overlapping at 5.5-6), so idle over [0, 1], [3, 4] and
# [7, 10]; two calls' spans, a replay span inside each hop's step span.
def _summary(with_spans=True):
    ms = 1e-3
    ops = [("tcn_window_kernel", 1 * ms, 3 * ms), ("tcn_window_kernel", 4 * ms, 6 * ms),
           ("Memcpy DtoH", 5.5 * ms, 7 * ms)]
    host = [("aten::mm", 0.2 * ms, 0.4 * ms), ("cudaLaunchKernel", 0.9 * ms, 1.0 * ms)]
    if with_spans:
        host += [("deepxi.enhance", 0.5 * ms, 4.5 * ms), ("deepxi.enhance", 6.5 * ms, 9.5 * ms),
                 ("deepxi.enhance.input", 0.5 * ms, 1.5 * ms),
                 ("deepxi.enhance.input", 6.5 * ms, 7.5 * ms),
                 ("deepxi.train.step", 0.5 * ms, 4.5 * ms),
                 ("deepxi.train.step", 6.5 * ms, 9.5 * ms),
                 ("deepxi.stream.step", 0.0, 4 * ms), ("deepxi.stream.step", 5 * ms, 9 * ms),
                 ("deepxi.stream.replay", 1 * ms, 2 * ms),
                 ("deepxi.stream.replay", 6 * ms, 8 * ms)]
    return Summary(10 * ms, ops, host)


def _flat(ivs):
    return [x for iv in ivs for x in iv]


class _Ctx:
    def __init__(self, trace, n=2):
        self.trace, self.work = trace, {"calls": n, "steps": n, "hops": n}


def test_interval_arithmetic():
    assert spans.intersect([(0, 2), (3, 5)], [(1, 4)]) == [(1, 2), (3, 4)]
    assert spans.intersect([(0, 1)], [(1, 2)]) == []
    assert spans.subtract([(0, 4), (5, 9)], [(1, 2), (6, 8)]) == [(0, 1), (2, 4), (5, 6),
                                                                   (8, 9)]
    assert spans.subtract([], [(1, 2)]) == []
    assert spans.subtract([(0, 4)], []) == [(0, 4)]
    assert spans.complement([(1, 3), (4, 12)], 0, 10) == [(0, 1), (3, 4)]
    assert spans.complement([], 0, 10) == [(0, 10)]
    assert spans.length([(0, 1.5), (2, 3)]) == 2.5


def test_spans_by_exact_name_and_the_idle_time_inside_them():
    s = _summary()
    assert _flat(spans.intervals(s, "deepxi.enhance")) == pytest.approx([0.5e-3, 4.5e-3,
                                                                         6.5e-3, 9.5e-3])
    assert spans.intervals(s, "deepxi.enhanc") == []
    idle = spans.idle(s)
    assert _flat(idle) == pytest.approx([0, 1e-3, 3e-3, 4e-3, 7e-3, 10e-3])
    ctx = _Ctx(s)
    assert spans.host_ms_per(ctx, "deepxi.enhance", 2) == pytest.approx(3.5)
    # [0.5, 1] and [3, 4] in the first call, [7, 9.5] in the second
    assert spans.idle_ms_per(ctx, "deepxi.enhance", 2) == pytest.approx(2.0)
    # the step less the replay: 3 + 2 ms over 2 hops
    assert spans.host_ms_per(ctx, "deepxi.stream.step", 2,
                             outside="deepxi.stream.replay") == pytest.approx(2.5)
    assert spans.host_ms_per(ctx, "deepxi.enhance", 0) is None
    assert spans.host_ms_per(ctx, "deepxi.stream.step", 2, outside="deepxi.none") is None


READERS = {
    "host_ms.enhance": 3.5,
    "input_host_ms.enhance": 1.0,
    "program_idle_ms.enhance": 2.0,
    "host_ms.train": 3.5,
    "program_idle_ms.train": 2.0,
    "server_host_ms.stream": 2.5,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader_on_a_summary(name):
    assert reader(name)(_Ctx(_summary())) == pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader_reads_none_without_the_spans(name):
    """As on a program that opens no span: no number, and no error."""
    assert reader(name)(_Ctx(_summary(with_spans=False))) is None
    assert reader(name)(_Ctx(Summary(0.01, [], []))) is None
