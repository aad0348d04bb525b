"""On the card (marked `cuda`; skips without one). A short traced run of
`resnet-1.1c.offline-b96` at its small widths. Every host launch of
`tcn_window_kernel` (the runtime call that CUPTI correlates with the
kernel) lies inside one of the port's `deepxi.enhance` spans, so the spans
are on the device trace's clock; no `deepxi.*` name is among the trace's
device operations (`Summary.ops`), so the spans leave the device's track,
its busy time and its idle gaps as they were; and the spans are host
function spans, not user annotations. Then the stream server's spans
around its graph's capture and replay."""

import os
import tempfile
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.harness import cell as cells
from perfbench.harness.trace import summarise

CELL = "resnet-1.1c.offline-b96"
KERNEL = "tcn_window_kernel"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_enhance_spans_hold_the_kernel_launches_and_stay_off_the_device(card):
    c = cells.load(CELL)
    driver = cells.traffic(c.wl["kind"]).Driver(c, 3_141_592_653, card, tiny=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        driver.window(0.3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = list(prof.profiler.kineto_results.events())
    on_card = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    on_host = [e for e in events if e.device_type() != torch.autograd.DeviceType.CUDA]

    summary = summarise(events, wall)
    assert summary.ops
    assert not [n for n, _, _ in summary.ops if n.startswith("deepxi.")]
    assert not [e.name() for e in on_card if e.name().startswith("deepxi.")]

    spans = sorted((e.start_ns(), e.end_ns()) for e in on_host if e.name() == "deepxi.enhance")
    assert len(spans) == driver.work["calls"] > 0
    assert not [e.name() for e in on_host
                if e.name().startswith("deepxi.") and e.is_user_annotation()]

    kernels = {e.correlation_id() for e in on_card if KERNEL in e.name()}
    launches = [(e.start_ns(), e.end_ns()) for e in on_host
                if e.correlation_id() in kernels and e.name().startswith("cu")]
    assert kernels and len(launches) == len(kernels)
    outside = [(s, e) for s, e in launches
               if not any(a <= s and e <= b for a, b in spans)]
    assert not outside, (len(outside), len(launches))


@pytest.mark.cuda
def test_stream_step_spans_its_replay_state_copies_and_capture(card):
    """`resnet-1.1c.stream-b256` at its small widths: a fresh server's first
    hop captures inside its step; every hop then holds one replay and the
    state copies in and out, each inside the hop's step span."""
    from deepxi_tpu_torch.serving import load_streaming_server

    c = cells.load("resnet-1.1c.stream-b256")
    driver = cells.traffic(c.wl["kind"]).Driver(c, 2_718_281_828, card, tiny=True)
    out_dir = os.path.join(tempfile.gettempdir(), "perfbench", c.name)
    server = load_streaming_server(out_dir)
    state = server.init_state()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(4):
            state, y = server.step(state, driver.hops[k])
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    assert not [e.name() for e in events if e.name().startswith("deepxi.")
                and e.device_type() == torch.autograd.DeviceType.CUDA]
    named = {}
    for e in events:
        if e.name().startswith("deepxi.stream."):
            named.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    counts = {n: len(v) for n, v in named.items()}
    assert counts == {"deepxi.stream.step": 4, "deepxi.stream.capture": 1,
                      "deepxi.stream.replay": 4, "deepxi.stream.state": 7}
    steps = named["deepxi.stream.step"]
    for name in ("deepxi.stream.capture", "deepxi.stream.replay", "deepxi.stream.state"):
        for s, e in named[name]:
            assert any(a <= s and e <= b for a, b in steps), name
    assert server.replays == 4
