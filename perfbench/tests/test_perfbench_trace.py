"""The trace's reduction: device busy time as the union of operations in
the window, the window's own annotation left out, the lead-in kernel left
out, and idle gaps named by the host's innermost operation."""

import torch

from perfbench.harness import readers
from perfbench.harness.trace import summarise

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Event:
    def __init__(self, name, device, start, end):
        self._args = name, device, start, end

    def name(self):
        return self._args[0]

    def device_type(self):
        return self._args[1]

    def start_ns(self):
        return self._args[2]

    def end_ns(self):
        return self._args[3]


def _summary():
    return summarise([
        _Event("perfbench.window", CPU, 1000, 11000),
        _Event("perfbench.window", CUDA, 1000, 11000),
        _Event("spin_kernel", CUDA, 0, 900),
        _Event("aten::mm", CPU, 1500, 3000),
        _Event("cudaLaunchKernel", CPU, 2000, 2500),
        _Event("void tcn_window_kernel<1, 2, false>(float const*)", CUDA, 2600, 5000),
        _Event("void tcn_window_kernel<1, 2, false>(float const*)", CUDA, 4000, 5500),
        _Event("Memcpy DtoH (Device -> Pageable)", CUDA, 6000, 9000)], 1e-5)


def test_busy_idle_and_gaps():
    s = _summary()
    assert s.window_s == 1e-5
    assert abs(s.busy_s - 5.9e-6) < 1e-12          # [1.6, 4.5] and [5, 8] us
    b = s.breakdown()
    assert b["device_ops"][0][0] == "tcn_window_kernel<1, 2, false>"   # 2.4 + 1.5 us
    assert b["device_ops"][1][0] == "Memcpy DtoH"
    assert dict(b["idle_gaps"])["aten::mm"] == 1.6e-6


def test_readers_on_a_summary():
    class Ctx:
        trace = _summary()
    assert abs(readers.idle_pct(Ctx) - 41.0) < 1e-9
    assert abs(readers.device_ms_per(Ctx, readers.COPIES, 1) - 3e-3) < 1e-15
    assert readers.roofline_pct(Ctx, ("no_such_kernel",), 1.0) is None
    assert abs(readers.roofline_pct(Ctx, ("tcn_window_kernel",), 0.39e-6) - 10.0) < 1e-9
