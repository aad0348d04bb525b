"""The operation and byte counts against PERF.md section 6's numbers, and
the configurations' parameter counts."""

import pytest

from perfbench.harness import cell as cells
from perfbench.harness import peaks, work
from perfbench.inputs import weights
import perfbench.reference as ref


def test_tcn_block_flops():
    assert work.tcn_block_flops(cells.config("resnet-1.1c")) == 90_112


def test_lstm_bound_at_67_tflops():
    """PERF.md's bound of the LSTM kernels at B=8 T=256 H=512: 0.0641 ms
    at 67 TFLOP/s (operation-bound)."""
    B, T, H = 8, 256, 512
    flops = work.lstm_flops(H) * B * T
    assert flops / 67e12 * 1e3 == pytest.approx(0.0641, abs=5e-5)
    assert work.lstm_forward_bytes(T, B, H) / peaks.HBM_BYTE_S < flops / 67e12


@pytest.mark.parametrize("name,count", [("resnet-1.1c", 1_949_953), ("reslstm-1.0c", 10_760_449)])
def test_parameter_count(name, count):
    cfg = cells.config(name)
    n = sum(int(__import__("numpy").prod(s)) for s, _ in weights.shapes(cfg).values())
    assert n == count == cfg["weights"]["n_params"]


def test_forward_flops_and_receptive_field():
    cfg = cells.config("resnet-1.1c")
    assert work.forward_flops_per_frame(cfg) == 2 * 2 * 257 * 256 + 40 * 90_112
    assert ref.net(cfg).receptive_field(cfg) == 497
    lstm = cells.config("reslstm-1.0c")
    per_block = 2 * 512 * 2048 + 8 * 512 * 512
    assert work.forward_flops_per_frame(lstm) == 2 * 2 * 257 * 512 + 5 * per_block
    assert work.train_flops_per_frame(lstm) == 3 * work.forward_flops_per_frame(lstm) - 2 * 257 * 512


def test_least_seconds():
    assert peaks.least_seconds(495e12, 0) == 1.0
    assert peaks.least_seconds(0, 3.35e12) == 1.0
