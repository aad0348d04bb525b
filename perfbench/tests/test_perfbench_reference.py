"""The plain reference against the port on the CPU at small widths, for
each traffic kind (what `correct` compares, run end to end), and the
reference's own pieces against independent definitions."""

import math

import numpy as np
import pytest
import torch

from perfbench.harness import cell as cells
from perfbench import named
from perfbench.reference import dsp
from perfbench.reference.ops import round_tf32
from perfbench.run import judge, rehearsal

CELLS = [w["name"] for w in cells.manifest()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_port(name):
    ok, checks = rehearsal(name, 3_000_000_019, 0.3)
    assert ok, checks


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference with its products' operands in TF32, put in the
    program's place, reads past a limit (here at small widths; the limits'
    readings are at the cells' own sizes on the card)."""
    c = cells.load(name)
    driver = cells.traffic(c.wl["kind"]).Driver(c, 77, torch.device("cpu"), tiny=True)
    driver.window(0.2)
    numbers = judge(driver, tf32=True)
    assert any(numbers[k] > v for k, v in c.wl["limits"].items()), numbers


def test_exp1():
    x = torch.tensor([1e-8, 0.01, 0.5, 1.0, 1.5, 4.0, 30.0, 700.0], dtype=torch.float64)
    from scipy.special import exp1
    np.testing.assert_allclose(dsp.exp1(x).numpy(), exp1(x.numpy()), rtol=1e-12)


def test_round_tf32():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159265, 1e-30])
    r = round_tf32(x)
    bits = r.view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -9       # ties to even
    assert torch.all((r - x).abs() <= x.abs() * 2 ** -11)


def test_synthesis_is_inverse_of_analysis():
    x = torch.randn(2, 4096, generator=torch.Generator().manual_seed(0))
    y = dsp.istft(dsp.stft(x, 512, 256, 512), 512, 256, 512)
    # every sample but the first half-frame is covered by two frames
    assert torch.allclose(y[:, 256:4096], x[:, 256:], atol=1e-5)


def test_db_normal_cdf_round_trip():
    stats = {"xi_map.mu": torch.tensor([1.0, -3.0]), "xi_map.sigma": torch.tensor([5.0, 10.0])}
    xi = torch.tensor([[0.01, 30.0], [2.0, 1e-3]])
    m = named.module("reference/maps", "DBNormalCDF")
    back = m.inverse(m.forward(xi, stats), stats)
    assert torch.allclose(back, xi, rtol=1e-3)
    lsa = named.module("reference/gains", "mmse-lsa").gain
    assert math.isclose(float(lsa(torch.tensor(1e12), torch.tensor(1e12))), 1.0, rel_tol=1e-6)
