"""On the card (marked `cuda`; skips without one): each cell's run at its
small widths through the kernels comes out correct, and the precision
control put in the program's place does not. The cells' own sizes are read
by `perfbench/calibrate.py check` and `perfbench/run.py`."""

import pytest
import torch

from perfbench.harness import cell as cells
from perfbench.run import judge, verdict

CELLS = [w["name"] for w in cells.manifest()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_small_cell_on_the_card(card, name):
    c = cells.load(name)
    Driver = cells.traffic(c.wl["kind"]).Driver
    driver = Driver(c, 2_718_281_828, card, tiny=True)
    driver.window(0.5)
    ok, checks = verdict(judge(driver), c.wl["limits"])
    assert ok, checks
    control = Driver(c, 2_718_281_828, card, tiny=True)
    control.window(0.2)
    numbers = judge(control, tf32=True)
    assert any(numbers[k] > v for k, v in c.wl["limits"].items()), numbers
