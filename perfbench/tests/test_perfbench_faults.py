"""A run with the timed path broken underneath comes out not correct: each
cell's run (set-up, window, check) on the CPU at small widths with each
fault its traffic can have planted in the program where it produces its
answer (each traffic driver's `FAULTS`). The card's look is skipped; everything after
it is the run's own."""

import pytest

from perfbench.harness import cell as cells
from perfbench.harness.faults import faults, planted
from perfbench.run import rehearsal

SEED = 3_141_592_653
CASES = [(w["name"], fault) for w in cells.manifest()["workloads"]
         for fault in faults(cells.workload(w["name"])["kind"])]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{n}-{f}" for n, f in CASES])
def test_fault_is_not_correct(name, fault):
    with planted(cells.workload(name)["kind"], fault):
        ok, checks = rehearsal(name, SEED, 0.2)
    assert not ok, checks
