"""Faults planted in the program where it produces its answers, to show
that the check catches them (the benchmark's tests on the CPU, and
`calibrate.py check --fault` on the card at a cell's own size). Each
traffic driver declares its own: `FAULTS`, the names of the faults its
cells can have, and `broken(fault)`, the replacements of its program entry
points ({name in the traffic module: wrapper of the real one})."""

from __future__ import annotations

import contextlib

from perfbench.harness import cell as cells


def faults(kind: str):
    return tuple(getattr(cells.traffic(kind), "FAULTS", ()))


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """The traffic driver `kind`'s program entry points replaced by ones
    with `fault`, inside the block."""
    mod = cells.traffic(kind)
    if fault not in faults(kind):
        raise ValueError(f"{kind} traffic has no fault {fault!r}")
    real = {}
    try:
        for name, wrap in mod.broken(fault).items():
            real[name] = getattr(mod, name)
            setattr(mod, name, wrap(real[name]))
        yield
    finally:
        for name, fn in real.items():
            setattr(mod, name, fn)
