"""A cell's files, found by name: `BENCHMARK.json` at the checkout's root,
`configs/<config>.json`, `workloads/<cell>.json`, the traffic driver
`traffic/<kind>.py` and one reader `metrics/<metric>.py` per per-layer
metric. Adding a cell, a configuration or a per-layer metric adds files and
edits none (so do a network, family, map or gain of the reference:
`perfbench/named.py`)."""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List

from perfbench import named

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def config(name: str) -> dict:
    return _json(os.path.join(BENCH, "configs", f"{name}.json"))


def workload(name: str) -> dict:
    return _json(os.path.join(BENCH, "workloads", f"{name}.json"))


def traffic(kind: str):
    return importlib.import_module(f"perfbench.traffic.{kind}")


def reader(metric: str):
    """The `read(ctx)` of `metrics/<metric>.py`."""
    return named.module("metrics", metric).read


@dataclass
class Cell:
    name: str
    wl: dict          # workloads/<name>.json
    cfg: dict         # configs/<config>.json
    entry: dict       # the cell's entry in BENCHMARK.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(name: str, bench: Dict = None) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`) with its end-to-end
    metrics and the per-layer metrics it reports."""
    bench = bench or manifest()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    entry = entries[0]
    wl, cfg = workload(name), config(entry["config"])
    if wl["config"] != entry["config"] or wl["traffic"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in moved and _reports(m, name)]
    return Cell(name, wl, cfg, entry, e2e, layer)
