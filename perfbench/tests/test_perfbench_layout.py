"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic kind and per-layer metric found by name."""

import json
import os
import re

import pytest

import perfbench.reference as ref
from perfbench.harness import cell as cells

BENCH = cells.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYER_METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_manifest_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"]] + LAYER_METRICS)
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in CELLS:
        reported = [m for m in e2e.values() if c in m.get("workloads", [c])]
        assert len(reported) >= 2, c


@pytest.mark.parametrize("name", LAYER_METRICS)
def test_per_layer_metric_has_reader(name):
    m = [m for m in BENCH["per_layer"] if m["name"] == name][0]
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]][0]
    for c in m["workloads"]:
        assert c in moved.get("workloads", CELLS), (name, c)
    assert callable(cells.reader(name))


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    c = cells.load(name)
    assert c.entry["chips"] in (1, 4) and len(c.entry["why"]) <= 200
    assert c.entry["why"] == c.wl["why"]
    assert os.path.exists(os.path.join(cells.BENCH, "configs", f"{c.entry['config']}.json"))
    traffic = cells.traffic(c.wl["kind"])
    assert hasattr(traffic, "Driver") and hasattr(traffic, "FAULTS")
    assert c.wl["limits"] and all(v > 0 for v in c.wl["limits"].values())
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    cfg = cells.config(entry["name"])
    assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
    assert entry["source"] == cfg["source"] and len(entry["source"]) <= 200
    assert entry["reduced"] == cfg["reduced"] and len(entry["reduced"]) <= 16


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_reference_parts_found_by_name(entry):
    """The network, family, map and gain the configuration names each have
    a reference file, and the network's file counts its operations."""
    cfg = cells.config(entry["name"])
    fam = ref.family(cfg)
    n_feat, n_outp = fam.n_feat(cfg), fam.n_outp(cfg)
    net = ref.net(cfg)
    assert net.flops_per_frame(cfg, n_feat, n_outp) > 0
    assert net.train_flops_per_frame(cfg, n_feat, n_outp) > net.flops_per_frame(cfg, n_feat, n_outp)
    assert callable(ref.map_(cfg).inverse) and callable(ref.gain(cfg))


def test_missing_part_is_refused():
    with pytest.raises(LookupError, match="perfbench/reference/networks/NoSuchNet.py"):
        ref.net({"network_type": "NoSuchNet"})
