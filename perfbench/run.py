#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port `deepxi_tpu_torch`, one run of one
cell:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's program and inputs from the seed and warms up the
cell's shapes; the window measures for `--seconds` (with `--trace 1` under
torch.profiler, at most the cell's `trace_seconds`); then the outputs the
window produced are compared with the plain reference (`perfbench/reference`,
TF32 off). The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared beside its limit; the same numbers
are the last lines of standard error.

Without an NVIDIA card it rehearses the cell on the CPU at the
configuration's small widths (`tiny` in its files) through the port's plain
versions, prints the checks, and exits with 1 and no result: no number from
the CPU is reported under a metric's name.

Runs on one card; the kernels the port builds go to its own build
directory in the checkout, and the caches of PyTorch's extensions and
Triton to `perfbench/.cache/`. The streaming cell's bundle goes under
$TMPDIR.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "deepxi_tpu")
NO_CARD = 1
JAX_LOADED = 3


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's own name only begins with the latter's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(driver, tf32: bool = False):
    """The numbers compared: the program's outputs (or, with `tf32`, the
    reference's own in TF32, the precision control) against the reference's
    in float32."""
    got = driver.outputs()
    driver.release()
    import torch
    if driver.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference(False, list(got))
    if tf32:
        got = driver.reference(True, list(got))
    return driver.compare(got, ref)


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {value, limit}}): each number at or under its limit
    (a number compared with no limit in the workload file is refused)."""
    missing = set(numbers) ^ set(limits)
    if missing:
        raise KeyError(f"numbers and limits differ: {sorted(missing)}")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in checks.values())
    return ok, checks


def print_checks(checks: dict):
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()


def env_caches():
    """Fixed cache directories inside the checkout."""
    cache = os.path.join(BENCH, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    env_caches()
    sys.path.insert(0, ROOT)

    import torch
    from perfbench.harness import cell as cells

    c = cells.load(args.workload)
    chips = c.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return rehearse(args, chips)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 as the configuration states
    torch.backends.cudnn.allow_tf32 = False
    t_driver = time.perf_counter()
    driver = cells.traffic(c.wl["kind"]).Driver(c, args.seed, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    print(f"setup_s {setup_s:.3f}: imports {t_driver - T_START:.3f} s, "
          f"{driver.phases.line()}", file=sys.stderr)

    if args.trace:
        from perfbench.harness.trace import Traced
        with Traced() as traced:
            res = driver.window(min(args.seconds, c.wl["trace_seconds"]))
        summary = traced.summary
    else:
        res = driver.window(args.seconds)
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    work = dict(driver.work)
    ok, checks = verdict(judge(driver), c.wl["limits"])

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(peak)}
    out = {"correct": ok and res["failed"] == 0, "attempted": res["attempted"],
           "failed": res["failed"]}
    if args.trace:
        ctx = Context(c.cfg, c.wl, work, summary)
        metrics = {}
        for m in c.per_layer:
            value = cells.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
        out.update(metrics=metrics, device=device, breakdown=summary.breakdown())
    else:
        metrics = {m["name"]: {"value": rate(res["metrics"], m["name"]), "unit": m["unit"]}
                   for m in c.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        out.update(metrics=metrics, device=device)
    out["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark runs the port alone",
              file=sys.stderr)
        return JAX_LOADED
    print_checks(checks)
    print(json.dumps(out), flush=True)
    return 0


def rate(measured: dict, name: str) -> float:
    """The end-to-end metric `name` of a run: what the driver measured under
    that name, or, for `<metric>.<class>`, under `<metric>` (the same number,
    held to the bound of the cells of that class)."""
    return measured[name] if name in measured else measured[name.split(".")[0]]


class Context:
    """What a per-layer reader reads: the configuration, the workload file,
    the work of the traced window (`work`: calls, steps or hops, and their
    shapes) and the trace's `Summary`."""

    def __init__(self, cfg, wl, work, trace):
        self.cfg, self.wl, self.work, self.trace = cfg, wl, work, trace


def rehearsal(workload: str, seed: int, seconds: float):
    """(correct, checks) of the cell on the CPU at its small widths: set-up,
    a window of at most 2 s, the check."""
    import torch
    from perfbench.harness import cell as cells
    c = cells.load(workload)
    driver = cells.traffic(c.wl["kind"]).Driver(c, seed, torch.device("cpu"), tiny=True)
    driver.window(min(seconds, 2.0))
    return verdict(judge(driver), c.wl["limits"])


def rehearse(args, chips: int) -> int:
    """The rehearsal printed; exits with NO_CARD and no result."""
    import torch
    ok, checks = rehearsal(args.workload, args.seed, args.seconds)
    print(f"rehearsal on the CPU at small widths: correct {ok}", file=sys.stderr)
    print_checks(checks)
    print(f"no result: {args.workload} needs {chips} NVIDIA card(s), this machine has "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
          file=sys.stderr)
    return NO_CARD


if __name__ == "__main__":
    sys.exit(main())
