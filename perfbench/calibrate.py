#!/usr/bin/env python3
"""Readings that set a cell's limits and its hop interval, on the card;
the benchmark's own runs never run this.

    python3 perfbench/calibrate.py check --workload <cell> --seeds a,b,.. [--control-seeds c,d,..] [--fault F] [--seconds 3]
    python3 perfbench/calibrate.py sweep --workload <cell> --intervals 0,3,4,5 [--seconds 5]

`check` builds the cell for each seed, runs a short window at the cell's
own load, and prints one JSON line a seed: the numbers the run compares
(the program's outputs against the float32 reference) and, for the control
seeds, the same numbers of the control (the reference with its products'
operands rounded to TF32, put in the program's place). The lower reading
of a limit is the largest program number over a dozen seeds or more, the
upper the smallest control number (run.py's `limits` lie between). With
`--fault`, the program runs with that fault planted (one of the traffic
driver's `FAULTS`, `harness/faults.py`).

`sweep` runs a streaming cell's window at each hop interval in ms (0: hops
back to back) and prints the hops' latency quantiles: the highest rate the
server sustains, from which the cell's fixed interval is chosen.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("check", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--intervals", default="0")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()

    import contextlib

    import torch
    from perfbench.harness import cell as cells
    from perfbench.harness.faults import planted
    from perfbench.run import env_caches, forbidden_modules

    env_caches()
    if not torch.cuda.is_available():
        sys.exit("calibrate needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    c = cells.load(args.workload)
    Driver = cells.traffic(c.wl["kind"]).Driver
    dev = torch.device("cuda")
    print(json.dumps({"card": torch.cuda.get_device_name(0), "cell": c.name}), flush=True)

    if args.what == "sweep":
        driver = Driver(c, 1, dev)
        for ms in (float(v) for v in args.intervals.split(",")):
            driver.p["hop_interval_ms"] = ms
            res = driver.window(args.seconds)
            lat = np.asarray(driver.latencies) * 1e3
            print(json.dumps({"interval_ms": ms, "hops": len(lat),
                              "hops_per_s": len(lat) / args.seconds,
                              "p50_ms": float(np.percentile(lat, 50)),
                              "p95_ms": res["metrics"]["hop_ms_p95"],
                              "max_ms": float(lat.max())}), flush=True)
        return

    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s] + sorted(controls)
    for seed in dict.fromkeys(seeds):
        t0 = time.perf_counter()
        with planted(c.wl["kind"], args.fault) if args.fault else contextlib.nullcontext():
            driver = Driver(c, seed, dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        res = driver.window(args.seconds)
        got = driver.outputs()
        driver.release()
        torch.cuda.empty_cache()
        ref = driver.reference(False, list(got))
        line = {"seed": seed, "fault": args.fault, "setup_s": setup, "metrics": res["metrics"],
                "program": driver.compare(got, ref)}
        if seed in controls:
            line["control"] = driver.compare(driver.reference(True, list(got)), ref)
        line["check_s"] = time.perf_counter() - t0 - setup - args.seconds
        print(json.dumps(line), flush=True)
        del driver, got, ref
        torch.cuda.empty_cache()
    if forbidden_modules():
        sys.exit(f"loaded {forbidden_modules()}")


if __name__ == "__main__":
    main()
