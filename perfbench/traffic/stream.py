"""Real-time streaming: a batch of channels served hop by hop by the
port's exported streaming step (`serving.export_streaming` of a
`streaming.StreamingEnhancer`, loaded as a `serving.StreamingServer`, which
replays one CUDA graph a hop). Each hop hands the server an int16 chunk
[channels, N_s] from the host and takes the enhanced hop back to the host.

Hops are due at a fixed interval from the workload file, whether or not
the last one is done (an open loop): a hop's latency runs from when it was
due to when its output is on the host, so a late hop delays the next. The
channels are seeded mixtures, looped. Reports `hop_ms_p95`, the 95th
percentile of every hop's latency in the window.

The check compares the last hops of the window with the plain reference's
offline enhancement of each channel's audio up to them: from far enough
back that the causal network's receptive field is whole, so what the
server carried from hop to hop (delay lines, analysis and synthesis tails)
is judged as well as the hop itself."""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from perfbench.harness import program
from perfbench.harness.phases import Phases
from perfbench.inputs import synth, weights
import perfbench.reference as ref
from perfbench.reference import dsp
from perfbench.traffic.offline import mixtures

FAULTS = ("unchanged", "altered")


def streaming_server(sm, out_dir: str, batch: int):
    """The port's streaming bundle of `sm` for `batch` channels, exported
    to `out_dir` and loaded (a name of this module, so that a test can
    break the timed path underneath)."""
    from deepxi_tpu_torch.serving import StreamingServer, export_streaming
    export_streaming(sm, out_dir, batch=batch)
    return StreamingServer(out_dir)


class _Server:
    def __init__(self, server, fault):
        self.server, self.fault = server, fault

    def init_state(self):
        return self.server.init_state()

    def step(self, state, chunk):
        new, y = self.server.step(state, chunk)
        if self.fault == "unchanged":
            return tuple(torch.zeros_like(t) for t in state), y
        y = y.clone()
        y[0, 7] += 0.05
        return new, y


def broken(fault: str) -> dict:
    """`unchanged`: the server hands back a zeroed state each hop;
    `altered`: one sample of a hop is changed."""
    return {"streaming_server": lambda real: lambda *a, **k: _Server(real(*a, **k), fault)}


class Driver:
    def __init__(self, cell, seed: int, device, tiny: bool = False):
        from deepxi_tpu_torch.streaming import StreamingEnhancer

        self.cfg = cfg = dict(cell.cfg, **(cell.cfg["tiny"] if tiny else {}))
        self.p = p = dict(cell.wl["params"], **(cell.wl["tiny"] if tiny else {}))
        self.device = device
        self.phases = ph = Phases(device)
        draws = synth.Draws(seed, device)
        self.C, N_s = p["channels"], cfg["N_s"]
        n = int(p["seconds"] * cfg["f_s"]) // N_s * N_s
        with ph("inputs"):
            audio = mixtures(draws, cfg, p, self.C, n)
            # [hops, channels, N_s]: each hop's chunk contiguous on the host
            self.hops = np.ascontiguousarray(audio.cpu().numpy().reshape(self.C, -1, N_s)
                                             .transpose(1, 0, 2))
        with ph("weights"):
            self.params = weights.params(cfg, draws, tiny)
            self.stats = weights.stats(cfg, device)
        with ph("program"):
            pcfg = program.port_config(cfg)
            it = program.family(cfg, self.stats, device)
            net = program.network(pcfg, it, device)
            sm = StreamingEnhancer(it, net, self.params, cfg["gain"], device=device)
        with ph("export and load"):
            out_dir = os.path.join(tempfile.gettempdir(), "perfbench", cell.name)
            self.server = streaming_server(sm, out_dir, self.C)
        with ph("warm-up"):
            state = self.server.init_state()
            zeros = np.zeros_like(self.hops[0])
            for _ in range(p["warmup_hops"]):  # captures the graph; warms the copies
                state, y = self.server.step(state, zeros)
                y.cpu()
        self.work = {"hops": 0, "channels": self.C}

    def window(self, seconds: float) -> dict:
        """Hops from a fresh state of every channel (copied into the
        server's), due every `hop_interval_ms`."""
        interval = self.p["hop_interval_ms"] / 1e3
        keep = self.p["checked_hops"]
        state = self.server.init_state()
        lat, self.ring = [], {}
        k, t0 = 0, time.perf_counter()
        while True:
            due = t0 + k * interval
            # every hop due inside the window is served (back to back: until it ends)
            if (due if interval > 0 else time.perf_counter()) - t0 >= seconds:
                break
            while time.perf_counter() < due:
                pass
            state, y = self.server.step(state, self.hops[k % len(self.hops)])
            y = y.cpu()
            lat.append(time.perf_counter() - due)
            self.ring[k % keep] = (k, y)
            k += 1
        self.K, self.latencies = k, lat
        self.work = {"hops": k, "channels": self.C}
        return {"attempted": k, "failed": 0,
                "metrics": {"hop_ms_p95": float(np.percentile(lat, 95)) * 1e3}}

    def outputs(self) -> dict:
        return {k: y.to(self.device) for k, y in self.ring.values()}

    def release(self):
        del self.server

    def reference(self, tf32: bool, hops) -> dict:
        """The offline enhancement of each channel's chunks from hop k0 - 1
        to the last, k0 a receptive field and two hops before the first
        checked one (or 0, as for a network whose reference file states no
        receptive field), so every checked hop's output is exact."""
        N_s = self.cfg["N_s"]
        first = min(hops)
        field = getattr(ref.net(self.cfg), "receptive_field", None)
        k0 = max(0, first - field(self.cfg) - 2) if field else 0
        idx = [(k - 1) % len(self.hops) for k in range(k0, self.K + 1)]
        chunks = self.hops[idx]                         # [n, C, N_s]
        if k0 == 0:
            chunks[0] = 0                               # before the first hop: silence
        z = torch.as_tensor(np.ascontiguousarray(chunks.transpose(1, 0, 2)),
                            device=self.device).reshape(self.C, -1)
        net = ref.network(self.cfg, self.params, tf32)
        block = self.p["reference_rows"]
        with torch.no_grad():
            y = torch.cat([dsp.enhance(net, z[r:r + block], self.cfg, self.stats)
                           for r in range(0, self.C, block)])
        return {k: y[:, (k - k0) * N_s:(k - k0 + 1) * N_s] for k in hops}

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        """hop_gap: the worst channel's largest sample gap over the checked
        hops, over the largest magnitude of its reference output there."""
        if set(got) != set(ref):
            return {"hop_gap": float("inf")}
        keys = sorted(ref)
        y = torch.cat([got[k] for k in keys], 1)
        r = torch.cat([ref[k] for k in keys], 1)
        gap = (y - r).abs().amax(1) / r.abs().amax(1).clamp(min=1e-30)
        return {"hop_gap": float(torch.nan_to_num(gap, nan=float("inf")).max())}
