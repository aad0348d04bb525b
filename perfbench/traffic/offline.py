"""Offline enhancement of recorded audio in batches: each call is the
port's `enhance.make_enhancer` (the inference fast path's network forward,
`framework.fast_apply_fn`) on a numpy int16 batch [rows, seconds * f_s],
its output copied back into a pinned host array of the caller's, one a
pool batch, reused from call to call, as a corpus enhancer that pays by the
card-hour keeps its output buffers. (A fresh pageable `.cpu()` tensor a
call puts the host's page faults and memcpy into every call: runs spread
by 10-12%, and by 4-14% with reused pageable arrays.) The input stays the
port's own: `make_enhancer` copies the caller's numpy int16 batch from
pageable memory. Calls go back to back
(a closed loop), cycling through a pool of batches made in set-up. Each
row is a seeded utterance plus a seeded noise segment at a seeded SNR.

Reports `enhance_audio_s_per_s`: the seconds of noisy audio enhanced and
back on the host in the window, over the window's seconds. The check
compares the last output of each pool batch in the window with the plain
reference's enhancement of the same rows."""

from __future__ import annotations

import time

import torch

from perfbench.harness import program
from perfbench.harness.phases import Phases
from perfbench.inputs import synth, weights
from perfbench.reference import dsp, network as reference_network

FAULTS = ("half", "altered")


def make_enhancer(*args, **kwargs):
    """The port's `enhance.make_enhancer` (a name of this module, so that a
    test can break the timed path underneath)."""
    from deepxi_tpu_torch.enhance import make_enhancer as port_make_enhancer
    return port_make_enhancer(*args, **kwargs)


def broken(fault: str) -> dict:
    """`half`: half of each batch's rows come back zero; `altered`: one
    sample of a call's output is changed."""
    def wrap(real):
        def make(*args, **kwargs):
            enhance = real(*args, **kwargs)

            def call(params, x):
                y = enhance(params, x)
                if fault == "half":
                    y[y.shape[0] // 2:] = 0.0
                else:
                    y[0, y.shape[1] // 2] += 0.05
                return y
            return call
        return make
    return {"make_enhancer": wrap}


def mixtures(draws, cfg: dict, p: dict, rows: int, n: int) -> torch.Tensor:
    """int16 [rows, n] on the device: utterances plus noise segments from a
    bank of recordings, at SNRs of the mix's range."""
    f_s = cfg["f_s"]
    n_noise = int(p["noise_seconds"] * f_s)
    kinds = [synth.NOISE_KINDS[i] for i in draws.rng.integers(0, 4, p["noise_signals"])]
    bank = synth.noise(draws, kinds, n_noise)
    s = synth.speech(draws, [n] * rows, n)
    pick = torch.as_tensor(draws.rng.integers(0, p["noise_signals"], rows), device=draws.device)
    offs = torch.as_tensor(draws.rng.integers(0, n_noise - n + 1, rows), device=draws.device)
    idx = offs[:, None] + torch.arange(n, device=draws.device)[None, :]
    d = torch.gather(bank[pick], 1, idx)
    lo, hi = p["snr_db"]
    snr = torch.as_tensor(draws.rng.integers(lo, hi + 1, rows), device=draws.device)
    return synth.mixture(s, d, snr)


class Driver:
    """Set-up in the constructor; then `window(seconds)`, `outputs()`,
    `reference(tf32)` and `compare(outputs, reference)`."""

    def __init__(self, cell, seed: int, device, tiny: bool = False):
        self.cfg = cfg = dict(cell.cfg, **(cell.cfg["tiny"] if tiny else {}))
        self.p = p = dict(cell.wl["params"], **(cell.wl["tiny"] if tiny else {}))
        self.device = device
        self.phases = ph = Phases(device)
        draws = synth.Draws(seed, device)
        self.rows, self.n = p["rows"], int(p["seconds"] * cfg["f_s"])
        with ph("inputs"):
            self.pool = [mixtures(draws, cfg, p, self.rows, self.n).cpu().numpy()
                         for _ in range(p["pool"])]
        with ph("weights"):
            self.params = weights.params(cfg, draws, tiny)
            self.stats = weights.stats(cfg, device)
        with ph("program"):
            pcfg = program.port_config(cfg)
            it = program.family(cfg, self.stats, device)
            net = program.network(pcfg, it, device)
            self.enhance = make_enhancer(it, net, cfg["gain"],
                                         apply_fn=program.fast_apply(pcfg), device=device)
        self.T = -(-self.n // cfg["N_s"])
        self.last = {}
        with ph("warm-up"):
            y = self.enhance(self.params, self.pool[0])   # every shape of the window
            self.host = [torch.empty(y.shape, pin_memory=device.type == "cuda")
                         for _ in self.pool]
            for out in self.host:
                out.copy_(y)
        self.work = {"calls": 0, "rows": self.rows, "T": self.T,
                     "valid_frames": self.rows * self.T}

    def window(self, seconds: float) -> dict:
        n, t0 = 0, time.perf_counter()
        while True:
            b = n % len(self.pool)
            self.last[b] = self.host[b].copy_(self.enhance(self.params, self.pool[b]))
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.work["calls"] = n
        audio = n * self.rows * self.n / self.cfg["f_s"]
        return {"attempted": n * self.rows, "failed": 0,
                "metrics": {"enhance_audio_s_per_s": audio / elapsed}}

    def outputs(self):
        return {b: y.to(self.device) for b, y in self.last.items()}

    def release(self):
        del self.enhance

    def reference(self, tf32: bool, batches) -> dict:
        net = reference_network(self.cfg, self.params, tf32)
        out = {}
        block = self.p["reference_rows"]
        with torch.no_grad():
            for b in batches:
                x = torch.as_tensor(self.pool[b], device=self.device)
                out[b] = torch.cat([dsp.enhance(net, x[r:r + block], self.cfg, self.stats)
                                    for r in range(0, self.rows, block)])
        return out

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        """wave_gap: the worst row's largest sample gap, over the largest
        magnitude of the reference's row."""
        worst = 0.0
        for b, r in ref.items():
            y = got[b]
            if y.shape != r.shape:
                return {"wave_gap": float("inf")}
            gap = (y - r).abs().amax(1) / r.abs().amax(1).clamp(min=1e-30)
            worst = max(worst, float(torch.nan_to_num(gap, nan=float("inf")).max()))
        return {"wave_gap": worst}
