"""Training on a corpus of uneven utterances: steps of the port's
`training.make_train_step` (example synthesis on the card, forward,
masked loss, backward, the clipped Adam update) on mini-batches of the
configuration's size, back to back (a closed loop).

The clean lengths follow the workload file's `mix`: each corpus's share of
the utterances (its count over the mix's total, rounded by largest
remainder), its lengths spread evenly over (1 - spread) to (1 + spread)
times its mean. The file's `groups` put them once into fixed batches, as a
shuffled loader would (so the work does not depend on the seed); each
batch is padded by the port's rule, frames up to a multiple of
`pad_frames` (the loader's `bucket_length`, copied below). The seed picks
the audio, the noise, the order of the batches, each step's SNRs and noise
offsets. Batches wait in host memory and are copied to the card each step,
as the loader's are.

Set-up builds one train state and drives it through one pass over the
batches: its first three steps are the first the check follows, the rest
warm up every batch's shape; the window goes on from that same state.
The check follows the window's last three steps too, from the state the
program held before them. Reports `train_audio_s_per_s`: the seconds of
clean audio (unpadded lengths) in the steps completed in the window, over
the window's seconds."""

from __future__ import annotations

import collections
import math
import statistics
import time

import torch

from perfbench.harness import program
from perfbench.harness.phases import Phases
from perfbench.inputs import synth, weights
from perfbench.reference import train as reference_train

CHECKED_STEPS = 3
TABLE_STEPS = 4096   # steps of SNRs and offsets drawn in set-up (cycled past it)
FAULTS = ("unchanged", "unchanged_later", "half", "altered")
STAGES = (("first", ""), ("late", "late_"))   # the checked stages, their numbers' prefix


def make_train_step(*args, **kwargs):
    """The port's `training.make_train_step` (a name of this module, so
    that a test can break the timed path underneath)."""
    from deepxi_tpu_torch.training import make_train_step as port_make_train_step
    return port_make_train_step(*args, **kwargs)


def broken(fault: str) -> dict:
    """`unchanged`: a step returns the state it was given; `unchanged_later`:
    so does every step after the first three; `half`: a step runs on half
    of its batch (the loss the mean over those rows); `altered`: the loss a
    step reports is changed."""
    def wrap(real):
        def make(*args, **kwargs):
            step = real(*args, **kwargs)
            calls = [0]

            def call(state, s, d, s_len, d_len, snr, offsets=None):
                calls[0] += 1
                if fault == "unchanged" or (fault == "unchanged_later"
                                            and calls[0] > CHECKED_STEPS):
                    return state, step(state, s, d, s_len, d_len, snr, offsets=offsets)[1]
                if fault == "half":
                    h = s.shape[0] // 2
                    return step(state, s[:h], d[:h], s_len[:h], d_len[:h], snr[:h],
                                offsets=offsets[:h])
                new, out = step(state, s, d, s_len, d_len, snr, offsets=offsets)
                if fault == "altered":
                    out = {"loss": out["loss"] * 1.001}
                return new, out
            return call
        return make
    return {"make_train_step": wrap}


def bucket_length(n: int, N_s: int, frames_per_bucket: int) -> int:
    """Pad length of `n` samples: the frame count rounded up to a multiple
    of `frames_per_bucket` (deepxi_tpu_torch/data/loader.bucket_length)."""
    frames = -(-n // N_s)
    return max(frames_per_bucket, -(-frames // frames_per_bucket) * frames_per_bucket) * N_s


def mix_lengths(mix: dict) -> list:
    """The mix's clean lengths in seconds, corpus by corpus."""
    corpora, n = mix["corpora"], mix["utterances"]
    total = sum(c["utterances"] for c in corpora)
    exact = [n * c["utterances"] / total for c in corpora]
    counts = [int(e) for e in exact]
    for i in sorted(range(len(exact)), key=lambda i: counts[i] - exact[i])[:n - sum(counts)]:
        counts[i] += 1
    s = mix["spread"]
    return [c["mean_s"] * (1.0 - s + 2.0 * s * (j + 0.5) / k)
            for c, k in zip(corpora, counts) for j in range(k)]


class Driver:
    def __init__(self, cell, seed: int, device, tiny: bool = False):
        from deepxi_tpu_torch.training import TrainState, make_optimizer

        self.cfg = cfg = dict(cell.cfg, **(cell.cfg["tiny"] if tiny else {}))
        self.p = p = dict(cell.wl["params"], **(cell.wl["tiny"] if tiny else {}))
        self.device = device
        self.phases = ph = Phases(device)
        draws = synth.Draws(seed, device)
        f_s, N_s = cfg["f_s"], cfg["N_s"]
        with ph("inputs"):
            lengths = [int(round(s * f_s)) for s in mix_lengths(p["mix"])]
            groups = p["groups"]
            n_noise = int(p["noise_seconds"] * f_s)
            pads = [bucket_length(max(lengths[i] for i in g), N_s, p["pad_frames"]) for g in groups]
            speech = synth.speech(draws, lengths, max(pads))
            kinds = [synth.NOISE_KINDS[i] for i in draws.rng.integers(0, 4, p["noise_signals"])]
            noise = synth.noise(draws, kinds, n_noise)
            self.batches = []
            for g, L in zip(groups, pads):
                pick = draws.rng.integers(0, p["noise_signals"], len(g))
                self.batches.append({
                    "s": speech[g, :L].cpu().numpy(), "d": noise[pick].cpu().numpy(),
                    "s_len": torch.tensor([lengths[i] for i in g], dtype=torch.int32),
                    "d_len": torch.full((len(g),), n_noise, dtype=torch.int32),
                    "audio_s": sum(lengths[i] for i in g) / f_s,
                    "frames": sum(-(-lengths[i] // N_s) for i in g),
                    "T": L // N_s})
            self.order = draws.rng.permutation(len(groups))
            lo, hi = cfg["min_snr"], cfg["max_snr"]
            rows = len(groups[0])
            self.snr = torch.as_tensor(draws.rng.integers(lo, hi + 1, (TABLE_STEPS, rows)),
                                       dtype=torch.float32)
            self.offsets = []
            for i in range(TABLE_STEPS):
                b = self.batches[self.order[i % len(groups)]]
                hi_off = (b["d_len"] - b["s_len"]).numpy()
                self.offsets.append(torch.as_tensor(draws.rng.integers(0, hi_off + 1)))

        with ph("weights"):
            self.params0 = weights.params(cfg, draws, tiny)
            self.stats = weights.stats(cfg, device)
        if not tiny and sum(v.numel() for v in self.params0.values()) != cfg["weights"]["n_params"]:
            raise ValueError("the seeded weights do not count the configuration's parameters")
        with ph("program"):
            pcfg = program.port_config(cfg)
            it = program.family(cfg, self.stats, device)
            net = program.network(pcfg, it, device)
            tx = make_optimizer(pcfg.network_type)
            self.b1 = tx.b1
            self.step_fn = make_train_step(net, it, tx, cfg["loss_fnc"])
            self.state = TrainState.create(self.params0, tx)
        self.step_no = 0
        # (step, state it was given, loss it reported) of the last steps
        self.recent = collections.deque(maxlen=CHECKED_STEPS)
        with ph("warm-up"):
            for _ in range(len(groups)):      # one pass: 3 checked steps, every shape
                self._step()
                if self.step_no == CHECKED_STEPS:
                    self.first = list(self.recent) + [(None, self.state, None)]
        self.work = {"steps": 0, "shapes": []}

    def _feed(self, i: int):
        b = self.batches[self.order[i % len(self.batches)]]
        return b, self.snr[i % TABLE_STEPS], self.offsets[i % TABLE_STEPS]

    def _step(self):
        b, snr, offs = self._feed(self.step_no)
        s = torch.as_tensor(b["s"]).to(self.device)
        d = torch.as_tensor(b["d"]).to(self.device)
        given = self.state
        self.state, out = self.step_fn(given, s, d, b["s_len"], b["d_len"], snr, offsets=offs)
        self.recent.append((self.step_no, given, out["loss"]))
        self.step_no += 1

    def window(self, seconds: float) -> dict:
        """Steps until `seconds` have passed, and at least the three the
        check follows."""
        n, audio, shapes, t0 = 0, 0.0, [], time.perf_counter()
        while True:
            b = self._feed(self.step_no)[0]
            self._step()
            n += 1
            audio += b["audio_s"]
            shapes.append((b["T"], len(b["s_len"]), b["frames"]))
            if n >= CHECKED_STEPS and time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        self.work = {"steps": n, "shapes": shapes}
        self.late = list(self.recent) + [(None, self.state, None)]
        return {"attempted": n, "failed": 0,
                "metrics": {"train_audio_s_per_s": audio / elapsed}}

    def _stage(self, steps) -> dict:
        """What the program made in three steps: their losses, the first
        one's gradient as the optimizer got it (the change of its first
        moment over 1 - b1) and each parameter's change after the three."""
        (_, s0, _), (_, s1, _), last = steps[0], steps[1], steps[-1][1]
        b1 = self.b1
        mu0, mu1 = s0.opt_state["mu"], s1.opt_state["mu"]
        return {"losses": [float(loss) for _, _, loss in steps[:-1]],
                "grad1": {k: (mu1[k].double() - b1 * mu0[k].double()) / (1.0 - b1) for k in mu1},
                "change3": {k: last.params[k] - s0.params[k] for k in s0.params}}

    def outputs(self) -> dict:
        """The first three steps' and the window's last three (and, for the
        reference, the step and the state each stage started from)."""
        i0, s0, _ = self.late[0]
        self.starts = {"first": (0, self.params0, None), "late": (i0, s0.params, s0.opt_state)}
        return {name: self._stage(getattr(self, name)) for name, _ in STAGES}

    def release(self):
        del self.step_fn, self.state, self.recent, self.first, self.late

    def reference(self, tf32: bool, stages) -> dict:
        """The reference's three steps from the state each stage started
        from: the seed's parameters and the optimizer's state before its
        first update for the first, the program's state before them for
        the window's last."""
        out = {}
        for name in stages:
            start, params, opt = self.starts[name]
            batches = []
            for i in range(start, start + CHECKED_STEPS):
                b, snr, offs = self._feed(i)
                batches.append({"s": torch.as_tensor(b["s"], device=self.device),
                                "d": torch.as_tensor(b["d"], device=self.device),
                                "s_len": b["s_len"].to(self.device),
                                "offsets": offs.to(self.device), "snr": snr.to(self.device)})
            losses, grad1, p3 = reference_train.steps(params, batches, self.cfg, self.stats,
                                                      tf32, opt)
            out[name] = {"losses": losses, "grad1": grad1,
                         "change3": {k: p3[k] - params[k] for k in p3}}
        return out

    def compare(self, got: dict, ref: dict) -> dict:
        """Of each stage: loss_gap, the worst step's |loss - reference| over
        the reference's; grad_gap and change_gap, the worst leaf's gap
        between the program's norm and the reference's, over the larger of
        that leaf's reference norm and the median leaf's. Leaves whose
        reference gradient is under a thousandth of the median leaf's are
        left out of both (their change is round-off under Adam). The
        window's stage's numbers begin with `late_`."""
        out = {}
        for name, prefix in STAGES:
            for k, v in _gaps(got[name], ref[name]).items():
                out[prefix + k] = v
        return out



def _finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")


def _gaps(got: dict, ref: dict) -> dict:
    norm = reference_train.norm
    loss_gap = max(_finite(abs(a - b) / abs(b)) for a, b in zip(got["losses"], ref["losses"]))
    g_ref = {k: norm(v) for k, v in ref["grad1"].items()}
    med = statistics.median(g_ref.values())
    keep = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    out = {"loss_gap": loss_gap}
    for name, gap in (("grad1", "grad_gap"), ("change3", "change_gap")):
        r = {k: norm(ref[name][k]) for k in keep}
        scale = statistics.median(r.values())
        out[gap] = max(_finite(abs(norm(got[name][k]) - r[k]) / max(r[k], scale)) for k in keep)
    return out
