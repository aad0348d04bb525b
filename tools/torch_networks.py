"""The remaining networks on the card at their presets' full widths
(chip_smoke.py phase 3l): rdlnet-1.0n (18 blocks, length 7, m_1 32),
reslstm-1.0c (d_model 512, 5 blocks), ResBiLSTM at reslstm-1.0c's widths,
MHANet V1 at mhanet-1.1c's widths (d_model 256, 5 blocks, 8 heads) and
mhanet-1.1c with the "block" attention, on seeded flax-like weights and the
resnet-1.1c artifact's MagXi statistics.

`networks_phase(device, fail)` writes a synthetic corpus (24 clean 4 s
utterances, 6 noise files of 8 s) and a test set (the resnet artifact's
4 s noisy utterance and the same tiled 5x), and for each model (TF32 off, as
the package sets it when imported):

  * `DeepXiTorch.train` takes three steps at B = 8 x 4.096 s (the plain
    network under autograd: no TCN or spectral kernel may launch; the LSTMs'
    recurrence runs its forward and backward kernels, which must each launch
    once a direction a block a step): finite losses; the first step's
    gradients on 2 utterances x 32 frames of its
    batch, the output layer scaled out of the sigmoid's saturation (as
    phase 3k does), against float64 autograd on the card along the f32
    pass's ReLU sides (a tie takes the f32 side, as phase 3k gives it the
    kernel's), 2e-4 of each leaf's max abs;
  * the trained network's output on the 4 s utterance's network input (as
    infer pads it) against the same network in float64 on the card, 1e-4
    of its scale on the valid frames; for the "block" attention also
    against "full" on the same input and against "stream" (the B9 kernel)
    on the utterance tiled 9x (36 s, T = 2272), 1e-4 of the scale;
  * `infer` writes `y` (batched), `xi_hat` and `d_hat` (per utterance) for
    the test set, and the same `infer` with no spectral kernel writes the
    references (`estimator(kernels=False)`, `gain_synthesiser(g,
    kernels=False)`; the batched `y` takes no spectral kernel, so both
    sides are one computation and the network checks are its test):
    xi_hat within 1e-3 in the network's output units, `d_hat` within 1e-3
    of its scale and its wav one int16 step from it (phase 3k's gates);
    each call's launches of B1-B4 are counted (zeroed just before it): B2
    one an utterance on xi_hat, B3 one an utterance on d_hat, none on the
    batched `y`, never B1 or B4;
  * `make_enhancer` (the network's own forward; the LSTMs' recurrence on its
    kernel, `deepxi::masked_lstm`) at B = 1 x 4 s and B = 96 x 10 s, median
    wall ms of 5 calls (3 for the LSTMs) after a warm-up, beside the
    prediction written in PERF.md before the first run.

Returns {"launches": {kernel: {what: launches}}, "times": {what: ms}}.
Run alone on a machine with a card: python3 tools/torch_networks.py
"""

from __future__ import annotations

import copy
import functools
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
from torch.func import functional_call

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_families as fam  # noqa: E402
from deepxi_tpu_torch import enhance  # noqa: E402
from deepxi_tpu_torch.compat.artifact import FLAGSHIP_ROOT  # noqa: E402
from deepxi_tpu_torch.config import preset  # noqa: E402
from deepxi_tpu_torch.data.listing import batch_list  # noqa: E402
from deepxi_tpu_torch.data.loader import MiniBatchLoader  # noqa: E402
from deepxi_tpu_torch.data.wavio import read_wav, save_wav  # noqa: E402
from deepxi_tpu_torch.framework import DeepXiTorch, build_network  # noqa: E402
from deepxi_tpu_torch.models.attention import sequence_valid_mask  # noqa: E402
from deepxi_tpu_torch.ops.kernels import lstm, spectral  # noqa: E402
from deepxi_tpu_torch.ops.kernels.mha_flash_stream import flash_attention_streaming  # noqa: E402
from deepxi_tpu_torch.sig.mix import noise_offsets, normalise  # noqa: E402
from deepxi_tpu_torch.training import (TrainState, frame_mask, make_optimizer,  # noqa: E402
                                       make_train_step, masked_loss)

GRAD_TOL_REL = 2e-4   # chip_smoke.py's limit for gradients against float64
NET_TOL_REL = 1e-4    # the f32 network output against float64, of its scale
Z_MAX = 4.0           # the output layer's largest pre-activation in the gradient check
TRAIN_B = 8
# model: (preset, overrides)
MODELS = {
    "rdlnet-1.0n": ("rdlnet-1.0n", {}),
    "reslstm-1.0c": ("reslstm-1.0c", {}),
    "ResBiLSTM": ("reslstm-1.0c", dict(network_type="ResBiLSTM")),
    "MHANet V1": ("mhanet-1.1c", dict(network_type="MHANet")),
    "mhanet-1.1c block": ("mhanet-1.1c", dict(attention_impl="block")),
}
# make_enhancer wall ms (B=1 x 4 s, B=96 x 10 s) predicted in PERF.md before the
# first run on the card (NVIDIA H100 80GB HBM3); the LSTMs' anew before the
# first run of the persistent recurrence kernel (csrc/lstm.cu, one launch a
# direction a block)
PREDICTED_MS = {
    "rdlnet-1.0n": ((25.0, 50.0), (60.0, 120.0)),
    "reslstm-1.0c": ((4.0, 7.0), (60.0, 100.0)),
    "ResBiLSTM": ((8.0, 12.0), (120.0, 200.0)),
    "MHANet V1": ((2.5, 5.0), (30.0, 60.0)),
    "mhanet-1.1c block": ((2.5, 5.0), (30.0, 60.0)),
}


def _out_leaves(params):
    return [k for k in params if k.split(".")[0] in ("out_conv", "out_dense")]


class _ReluSides:
    """`torch.relu` recording the side of 0 each input takes (`record`), or
    applying the recorded sides in call order (`force`: the gradient
    follows them too), so that float64 autograd follows the f32 forward at
    a ReLU tie; counts the inputs whose side the forced pass would have
    taken otherwise, and the largest of them over its tensor's scale."""

    def __init__(self):
        self.sides, self.mode, self.i, self.flips, self.flip_rel = [], None, 0, 0, 0.0
        self._relu = torch.relu

    def __call__(self, x):
        if self.mode == "record":
            self.sides.append(x.detach() > 0)
            return self._relu(x)
        side = self.sides[self.i]
        self.i += 1
        flip = (x.detach() > 0) != side
        if flip.any():
            self.flips += int(flip.sum())
            self.flip_rel = max(self.flip_rel, (x.detach().abs()[flip].max()
                                                / x.detach().abs().max()).item())
        return x * side.to(x.dtype)

    def run(self, mode, fn):
        self.mode, self.i = mode, 0
        torch.relu = self
        try:
            return fn()
        finally:
            torch.relu = self._relu


def _crop_grads(dx, s_list, d_list, dev):
    """The masked loss's gradients on 2 utterances x 32 frames of the first
    batch from the seeded initial parameters, the output layer scaled so
    that no pre-activation exceeds Z_MAX (a saturated sigmoid meets Keras'
    clip of the prediction, where one f32 rounding switches a bin's
    gradient between ~1 and 0), in f32 and in float64 on the card, the
    float64 pass along the f32 pass's ReLU sides (a ReLU input within
    rounding of 0 takes either side in f32; as phase 3k gives ties the
    kernel's side). Returns (worst leaf's error over its max abs, the leaf,
    the output layer's scale, a line of readings: the unforced float64
    distance and the ReLU inputs whose side differs)."""
    cfg = dx.cfg
    params0 = dx.init_params()
    s, d, s_len, d_len, snr = next(MiniBatchLoader(
        s_list, d_list, TRAIN_B, cfg.snr_levels, seed=cfg.seed, N_s=cfg.N_s).epoch(0))
    offs = noise_offsets(torch.as_tensor(s_len), torch.as_tensor(d_len),
                         torch.Generator().manual_seed(cfg.seed + 1))
    with torch.no_grad():
        inp, tgt, nf = dx.inp_tgt.example(
            torch.as_tensor(s, device=dev), torch.as_tensor(d, device=dev),
            torch.as_tensor(s_len), torch.as_tensor(d_len), torch.as_tensor(snr),
            offsets=offs)
        inp, tgt = inp[:2, :32].contiguous(), tgt[:2, :32].contiguous()
        mask = frame_mask(inp.shape[1], nf, dev)[:2, :32]
        linear = copy.deepcopy(dx.network)
        linear.outp_act = "Linear"
        z = functional_call(linear, params0, (inp,))
        scale = min(1.0, Z_MAX / z.abs().max().item())
        for k in _out_leaves(params0):
            params0[k] = params0[k] * scale

    def grads(p0):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        dt = next(iter(p0.values())).dtype
        loss = masked_loss(functional_call(dx.network, p, (inp.to(dt),)), tgt.to(dt),
                           mask.to(dt), cfg.loss_fnc)
        return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    def worst(g, ref):
        return max(((g[k].double() - ref[k]).abs().max().item()
                    / max(ref[k].abs().max().item(), 1e-30), k) for k in ref)

    p64 = {k: v.double() for k, v in params0.items()}
    sides = _ReluSides()
    g32 = sides.run("record", lambda: grads(params0))
    g64_forced = sides.run("force", lambda: grads(p64))
    w = worst(g32, g64_forced)
    readings = (f"unforced float64 {worst(g32, grads(p64))[0]:.3e}; {sides.flips} ReLU "
                f"inputs on the other side of 0 in float64 than in f32, the largest "
                f"{sides.flip_rel:.2e} of its tensor's scale")
    return w[0], w[1], scale, readings


def _step_ms(dx, s_list, d_list, dev) -> float:
    """Wall ms of one more train step (synchronised) from the trained state
    on the run's first batch, the same step `DeepXiTorch.train` takes."""
    cfg = dx.cfg
    tx = make_optimizer(cfg.network_type, cfg.d_model or 256, cfg.warmup_steps)
    step = make_train_step(dx.network, dx.inp_tgt, tx, cfg.loss_fnc)
    state = TrainState.create(dx._state.params, tx)
    s, d, s_len, d_len, snr = next(MiniBatchLoader(
        s_list, d_list, TRAIN_B, cfg.snr_levels, seed=cfg.seed, N_s=cfg.N_s).epoch(0))
    batch = (torch.as_tensor(s, device=dev), torch.as_tensor(d, device=dev),
             torch.as_tensor(s_len), torch.as_tensor(d_len), torch.as_tensor(snr))
    fam._sync(dev)
    t0 = time.perf_counter()
    step(state, *batch, generator=torch.Generator().manual_seed(cfg.seed))
    fam._sync(dev)
    return (time.perf_counter() - t0) * 1e3


def _rel(a, b, valid):
    """max |a - b| over the valid frames, over max |b| there."""
    a, b = a.double()[valid], b.double()[valid]
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _network_checks(name, dx, params, noisy, dev, fail) -> str:
    """The trained network's f32 output against float64 on the card (and,
    for the "block" attention, against "full" and "stream")."""
    it = dx.inp_tgt

    def net_input(x):
        xp = torch.as_tensor(dx._padded(x, len(x)), device=dev)
        return spectral.stft_mag(normalise(xp), it.N_d, it.N_s, it.K)

    inp = net_input(noisy)
    valid = sequence_valid_mask(inp)
    net64 = copy.deepcopy(dx.network).double()
    with torch.no_grad():
        y = functional_call(dx.network, params, (inp,))
        y64 = functional_call(net64, {k: v.double() for k, v in params.items()},
                              (inp.double(),))
    err = _rel(y, y64, valid)
    msgs = [f"f32 against float64 {err:.3e} of the scale (T={inp.shape[1]})"]
    ok = err <= NET_TOL_REL
    if dx.cfg.attention_impl == "block":
        for impl, x in (("full", noisy), ("stream", np.tile(noisy, 9))):
            other = build_network(dx.cfg.replace(attention_impl=impl), it.n_feat,
                                  it.n_outp).to(dev).eval()
            m = inp if impl == "full" else net_input(x)
            v = sequence_valid_mask(m)
            with torch.no_grad():
                n0 = flash_attention_streaming.launches
                e = _rel(functional_call(dx.network, params, (m,)),
                         functional_call(other, params, (m,)), v)
                launched = flash_attention_streaming.launches - n0
            msgs.append(f"against {impl!r} {e:.3e} (T={m.shape[1]}"
                        + (f", B9 {launched} launches" if impl == "stream" else "") + ")")
            ok = ok and e <= NET_TOL_REL and (impl == "full" or launched > 0)
    if not ok:
        fail(f"[3l] {name}: the network output disagrees ({'; '.join(msgs)})")
    return "; ".join(msgs)


def _hold_fail(fail):
    """phase 3k's gates, their messages naming this phase."""
    return lambda msg: fail(msg.replace("[3k]", "[3l]", 1))


def _model(name, dirs, test_dir, tmp, dev, fail, launches, times, card):
    ver, over = MODELS[name]
    paths = dict(model_path=os.path.join(tmp, "model"), log_path=os.path.join(tmp, "log"),
                 data_path=os.path.join(tmp, "data"), test_x_path=test_dir,
                 out_path=os.path.join(tmp, "out"))
    cfg = preset(ver, mbatch_size=TRAIN_B, max_epochs=1, val_flag=False, seed=5,
                 **paths, **over).replace(ver=name.replace(" ", "-"))
    os.makedirs(cfg.data_path, exist_ok=True)
    shutil.copy(os.path.join(FLAGSHIP_ROOT, "stats.npz"),
                os.path.join(cfg.data_path, f"{cfg.ver}_stats.npz"))
    s_list = batch_list(dirs[0], "clean", cfg.data_path)[:3 * TRAIN_B]
    d_list = batch_list(dirs[1], "noise", cfg.data_path)
    dx = DeepXiTorch(cfg, s_list, d_list, device=dev)
    n_params = sum(v.numel() for v in dx.network.state_dict().values())
    hold_fail = _hold_fail(fail)

    fam._zero()
    lstm.masked_lstm.launches = lstm.masked_lstm_backward.launches = 0
    t0 = time.perf_counter()
    losses = dx.train(verbose=False)
    fam._sync(dev)
    t_train = time.perf_counter() - t0
    n = fam._counts()
    n_lstm = (lstm.masked_lstm.launches, lstm.masked_lstm_backward.launches)
    is_lstm = "LSTM" in type(dx.network).__name__
    want_lstm = 3 * cfg.n_blocks * (2 if "Bi" in cfg.network_type else 1) if is_lstm else 0
    t_step = _step_ms(dx, s_list, d_list, dev)
    w, leaf, scale, readings = _crop_grads(dx, s_list, d_list, dev)
    print(f"[3l] {name} ({type(dx.network).__name__}, {n_params:,} parameters): 3 train steps "
          f"at B={TRAIN_B} x 4.096 s in {t_train:.2f} s, losses {losses}, kernel launches "
          f"{ {k: v for k, v in n.items() if v} } (the plain network under autograd: none), "
          f"LSTM forward/backward kernels {n_lstm} (want {want_lstm} backward, at least as "
          f"many forward); "
          f"first step's gradients on 2 x 32 frames (output layer x{scale:.4g}) against "
          f"float64 along the f32 ReLU sides: worst rel err {w:.3e} at {leaf} (tol "
          f"{GRAD_TOL_REL:.0e}); {readings}; {card}")
    if not (np.isfinite(losses).all() and w <= GRAD_TOL_REL and not any(n.values())
            and n_lstm[1] == want_lstm and n_lstm[0] >= want_lstm):
        fail(f"[3l] {name}: training (losses {losses}, gradients {w:.3e}, launches {n}, "
             f"LSTM {n_lstm})")
    times[f"{name} train step"] = t_step

    params = dx._state.params
    noisy = read_wav(os.path.join(test_dir, "c012_white_5dB.wav"))[0]
    print(f"[3l] {name} network output: {_network_checks(name, dx, params, noisy, dev, fail)}")

    plain = DeepXiTorch(cfg.replace(out_path=os.path.join(tmp, "out_plain")), device=dev)
    plain.estimator = functools.partial(plain.estimator, kernels=False)
    plain.gain_synthesiser = functools.partial(plain.gain_synthesiser, kernels=False)
    n_utt = len(os.listdir(test_dir))
    for out_type in ("y", "xi_hat", "d_hat"):
        kw = dict(params=params, out_type=out_type, epochs=[1], gains=["mmse-lsa"])
        batched = out_type == "y"
        ref = None if batched else plain.infer(**kw)
        fam._zero()
        t0 = time.perf_counter()
        got = dx.infer(**kw)
        fam._sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        n = fam._counts()
        label = f"{name} infer {out_type}"
        times[label] = wall
        for k in ("B1", "B2", "B3", "B4"):
            launches.setdefault(k, {})[label] = n[k]
        want = {"B1": 0, "B4": 0, "B2": n_utt if out_type == "xi_hat" else 0,
                "B3": n_utt if out_type == "d_hat" else 0}
        if any(n[k] != v for k, v in want.items()):
            fail(f"[3l] {label}: launches {n}, expected {want}")
        if batched:
            msg = ("the batched route (no spectral kernel: both sides one computation, "
                   "the network held above)")
        elif out_type == "d_hat":
            msg = fam._hold_wave(name, label, got, fam._float_outputs(dx, params, out_type,
                                                                      test_dir),
                                 fam._float_outputs(plain, params, out_type, test_dir),
                                 hold_fail)
        else:
            msg = "; ".join(fam._hold(name, dx.inp_tgt, out_type, g, r, None, hold_fail)
                            for g, r in zip(got, ref))
        print(f"[3l] {label}: {wall:.1f} ms for 4 s + 20 s ({card}); launches B2 {n['B2']} "
              f"B3 {n['B3']} ({n_utt} utterances), B1 {n['B1']} B4 {n['B4']}; against the "
              f"route with no spectral kernel: {msg}")

    art_noisy = noisy
    long = np.tile(art_noisy, -(-160000 // art_noisy.shape[0]))[:160000]
    batches = {"B=1 x 4 s": art_noisy[None],
               "B=96 x 10 s": np.stack([np.roll(long, 997 * i) for i in range(96)])}
    enh = enhance.make_enhancer(dx.inp_tgt, dx.network, "mmse-lsa", device=dev)
    reps = 3 if "LSTM" in type(dx.network).__name__ else 5
    for (label, x), predicted in zip(batches.items(), PREDICTED_MS[name]):
        with torch.no_grad():
            y = enh(params, x)
        fam._sync(dev)
        if not (torch.isfinite(y).all() and y.shape[0] == x.shape[0]):
            fail(f"[3l] {name} make_enhancer {label}: the waveform is not finite")
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            with torch.no_grad():
                enh(params, x)
            fam._sync(dev)
            ts.append((time.perf_counter() - t0) * 1e3)
        ts = np.sort(ts)
        times[f"{name} make_enhancer {label}"] = float(np.median(ts))
        print(f"[3l] {name} make_enhancer {label}: median {np.median(ts):.3f} ms of {reps} "
              f"(min {ts[0]:.3f}, max {ts[-1]:.3f}); predicted {predicted[0]:g}-{predicted[1]:g}"
              f" ms; {card}")
    print(f"[3l] {name} train step at B={TRAIN_B} x 4.096 s (after the 3 steps): "
          f"{t_step:.1f} ms; {card}")


def networks_phase(device, fail, card="") -> dict:
    dev = torch.device(device)
    launches, times = {}, {}
    tmp = tempfile.mkdtemp(prefix="deepxi_networks_")
    try:
        t0 = time.perf_counter()
        dirs = fam.write_corpus(os.path.join(tmp, "set"))
        art_noisy = read_wav(os.path.join(FLAGSHIP_ROOT, "c012_white_5dB.wav"))[0]
        test_dir = os.path.join(tmp, "test")
        save_wav(os.path.join(test_dir, "c012_white_5dB.wav"), art_noisy, 16000)
        save_wav(os.path.join(test_dir, "c012_white_5dB_x5.wav"), np.tile(art_noisy, 5), 16000)
        print(f"[3l] corpus of 24 x 4 s and test set ({time.perf_counter() - t0:.1f} s); {card}")
        for name in MODELS:
            t0 = time.perf_counter()
            _model(name, dirs, test_dir, os.path.join(tmp, name.replace(" ", "_")), dev, fail,
                   launches, times, card)
            print(f"[3l] {name}: {time.perf_counter() - t0:.1f} s; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "times": times}


if __name__ == "__main__":
    import subprocess
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    failures = []

    def _record(msg):
        print(f"FAIL: {msg}", flush=True)
        failures.append(msg)

    t = time.perf_counter()
    networks_phase("cuda", _record, card)
    print(f"networks phase: {time.perf_counter() - t:.1f} s, {len(failures)} failures; {card}")
    sys.exit(1 if failures else 0)
