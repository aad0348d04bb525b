"""The masked LSTM recurrence (forward and backward kernels), the LSTM
bundles, the native wav decoder and the JAX-free artifact tool on one card
(chip_smoke.py phase 3o).

`lstm_phase(device, fail, card, native_build_s)`:

  * holds both kernels of csrc/lstm.cu, each one cooperative launch a call,
    against their plain versions at reslstm-1.0c's H = 512, B = 1 T = 250,
    B = 32 T = 1025, the train shape B = 8 T = 256 and the offline batch
    B = 96 T = 626 (checked, not timed), forward and reverse,
    with masked frames inside rows and a padded tail: the forward (`deepxi::
    masked_lstm` and the training forward's ys, gates and cell state) against
    `masked_lstm_train_plain`, the backward against
    `masked_lstm_backward_plain` on the same saved state, every batch row
    within 1e-4 of each output's scale, a second call of each bitwise (the
    products on FMAs at B = 1 and 8, on the tensor cores at B = 32 and 96;
    the forward's launches and those on the tensor cores counted against
    `kernel_plan`'s route); and times both beside their bounds (f32 and tensor-core), the plain
    versions and the library call
    (cuDNN `torch.nn.LSTM`, TF32 off, on the same xp with identity input
    weights, all frames valid, where the functions agree; checked within
    1e-4 first: its forward, and its backward for the gradient of xp and
    the recurrent weights against the Function's);
  * for reslstm-1.0c and ResBiLSTM at full width on seeded weights (the
    resnet artifact's statistics, TF32 off): three train steps at B = 8 x
    4.096 s on one batch through the kernels (the losses must fall; the
    forward and backward kernels' launches counted, zeroed just before,
    one each a direction a block a step), the first step's gradients on
    2 utterances x 32 frames against plain autograd through the plain loop
    (2e-4 of each leaf's scale), and the step's wall ms on the kernels and
    on the plain loop, in turns; the epoch written as a checkpoint, the
    bundle written by `python -m deepxi_tpu_torch --export 1` (`cli.main`:
    batch 32, the six buckets; one op call a direction a block in each
    program), 4 rows served at bucket 65,536 against the live enhancer
    (1e-6), the kernel's launches a server call counted (zeroed just before
    it); `infer`'s per-utterance network output (`DeepXiTorch.estimator`)
    and `make_enhancer` at B = 1 x 4 s on the kernel against the plain loop
    (`rnn.masked_lstm` swapped for `masked_lstm_plain`): outputs within 1e-4
    of the scale, wall ms in turns beside the predictions written in PERF.md
    before the first run;
  * the native decoder: its build seconds (measured by the caller before
    any wav was written), a corpus written and read back through it, and a
    loader epoch bitwise equal with ``DEEPXI_TORCH_NO_NATIVE=1``;
  * reslstm-1.0c trained three steps (B = 4 x 4.096 s, through both
    kernels: each must launch), `tools/torch_make_artifact.py` (its
    `main`), then `python3 -m deepxi_tpu_torch --enhance <artifact>` in a
    subprocess: rc 0, the wav within one int16 step of `infer`'s.

  * the input projection (`lstm_input_proj`, csrc/lstm_input_proj.cu)
    against the float64 product at B = 1 T = 250, B = 8 T = 256, B = 96 T =
    626 and 111 rows (no multiple of the tile): within 1e-6 of the scale, a
    second call bitwise and without W_x's split; each of the first three timed by CUDA events (no
    torch.profiler: its use before phase 4 has left that phase's traces
    short of device events) beside its bound (operations at 165 TFLOP/s or
    bytes of x, W_x and xp once), cuBLAS's `addmm` alone and `addmm` with
    the time-major copy it replaces (the plain version); reslstm-1.0c's infer
    call launches the projection 5 times, a second call with the same
    weights no split of W_x, its train steps neither;

Returns {"launches": {what: launches}, "rows": {kernel: the kernels-line
row's measured fields}, "times": {what: ms}}. Run alone on a machine with a
card: python3 tools/torch_lstm.py (records failures and goes on).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
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
import torch_make_artifact  # noqa: E402
from deepxi_tpu_torch import cli, native  # noqa: E402
from deepxi_tpu_torch.compat.artifact import FLAGSHIP_ROOT  # noqa: E402
from deepxi_tpu_torch.config import preset  # noqa: E402
from deepxi_tpu_torch.data.listing import batch_list  # noqa: E402
from deepxi_tpu_torch.data.loader import MiniBatchLoader  # noqa: E402
from deepxi_tpu_torch.data.wavio import read_wav, save_wav  # noqa: E402
from deepxi_tpu_torch.enhance import make_enhancer  # noqa: E402
from deepxi_tpu_torch.framework import DeepXiTorch  # noqa: E402
from deepxi_tpu_torch.models import rnn  # noqa: E402
from deepxi_tpu_torch.ops.kernels import lstm  # noqa: E402
from deepxi_tpu_torch.serving import load_server  # noqa: E402
from deepxi_tpu_torch.training import (TrainState, frame_mask, make_optimizer,  # noqa: E402
                                       make_train_step, masked_loss, save_checkpoint)

KERNEL_TOL_REL = 1e-4   # a kernel against its plain version, of each output's scale
PROJ_TOL_REL = 1e-6     # the projection against the float64 product, of its scale
LIB_TOL_REL = 1e-4      # cuDNN against the kernels on all-valid frames, before it is timed
LIVE_TOL = 1e-6         # a bundle against the live enhancer
NET_TOL_REL = 1e-4      # the network output on the kernel against the plain loop
GRAD_TOL_REL = 2e-4     # network gradients on the kernels against the plain loop's
H = 512                 # reslstm-1.0c's d_model
# (B, T): a 4 s utterance, the B = 32 long batch, and the train step's batch
KERNEL_SHAPES = ((1, 250), (32, 1025), (8, 256))
# checked against the plain versions only: the offline batch (24 rows a CTA,
# the forward's tensor-core route with all of them in one stage)
CHECK_SHAPES = KERNEL_SHAPES + ((96, 626),)
TRAIN_B, TRAIN_L = 8, 65536   # the preset's mini-batch of 4.096 s buckets
# H100 SXM: f32 outside the tensor cores, f32-accurate on them (three TF32
# products, 495 / 3 TFLOP/s), HBM3 (chip_smoke.py's constants)
PEAK_F32_FLOPS, PEAK_TC_FLOPS, PEAK_BYTES = 67e12, 165e12, 3.35e12
MODELS = {"reslstm-1.0c": ("reslstm-1.0c", {}),
          "ResBiLSTM": ("reslstm-1.0c", dict(network_type="ResBiLSTM"))}
SERVE_ROWS, SERVE_BUCKET = 4, 65536
# wall ms at B = 1 x 4 s predicted in PERF.md before the first run on the card
# (NVIDIA H100 80GB HBM3): make_enhancer on the kernel
PREDICTED_MS = {"reslstm-1.0c": (4.0, 7.0), "ResBiLSTM": (8.0, 12.0)}
# the train step at B = 8 x 4.096 s on the kernels, predicted likewise
PREDICTED_STEP_MS = {"reslstm-1.0c": (15.0, 60.0), "ResBiLSTM": (25.0, 90.0)}


def _inputs(B, T, seed, dev):
    """xp [T, B, 4H] (~N(0, 0.25)), w_h [H, 4H] (~N(0, 1/H)) and a mask with
    an all-zero frame inside every third row and the last row padded over
    its last fifth."""
    gen = torch.Generator().manual_seed(seed)
    xp = (torch.randn(T, B, 4 * H, generator=gen) * 0.5).to(dev)
    w_h = (torch.randn(H, 4 * H, generator=gen) * H ** -0.5).to(dev)
    mask = torch.ones(T, B, dtype=torch.bool)
    mask[T // 3, ::3] = False
    mask[T - T // 5:, B - 1] = False
    return xp, w_h, mask.to(dev)


def bound_ms(B, T, backward=False):
    """(ms, bound_by, tc_ms): 8 B H^2 FLOP a frame at the f32 peak, against
    each input read and each output written once: the forward's xp, mask, w_h
    and ys; the backward's dys, the saved gates and cell state, the mask, w_h
    and dxp. tc_ms: the same FLOPs at the 165 TFLOP/s of three TF32
    tensor-core products an f32 one (csrc/mma_tf32x3.cuh), or the bytes where
    they take longer."""
    flops = 8.0 * B * H * H * T
    floats = (T * B * (H + 4 * H + H + 4 * H) if backward else T * B * (4 * H + H)) + 4 * H * H
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, (4 * floats + T * B) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"),
            max(flops / PEAK_TC_FLOPS, t_bytes) * 1e3)


def _cuda_ms(fn, iters):
    """Mean ms of `iters` calls from CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rel(a, ref):
    """The worst batch row's max |a - ref| over ref's max abs ([T, B, ...])."""
    return ((a - ref).abs().amax(dim=(0, 2)).max() / ref.abs().max()).item()


def _cudnn(xp_or_x, w_ih, b_ih, w_h, dev):
    """torch.nn.LSTM (cuDNN) holding these weights: input weights w_ih [C,
    4H] and bias b_ih, recurrent w_h [H, 4H] and no recurrent bias."""
    m = torch.nn.LSTM(w_ih.shape[0], H).to(dev)
    with torch.no_grad():
        m.weight_ih_l0.copy_(w_ih.T)
        m.bias_ih_l0.copy_(b_ih)
        m.weight_hh_l0.copy_(w_h.T)
        m.bias_hh_l0.zero_()
    m.flatten_parameters()
    return m


def _check_kernels(B, T, dev, fail, card, errs):
    """Both kernels against their plain versions at (B, T), both
    directions; a second call of each bitwise; the forward's launches, and
    those on the tensor cores, counted against `kernel_plan`'s route."""
    xp, w_h, mask = _inputs(B, T, B + T, dev)
    dys = torch.randn(T, B, H, generator=torch.Generator().manual_seed(T)).to(dev)
    tc = lstm.kernel_plan(False, B, H)["tensor_cores"]
    for reverse in (False, True):
        lstm.masked_lstm.launches = lstm.masked_lstm.tensor_core_launches = 0
        with torch.no_grad():
            ys = lstm.masked_lstm(xp, w_h, mask, reverse)
            ys_t, gates, cs = lstm.masked_lstm_train(xp, w_h, mask, reverse)
            dxp = lstm.masked_lstm_backward(dys, gates, cs, w_h, mask, reverse)
            ref, g_ref, c_ref = lstm.masked_lstm_train_plain(xp, w_h, mask, reverse)
            dxp_ref = lstm.masked_lstm_backward_plain(dys, g_ref, c_ref, w_h, mask, reverse)
            again = lstm.masked_lstm(xp, w_h, mask, reverse)
            dxp_again = lstm.masked_lstm_backward(dys, gates, cs, w_h, mask, reverse)
        torch.cuda.synchronize()
        fwd = max(_rel(ys, ref), _rel(gates, g_ref), _rel(cs, c_ref))
        bwd = _rel(dxp, dxp_ref)
        errs["masked_lstm"].append(fwd)
        errs["masked_lstm_backward"].append(bwd)
        same = (torch.equal(ys, again) and torch.equal(ys, ys_t)
                and torch.equal(dxp, dxp_again))
        counts = (lstm.masked_lstm.launches, lstm.masked_lstm.tensor_core_launches)
        print(f"[3o] H={H} B={B} T={T} {'reverse' if reverse else 'forward'}: forward kernel "
              f"(ys, gates, c) worst batch row {fwd:.3e}, backward (dxp) {bwd:.3e} of the "
              f"scale (tol {KERNEL_TOL_REL:.0e}); a second call of each "
              f"{'bitwise' if same else 'DIFFERS'}; forward launches {counts[0]}, on the "
              f"tensor cores {counts[1]}; {card}")
        if fwd > KERNEL_TOL_REL or bwd > KERNEL_TOL_REL or not same:
            fail(f"[3o] the LSTM kernels disagree with their plain versions at B={B} T={T} "
                 f"reverse={reverse} (forward {fwd:.3e}, backward {bwd:.3e}, bitwise {same})")
        if counts != (3, 3 if tc else 0):
            fail(f"[3o] the forward's launches at B={B} T={T} are {counts} (all, tensor cores); "
                 f"kernel_plan's route is {'tensor cores' if tc else 'FMAs'}")


def proj_checks(dev, fail, card):
    """The input projection against the float64 product at the LSTM shapes
    (and 111 rows), then timed at KERNEL_SHAPES' first and third and the
    offline batch beside its bound, `addmm` alone and the plain version;
    the kernels-line row."""
    row, errs = {}, []
    for B, T in ((1, 250), (8, 256), (96, 626), (3, 37)):
        gen = torch.Generator().manual_seed(B + T)
        x = torch.randn(B, T, H, generator=gen)
        w_x = [torch.randn(H, H, generator=gen) * H ** -0.5 for _ in range(4)]
        b = torch.randn(4 * H, generator=gen)
        ref = lstm.lstm_input_proj_plain(x.double(), [w.double() for w in w_x], b.double())
        x, w_x, b = x.to(dev), [w.to(dev) for w in w_x], b.to(dev)
        with torch.no_grad():
            lstm.lstm_input_proj.launches = lstm.lstm_input_proj.split_launches = 0
            xp = lstm.lstm_input_proj(x, w_x, b)
            same = torch.equal(xp, lstm.lstm_input_proj(x, w_x, b))
            err = ((xp.double().cpu() - ref).abs().max() / ref.abs().max()).item()
            lib_err = ((lstm.lstm_input_proj_plain(x, w_x, b).double().cpu() - ref).abs().max()
                       / ref.abs().max()).item()
            errs.append(err)
            calls = (lstm.lstm_input_proj.launches, lstm.lstm_input_proj.split_launches)
            print(f"[3o] input projection B={B} T={T} C={H} 4H={4 * H}: {err:.3e} of the "
                  f"scale from float64 (tol {PROJ_TOL_REL:.0e}; cuBLAS f32 {lib_err:.3e}); a "
                  f"second call {'bitwise' if same else 'DIFFERS'}; two calls launch the "
                  f"product {calls[0]} times, W_x's split {calls[1]}; {card}")
            if err > PROJ_TOL_REL or not same or calls != (2, 1):
                fail(f"[3o] the input projection at B={B} T={T} ({err:.3e}, bitwise {same}, "
                     f"launches {calls})")
            if (B, T) == (3, 37):
                continue
            flops = 2.0 * B * T * H * 4 * H
            t_ops = flops / PEAK_TC_FLOPS
            t_bytes = 4.0 * (B * T * H + 4 * H * H + 4 * H + B * T * 4 * H) / PEAK_BYTES
            times = dict(
                ms=_cuda_ms(lambda: lstm.lstm_input_proj(x, w_x, b), 20),  # noqa: B023
                plain_ms=_cuda_ms(lambda: lstm.lstm_input_proj_plain(x, w_x, b), 20),  # noqa: B023
                library_ms=_cuda_ms(lambda: torch.addmm(  # noqa: B023
                    b, x.reshape(B * T, -1), torch.cat(w_x, 1)), 20),  # noqa: B023
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                shape={"B": B, "T": T, "C": H, "N": 4 * H})
        print(f"[3o] input projection B={B} T={T}: kernel {times['ms']:.4f} ms "
              f"({flops / times['ms'] / 1e9:.1f} TFLOP/s), addmm and the copy "
              f"{times['plain_ms']:.4f}, addmm alone {times['library_ms']:.4f}, bound "
              f"{times['bound_ms']:.4f} ({times['bound_by']} at 165 TFLOP/s or 3.35 TB/s, "
              f"{times['bound_ms'] / times['ms']:.1%}); {card}")
        row.update(times if (B, T) == (1, 250) else {f"at_b{B}_t{T}": times})
    row["max_abs_err"] = max(errs)
    return row


def _time_kernels(B, T, dev, fail, card):
    """Each kernel timed beside its bound, its plain version and cuDNN (the
    same function where all frames are valid, checked first)."""
    xp, w_h, mask = _inputs(B, T, B + T, dev)
    dys = torch.randn(T, B, H, generator=torch.Generator().manual_seed(T)).to(dev)
    ones = torch.ones_like(mask)
    lib = _cudnn(xp, torch.eye(4 * H, device=dev), torch.zeros(4 * H, device=dev), w_h, dev)
    xq = xp.clone().requires_grad_(True)
    y_lib = lib(xq)[0]
    wq = w_h.clone().requires_grad_(True)
    y_k = lstm.masked_lstm(xq, wq, ones)
    g_lib = torch.autograd.grad(y_lib, [xq, lib.weight_hh_l0], dys, retain_graph=True)
    g_k = torch.autograd.grad(y_k, [xq, wq], dys)
    lib_rel = max(_rel(y_lib, y_k), _rel(g_lib[0], g_k[0]),
                  ((g_lib[1].T - g_k[1]).abs().max() / g_k[1].abs().max()).item())
    if lib_rel > LIB_TOL_REL:
        fail(f"[3o] cuDNN's LSTM is not the kernels' function on valid frames ({lib_rel:.3e})")
    with torch.no_grad():
        _, gates, cs = lstm.masked_lstm_train(xp, w_h, mask)
        _, g_ref, c_ref = lstm.masked_lstm_train_plain(xp, w_h, mask, False)
        fwd = _cuda_ms(lambda: lstm.masked_lstm(xp, w_h, mask), 10)
        fwd_train = _cuda_ms(lambda: lstm.masked_lstm_train(xp, w_h, mask), 10)
        fwd_plain = _cuda_ms(lambda: lstm.masked_lstm_plain(xp, w_h, mask, False), 3)
        lib_fwd = _cuda_ms(lambda: lib(xp), 10)
        bwd = _cuda_ms(lambda: lstm.masked_lstm_backward(dys, gates, cs, w_h, mask), 10)
        bwd_plain = _cuda_ms(lambda: lstm.masked_lstm_backward_plain(
            dys, g_ref, c_ref, w_h, mask, False), 3)
    lib_bwd = _cuda_ms(lambda: torch.autograd.grad(y_lib, [xq, lib.weight_hh_l0], dys,
                                                   retain_graph=True), 10)
    fb, fby, ftc = bound_ms(B, T)
    bb, bby, btc = bound_ms(B, T, backward=True)
    print(f"[3o] H={H} B={B} T={T}: forward kernel {fwd:.4f} ms (1 launch; saving "
          f"{fwd_train:.4f}), plain {fwd_plain:.4f}, cuDNN nn.LSTM forward on xp {lib_fwd:.4f} "
          f"(identity input weights; within {lib_rel:.1e} rel), bound {fb:.4f} ({fby}, "
          f"{fb / fwd:.1%}) / TC {ftc:.4f} ({ftc / fwd:.1%}); backward kernel {bwd:.4f} ms "
          f"(1 launch), plain {bwd_plain:.4f}, cuDNN backward (dx and the weights' gradients) "
          f"{lib_bwd:.4f}, bound {bb:.4f} ({bby}, {bb / bwd:.1%}) / TC {btc:.4f} "
          f"({btc / bwd:.1%}); {card}")
    shape = {"B": B, "T": T, "H": H}
    return (dict(ms=fwd, saving_ms=fwd_train, plain_ms=fwd_plain, bound_ms=fb, bound_by=fby,
                 tc_bound_ms=ftc, library_ms=lib_fwd, shape=shape),
            dict(ms=bwd, plain_ms=bwd_plain, bound_ms=bb, bound_by=bby, tc_bound_ms=btc,
                 library_ms=lib_bwd, shape=shape))


def kernel_checks(dev, fail, card):
    """Both kernels against their plain versions at the main path's shapes
    (CHECK_SHAPES), then each of KERNEL_SHAPES timed beside its bound and
    cuDNN; the kernels-line rows (the first shape's times, the others under
    `at_b<B>_t<T>`)."""
    errs = {"masked_lstm": [], "masked_lstm_backward": []}
    rows = {name: {} for name in errs}
    for B, T in CHECK_SHAPES:
        _check_kernels(B, T, dev, fail, card, errs)
        if (B, T) not in KERNEL_SHAPES:
            continue
        for name, times in zip(rows, _time_kernels(B, T, dev, fail, card)):
            rows[name].update(times if (B, T) == KERNEL_SHAPES[0] else {f"at_b{B}_t{T}": times})
    for name, row in rows.items():
        row["max_abs_err"] = max(errs[name])
    rows["lstm_input_proj"] = proj_checks(dev, fail, card)
    return rows


def _host_ms(fn, dev, iters=3):
    """Median wall ms of `iters` synchronised calls after one warm-up."""
    fn()
    fam._sync(dev)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        fam._sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _setup(name, tmp, dev):
    """DeepXiTorch of `name` at full width on the resnet artifact's
    statistics, its seeded weights saved as epoch 1; (dx, params, cfg, argv
    overrides)."""
    ver, over = MODELS[name]
    paths = dict(model_path=os.path.join(tmp, "model"), data_path=os.path.join(tmp, "data"),
                 out_path=os.path.join(tmp, "out"), log_path=os.path.join(tmp, "log"))
    cfg = preset(ver, seed=5, **paths, **over)
    os.makedirs(cfg.data_path, exist_ok=True)
    shutil.copy(os.path.join(FLAGSHIP_ROOT, "stats.npz"),
                os.path.join(cfg.data_path, f"{cfg.ver}_stats.npz"))
    dx = DeepXiTorch(cfg, device=dev)
    params = dx.init_params()
    save_checkpoint(os.path.join(cfg.model_path, cfg.ver), 0,
                    TrainState.create(params, make_optimizer(cfg.network_type)))
    return dx, params, cfg, [a for k, v in over.items() for a in (f"--{k}", str(v))]


def _counted(fn):
    """fn()'s result and the forward and backward kernels' launches and the
    projection's calls in it, zeroed just before it."""
    lstm.masked_lstm.launches = lstm.masked_lstm_backward.launches = 0
    lstm.lstm_input_proj.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, (lstm.masked_lstm.launches, lstm.masked_lstm_backward.launches,
                 lstm.lstm_input_proj.launches)


@contextlib.contextmanager
def _plain_loop():
    """MaskedLSTM's ops swapped for the plain loop and the plain product."""
    rnn.masked_lstm, rnn.lstm_input_proj = lstm.masked_lstm_plain, lstm.lstm_input_proj_plain
    try:
        yield
    finally:
        rnn.masked_lstm, rnn.lstm_input_proj = lstm.masked_lstm, lstm.lstm_input_proj


def _train_batch(dev):
    """B = 8 synthetic utterances and noises of 4.096 s (int16 on the card),
    their lengths, SNRs and zero noise offsets."""
    from synth_corpus import synth_noise, synth_utterance
    rng = np.random.RandomState(23)
    s = np.stack([synth_utterance(rng, TRAIN_L / 16000) for _ in range(TRAIN_B)])
    d = np.stack([synth_noise(rng, ("white", "pink")[i % 2], TRAIN_L / 16000)
                  for i in range(TRAIN_B)])
    lens = torch.full((TRAIN_B,), TRAIN_L, dtype=torch.int64)
    lens[1] = TRAIN_L - 20000                 # a padded row
    snr = torch.tensor([-5.0, 0.0, 5.0, 10.0] * (TRAIN_B // 4))
    return (torch.as_tensor(s[:, :TRAIN_L], device=dev), torch.as_tensor(d[:, :TRAIN_L],
                                                                         device=dev),
            lens, lens, snr, torch.zeros(TRAIN_B, dtype=torch.int64))


def train_checks(name, dx, params, dev, fail, card, launches, times):
    """Three train steps on one batch through the kernels (losses falling,
    each kernel launched once a direction a block a step), the first step's
    crop gradients against the plain loop's, and the step's wall ms on the
    kernels and on the plain loop."""
    cfg = dx.cfg
    s, d, s_len, d_len, snr, offs = _train_batch(dev)
    tx = make_optimizer(cfg.network_type)
    step = make_train_step(dx.network, dx.inp_tgt, tx, cfg.loss_fnc)

    def three_steps():
        state, losses = TrainState.create(dict(params), tx), []
        for _ in range(3):
            state, m = step(state, s, d, s_len, d_len, snr, offsets=offs)
            losses.append(float(m["loss"]))
        return losses

    losses, (n_fwd, n_bwd, n_proj) = _counted(three_steps)
    n_dir = cfg.n_blocks * (2 if "Bi" in cfg.network_type else 1)
    state = TrainState.create(dict(params), tx)
    t_k = _host_ms(lambda: step(state, s, d, s_len, d_len, snr, offsets=offs), dev)  # noqa: B023
    with _plain_loop():
        t_p = _host_ms(lambda: step(state, s, d, s_len, d_len, snr, offsets=offs), dev, 1)  # noqa: B023,E501
    t_k2 = _host_ms(lambda: step(state, s, d, s_len, d_len, snr, offsets=offs), dev)  # noqa: B023

    with torch.no_grad():
        inp, tgt, nf = dx.inp_tgt.example(s, d, s_len, d_len, snr, offsets=offs)
        inp, tgt = inp[:2, :32].contiguous(), tgt[:2, :32].contiguous()
        mask = frame_mask(inp.shape[1], nf, dev)[:2, :32]

    def grads():
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = masked_loss(functional_call(dx.network, p, (inp,)), tgt, mask, cfg.loss_fnc)
        return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    g_k = grads()
    with _plain_loop():
        g_p = grads()
    err, leaf = max(((g_k[k] - g_p[k]).abs().max().item()
                     / max(g_p[k].abs().max().item(), 1e-30), k) for k in g_p)
    t_step = float(np.median([t_k, t_k2]))
    lo, hi = PREDICTED_STEP_MS[name]
    launches[f"{name} train, 3 steps B={TRAIN_B} x 4.096 s"] = n_fwd
    launches[f"{name} train, 3 steps B={TRAIN_B} x 4.096 s, backward"] = n_bwd
    launches[f"{name} train, 3 steps B={TRAIN_B} x 4.096 s, projection"] = n_proj
    if n_proj:
        fail(f"[3o] {name}: the train steps called the inference projection {n_proj} times")
    times.update({f"{name} train step B={TRAIN_B} x 4.096 s": t_step,
                  f"{name} train step B={TRAIN_B} x 4.096 s, plain loop": t_p})
    print(f"[3o] {name}: 3 train steps at B={TRAIN_B} x 4.096 s on one batch through the "
          f"kernels: losses {losses}; forward {n_fwd}, backward {n_bwd} launches (want "
          f"{3 * n_dir} each); the step {t_k:.1f} / {t_k2:.1f} ms (predicted {lo:g}-{hi:g}), "
          f"on the plain loop {t_p:.1f} ms; first step's gradients on 2 x 32 frames against "
          f"the plain loop's: worst {err:.3e} at {leaf} (tol {GRAD_TOL_REL:.0e}); {card}")
    if (not np.isfinite(losses).all() or not losses[2] < losses[0] or err > GRAD_TOL_REL
            or n_fwd != 3 * n_dir or n_bwd != 3 * n_dir):
        fail(f"[3o] {name} training through the kernels (losses {losses}, launches "
             f"{n_fwd}/{n_bwd}, gradients {err:.3e} at {leaf})")


def bundles_and_times(dev, fail, card, tmp, launches, times):
    """Each LSTM's bundle through --export 1 against the live enhancer, and
    its per-utterance network output and make_enhancer at B = 1 x 4 s on the
    kernel against the plain loop."""
    noisy = read_wav(os.path.join(FLAGSHIP_ROOT, "c012_white_5dB.wav"))[0]
    for name in MODELS:
        dx, params, cfg, over = _setup(name, os.path.join(tmp, name), dev)
        train_checks(name, dx, params, dev, fail, card, launches, times)
        out = os.path.join(tmp, name, "serving")
        t0 = time.perf_counter()
        rc = cli.main(["--ver", cfg.ver, "--export", "1", "--test_epoch", "1",
                       "--export_path", out, "--data_path", cfg.data_path,
                       "--model_path", cfg.model_path, *over])
        t_export = time.perf_counter() - t0
        if rc != 0:
            fail(f"[3o] {name}: --export 1 returned {rc}")
        manifest = json.load(open(os.path.join(out, "manifest.json")))
        ep = torch.export.load(os.path.join(out, f"enhancer_L{SERVE_BUCKET}.pt2"))
        n_ops = sum(str(n.target) == "deepxi.masked_lstm.default" for n in ep.graph.nodes)
        want_ops = cfg.n_blocks * (2 if "Bi" in cfg.network_type else 1)
        x = np.stack([np.roll(np.resize(noisy, SERVE_BUCKET - 1000), 3001 * i)
                      for i in range(SERVE_ROWS)])
        server = load_server(out)
        with torch.no_grad():
            y, (calls, _, proj) = _counted(lambda: server(x))  # noqa: B023
            xp = np.zeros((manifest["batch"], SERVE_BUCKET), np.int16)
            xp[:SERVE_ROWS, :x.shape[1]] = x
            y_live = dx.fast_enhancer("mmse-lsa")(params, xp).cpu().numpy()[:SERVE_ROWS,
                                                                           :y.shape[1]]
        err = np.abs(y - y_live).max()
        launches[f"{name} server call"] = calls
        launches[f"{name} server call, projection"] = proj
        print(f"[3o] {name}: --export 1 wrote {len(manifest['buckets'])} buckets at batch "
              f"{manifest['batch']} in {t_export:.1f} s, {n_ops} masked_lstm calls in the "
              f"L={SERVE_BUCKET} program (want {want_ops}); {SERVE_ROWS} rows served: "
              f"{calls} kernel launches; against the live enhancer {err:.3e} (tol "
              f"{LIVE_TOL:.0e}); {card}")
        if (n_ops != want_ops or calls != want_ops or proj != want_ops or err > LIVE_TOL
                or not np.isfinite(y).all() or np.abs(y).max() < 1e-4):
            fail(f"[3o] {name}: the bundle (ops {n_ops}, calls {calls}, error {err:.3e})")

        # per utterance, as infer runs it: the network output on the kernel
        # and on the plain loop; then make_enhancer
        x1 = dx._padded(noisy, len(noisy))
        est = dx.estimator()
        split0 = lstm.lstm_input_proj.split_launches
        (y_k, _), (calls, _, proj) = _counted(lambda: est(params, x1))  # noqa: B023
        split = lstm.lstm_input_proj.split_launches - split0
        again = _counted(lambda: est(params, x1))[1][2]  # noqa: B023
        split_again = lstm.lstm_input_proj.split_launches - split0 - split
        enh = make_enhancer(dx.inp_tgt, dx.network, "mmse-lsa", device=dev)
        t_est = _host_ms(lambda: est(params, x1), dev)  # noqa: B023
        t_enh = _host_ms(lambda: enh(params, noisy[None]), dev)  # noqa: B023
        with _plain_loop():
            y_p = est(params, x1)[0]
            t_est_p = _host_ms(lambda: est(params, x1), dev)  # noqa: B023
            t_enh_p = _host_ms(lambda: enh(params, noisy[None]), dev)  # noqa: B023
        rel = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
        launches[f"{name} infer xi_hat, B=1 x 4 s"] = calls
        launches[f"{name} infer xi_hat, B=1 x 4 s, projection"] = proj
        launches[f"{name} infer xi_hat, B=1 x 4 s, projection's split"] = split
        times.update({f"{name} estimator B=1 x 4 s": t_est,
                      f"{name} estimator B=1 x 4 s, plain loop": t_est_p,
                      f"{name} make_enhancer B=1 x 4 s": t_enh,
                      f"{name} make_enhancer B=1 x 4 s, plain loop": t_enh_p})
        lo, hi = PREDICTED_MS[name]
        print(f"[3o] {name} B=1 x 4 s (T={y_k.shape[1]}): infer's network output "
              f"(estimator) {t_est:.2f} ms on the kernel ({calls} launches), {t_est_p:.2f} ms "
              f"on the plain loop, within {rel:.2e} of its "
              f"scale (tol {NET_TOL_REL:.0e}); make_enhancer {t_enh:.2f} ms (predicted "
              f"{lo:g}-{hi:g}), plain loop {t_enh_p:.2f} ms; {card}")
        print(f"[3o] {name} B=1 x 4 s: the projection's launches {proj} (W_x's split {split}) "
              f"on the first call, {again} ({split_again}) on the second")
        if (rel > NET_TOL_REL or calls != want_ops or proj != want_ops
                or (again, split_again) != (want_ops, 0)):
            fail(f"[3o] {name}: the kernel's network output ({rel:.3e}, {calls} calls, "
                 f"{proj} projection launches, {split} splits; then {again}, {split_again})")
        del dx, server, est, enh


def native_checks(dev, fail, card, tmp, native_build_s, times):
    """A corpus written and read back through the native decoder, and a
    loader epoch with and without it."""
    from synth_corpus import synth_noise, synth_utterance
    rng = np.random.RandomState(17)
    root = os.path.join(tmp, "native")
    wavs = {os.path.join(root, "s", f"u{i:02d}.wav"): synth_utterance(rng, 2.0 + 0.25 * i)
            for i in range(16)}
    wavs.update({os.path.join(root, "d", f"n{j}.wav"): synth_noise(rng, "pink", 8.0)
                 for j in range(3)})
    t0 = time.perf_counter()
    for p, w in wavs.items():
        save_wav(p, w, 16000)
    t_write = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = {p: read_wav(p)[0] for p in wavs}
    t_read = (time.perf_counter() - t0) * 1e3
    bad = [p for p, w in wavs.items() if not np.array_equal(back[p], w)]
    s_list = batch_list(os.path.join(root, "s"), "clean", os.path.join(root, "data"))
    d_list = batch_list(os.path.join(root, "d"), "noise", os.path.join(root, "data"))

    def epoch():
        loader = MiniBatchLoader(s_list, d_list, 4, [-5, 0, 5], seed=2)
        t = time.perf_counter()
        out = list(loader.epoch(0))
        return out, (time.perf_counter() - t) * 1e3

    calls = []
    load_batch = native.load_batch
    native.load_batch = lambda *a, **k: calls.append(1) or load_batch(*a, **k)
    try:
        with_native, t_nat = epoch()
    finally:
        native.load_batch = load_batch
    os.environ["DEEPXI_TORCH_NO_NATIVE"] = "1"
    try:
        without, t_py = epoch()
    finally:
        del os.environ["DEEPXI_TORCH_NO_NATIVE"]
    same = len(with_native) == len(without) == 4 and all(
        np.array_equal(a, b) for x, y in zip(with_native, without) for a, b in zip(x, y))
    times.update({"native build s": native_build_s, "native epoch": t_nat,
                  "python epoch": t_py})
    print(f"[3o] native wav decoder: built in {native_build_s:.2f} s; {len(wavs)} wavs "
          f"written in {t_write:.1f} ms and read back in {t_read:.1f} ms ({len(bad)} differ); "
          f"a loader epoch of 4 batches x 4 rows: {len(calls)} load_batch calls, "
          f"{t_nat:.1f} ms native, {t_py:.1f} ms with DEEPXI_TORCH_NO_NATIVE=1, "
          f"{'bitwise equal' if same else 'DIFFERENT'}; {card}")
    if bad or not same or len(calls) != 8:
        fail(f"[3o] the native decoder ({len(bad)} wavs differ, epochs equal: {same}, "
             f"{len(calls)} load_batch calls)")


def artifact_flow(dev, fail, card, tmp, times):
    """reslstm-1.0c trained three steps -> tools/torch_make_artifact.py ->
    `python3 -m deepxi_tpu_torch --enhance`, against infer's wav."""
    from synth_corpus import synth_noise, synth_utterance
    work = os.path.join(tmp, "work")
    rng = np.random.RandomState(3)
    dirs = (os.path.join(work, "set", "train_clean_speech"),
            os.path.join(work, "set", "train_noise"))
    for i in range(12):
        save_wav(os.path.join(dirs[0], f"sp{i:02d}.wav"), synth_utterance(rng, 4.0), 16000)
    for kind in ("white", "pink"):
        save_wav(os.path.join(dirs[1], f"{kind}.wav"), synth_noise(rng, kind, 8.0), 16000)
    test_x = os.path.join(work, "set", "test_noisy_speech")
    for sub, name in (("test_clean_speech", "c012.wav"), ("test_noisy_speech",
                                                          "c012_white_5dB.wav")):
        os.makedirs(os.path.join(work, "set", sub), exist_ok=True)
        shutil.copy(os.path.join(FLAGSHIP_ROOT, name), os.path.join(work, "set", sub, name))
    cfg = preset("reslstm-1.0c", mbatch_size=4, max_epochs=1, val_flag=False, seed=5,
                 model_path=os.path.join(work, "model"), data_path=os.path.join(work, "data"),
                 out_path=os.path.join(work, "out"), log_path=os.path.join(work, "log"),
                 test_x_path=test_x)
    os.makedirs(cfg.data_path, exist_ok=True)
    shutil.copy(os.path.join(FLAGSHIP_ROOT, "stats.npz"),
                os.path.join(cfg.data_path, f"{cfg.ver}_stats.npz"))
    s_list = batch_list(dirs[0], "clean", cfg.data_path)
    d_list = batch_list(dirs[1], "noise", cfg.data_path)
    dx = DeepXiTorch(cfg, s_list, d_list, device=dev)
    t0 = time.perf_counter()
    losses, (n_fwd, n_bwd, _) = _counted(lambda: dx.train(verbose=False))
    t_train = time.perf_counter() - t0
    print(f"[3o] reslstm-1.0c: 3 train steps at B=4 x 4.096 s in {t_train:.1f} s (forward "
          f"kernel {n_fwd}, backward kernel {n_bwd} launches), losses {losses}; {card}")
    if n_fwd < 15 or n_bwd != 15 or not np.isfinite(losses).all():
        fail(f"[3o] reslstm-1.0c training (losses {losses}, launches {n_fwd}/{n_bwd})")
    art = os.path.join(tmp, "artifact")
    t0 = time.perf_counter()
    rc = torch_make_artifact.main(["--work", work, "--ver", "reslstm-1.0c", "--epoch", "1",
                                   "--out", art])
    t_mk = time.perf_counter() - t0
    if rc != 0:
        fail(f"[3o] tools/torch_make_artifact.py returned {rc}")
    enh_dir = os.path.join(tmp, "enhanced")
    t0 = time.perf_counter()
    en = subprocess.run([sys.executable, "-m", "deepxi_tpu_torch", "--enhance", art,
                         "--in_wavs", os.path.join(test_x, "c012_white_5dB.wav"),
                         "--out_dir", enh_dir], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                        capture_output=True, text=True, timeout=600)
    t_en = time.perf_counter() - t0
    if en.returncode != 0:
        fail(f"[3o] --enhance of the reslstm-1.0c artifact failed: {en.stderr[-2000:]}")
    ref = read_wav(dx.infer(epochs=[1], gains=["mmse-lsa"], out_type="y")[0])[0]
    y = read_wav(os.path.join(enh_dir, "c012_white_5dB.wav"))[0]
    steps = int(np.abs(y.astype(np.int32) - ref[:len(y)]).max())
    times.update({"make_artifact s": t_mk, "--enhance s": t_en})
    print(f"[3o] tools/torch_make_artifact.py (its main, in this process): {t_mk:.1f} s, "
          f"{len(os.listdir(art))} files; python3 -m deepxi_tpu_torch --enhance <artifact>: rc "
          f"{en.returncode} in {t_en:.1f} s, {len(y)} samples, {steps} int16 steps from "
          f"infer's wav (tol 1); {card}")
    if len(y) != 64000 or steps > 1:
        fail("[3o] --enhance of the artifact is not infer's waveform")


def lstm_phase(device, fail, card="", native_build_s=0.0) -> dict:
    dev = torch.device(device)
    launches, times = {}, {}
    tmp = tempfile.mkdtemp(prefix="deepxi_lstm_")
    try:
        t0 = time.perf_counter()
        rows = kernel_checks(dev, fail, card)
        print(f"[3o] kernel checks and times: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bundles_and_times(dev, fail, card, tmp, launches, times)
        print(f"[3o] train steps, bundles and B=1 x 4 s times: "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        native_checks(dev, fail, card, tmp, native_build_s, times)
        artifact_flow(dev, fail, card, tmp, times)
        print(f"[3o] native decoder and artifact flow: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "rows": rows, "times": times}


if __name__ == "__main__":
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
    build_s = native.build()
    lstm_phase("cuda", _record, card, build_s)
    print(f"lstm phase: {time.perf_counter() - t:.1f} s, {len(failures)} failures; {card}")
    sys.exit(1 if failures else 0)
