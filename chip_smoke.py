#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit, torch and CUDA versions, and
     the build of every CUDA kernel from `deepxi_tpu_torch/ops/kernels/csrc`
     (one nvcc per source, all started together);
  2. each kernel against its plain PyTorch version on the card at full width
     (d_model 256, d_f 64, k 3, seeded weights with nonzero biases): the two
     inference kernels, the training stack's saving forward, and its
     backward with saved block inputs and with a replayed forward;
  3. the enhancement path: the checked-in trained resnet-1.1c artifact
     enhances its 4 s noisy utterance (T=250, per-block kernel) and the same
     utterance tiled five times (T=1250, halo-tiled kernel); both kernels
     must launch, the outputs must agree with the port's plain path on the
     same card, and the enhanced SNR must beat the noisy SNR;
  3b. the training path: `DeepXiTorch.train()` at full width (resnet-1.1c,
     B=8, 2 epochs of 2 steps) on a synthetic corpus written to a temporary
     directory; both training kernels must launch, the losses must be
     finite, the first step's gradients must agree with autograd of the
     plain ResNetV2 (on a crop of the batch; on the whole batch, against
     float64 as closely as the plain path does), 30 steps on one batch must
     lower its loss, and a restored checkpoint must give the same next-step
     loss;
  4. times from CUDA events after warm-up: each kernel and its plain version
     at the main-path shapes (and the inference kernels at B=96, T=625), the
     end-to-end enhance, and one train step, fused against plain (median,
     min and max over 30 and 10 steps).
The last three lines are the card line, the kernels JSON and the result JSON.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Kernel vs plain: f32 FMA loops against f32 matmuls summing in another
# order, through up to 20 blocks with LayerNorm: 1e-4 of the output's scale.
KERNEL_TOL_REL = 1e-4
# Gradients of the training kernels against their plain versions, and of
# the fused stack against autograd of the plain network: 2e-4 of each
# leaf's max abs, the JAX package's limit for its fused backward; sums over
# B*T rows run in another order.
GRAD_TOL_REL = 2e-4
# The first training batch's gradients, whole: ReLU ties (below) move both
# f32 paths off float64 by up to ~1e-2 of a leaf's scale, so the fused path's
# worst leaf distance to float64 must be at most twice the plain path's plus
# the 2e-4 above; a tie cannot break that, a wrong gradient does.
TIE_FACTOR = 2.0
# A restored checkpoint's next-step loss against the live state's.
CKPT_TOL = 1e-6
# Network output (sigmoid) and waveform of the fused main path against the
# port's plain path on the same card.
NET_ATOL = 1e-3
WAVE_ATOL = 1e-3
WAVE_REL_RMS = 1e-3

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Matrix-product FLOPs of one bottleneck block per row: 1x1 256->64, k=3
# 64->64, 1x1 64->256. The forward, the backward's input gradients and its
# weight gradients each take this many; the backward's recompute takes only
# the first two products (the block's output is not rebuilt).
BLOCK_FLOPS_PER_ROW = 2 * (256 * 64 + 3 * 64 * 64 + 64 * 256)
RECOMPUTE_FLOPS_PER_ROW = 2 * (256 * 64 + 3 * 64 * 64)
BWD_FLOPS_PER_ROW = RECOMPUTE_FLOPS_PER_ROW + 2 * BLOCK_FLOPS_PER_ROW
# Floats of one block's weights (and of its weight gradients).
BLOCK_FLOATS = 256 * 64 + 64 + 3 * 64 * 64 + 64 + 64 * 256 + 256
# The training shapes: the preset's mini-batch of 4.096 s buckets, G = 10.
TRAIN_B, TRAIN_T, TRAIN_G = 8, 256, 10

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean ms per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_times(fn, iters=10, warmup=2):
    """ms of each of `iters` calls on the host clock, each synchronised."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(ts)


def host_ms(fn, iters=10, warmup=2):
    """Median ms per call on the host clock, each call synchronised."""
    return float(np.median(host_times(fn, iters, warmup)))


def bound_ms(B, T, G):
    """Least time for one group call: its product FLOPs at the f32 peak or
    its bytes (x read once, y written once, weights read once) at the HBM
    rate, whichever is larger."""
    flops = BLOCK_FLOPS_PER_ROW * B * T * G
    nbytes = 4 * (2 * B * T * 256 + G * BLOCK_FLOATS)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def train_bound_ms(B, T, G, flops_per_row, act_rows, grads):
    """Least time of a training kernel call: `flops_per_row` product FLOPs
    per row and block at the f32 peak, or its bytes (`act_rows` [B, T, 256]
    activation tensors read or written once, weights in and, with `grads`,
    their gradients out) at the HBM rate, whichever is larger."""
    flops = flops_per_row * B * T * G
    nbytes = 4 * (act_rows * B * T * 256 + (2 if grads else 1) * G * BLOCK_FLOATS)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def errs(pairs):
    """(max abs error, max error over each reference's max abs) of
    (value, reference) pairs."""
    ab = max((a - r).abs().max().item() for a, r in pairs)
    rel = max((a - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
              for a, r in pairs)
    return ab, rel


def write_corpus(root, seed=0):
    """16 clean 4 s utterances and 6 noise files of 8 s from the numpy-only
    generators of tools/synth_corpus.py, as 16-bit wavs."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from synth_corpus import NOISE_KINDS, synth_noise, synth_utterance

    from deepxi_tpu_torch.data.wavio import save_wav
    rng = np.random.RandomState(seed)
    dirs = (os.path.join(root, "train_clean_speech"), os.path.join(root, "train_noise"))
    for i in range(16):
        save_wav(os.path.join(dirs[0], f"sp{i:02d}.wav"), synth_utterance(rng, 4.0), 16000)
    for kind in NOISE_KINDS:
        save_wav(os.path.join(dirs[1], f"{kind}.wav"), synth_noise(rng, kind, 8.0), 16000)
    return dirs


def snr_db(clean, y):
    n = min(len(clean), len(y))
    s = clean[:n].astype(np.float64) / 32768.0
    e = s - y[:n].astype(np.float64)
    return 10.0 * np.log10(np.sum(s * s) / np.sum(e * e))


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    if not os.path.isdir(os.path.join(ROOT, "deepxi_tpu_torch")):
        fail("deepxi_tpu_torch/ is not beside this script: run it from the repository")

    from deepxi_tpu_torch.compat.artifact import load_flagship_artifact
    from deepxi_tpu_torch.enhance import make_enhancer
    from deepxi_tpu_torch.models.tcn import cyclic_dilation
    from deepxi_tpu_torch.config import preset
    from deepxi_tpu_torch.data.listing import batch_list
    from deepxi_tpu_torch.data.loader import MiniBatchLoader
    from deepxi_tpu_torch.framework import DeepXiTorch
    from deepxi_tpu_torch.ops.kernels import _build, tcn_fused, tcn_fused_train
    from deepxi_tpu_torch.sig.mix import noise_offsets
    from deepxi_tpu_torch.training import (TrainState, frame_mask,
                                           make_optimizer, make_train_step,
                                           masked_loss, restore_checkpoint)
    from torch.func import functional_call
    from deepxi_tpu_torch.ops.kernels.spectral import stft_mag
    from deepxi_tpu_torch.sig.mix import normalise

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)

    # 1. device and build -------------------------------------------------
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_s = _build.build(["tcn_fused", "tcn_fused_train"])
    print(f"[1] build: {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in build_s.items())})")
    for lib in build_s:
        with open(_build.log_path(lib)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"[1] ptxas {lib}: {line.strip()}")

    # 2. each kernel against its plain version at full width ----------------
    gen = torch.Generator().manual_seed(0)
    dil = [cyclic_dilation(i, 16) for i in range(40)]
    checks = {}
    cases = (
        ("fused_block_group_whole", tcn_fused.fused_block_group_whole,
         tcn_fused.fused_block_group_whole_ref, 20, 250, {}),
        ("fused_block_group", tcn_fused.fused_block_group,
         tcn_fused.fused_block_group_ref, tcn_fused.TILED_GROUP, 1250,
         {"tile_t": tcn_fused.TILED_TILE_T}),
    )
    for kname, kernel, ref, G, T, kw in cases:
        w = tcn_fused.random_block_weights(G, gen, dev)
        x = torch.relu(torch.randn(4, T, 256, generator=gen)).to(dev)
        y, y_ref = kernel(x, w, dil[:G], **kw), ref(x, w, dil[:G], **kw)
        torch.cuda.synchronize()
        err = (y - y_ref).abs().max().item()
        scale = y_ref.abs().max().item()
        print(f"[2] {kname}: B=4 T={T} G={G}: max abs err {err:.3e}, "
              f"max rel err {err / scale:.3e} (tol {KERNEL_TOL_REL:.0e} rel), "
              f"finite {bool(torch.isfinite(y).all())}")
        if not (err <= KERNEL_TOL_REL * scale and torch.isfinite(y).all()):
            fail(f"{kname} disagrees with its plain version")
        checks[kname] = err

    # the training kernels at the train step's shape, B=8, T=256, G=10
    # (dilations 1..16, 1, ...): the weight gradients' 12 row splits of 170
    # or 171 rows cross utterance boundaries and the 32-row chunks
    G = TRAIN_G
    w = tcn_fused.random_block_weights(G, gen, dev)
    x = torch.relu(torch.randn(TRAIN_B, TRAIN_T, 256, generator=gen)).to(dev)
    dout = torch.randn(TRAIN_B, TRAIN_T, 256, generator=gen).to(dev)
    out, hs = tcn_fused_train.fused_block_group_whole_saved(x, w, dil[:G])
    out_r, hs_r = tcn_fused_train.fused_block_group_whole_saved_ref(x, w, dil[:G])
    torch.cuda.synchronize()
    err, rel = errs([(out, out_r), (hs, hs_r)])
    print(f"[2] fused_block_group_whole_saved: B={TRAIN_B} T={TRAIN_T} G={G}: out and "
          f"hs {tuple(hs.shape)}: max abs err {err:.3e}, max rel err {rel:.3e} "
          f"(tol {KERNEL_TOL_REL:.0e} rel)")
    if not (rel <= KERNEL_TOL_REL and torch.isfinite(hs).all()):
        fail("fused_block_group_whole_saved disagrees with its plain version")
    checks["fused_block_group_whole_saved"] = err
    # The plain backward takes the kernel's own block inputs: fed the plain
    # forward's, which differ by rounding, a ReLU whose input lies within
    # rounding of 0 can take the other side and change the rows it reaches
    # by O(1) (measured 1.7e-2 here). Replay mode replays the kernel forward.
    # A tie inside a block (u1 or y within 1e-5 of 0) takes the kernel's side.
    checks["fused_block_group_bwd"] = 0.0
    modes = {}
    for mode, saved in (("saved", hs), ("replay", None)):
        dh, dw = tcn_fused_train.fused_block_group_bwd(x, dout, w, dil[:G],
                                                       saved_h=saved)
        torch.cuda.synchronize()
        modes[mode] = [dh] + [a for g in range(G) for a in dw[g]]
        (dh_r, dw_r), _, flips = tcn_fused_train.bwd_ref_up_to_ties(
            (dh, dw), x, dout, w, dil[:G], hs, GRAD_TOL_REL)
        pairs = [(dh, dh_r)] + [(a, r) for g in range(G) for a, r in zip(dw[g], dw_r[g])]
        err, rel = errs(pairs)
        print(f"[2] fused_block_group_bwd ({mode}): B={TRAIN_B} T={TRAIN_T} G={G}: dh and "
              f"{len(pairs) - 1} weight-gradient leaves: max abs err {err:.3e}, "
              f"worst leaf rel err {rel:.3e} (tol {GRAD_TOL_REL:.0e} of each leaf's "
              f"max abs); ReLU ties given the kernel's side: {flips}")
        if not (rel <= GRAD_TOL_REL and all(torch.isfinite(a).all() for a, _ in pairs)):
            fail(f"fused_block_group_bwd ({mode}) disagrees with its plain version")
        checks["fused_block_group_bwd"] = max(checks["fused_block_group_bwd"], err)
    same = all(torch.equal(a, b) for a, b in zip(modes["saved"], modes["replay"]))
    print(f"[2] fused_block_group_bwd: replay and saved modes bitwise equal: {same}")

    # 3. the enhancement path -----------------------------------------------
    art = load_flagship_artifact(device=dev)
    fused = lambda p, m: tcn_fused.resnetv2_apply_fused(p, m)  # noqa: E731
    enhance = make_enhancer(art.inp_tgt, art.net, "mmse-lsa", apply_fn=fused, device=dev)
    enhance_plain = make_enhancer(art.inp_tgt, art.net, "mmse-lsa", device=dev)
    utts = {"4 s, T=250": (art.noisy[None], art.clean),
            "20 s, T=1250": (np.tile(art.noisy, 5)[None], np.tile(art.clean, 5))}

    counted = {"fused_block_group_whole": tcn_fused.fused_block_group_whole,
               "fused_block_group": tcn_fused.fused_block_group,
               "fused_block_group_whole_saved":
                   tcn_fused_train.fused_block_group_whole_saved,
               "fused_block_group_bwd": tcn_fused_train.fused_block_group_bwd}
    for fn in counted.values():
        fn.launches = 0
    outs = {k: enhance(art.params, x) for k, (x, _) in utts.items()}
    torch.cuda.synchronize()
    launches = {k: counted[k].launches
                for k in ("fused_block_group_whole", "fused_block_group")}
    print(f"[3] launches on the main path: {launches}")
    for kname, n in launches.items():
        if n < 1:
            fail(f"{kname} was not launched on the main path")

    for k, (x, clean) in utts.items():
        y = outs[k]
        mag = stft_mag(normalise(torch.as_tensor(x, device=dev)), 512, 256, 512)
        with torch.no_grad():
            net_err = (fused(art.params, mag) - art.net(mag)).abs().max().item()
        y_plain = enhance_plain(art.params, x)
        w_err = (y - y_plain).abs().max().item()
        w_rel = ((y - y_plain).square().mean() / y_plain.square().mean()).sqrt().item()
        y_np = y[0].cpu().numpy()
        snr_noisy, snr_enh = snr_db(clean, x[0] / 32768.0), snr_db(clean, y_np)
        print(f"[3] {k}: out {tuple(y.shape)}, net max abs err {net_err:.3e} "
              f"(tol {NET_ATOL:.0e}), wave max abs err {w_err:.3e} (tol "
              f"{WAVE_ATOL:.0e}), rel RMS {w_rel:.3e} (tol {WAVE_REL_RMS:.0e}); "
              f"SNR noisy {snr_noisy:.3f} dB -> enhanced {snr_enh:.3f} dB")
        if not np.isfinite(y_np).all() or y.shape[-1] != (-(-x.shape[-1] // 256) + 1) * 256:
            fail(f"{k}: output not finite or of the wrong length")
        if net_err > NET_ATOL or w_err > WAVE_ATOL or w_rel > WAVE_REL_RMS:
            fail(f"{k}: fused path disagrees with the plain path")
        if snr_enh <= snr_noisy:
            fail(f"{k}: enhanced SNR does not beat noisy SNR")

    # 3b. the training path -------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="deepxi_chip_smoke_")
    try:
        t0 = time.perf_counter()
        clean_dir, noise_dir = write_corpus(tmp)
        cfg = preset("resnet-1.1c", mbatch_size=TRAIN_B, sample_size=16,
                     max_epochs=2, model_path=os.path.join(tmp, "model"),
                     set_path=tmp, log_path=os.path.join(tmp, "log"),
                     data_path=os.path.join(tmp, "data"))
        s_list = batch_list(clean_dir, "clean", cfg.data_path)
        d_list = batch_list(noise_dir, "noise", cfg.data_path)
        print(f"[3b] corpus: {len(s_list)} utterances of 4 s, {len(d_list)} noise "
              f"files ({time.perf_counter() - t0:.1f} s)")
        dx = DeepXiTorch(cfg, s_list, d_list, device=dev)
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        losses = dx.train(verbose=False)
        torch.cuda.synchronize()
        train_launches = {k: counted[k].launches for k in
                          ("fused_block_group_whole_saved", "fused_block_group_bwd")}
        launches.update(train_launches)
        print(f"[3b] DeepXiTorch.train(): {cfg.max_epochs} epochs of "
              f"{len(s_list) // TRAIN_B} steps, B={TRAIN_B}, full width "
              f"({sum(v.numel() for v in dx._state.params.values()):,} parameters) "
              f"in {time.perf_counter() - t0:.1f} s; epoch losses {losses}; "
              f"launches {train_launches}")
        for kname, n in train_launches.items():
            if n < 1:
                fail(f"{kname} was not launched on the training path")
        if not (len(losses) == cfg.max_epochs and np.isfinite(losses).all()):
            fail("training losses are not finite")

        # the first step's batch (the loader's and the offsets' seeds are the
        # run's), from the run's seeded initial parameters
        params0 = dx.init_params()
        s, d, s_len, d_len, snr = next(MiniBatchLoader(
            s_list, d_list, TRAIN_B, cfg.snr_levels, seed=cfg.seed,
            N_s=cfg.N_s).epoch(0))
        offs = noise_offsets(torch.as_tensor(s_len), torch.as_tensor(d_len),
                             torch.Generator().manual_seed(cfg.seed + 1))
        batch = (torch.as_tensor(s, device=dev), torch.as_tensor(d, device=dev),
                 torch.as_tensor(s_len), torch.as_tensor(d_len), torch.as_tensor(snr))
        with torch.no_grad():
            inp, tgt, nf = dx.inp_tgt.example(*batch, offsets=offs)
        mask = frame_mask(inp.shape[1], nf, dev)
        fused_apply = dx.apply_fn()
        plain_apply = lambda p, m: functional_call(dx.network, p, (m,))  # noqa: E731

        def loss_grads(apply, p0, rows=slice(None), frames=slice(None)):
            p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
            m = inp[rows, frames].to(next(iter(p0.values())).dtype)
            loss = masked_loss(apply(p, m), tgt[rows, frames].to(m.dtype),
                               mask[rows, frames], cfg.loss_fnc)
            return loss.item(), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

        def worst(g, ref):
            return max(((g[k].double() - ref[k].double()).abs().max().item()
                        / max(ref[k].abs().max().item(), 1e-30), k) for k in ref)

        # The whole batch holds ~30 M ReLU inputs: one or two lie within f32
        # rounding of 0, where the two f32 forwards can take opposite sides
        # and the gradients below that block move by ~1e-2 of their scale, as
        # plain autograd in f32 does against float64. So the whole batch is
        # held to float64 relative to the plain path's own distance, and the
        # 2e-4 limit on 2 utterances x 32 frames of the same batch.
        l_f, g_f = loss_grads(fused_apply, params0)
        l_p, g_p = loss_grads(plain_apply, params0)
        _, g_64 = loss_grads(plain_apply, {k: v.double() for k, v in params0.items()})
        w_f64, w_p64 = worst(g_f, g_64), worst(g_p, g_64)
        print(f"[3b] first step, whole batch, inp {tuple(inp.shape)}: loss fused "
              f"{l_f:.7f} plain {l_p:.7f}; worst leaf rel err fused/plain "
              f"{worst(g_f, g_p)[0]:.3e}, fused/float64 {w_f64[0]:.3e} at {w_f64[1]}, "
              f"plain/float64 {w_p64[0]:.3e} at {w_p64[1]} (tol fused/float64 <= "
              f"{TIE_FACTOR:g} x plain/float64 + {GRAD_TOL_REL:.0e})")
        if not w_f64[0] <= TIE_FACTOR * w_p64[0] + GRAD_TOL_REL:
            fail("fused gradients of the whole batch are further from float64 than "
                 "ReLU ties explain")
        crop = dict(rows=slice(0, 2), frames=slice(0, 32))
        _, g_f = loss_grads(fused_apply, params0, **crop)
        _, g_p = loss_grads(plain_apply, params0, **crop)
        w = worst(g_f, g_p)
        print(f"[3b] first step, 2 utterances x 32 frames of the batch: gradients of "
              f"{len(g_p)} leaves, worst rel err {w[0]:.3e} at {w[1]} (tol "
              f"{GRAD_TOL_REL:.0e} of each leaf's max abs)")
        if not w[0] <= GRAD_TOL_REL:
            fail("fused gradients disagree with autograd of the plain ResNetV2")

        tx = make_optimizer(cfg.network_type)
        step = make_train_step(dx.network, dx.inp_tgt, tx, cfg.loss_fnc,
                               apply_fn=fused_apply)
        step_plain = make_train_step(dx.network, dx.inp_tgt, tx, cfg.loss_fnc)
        st = TrainState.create(params0, tx)
        fit = []
        for _ in range(30):
            st, m = step(st, *batch, offsets=offs)
            fit.append(m["loss"])
        fit = torch.stack(fit).tolist()
        print(f"[3b] 30 steps on one batch: loss {fit[0]:.5f} -> {fit[-1]:.5f}")
        if not (np.isfinite(fit).all() and fit[-1] < fit[0]):
            fail("30 steps on one batch did not lower its loss")

        restored = restore_checkpoint(os.path.join(cfg.model_path, cfg.ver),
                                      cfg.max_epochs - 1, TrainState.create(params0, tx))
        l_live = step(dx._state, *batch, offsets=offs)[1]["loss"].item()
        l_back = step(restored, *batch, offsets=offs)[1]["loss"].item()
        print(f"[3b] checkpoint epoch-{cfg.max_epochs - 1}: next-step loss live "
              f"{l_live:.9f}, restored {l_back:.9f} (tol {CKPT_TOL:.0e})")
        if not (restored.step == dx._state.step and abs(l_live - l_back) <= CKPT_TOL):
            fail("a restored checkpoint does not continue the run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 4. times --------------------------------------------------------------
    print(f"[4] times on {card}")
    kernels = []
    shapes = {"fused_block_group_whole": [(1, 250), (96, 625)],
              "fused_block_group": [(1, 1250), (96, 625)]}
    G = tcn_fused.TILED_GROUP
    for kname, kernel, ref, _, _, kw in cases:
        w = tcn_fused.random_block_weights(G, gen, dev)
        row = {"name": kname, "route": "cuda",
               "source": "deepxi_tpu_torch/ops/kernels/csrc/tcn_fused.cu",
               "replaces": ("deepxi_tpu/ops/kernels/tcn_fused.py:57"
                            if kname.endswith("whole")
                            else "deepxi_tpu/ops/kernels/tcn_fused.py:289"),
               "launches": launches[kname], "max_abs_err": checks[kname]}
        for i, (B, T) in enumerate(shapes[kname]):
            x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(dev)
            ms = cuda_ms(lambda: kernel(x, w, dil[:G], **kw))
            plain = cuda_ms(lambda: ref(x, w, dil[:G], **kw))
            bound, by = bound_ms(B, T, G)
            print(f"[4] {kname}: one call of G={G} blocks at B={B} T={T}: "
                  f"{ms:.4f} ms; plain {plain:.4f} ms; bound {bound:.4f} ms "
                  f"({by}); {bound / ms:.1%} of the bound")
            keys = (dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                         library_ms=None, shape={"B": B, "T": T, "G": G})
                    if i == 0 else {"at_b96_t625": dict(ms=ms, plain_ms=plain,
                                                         bound_ms=bound)})
            row.update(keys)
        kernels.append(row)

    for B, n in ((1, art.noisy.shape[0]), (96, 160000)):
        x = np.tile(art.noisy, -(-n // art.noisy.shape[0]))[:n][None].repeat(B, 0)
        t_fused = host_ms(lambda: enhance(art.params, x))
        t_plain = host_ms(lambda: enhance_plain(art.params, x))
        audio_s = B * n / 16000.0
        print(f"[4] enhance B={B} x {n / 16000:.1f} s: fused {t_fused:.3f} ms "
              f"({audio_s / t_fused * 1e3:.1f} audio-s/s), plain {t_plain:.3f} ms "
              f"({audio_s / t_plain * 1e3:.1f} audio-s/s)")
    mag = torch.relu(torch.randn(96, 625, 257, generator=gen)).to(dev)
    t_stack = cuda_ms(lambda: fused(art.params, mag), iters=5)
    print(f"[4] resnetv2_apply_fused B=96 T=625 (40 blocks): {t_stack:.3f} ms "
          f"(bound {bound_ms(96, 625, 40)[0]:.3f} ms)")

    # the training kernels at the preset's train shape
    B, T, G = TRAIN_B, TRAIN_T, TRAIN_G
    w = tcn_fused.random_block_weights(G, gen, dev)
    x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(dev)
    dout = torch.randn(B, T, 256, generator=gen).to(dev)
    _, hs = tcn_fused_train.fused_block_group_whole_saved(x, w, dil[:G])
    timed = {
        "fused_block_group_whole_saved": (
            lambda: tcn_fused_train.fused_block_group_whole_saved(x, w, dil[:G]),
            lambda: tcn_fused_train.fused_block_group_whole_saved_ref(x, w, dil[:G]),
            train_bound_ms(B, T, G, BLOCK_FLOPS_PER_ROW, 2 + G, False)),
        "fused_block_group_bwd": (
            lambda: tcn_fused_train.fused_block_group_bwd(x, dout, w, dil[:G], saved_h=hs),
            lambda: tcn_fused_train.fused_block_group_bwd_ref(x, dout, w, dil[:G],
                                                             saved_h=hs),
            train_bound_ms(B, T, G, BWD_FLOPS_PER_ROW, 2 + G, True)),
        "replay": (
            lambda: tcn_fused_train.fused_block_group_bwd(x, dout, w, dil[:G]),
            lambda: tcn_fused_train.fused_block_group_bwd_ref(x, dout, w, dil[:G]),
            train_bound_ms(B, T, G, BLOCK_FLOPS_PER_ROW + BWD_FLOPS_PER_ROW, 3, True)),
    }
    times = {}
    for kname, (kernel, ref, (bound, by)) in timed.items():
        ms, plain = cuda_ms(kernel), cuda_ms(ref)
        times[kname] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)
        print(f"[4] {kname if kname != 'replay' else 'fused_block_group_bwd (replay)'}: "
              f"one call of G={G} blocks at B={B} T={T}: {ms:.4f} ms; plain "
              f"{plain:.4f} ms; bound {bound:.4f} ms ({by}); {bound / ms:.1%} of "
              f"the bound")
    for kname, src, line in (
            ("fused_block_group_whole_saved", "tcn_fused.cu", 81),
            ("fused_block_group_bwd", "tcn_fused_train.cu", 136)):
        row = {"name": kname, "route": "cuda",
               "source": f"deepxi_tpu_torch/ops/kernels/csrc/{src}",
               "replaces": f"deepxi_tpu/ops/kernels/tcn_fused_train.py:{line}",
               "launches": launches[kname], "max_abs_err": checks[kname],
               **times[kname], "library_ms": None, "shape": {"B": B, "T": T, "G": G}}
        if kname == "fused_block_group_bwd":
            row["replay"] = times["replay"]
        kernels.append(row)

    # one whole train step at B=8 x 4.096 s: fused stack against autograd of
    # the plain network, from the same state and batch
    st = TrainState.create(params0, tx)
    step_ms, spread, peak_mb = {}, {}, {}
    for arm, fn, n in (("fused", step, 30), ("plain", step_plain, 10)):
        torch.cuda.reset_peak_memory_stats()
        ts = host_times(lambda: fn(st, *batch, offsets=offs), iters=n)
        step_ms[arm] = float(np.median(ts))
        spread[arm] = f"{n} steps min {ts.min():.3f} max {ts.max():.3f}"
        peak_mb[arm] = torch.cuda.max_memory_allocated() / 2 ** 20
    audio_s = TRAIN_B * batch[0].shape[1] / 16000.0
    print(f"[4] train step B={TRAIN_B} x {batch[0].shape[1] / 16000:.3f} s (T={inp.shape[1]}): "
          + "; ".join(f"{arm} median {step_ms[arm]:.3f} ms ({spread[arm]}; "
                      f"{audio_s / step_ms[arm] * 1e3:.1f} audio-s/s, peak "
                      f"{peak_mb[arm]:.0f} MiB)" for arm in step_ms))

    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
