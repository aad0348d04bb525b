"""The hybrid and classical enhancement modes and the phoneme classifier on
the card at resnet-1.1c's full widths (d_model 256, 40 blocks, d_f 64, k 3;
chip_smoke.py phase 3m), with 98 phoneme classes, the MixMax Gaussians of
98 classes over 257 bins and VTS with K = 98, L = 2.

`hybrid_phase(device, fail, card)` writes a labelled synthetic corpus (8
clean 4 s utterances, their alignment and a 98-token lexicon in the fork's
formats), builds its Gaussians (tools/torch_build_gaussians.py, on the
card), and then:

  * `DeepXiTorch.train` takes three steps (3 epochs of one step) of the
    MagPhonemes classifier at B = 8 x 4.096 s through B5/B6 (both must
    launch; the losses finite, the last below the first); the first step's
    gradients on 2 utterances x 32 frames are held to float64 autograd of
    the plain ResNetV2 along B5's trajectory (tools/torch_families.py's
    check: 2e-4 of each leaf's scale), B5's block inputs to the plain
    network's (1e-3);
  * on the trained resnet-1.1c artifact's 4 s noisy utterance and the same
    tiled 5x (T = 256 and 1280), the kernels' network forward (B1, B4) is
    held to the plain network (1e-3), and `infer` writes `pho`, `y` with
    OM-LSA, `hybrid_mixmax` (the network's posteriors), `hybrid_omlsa`,
    `tracking_hist` and `tracking_vts`, each call's launches of B1-B6
    counted (zeroed just before it): `pho`, `y` and `hybrid_mixmax` must
    launch B1, B2 and B4, the classical modes none; `pho`'s posteriors are
    held to the plain route's (the plain network on the matmul |X|, 1e-3);
  * every mode's waveform on the card (the `infer` modes, and through
    `hybrid_infer` on the 4 s utterance OM-LSA with MCRA-2 and IMCRA, the
    histogram tracker's variants 0 and 2, MixMax with and without the
    posteriors and noise
    tracking, the network's posteriors normalised) is held to the same call
    on the CPU in float64 (the posteriors the card's), HYB_TOL of its scale
    (VTS VTS_TOL), and each written wav to the card's waveform (one int16
    step). `infer`'s hybrid_mixmax passes the classifier's sigmoid outputs
    as they are, as the JAX package does: where they sum past 1 in a frame
    its noise recursion is unstable (ROADMAP queue C), so it is held to the
    same call on the CPU in float32 (non-finite from the same hop or
    finite to the end; UNSTABLE_TOL of its scale where both are finite);
  * `python -m deepxi_tpu_torch --infer 1 --out_type tracking_hist` writes
    the wavs `infer` wrote;
  * the MCRA and IMCRA trackers, the histogram tracker and MixMax's noise
    tracking run under `torch.cuda.set_sync_debug_mode("error")`: no frame
    loop reads back from the card;
  * each mode is timed at B = 1 x 4 s (host clock, each call synchronised),
    and the `infer` routes' ATen operations counted, a call and a frame
    (48- against 64-frame slices; no torch.profiler, whose traces phase 4
    needs whole).

Returns {"launches": {kernel: {what: launches}}, "times": {what: ms}}.
Run alone on a machine with a card: python3 tools/torch_hybrid.py (records
failures and goes on).

Also the synthetic lexicon, alignment and corpus of that phase and of the
CPU tests (`write_lexicon`, `write_alignment`, `write_phoneme_corpus`).
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

# 21 un-toned initials and 15 finals, each final in tones 1-5: with the '|'
# separator and the closing '*', 98 tokens (MagPhonemes' default classes)
INITIALS = ("b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h", "j", "q", "x",
            "zh", "ch", "sh", "r", "z", "c", "s")
FINALS = ("a", "o", "e", "i", "u", "v", "ai", "ei", "ao", "ou", "an", "en", "ang",
          "eng", "ong")


def write_lexicon(path: str) -> None:
    """An `entry | tokens` lexicon of every initial and final (98 tokens)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for e in INITIALS + FINALS:
            f.write(f"{e} | {e}\n")


def write_alignment(path: str, utterances, seed: int = 0) -> None:
    """A forced alignment of `utterances` ((key, n_samples at 16 kHz), ...):
    segments of 40-200 ms of random initials and toned finals, now and then
    a "$0" segment and a "sil" one (not in the lexicon), and gaps."""
    rng = np.random.RandomState(seed)
    tokens = list(INITIALS) + [f + str(t) for f in FINALS for t in range(1, 6)]
    with open(path, "w") as f:
        for key, n in utterances:
            f.write(f"{key}\n")
            t, end = 0.0, n / 16000.0
            while t < end:
                dur = float(rng.uniform(0.04, 0.2))
                r = rng.rand()
                pho = "$0" if r < 0.05 else "sil" if r < 0.1 else tokens[rng.randint(len(tokens))]
                f.write(f"{t:.3f} {min(t + dur, end):.3f} {pho}\n")
                t += dur + (float(rng.uniform(0.0, 0.05)) if rng.rand() < 0.2 else 0.0)
            f.write(".\n")


def write_phoneme_corpus(root: str, n_clean: int = 4, n_samples: int = 8192,
                         test=(("t0_pink_5dB", 0.7), ("t1_white_0dB", 1.1)), seed: int = 0):
    """A labelled corpus under `root` from the numpy-only generators of
    tools/synth_corpus.py: `set/train_clean_speech` (`n_clean` utterances of
    `n_samples` samples each), `set/train_noise` (white and pink noise of
    3 n_samples), `test/` (noisy utterances of the given names and
    seconds), `lexicon.txt` and `train.ali` (`write_lexicon`,
    `write_alignment`)."""
    from synth_corpus import synth_noise, synth_utterance

    from deepxi_tpu_torch.data.wavio import save_wav
    rng = np.random.RandomState(seed)
    for i in range(n_clean):
        u = np.zeros(n_samples, np.int16)
        w = synth_utterance(rng, n_samples / 16000 + 0.01)[:n_samples]
        u[:len(w)] = w
        save_wav(os.path.join(root, "set", "train_clean_speech", f"u{i}.wav"), u, 16000)
    for j, kind in enumerate(("white", "pink")):
        save_wav(os.path.join(root, "set", "train_noise", f"n{j}.wav"),
                 synth_noise(rng, kind, 3 * n_samples / 16000), 16000)
    for name, sec in test:
        s = synth_utterance(rng, sec).astype(np.float32)
        x = s + 0.4 * synth_noise(rng, "pink", sec)[:len(s)]
        save_wav(os.path.join(root, "test", f"{name}.wav"),
                 np.clip(x, -32768, 32767).astype(np.int16), 16000)
    write_lexicon(os.path.join(root, "lexicon.txt"))
    write_alignment(os.path.join(root, "train.ali"),
                    [(f"u{i}", n_samples) for i in range(n_clean)], seed=seed + 1)


# A mode's waveform on the card against the same call on the CPU in float64, of its
# scale. VTS's batch EM takes each noise variance as E[x^2] - E[x]^2 of pseudo-noise
# log-magnitudes near -10, which cancels in float32 (card 7.2e-5, CPU float32 2.0e-5
# of its near-silent output's scale; the other modes up to 5.9e-6).
HYB_TOL, VTS_TOL = 1e-4, 5e-4
# `infer`'s hybrid_mixmax with the classifier's posteriors (an unstable noise
# recursion) against the same call on the CPU in float32, of its scale, on the
# samples finite on both (card 3.85e-7 and 4.45e-7 measured, T 256 and 1280)
UNSTABLE_TOL = 1e-5
NET_ATOL = 1e-3  # the network output against the plain network's
CLASSICAL = ("hybrid_omlsa", "tracking_hist", "tracking_vts")
# (label, hybrid_infer function, keywords, posteriors?) of the modes called directly
DIRECT = (("omlsa mcra2", "enhance_omlsa", dict(tracker="mcra2"), False),
          ("omlsa imcra", "enhance_omlsa", dict(tracker="imcra"), False),
          ("histogram variant 0", "enhance_tracking_histogram", dict(variant=0), False),
          ("histogram variant 2", "enhance_tracking_histogram", dict(variant=2), False),
          ("mixmax prior, tracking", "enhance_mixmax", dict(track_noise=True), False),
          ("mixmax prior, no tracking", "enhance_mixmax", dict(track_noise=False), False),
          ("mixmax posteriors, no tracking", "enhance_mixmax", dict(track_noise=False), True),
          ("mixmax normalised posteriors, tracking", "enhance_mixmax", dict(track_noise=True),
           "normalised"))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall_ms(fn, dev, iters=3):
    """Median ms of `iters` synchronised calls after one warm-up."""
    fn()
    _sync(dev)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _aten_ops(fn) -> int:
    """The ATen operations `fn()` dispatches (about one launch each on the
    card; a `deepxi::` kernel op counts one)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _cpu64(fn_name, kw, wav_i16, model, post):
    """The hybrid_infer function on the CPU in float64: the waveform
    normalised in float64, the model and posteriors cast."""
    import torch

    from deepxi_tpu_torch import hybrid_infer
    x = torch.as_tensor(wav_i16.astype(np.float64) / 32768.0)
    args = dict(kw)
    if model is not None:
        args["model"] = model.to("cpu", torch.float64)
    if post is not None:
        args["posteriors"] = post.to("cpu", torch.float64)
    return getattr(hybrid_infer, fn_name)(x, **args).numpy()


def _wav_vs_float(path, y, fail, label) -> int:
    """The written wav against the float waveform it was written from: one
    int16 step at most."""
    from deepxi_tpu_torch.data.wavio import read_wav
    w = read_wav(path)[0].astype(np.int64)
    q = np.asarray(y[:len(w)] * 32768.0, np.int16).astype(np.int64)
    steps = int(np.abs(w - q).max())
    if len(w) > len(y) or steps > 1:
        fail(f"[3m] {label}: the written wav is {steps} int16 steps from the card's waveform")
    return steps


def _unstable_mixmax(name, y, wav_i16, model, post, fail) -> str:
    """MixMax with noise tracking weighted by posteriors that sum past 1 in
    some frame (a classifier's sigmoid outputs, as the JAX package passes
    them): there the presence sum_i p_i rho_i can exceed 1 and the noise
    recursion g <- rho g + (1 - rho)(...) grows without bound (ROADMAP queue
    C), amplifying rounding, so no float64 value is its reference. The same
    call on the CPU in float32 must turn non-finite within two hops of the
    card (both finite to the end counts), and on the samples finite on both
    the card's waveform must be within UNSTABLE_TOL of its scale; the
    distance from float64 is printed."""
    import torch

    from deepxi_tpu_torch import hybrid_infer
    y32 = hybrid_infer.enhance_mixmax(
        torch.as_tensor(wav_i16), model.to("cpu"), posteriors=post.cpu()).numpy()
    y64 = _cpu64("enhance_mixmax", {}, wav_i16, model, post)

    def first_bad(v):
        bad = np.flatnonzero(~np.isfinite(v))
        return int(bad[0]) if len(bad) else len(v)

    a, b = first_bad(y), first_bad(y32)
    if abs(a - b) > 512:
        fail(f"[3m] hybrid_mixmax {name}: non-finite from sample {a} on the card, {b} on "
             "the CPU")
    n = min(a, b)
    if n == 0:
        fail(f"[3m] hybrid_mixmax {name}: no sample finite on both the card and the CPU")
        return f"{name}: no finite sample"
    d32, d64 = (float(np.abs(y[:n] - r[:n]).max() / np.abs(r[:n]).max()) for r in (y32, y64))
    if not d32 <= UNSTABLE_TOL:
        fail(f"[3m] hybrid_mixmax {name}: {d32:.3e} of the scale from the CPU's float32 on "
             f"its first {n} samples (tol {UNSTABLE_TOL:.0e})")
    sums = post.sum(-1)
    return (f"{name}: posteriors sum to {sums.min().item():.3g}-{sums.max().item():.3g} a "
            f"frame, so the noise recursion is unstable (ROADMAP queue C): finite to sample "
            f"{a} of {len(y)} on the card, {b} on the CPU in float32; before that "
            f"{d32:.3e} of the scale from the CPU's float32 (tol {UNSTABLE_TOL:.0e}), "
            f"{d64:.3e} from its float64 (not a reference)")


def hybrid_phase(device, fail, card="") -> dict:
    import torch
    from scipy.io import loadmat

    import torch_build_gaussians
    import torch_families
    from deepxi_tpu_torch import cli, hybrid_infer
    from deepxi_tpu_torch.compat.artifact import FLAGSHIP_ROOT
    from deepxi_tpu_torch.config import preset
    from deepxi_tpu_torch.data.listing import batch_list, batch_list_labelled
    from deepxi_tpu_torch.data.wavio import read_wav, save_wav
    from deepxi_tpu_torch.dsp import histnoise, mixmax, trackers
    from deepxi_tpu_torch.framework import DeepXiTorch

    dev = torch.device(device)
    kernels = torch_families.KERNELS
    launches, times = {}, {}
    tmp = tempfile.mkdtemp(prefix="deepxi_hybrid_")
    try:
        t0 = time.perf_counter()
        write_phoneme_corpus(tmp, n_clean=8, n_samples=64000, test=(), seed=7)
        test_dir = os.path.join(tmp, "test")
        noisy = read_wav(os.path.join(FLAGSHIP_ROOT, "c012_white_5dB.wav"))[0]
        utts = {"c012_white_5dB": noisy, "c012_white_5dB_x5": np.tile(noisy, 5)}
        for name, x in utts.items():
            save_wav(os.path.join(test_dir, name + ".wav"), x, 16000)
        g = os.path.join(tmp, "gaussians.npz")
        clean, noise = (os.path.join(tmp, "set", d) for d in ("train_clean_speech", "train_noise"))
        args = ["--clean", clean, "--ali", os.path.join(tmp, "train.ali"), "--lexicon",
                os.path.join(tmp, "lexicon.txt"), "--noise", noise, "--out", g]
        if torch_build_gaussians.main(args + ["--platform", dev.type]) != 0:
            fail("[3m] tools/torch_build_gaussians.py failed")
        z = np.load(g)
        print(f"[3m] corpus of 8 x 4 s with its alignment and 98-token lexicon, Gaussians "
              f"{z['means'].shape} ({time.perf_counter() - t0:.1f} s)")

        cfg = preset("resnet-1.1c", inp_tgt_type="MagPhonemes", Noutp=98, mbatch_size=8,
                     max_epochs=3, val_flag=False, seed=5, test_epoch=3,
                     ali_path=os.path.join(tmp, "train.ali"),
                     lexicon_path=os.path.join(tmp, "lexicon.txt"), mixmax_stats=g,
                     vts_stats=g, test_x_path=test_dir,
                     **{f"{k}_path": os.path.join(tmp, k) for k in ("data", "model", "log",
                                                                   "out")})
        cfg = cfg.replace(ver="resnet-1.1c-phonemes")
        s_list = batch_list_labelled(clean, cfg.ali_path, cfg.lexicon_path, "clean",
                                     cfg.data_path, frame_ms=cfg.T_s)
        d_list = batch_list(noise, "noise", cfg.data_path)
        dx = DeepXiTorch(cfg, s_list, d_list, device=dev)
        torch_families._zero()
        t0 = time.perf_counter()
        losses = dx.train(verbose=False)
        _sync(dev)
        t_train = time.perf_counter() - t0
        n = torch_families._counts()
        for k in ("B5", "B6"):
            launches.setdefault(k, {})["MagPhonemes train, 3 steps"] = n[k]
        print(f"[3m] MagPhonemes DeepXiTorch.train(): 3 epochs of one step at B=8 x 4.096 s "
              f"in {t_train:.2f} s; losses {', '.join(f'{v:.5f}' for v in losses)}; B5 "
              f"{n['B5']} B6 {n['B6']}")
        if not (n["B5"] and n["B6"]) or not np.isfinite(losses).all() \
                or not losses[-1] < losses[0]:
            fail(f"[3m] MagPhonemes training: B5 {n['B5']}, B6 {n['B6']}, losses {losses}")
        w, leaf, fwd, shape, readings = torch_families._crop_grads(dx, s_list[:8], d_list, dev)
        print(f"[3m] MagPhonemes first step's gradients on {shape} against float64 autograd "
              f"of the plain network along B5's trajectory: worst rel err {w:.3e} at {leaf} "
              f"(tol {torch_families.GRAD_TOL_REL:.0e}); B5's block inputs {fwd:.3e} of "
              f"their scale (tol {torch_families.FWD_TOL_REL:.0e}); {readings}")
        if not (w <= torch_families.GRAD_TOL_REL and fwd <= torch_families.FWD_TOL_REL):
            fail("[3m] MagPhonemes: the fused stack's gradients or B5's forward disagree with "
                 "the plain ResNetV2")
        times["MagPhonemes train step"] = t_train / 3 * 1e3

        params = dx._state.params
        print(f"[3m] the kernels' network output against the plain network's, max abs (tol "
              f"{NET_ATOL:.0e}): "
              f"{torch_families._network_check(dx, params, test_dir, fail, '[3m]')}")
        plain = DeepXiTorch(cfg.replace(out_path=os.path.join(tmp, "out_plain")), device=dev)
        plain.fast_apply = lambda: None
        plain.estimator = lambda kernels=True: DeepXiTorch.estimator(plain, kernels=False)

        # infer: each call's launches counted, zeroed just before it
        posts = {}
        for out_type in ("pho", "y", "hybrid_mixmax") + CLASSICAL:
            kw = dict(params=params, out_type=out_type, epochs=[1],
                      gains=["omlsa"] if out_type == "y" else None)
            torch_families._zero()
            t0 = time.perf_counter()
            got = dx.infer(**kw)
            _sync(dev)
            wall = (time.perf_counter() - t0) * 1e3
            n = torch_families._counts()
            label = f"infer {out_type}" + (" omlsa" if out_type == "y" else "")
            times[label] = wall
            for k in ("B1", "B2", "B3", "B4"):
                launches.setdefault(k, {})[label] = n[k]
            net = out_type not in CLASSICAL
            if (bool(n["B1"] and n["B2"] and n["B4"]) != net) or n["B3"] or \
                    (not net and any(n.values())):
                fail(f"[3m] {label}: launches {n}")
            msgs = []
            if out_type == "pho":
                ref = plain.infer(**kw)
                for path, path_r in zip(got, ref):
                    p, p_r = loadmat(path)["pho_post"], loadmat(path_r)["pho_post"]
                    err = float(np.abs(p - p_r).max())
                    if p.shape != p_r.shape or p.shape[1] != 98 or not err <= NET_ATOL:
                        fail(f"[3m] pho {os.path.basename(path)}: {p.shape}, {err:.3e} from "
                             "the plain route")
                    tokens = open(path[:-4] + ".csv").read().split()
                    if len(tokens) != p.shape[0]:
                        fail(f"[3m] pho: {len(tokens)} tokens for {p.shape[0]} frames")
                    msgs.append(f"{os.path.basename(path)} {p.shape} {err:.3e} from the plain "
                                "route")
            else:
                for path in got:
                    name = os.path.basename(path)[:-4]
                    x = utts[name]
                    wp = dx._padded(x, len(x))
                    if out_type == "y":
                        y = dx._utterance_y(params, x, len(x), "omlsa")
                        fn, kw64, post, model = "enhance_omlsa", {}, None, None
                    else:
                        with torch.no_grad():
                            y = dx.hybrid_enhancer(out_type, params)(wp).cpu().numpy()
                        fn, kw64, model = {
                            "hybrid_mixmax": ("enhance_mixmax", {}, dx._load_mixmax_model()),
                            "hybrid_omlsa": ("enhance_omlsa", {}, None),
                            "tracking_hist": ("enhance_tracking_histogram", {}, None),
                            "tracking_vts": ("enhance_vts", {}, dx._load_vts_model())}[out_type]
                        post = None
                        if out_type == "hybrid_mixmax":
                            post = posts[name] = dx.estimator()(params, wp)[0][0]
                    n_frames = dx.inp_tgt.n_frames(len(x))
                    x64 = wp[0] if out_type != "y" else wp[0, :n_frames * 256]
                    if post is not None and post.sum(-1).max().item() > 1.0:
                        msgs.append(_unstable_mixmax(name, y, x64, model, post, fail))
                        if np.isfinite(y).all():
                            steps = _wav_vs_float(path, y, fail, f"{label} {name}")
                            msgs.append(f"wav {steps} step")
                        continue
                    y64 = _cpu64(fn, kw64, x64, model, post)
                    err = float(np.abs(y[:len(y64)] - y64).max() / np.abs(y64).max())
                    steps = _wav_vs_float(path, y, fail, f"{label} {name}")
                    if y.shape[0] < len(x) or not err <= (
                            VTS_TOL if out_type == "tracking_vts" else HYB_TOL):
                        fail(f"[3m] {label} {name}: {err:.3e} of the scale from the CPU's "
                             "float64")
                    msgs.append(f"{name} {err:.3e} of the scale (peak {np.abs(y64).max():.3g}) "
                                f"from the CPU's float64, wav {steps} step")
            print(f"[3m] {label}: {wall:.1f} ms for 4 s + 20 s; launches B1 {n['B1']} B2 "
                  f"{n['B2']} B3 {n['B3']} B4 {n['B4']}; {'; '.join(msgs)}")

        # the other modes through hybrid_infer on the 4 s utterance, against the
        # CPU's float64
        mm = dx._load_mixmax_model()
        for label, fn, kw, with_post in DIRECT:
            msgs = []
            for name, x in list(utts.items())[:1]:
                wp = dx._padded(x, len(x))
                model = mm if fn == "enhance_mixmax" else None
                post = posts[name] if with_post else None
                if with_post == "normalised":
                    post = post / post.sum(-1, keepdim=True)
                args = dict(kw, **({"model": model} if model is not None else {}),
                            **({"posteriors": post} if post is not None else {}))
                with torch.no_grad():
                    y = getattr(hybrid_infer, fn)(torch.as_tensor(wp[0], device=dev),
                                                  **args).cpu().numpy()
                y64 = _cpu64(fn, kw, wp[0], model, post)
                err = float(np.abs(y - y64).max() / np.abs(y64).max())
                if not err <= HYB_TOL:
                    fail(f"[3m] {label} {name}: {err:.3e} of the scale from the CPU's float64")
                msgs.append(f"{name} {err:.3e} (peak {np.abs(y64).max():.3g})")
            print(f"[3m] hybrid_infer {label}: against the CPU's float64, of the scale: "
                  f"{'; '.join(msgs)}")

        # the command line, on the card
        out_cli = os.path.join(tmp, "out_cli")
        argv = ["--ver", "resnet-1.1c", "--inp_tgt_type", "MagPhonemes", "--infer", "1",
                "--out_type", "tracking_hist", "--test_x_path", test_dir, "--out_path",
                out_cli, "--data_path", cfg.data_path, "--model_path", cfg.model_path]
        argv += [] if dev.type == "cuda" else ["--platform", "cpu"]  # the card by default
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        steps = 0
        for name in utts:
            a = read_wav(os.path.join(out_cli, "resnet-1.1c", "classical", "tracking_hist",
                                      name + ".wav"))[0].astype(np.int64)
            b = read_wav(os.path.join(cfg.out_path, cfg.ver, "classical", "tracking_hist",
                                      name + ".wav"))[0].astype(np.int64)
            steps = max(steps, int(np.abs(a - b).max()) if a.shape == b.shape else 1 << 16)
        print(f"[3m] python -m deepxi_tpu_torch {' '.join(argv[:8])} ...: rc {rc}, "
              f"{wall:.2f} s; its wavs {steps} int16 steps from infer's")
        if rc != 0 or steps > 0:
            fail("[3m] the --infer command line did not write infer's wavs")

        # no frame loop reads back from the card
        x4 = torch.as_tensor(dx._padded(noisy, len(noisy))[0], device=dev)
        with torch.no_grad():
            mag = torch.stft(x4.float(), 512, 256, 512, window=torch.hamming_window(
                512, periodic=False, device=dev), center=False, return_complex=True).abs().T
            log_mag = torch.log(torch.clamp(mag, min=1.2e-7))
            _sync(dev)
            torch.cuda.set_sync_debug_mode("error")
            try:
                trackers.omlsa_enhance(mag)
                trackers.omlsa_enhance(mag, tracker="imcra")
                histnoise.histogram_track(torch.square(mag))
                mixmax.enhance(mm, log_mag)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        print(f"[3m] MCRA and IMCRA OM-LSA, the histogram tracker and MixMax's noise tracking "
              f"ran on {tuple(mag.shape)} under set_sync_debug_mode('error'): no read-back")

        # B=1 x 4 s: host ms a call (each synchronised), and the ATen operations a
        # call dispatches and a frame adds (48- against 64-frame slices, past the
        # histogram's warm-up); no profiler here, whose traces phase 4 relies on
        w4 = dx._padded(noisy, len(noisy))
        routes = {f"infer route {m}": (lambda w, m=m: dx.hybrid_enhancer(m, params)(w))
                  for m in ("hybrid_mixmax",) + CLASSICAL}
        routes["pho route (estimator)"] = lambda w: dx.estimator()(params, w)
        routes["y omlsa route"] = lambda w: dx._utterance_y(params, w[0], w.shape[1], "omlsa")
        calls = {k: (lambda f=f: f(w4)) for k, f in routes.items()}
        for label, fn, kw, with_post in DIRECT:
            post = posts["c012_white_5dB"]
            if with_post == "normalised":
                post = post / post.sum(-1, keepdim=True)
            args = dict(kw, **({"model": mm} if fn == "enhance_mixmax" else {}),
                        **({"posteriors": post} if with_post else {}))
            calls[f"hybrid_infer {label}"] = (lambda fn=fn, args=args: getattr(
                hybrid_infer, fn)(x4, **args))
        for label, fn in calls.items():
            with torch.no_grad():
                ms = _wall_ms(fn, dev, iters=1 if label.startswith("hybrid_infer") else 2)
                ops_msg = ""
                if label in routes:
                    n_call = _aten_ops(fn)
                    n48, n64 = (_aten_ops(lambda n=n: routes[label](w4[:, :n * 256]))
                                for n in (48, 64))
                    ops_msg = (f"; {n_call} ATen operations a call, {(n64 - n48) / 16:g} a "
                               "frame")
                    times[f"{label} ATen operations a frame"] = (n64 - n48) / 16
            times[f"{label} B=1 x 4 s"] = ms
            print(f"[3m] {label}, B=1 x 4 s (T=256): {ms:.2f} ms a call (host clock, "
                  f"synchronised){ops_msg}; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "times": times}


if __name__ == "__main__":
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    import subprocess
    card_name = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip()
    failures = []

    def _record(msg):
        print(f"FAIL: {msg}", flush=True)
        failures.append(msg)

    t = time.perf_counter()
    hybrid_phase("cuda", _record, card_name)
    print(f"hybrid phase: {time.perf_counter() - t:.1f} s, {len(failures)} failures; "
          f"{card_name}")
    sys.exit(1 if failures else 0)
