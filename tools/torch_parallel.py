"""The parallel layer and the DSP utilities on one card (chip_smoke.py phase
3n): the mesh paths at world size 1 over NCCL, in the caller's process.

The card's machine has one card and NCCL puts no two ranks on one card, so
every mesh path runs on a one-rank group (a 1 x 1 mesh); two or more ranks
run only on the CPU over gloo (tests/test_torch_parallel.py), and two-card
numbers need a machine with two cards. `parallel_phase(device, fail,
card)`:

  * trains resnet-1.1c with `DeepXiTorch.train` for three steps (3 epochs
    of one step, B = 8 x 4.096 s, through B5/B6) with no group, then joins a
    one-rank NCCL group (`parallel.init_distributed` with a `file://`
    rendezvous) and trains the same run on its 1 x 1 mesh (n_data_shards
    1): the losses and parameters must be equal (1e-6; measured bitwise
    where the step is deterministic), the checkpoints written by rank 0;
    and times the train step on the mesh and with none, in turns;
  * enhances the resnet-1.1c artifact's 4 s utterance tiled to 60 s (T =
    3750) with `make_seq_sharded_enhancer` (B4 over the 68 s halo'd shard, B1
    on the head pass) against the offline `make_enhancer` through the same
    kernels (WAVE_ATOL), timed;
  * enhances the mhanet-1.1c artifact's 4 s utterance tiled to 36 s (T =
    2250, positions past max_len 2048) with `make_ring_mha_enhancer`
    against the offline enhancer with the plain network (WAVE_ATOL), timed;
  * exports the resnet-1.1c enhancer bundle under the 1 x 1 mesh and
    without one and serves the 4 s utterance from each: bitwise equal;
  * leaves the group;
  * runs the DSP utilities on the card against the CPU: the features (fbank,
    logfbank, mfcc, ssc, delta) and the adaptive filters (NLMS, LMS and
    block NLMS at B = 1 x 4 s, 64 taps, cancelling the artifact's noise from
    its noisy utterance) in float32 against the CPU's float64 run (the
    features 1e-4 of their scale; each filter no further from float64 than
    twice the CPU's own float32 run, or 1e-5 of the scale), the VAD (its
    energies are float32 in both packages) against the CPU's run (decisions
    exactly); each timed (host clock, synchronised).

Each path's launches of B1/B4/B5/B6 are counted, zeroed just before it.
Returns {"launches": {kernel: {what: launches}}, "times": {what: ms}}. Run
alone on a machine with a card: python3 tools/torch_parallel.py (records
failures and goes on).
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_families  # noqa: E402
from torch_families import _counts, _sync, _zero  # noqa: E402

WAVE_ATOL = 1e-3      # chip_smoke.py's limit for a waveform against the plain path
TRAIN_TOL = 1e-6      # the mesh run's losses and parameters against the unsharded run
FEATURE_TOL = 1e-4    # a feature on the card against the CPU's float64, of its scale
FILTER_FLOOR = 1e-5   # an adaptive filter's distance that passes whatever the CPU's


def _host_ms(fn, dev, iters=3):
    """Median wall ms of `iters` synchronised calls after one warm-up."""
    fn()
    _sync(dev)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _write_corpus(root, seed=11):
    """8 clean 4 s utterances and 2 noise files of 8 s."""
    from synth_corpus import synth_noise, synth_utterance

    from deepxi_tpu_torch.data.wavio import save_wav
    rng = np.random.RandomState(seed)
    dirs = (os.path.join(root, "train_clean_speech"), os.path.join(root, "train_noise"))
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    for i in range(8):
        save_wav(os.path.join(dirs[0], f"sp{i}.wav"), synth_utterance(rng, 4.0), 16000)
    for j, kind in enumerate(("white", "pink")):
        save_wav(os.path.join(dirs[1], f"{kind}.wav"), synth_noise(rng, kind, 8.0), 16000)
    return dirs


def _train(tmp, dirs, name, dev):
    """Three resnet-1.1c steps through DeepXiTorch.train; (losses, params,
    launches, mesh shape or None, the run's root, the DeepXiTorch)."""
    from deepxi_tpu_torch.config import preset
    from deepxi_tpu_torch.data.listing import batch_list
    from deepxi_tpu_torch.framework import DeepXiTorch
    from deepxi_tpu_torch.parallel.mesh import mesh_shape
    root = os.path.join(tmp, name)
    cfg = preset("resnet-1.1c", mbatch_size=8, sample_size=16, max_epochs=3,
                 val_flag=False, seed=5, n_data_shards=1,
                 **{f"{k}_path": os.path.join(root, k) for k in ("data", "model", "log")})
    s_list = batch_list(dirs[0], "clean", cfg.data_path)
    d_list = batch_list(dirs[1], "noise", cfg.data_path)
    dx = DeepXiTorch(cfg, s_list, d_list, device=dev)
    _zero()
    losses = dx.train(verbose=False)
    _sync(dev)
    n = _counts()
    shape = None if dx.mesh is None else mesh_shape(dx.mesh)
    return losses, dx._state.params, n, shape, root, dx


def _step_times(dx, mesh, dev, pairs=15):
    """Median ms of the resnet-1.1c train step (B = 8 x 4.096 s, through
    B5/B6, host clock, synchronised) with no mesh and on `mesh`, in turns."""
    from deepxi_tpu_torch.training import (TrainState, make_optimizer, make_train_step,
                                           shard_state, shardings_of)
    g = torch.Generator().manual_seed(9)
    s, d = ((torch.randn(8, 65536, generator=g) * a).to(torch.int16).to(dev)
            for a in (3000, 1000))
    lens, snr = torch.full((8,), 65536), torch.linspace(-5.0, 15.0, 8)
    zeros = torch.zeros(8, dtype=torch.int64)
    tx = make_optimizer("ResNetV2")
    runs = {}
    for label, m in (("none", None), ("mesh", mesh)):
        state = TrainState.create(dx._state.params, tx)
        sh = shardings_of(m, state.params) if m is not None else None
        if m is not None:
            state = shard_state(m, state, sh)
        runs[label] = [make_train_step(dx.network, dx.inp_tgt, tx, apply_fn=dx.apply_fn(),
                                       mesh=m, shardings=sh), state, []]
    for i in range(pairs + 2):
        for label in (("none", "mesh") if i % 2 == 0 else ("mesh", "none")):
            step, state, ts = runs[label]
            _sync(dev)
            t0 = time.perf_counter()
            runs[label][1], _ = step(state, s, d, lens, lens, snr, offsets=zeros)
            _sync(dev)
            if i >= 2:
                ts.append((time.perf_counter() - t0) * 1e3)
    return {label: float(np.median(r[2])) for label, r in runs.items()}


def parallel_phase(device, fail, card="") -> dict:
    import torch.distributed as dist

    from deepxi_tpu_torch.compat.artifact import (MHANET_ROOT, artifact_meta,
                                                  load_artifact, load_flagship_artifact)
    from deepxi_tpu_torch.config import preset
    from deepxi_tpu_torch.dsp import adaptive, features, vad
    from deepxi_tpu_torch.enhance import make_enhancer
    from deepxi_tpu_torch.framework import fast_apply_fn
    from deepxi_tpu_torch.parallel import init_distributed, make_mesh
    from deepxi_tpu_torch.parallel.mesh import mesh_shape
    from deepxi_tpu_torch.parallel.ring_attention import make_ring_mha_enhancer
    from deepxi_tpu_torch.parallel.seq_enhance import (make_seq_sharded_enhancer,
                                                       receptive_field_frames)
    from deepxi_tpu_torch.serving import export_enhancer, load_server

    dev = torch.device(device)
    launches, times = {}, {}
    print(f"[3n] torch.cuda.device_count() = {torch.cuda.device_count()}: every mesh path "
          f"runs on a one-rank NCCL group (a 1 x 1 mesh); NCCL puts no two ranks on one "
          f"card, so two-card runs need a machine with two cards (two and four ranks run "
          f"on the CPU over gloo in tests/test_torch_parallel.py)")
    tmp = tempfile.mkdtemp(prefix="deepxi_parallel_")
    try:
        dirs = _write_corpus(os.path.join(tmp, "set"))
        # -- data-parallel training: unsharded first, then on the 1 x 1 mesh
        base = _train(tmp, dirs, "unsharded", dev)
        if dist.is_initialized():
            fail("[3n] a process group exists before the phase joins one")
        init_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", world_size=1, rank=0)
        print(f"[3n] joined a one-rank {dist.get_backend()} group on "
              f"cuda:{torch.cuda.current_device()}")
        t0 = time.perf_counter()
        on_mesh = _train(tmp, dirs, "mesh", dev)
        wall = time.perf_counter() - t0
        if on_mesh[3] != {"data": 1, "model": 1} or base[3] is not None:
            fail(f"[3n] meshes: {on_mesh[3]} on the group, {base[3]} without one")
        loss_err = max(abs(a - b) for a, b in zip(on_mesh[0], base[0]))
        p_err = max((on_mesh[1][k] - base[1][k]).abs().max().item() for k in base[1])
        bitwise = on_mesh[0] == base[0] and all(torch.equal(on_mesh[1][k], base[1][k])
                                                for k in base[1])
        n = on_mesh[2]
        for k in ("B5", "B6"):
            launches.setdefault(k, {})["DeepXiTorch.train on the 1x1 mesh, 3 steps"] = n[k]
        ckpts = all(os.path.exists(os.path.join(on_mesh[4], "model", "resnet-1.1c",
                                                f"epoch-{e}", "state.pt")) for e in range(3))
        print(f"[3n] resnet-1.1c DeepXiTorch.train() on the 1x1 mesh: 3 steps at B=8 x "
              f"4.096 s in {wall:.2f} s; losses {', '.join(f'{v:.6f}' for v in on_mesh[0])}; "
              f"against the unsharded run: losses {loss_err:.2e}, parameters {p_err:.2e} "
              f"max abs ({'bitwise' if bitwise else 'not bitwise'}; tol {TRAIN_TOL:.0e}); "
              f"B5 {n['B5']} B6 {n['B6']}; checkpoints written: {ckpts}")
        if loss_err > TRAIN_TOL or p_err > TRAIN_TOL or not ckpts or not (n["B5"] and n["B6"]):
            fail("[3n] the train run on the 1x1 mesh is not the unsharded run's, or did "
                 "not launch B5/B6 or write its checkpoints")
        mesh = make_mesh(1, 1)
        print(f"[3n] make_mesh(1, 1): {mesh_shape(mesh)}")
        st = _step_times(on_mesh[5], mesh, dev)
        times.update({f"train step B=8 x 4.096 s, {k}": v for k, v in st.items()})
        print(f"[3n] resnet-1.1c train step at B=8 x 4.096 s, median of 15 in turns: "
              f"{st['mesh']:.2f} ms on the 1x1 mesh, {st['none']:.2f} ms with none "
              f"({st['mesh'] / st['none'] - 1:+.1%}; host clock, synchronised); {card}")

        # -- sequence-sharded enhancement of 60 s
        art = load_flagship_artifact(device=dev)
        cfg = preset("resnet-1.1c")
        apply = fast_apply_fn(cfg)
        x60 = np.tile(art.noisy, 15)
        seq = make_seq_sharded_enhancer(art.inp_tgt, art.net, "mmse-lsa", mesh=mesh,
                                        apply_fn=apply, device=dev)
        offline = make_enhancer(art.inp_tgt, art.net, "mmse-lsa", apply_fn=apply, device=dev)
        _zero()
        y = seq(art.params, x60)
        _sync(dev)
        n = _counts()
        y_off = offline(art.params, x60[None])[0, :len(x60)]
        err = (y - y_off).abs().max().item()
        ms = _host_ms(lambda: seq(art.params, x60), dev)
        ms_off = _host_ms(lambda: offline(art.params, x60[None]), dev)
        halo = receptive_field_frames(40, 16, 3)
        for k in ("B1", "B4"):
            launches.setdefault(k, {})["seq-sharded 60 s"] = n[k]
        times["seq-sharded resnet-1.1c 60 s"] = ms
        times["offline resnet-1.1c 60 s"] = ms_off
        print(f"[3n] make_seq_sharded_enhancer, resnet-1.1c, 60 s (T={len(x60) // 256}, halo "
              f"{halo} frames): max abs err {err:.3e} against make_enhancer (tol "
              f"{WAVE_ATOL:.0e}); B1 {n['B1']} B4 {n['B4']} a call; {ms:.1f} ms (offline "
              f"{ms_off:.1f} ms; host clock, synchronised); {card}")
        if err > WAVE_ATOL or not (n["B1"] and n["B4"]):
            fail("[3n] the sequence-sharded enhancer is not the offline one, or did not "
                 "launch B1 and B4")

        # -- ring MHANet enhancement of 36 s
        art_m = load_artifact(MHANET_ROOT, device=dev)
        _, cfg_m = artifact_meta(MHANET_ROOT)
        x36 = np.tile(art_m.noisy, 9)
        ring = make_ring_mha_enhancer(art_m.inp_tgt, mesh, "mmse-lsa",
                                      n_blocks=cfg_m.n_blocks, n_heads=cfg_m.n_heads,
                                      d_model=cfg_m.d_model, max_len=cfg_m.max_len or 2048,
                                      causal=cfg_m.causal, device=dev)
        plain = make_enhancer(art_m.inp_tgt, art_m.net, "mmse-lsa", device=dev)
        y = ring(art_m.params, x36)
        y_off = plain(art_m.params, x36[None])[0, :len(x36)]
        err = (y - y_off).abs().max().item()
        ms = _host_ms(lambda: ring(art_m.params, x36), dev)
        ms_off = _host_ms(lambda: plain(art_m.params, x36[None]), dev)
        times["ring mhanet-1.1c 36 s"] = ms
        times["offline plain mhanet-1.1c 36 s"] = ms_off
        print(f"[3n] make_ring_mha_enhancer, mhanet-1.1c, 36 s (T={len(x36) // 256}): max abs "
              f"err {err:.3e} against make_enhancer with the plain network (tol "
              f"{WAVE_ATOL:.0e}); {ms:.1f} ms (offline plain {ms_off:.1f} ms; host clock, "
              f"synchronised); {card}")
        if not (err <= WAVE_ATOL):
            fail("[3n] the ring enhancer is not the offline one")

        # -- a serving bundle under the 1 x 1 mesh against one without
        ys = {}
        for label, m in (("mesh", mesh), ("none", None)):
            out = os.path.join(tmp, f"bundle_{label}")
            export_enhancer(art.inp_tgt, art.net, art.params, out, batch=2,
                            buckets=(65536,), apply_fn=apply, mesh=m, device=dev)
            srv = load_server(out, mesh=m)
            _zero()
            ys[label] = srv(art.noisy[None])
            _sync(dev)
            n = _counts()
            if label == "mesh":
                for k in ("B1", "B4"):
                    launches.setdefault(k, {})["bundle on the 1x1 mesh, a call"] = n[k]
        same = np.array_equal(ys["mesh"], ys["none"])
        print(f"[3n] resnet-1.1c bundle exported under the 1x1 mesh: served output "
              f"{'bitwise' if same else 'NOT bitwise'} the bundle without a mesh; B1 "
              f"{launches['B1']['bundle on the 1x1 mesh, a call']} B4 "
              f"{launches['B4']['bundle on the 1x1 mesh, a call']} a call")
        if not same:
            fail("[3n] the 1x1-mesh bundle is not the bundle without a mesh")
        dist.destroy_process_group()

        # -- the DSP utilities on the card against the CPU
        noisy = art.noisy.astype(np.float64)
        noise = noisy - art.clean.astype(np.float64)[:len(noisy)]
        sig = noisy / 32768.0
        for name, fn in (("fbank", lambda x: features.fbank(x)[0]),
                         ("logfbank", features.logfbank), ("mfcc", features.mfcc),
                         ("ssc", features.ssc),
                         ("delta", lambda x: features.delta(features.mfcc(x)))):
            ref = fn(torch.as_tensor(sig)).numpy()
            xc = torch.as_tensor(sig, dtype=torch.float32, device=dev)
            got = fn(xc).cpu().double().numpy()
            rel = np.abs(got - ref).max() / np.abs(ref).max()
            ms = _host_ms(lambda: fn(xc), dev)  # noqa: B023
            times[f"features.{name} 4 s"] = ms
            print(f"[3n] features.{name} on 4 s {tuple(got.shape)}: {rel:.2e} of the scale "
                  f"from the CPU's float64 (tol {FEATURE_TOL:.0e}); {ms:.2f} ms")
            if not rel <= FEATURE_TOL:
                fail(f"[3n] features.{name} on the card is not the CPU's")
        filters = {"nlms": lambda x, d: adaptive.nlms(x, d, n_taps=64, mu=0.5),
                   "lms": lambda x, d: adaptive.lms(x, d, n_taps=64, mu=0.01),
                   "block_nlms": lambda x, d: adaptive.block_nlms(x, d, n_taps=64, mu=0.5)}
        for name, fn in filters.items():
            x_ref, d_ref = torch.as_tensor(noise / 32768.0), torch.as_tensor(sig)
            ref = [t.numpy() for t in fn(x_ref, d_ref)]
            cpu32 = [t.double().numpy() for t in fn(x_ref.float(), d_ref.float())]
            xc, dc = x_ref.float().to(dev), d_ref.float().to(dev)
            t0 = time.perf_counter()
            got = fn(xc, dc)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            got = [t.cpu().double().numpy() for t in got]

            def dist_(a):
                return max(np.abs(u - v).max() / np.abs(v).max() for u, v in zip(a, ref))
            d_card, d_cpu = dist_(got), dist_(cpu32)
            times[f"adaptive.{name} B=1 x 4 s, 64 taps"] = ms
            print(f"[3n] adaptive.{name}, B=1 x 4 s ({len(noisy)} samples), 64 taps: "
                  f"{ms:.1f} ms on the card (host clock, synchronised; "
                  f"{ms * 1e3 / len(noisy):.1f} us a sample); from the CPU's float64 "
                  f"{d_card:.2e} of the scale (the CPU's float32 {d_cpu:.2e}; tol "
                  f"max(2 x that, {FILTER_FLOOR:.0e})); {card}")
            if not d_card <= max(2.0 * d_cpu, FILTER_FLOOR):
                fail(f"[3n] adaptive.{name} on the card is not the CPU's")
        xa = torch.as_tensor(art.noisy.astype(np.float32))
        e_ref = vad.frame_energies(xa, 16000).numpy()
        e_card = vad.frame_energies(xa.to(dev), 16000).cpu().double().numpy()
        v_cpu = vad.energy_vad(xa, 16000)
        v_card = vad.energy_vad(xa.to(dev), 16000)
        seg_cpu = vad.speech_segments(xa, 16000)
        seg_card = vad.speech_segments(xa.to(dev), 16000)
        rel = np.abs(e_card - e_ref).max() / np.abs(e_ref).max()
        ms = _host_ms(lambda: vad.speech_segments(xa.to(dev), 16000), dev)
        times["vad.speech_segments 4 s"] = ms
        print(f"[3n] vad on 4 s: frame energies {rel:.2e} of the scale from the CPU's; "
              f"{int(v_card.sum())}/{len(v_card)} speech frames, "
              f"{len(seg_card)} segments, decisions and segments "
              f"{'equal to' if np.array_equal(v_card, v_cpu) and seg_card == seg_cpu else 'NOT'}"
              f" the CPU's; {ms:.2f} ms")
        if rel > FEATURE_TOL or not np.array_equal(v_card, v_cpu) or seg_card != seg_cpu:
            fail("[3n] the VAD on the card is not the CPU's")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "times": times}


if __name__ == "__main__":
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
    parallel_phase("cuda", _record, card_name)
    print(f"parallel phase: {time.perf_counter() - t:.1f} s, {len(failures)} failures; "
          f"{card_name}")
    sys.exit(1 if failures else 0)
