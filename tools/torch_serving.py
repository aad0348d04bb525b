"""Serving on the card at full width: the exported offline enhancer and the
streaming server of `deepxi_tpu_torch.serving` (chip_smoke.py phase 3j).

`serving_phase(device, fail)` runs, on the checked-in trained artifacts:

  * `export_enhancer` of resnet-1.1c at batch 4, buckets 65,536 (T=256: the
    per-block TCN kernel, 40 launches a call) and 320,000 (T=1250: the
    halo-tiled kernel, 20 a call), and of mhanet-1.1c at 65,536 (the fused
    transformer block, 5 a call); each bundle loaded, its launches counted
    a call, its output held to the live `make_enhancer` on the same kernels
    (1e-6, bitwise expected) and to the plain route (1e-3); the resnet
    65,536 bundle also loaded by a fresh process that imports only
    `deepxi_tpu_torch.serving`;
  * `export_streaming` of `StreamingEnhancer` (resnet-1.1c, B=1),
    `StreamingMHANet(fused=True)` at B=1 with f32 caches and at B=256 with
    bf16 caches, and MHANet `step_block` of 2 hops (B=1); each server
    streams its artifact's 4 s utterance (B=256: the utterance rotated a
    row) through one CUDA graph replayed a hop, held to the live streamer's
    eager steps on the same chunks (1e-6) and, for bf16 caches, to the f32
    live stream (2e-2 max abs, 5% relative RMS); the KV-cache kernel must
    launch 5 times a captured hop;
  * `python3 -m deepxi_tpu_torch --export 1` on resnet-1.1c set up as epoch
    1 (a checkpoint and the map statistics): the bundle loads and matches
    the live enhancer;
  * times (median, min and max, each call synchronised): the server hop at
    B=1 for both networks and at B=256 with bf16 caches (the MHANet hops at
    the clock 1023 on random caches) against the 16 ms hop, the server call
    at (4, 65,536) beside the live enhancer, and export seconds a bucket.

Returns {"launches": {kernel: {what: launches}}, "times": {...}}.
Run alone on a machine with a card: python3 tools/torch_serving.py
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from deepxi_tpu_torch import serving  # noqa: E402
from deepxi_tpu_torch.compat.artifact import (FLAGSHIP_ROOT, load_artifact,  # noqa: E402
                                              load_flagship_artifact)
from deepxi_tpu_torch.enhance import make_enhancer  # noqa: E402
from deepxi_tpu_torch.ops.kernels import (mha_block_fused, mha_cache,  # noqa: E402
                                          tcn_fused)
from deepxi_tpu_torch.streaming import StreamingEnhancer, StreamingMHANet  # noqa: E402

HOP_BUDGET_MS = 16.0
SAME_ATOL = 1e-6                      # the same kernels on the same inputs
WAVE_ATOL = 1e-3                      # against the plain route (chip_smoke.py)
BF16_ATOL, BF16_REL_RMS = 2e-2, 0.05  # bf16 caches against the f32 stream
BATCH = 4
# (bucket, the kernel its call launches, launches a call)
ENHANCER_BUCKETS = {
    "resnet-1.1c": ((65536, "fused_block_group_whole", 40),
                    (320000, "fused_block_group", 20)),
    "mhanet-1.1c": ((65536, "fused_transformer_block", 5),),
}
WRAPPERS = {"fused_block_group_whole": tcn_fused.fused_block_group_whole,
            "fused_block_group": tcn_fused.fused_block_group,
            "fused_transformer_block": mha_block_fused.fused_transformer_block,
            "mha_cache_step": mha_cache.mha_cache_step}


def _counts():
    return {k: fn.launches for k, fn in WRAPPERS.items()}


def _delta(before):
    return {k: fn.launches - before[k] for k, fn in WRAPPERS.items()
            if fn.launches != before[k]}


def host_times(fn, iters=20, warmup=2) -> np.ndarray:
    """Milliseconds of `iters` calls of `fn`, each synchronised."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return np.array(ts)


def _stats(ts: np.ndarray) -> dict:
    return {"median": float(np.median(ts)), "min": float(ts.min()), "max": float(ts.max())}


def _fmt(s: dict) -> str:
    return f"median {s['median']:.3f} ms (min {s['min']:.3f}, max {s['max']:.3f})"


def _rows(wav: np.ndarray, B: int) -> np.ndarray:
    """B rows of `wav`, row r rotated by r * 997 samples."""
    return np.stack([np.roll(wav, r * 997) for r in range(B)])


class _ExportClock:
    """Seconds of each `torch.export.export` call (the save excluded)."""

    def __enter__(self):
        self.seconds, self._orig = [], torch.export.export

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = self._orig(*args, **kw)
            self.seconds.append(time.perf_counter() - t0)
            return out
        torch.export.export = timed
        return self

    def __exit__(self, *exc):
        torch.export.export = self._orig


def _fresh_process_output(bundle: str, x: np.ndarray, tmp: str) -> np.ndarray:
    """The bundle's output on x from a new interpreter that imports only
    `deepxi_tpu_torch.serving`."""
    code = ("import sys, numpy as np\n"
            "from deepxi_tpu_torch.serving import load_server\n"
            "np.save(sys.argv[3], load_server(sys.argv[1])(np.load(sys.argv[2])))\n"
            "assert 'jax' not in sys.modules\n")
    xin, yout = os.path.join(tmp, "x.npy"), os.path.join(tmp, "y.npy")
    np.save(xin, x)
    r = subprocess.run([sys.executable, "-c", code, bundle, xin, yout], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": ROOT})
    if r.returncode != 0:
        raise RuntimeError(f"the fresh process failed:\n{r.stderr[-4000:]}")
    return np.load(yout)


def _enhancers(dev, arts, tmp, fail, launches, times):
    for ver, art in arts.items():
        apply = (tcn_fused.resnetv2_apply_fused if ver == "resnet-1.1c"
                 else mha_block_fused.mhanetv3_apply_fused)
        buckets = ENHANCER_BUCKETS[ver]
        out = os.path.join(tmp, ver)
        t0 = time.perf_counter()
        with _ExportClock() as clock:
            serving.export_enhancer(art.inp_tgt, art.net, art.params, out, batch=BATCH,
                                    buckets=[b for b, _, _ in buckets], apply_fn=apply,
                                    ver=ver, device=dev)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        server = serving.load_server(out)
        load_s = time.perf_counter() - t0
        times[f"{ver} export s"] = {str(b): s for (b, _, _), s in zip(buckets, clock.seconds)}
        print(f"[3j] {ver} export_enhancer, batch {BATCH}, buckets "
              f"{[b for b, _, _ in buckets]}: {wall:.2f} s in all; torch.export.export "
              f"{', '.join(f'{s:.2f} s' for s in clock.seconds)} a bucket; load_server "
              f"{load_s:.2f} s; platforms {server.manifest['platforms']}")
        live = make_enhancer(art.inp_tgt, art.net, "mmse-lsa", apply_fn=apply, device=dev)
        plain = make_enhancer(art.inp_tgt, art.net, "mmse-lsa", device=dev)
        for L, kname, per_call in buckets:
            # the 4 s utterance (65,536), or it tiled 5 times (320,000)
            n = L // len(art.noisy) * len(art.noisy)
            x = _rows(np.tile(art.noisy, L // len(art.noisy)), BATCH)
            before = _counts()
            y = server(x)
            torch.cuda.synchronize()
            got = _delta(before)
            launches.setdefault(kname, {})[f"{ver} EnhancerServer at ({BATCH}, {L})"] = \
                got.get(kname, 0)
            xp = np.zeros((BATCH, L), np.int16)
            xp[:, :n] = x
            y_live = live(art.params, xp).cpu().numpy()[:, :y.shape[1]]
            y_plain = plain(art.params, xp).cpu().numpy()[:, :y.shape[1]]
            e_live, e_plain = np.abs(y - y_live).max(), np.abs(y - y_plain).max()
            print(f"[3j] {ver} EnhancerServer, x int16 {x.shape} into bucket {L}: y "
                  f"{y.shape}, launches {got}; against the live enhancer max abs "
                  f"{e_live:.3e} (bitwise {bool(np.array_equal(y, y_live))}; tol "
                  f"{SAME_ATOL:.0e}); against the plain route {e_plain:.3e} (tol "
                  f"{WAVE_ATOL:.0e})")
            if not np.isfinite(y).all() or y.shape != (BATCH, (-(-n // 256) + 1) * 256):
                fail(f"{ver} EnhancerServer: output not finite or of the wrong shape")
            if got != {kname: per_call}:
                fail(f"{ver} EnhancerServer at bucket {L}: launches {got}, not "
                     f"{{{kname!r}: {per_call}}}")
            if e_live > SAME_ATOL or e_plain > WAVE_ATOL:
                fail(f"{ver} EnhancerServer at bucket {L} disagrees")
            if ver == "resnet-1.1c" and L == 65536:
                y_fresh = _fresh_process_output(out, x, tmp)
                e = np.abs(y_fresh - y).max()
                print(f"[3j] {ver} bundle loaded by a fresh process importing only "
                      f"deepxi_tpu_torch.serving: max abs {e:.3e} from this process's "
                      f"(tol {SAME_ATOL:.0e})")
                if y_fresh.shape != y.shape or e > SAME_ATOL:
                    fail("the bundle loaded in a fresh process disagrees")
            if L == 65536:
                t_srv = _stats(host_times(lambda: server(x)))  # noqa: B023
                t_live = _stats(host_times(
                    lambda: live(art.params, xp).cpu().numpy()))  # noqa: B023
                times[f"{ver} EnhancerServer ({BATCH}, {L}) ms"] = t_srv
                times[f"{ver} live enhancer ({BATCH}, {L}) ms"] = t_live
                print(f"[3j] {ver} EnhancerServer call at ({BATCH}, {L}), numpy in and "
                      f"out: {_fmt(t_srv)}; the live enhancer on the padded batch, numpy "
                      f"in and out: {_fmt(t_live)}; ratio {t_srv['median'] / t_live['median']:.3f}")
        del server, live, plain


def _stream(step, state, chunks):
    outs = []
    for c in chunks:
        state, y = step(state, c)
        outs.append(y)
    return state, torch.cat(outs, 1)


def _wave_errs(y, ref):
    err = (y - ref).abs().max().item()
    rel = ((y - ref).pow(2).mean() / ref.pow(2).mean()).sqrt().item()
    return err, rel


def _streams(dev, arts, tmp, fail, launches, times):
    art, art_m = arts["resnet-1.1c"], arts["mhanet-1.1c"]
    cases = (
        ("resnet-1.1c StreamingEnhancer, B=1", art, 1, 1,
         lambda: StreamingEnhancer(art.inp_tgt, art.net, art.params, device=dev)),
        ("mhanet-1.1c StreamingMHANet(fused=True), f32 caches, B=1", art_m, 1, 1,
         lambda: StreamingMHANet(art_m.inp_tgt, art_m.net, art_m.params, fused=True,
                                 device=dev)),
        ("mhanet-1.1c StreamingMHANet(fused=True), bf16 caches, B=256", art_m, 256, 1,
         lambda: StreamingMHANet(art_m.inp_tgt, art_m.net, art_m.params, fused=True,
                                 cache_dtype=torch.bfloat16, device=dev)),
        ("mhanet-1.1c StreamingMHANet step_block of 2 hops, B=1", art_m, 1, 2,
         lambda: StreamingMHANet(art_m.inp_tgt, art_m.net, art_m.params, device=dev)),
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, a, B, H, make in cases:
        sm = make()
        out = os.path.join(tmp, f"stream_{len(os.listdir(tmp))}")
        t0 = time.perf_counter()
        serving.export_streaming(sm, out, batch=B, hop_batch=H, ver=label.split()[0])
        export_s = time.perf_counter() - t0
        srv = serving.load_streaming_server(out)
        wav = torch.as_tensor(_rows(a.noisy, B), device=dev)
        n_calls = wav.shape[1] // (H * 256)
        chunks = [wav[:, i * H * 256:(i + 1) * H * 256] for i in range(n_calls)]
        before = _counts()
        t0 = time.perf_counter()
        state, y = _stream(srv.step, srv.init_state(), chunks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _delta(before)
        step = sm.step if H == 1 else sm.step_block
        _, y_live = _stream(step, sm.init_state(B), chunks)
        err = (y - y_live).abs().max().item()
        fused = getattr(sm, "fused", False)
        n_blocks = len(sm.blocks)
        want = {"mha_cache_step": (serving.WARMUPS + 1) * n_blocks} if fused else {}
        aliased = [a_ is b_ for a_, b_ in zip(getattr(srv, "_state", ()),
                                              getattr(srv, "_new", ()))]
        print(f"[3j] {label}: export_streaming {export_s:.2f} s; {n_calls} server steps "
              f"of {H} hop(s) in {wall:.2f} s, {srv.replays} CUDA graph replays; launches "
              f"{got} (at capture: {serving.WARMUPS} warm-ups and the captured step; a "
              f"replay counts none); state tensors written in place by the loaded step: "
              f"{sum(aliased)} of {len(aliased)}; against the live eager steps max abs "
              f"{err:.3e} (bitwise {bool(torch.equal(y, y_live))}; tol {SAME_ATOL:.0e})")
        if fused:
            launches.setdefault("mha_cache_step", {})[label] = (
                f"{n_blocks} a hop in the captured graph ({got.get('mha_cache_step', 0)} "
                f"counted at capture)")
        if not torch.isfinite(y).all() or y.shape != (B, n_calls * H * 256):
            fail(f"{label}: server output not finite or of the wrong shape")
        if srv.replays != n_calls:
            fail(f"{label}: {srv.replays} replays for {n_calls} steps")
        if got != want:
            fail(f"{label}: launches {got}, not {want}")
        if err > SAME_ATOL:
            fail(f"{label}: the server disagrees with the live steps")
        if sm.__class__ is StreamingMHANet and sm.cache_dtype == torch.bfloat16:
            sm32 = StreamingMHANet(a.inp_tgt, a.net, a.params, fused=True, device=dev)
            _, y32 = _stream(sm32.step, sm32.init_state(B), chunks)
            e, rel = _wave_errs(y, y32)
            print(f"[3j] {label}: against the f32 live stream max abs {e:.3e} (tol "
                  f"{BF16_ATOL:.0e}), rel RMS {rel:.3e} (tol {BF16_REL_RMS:.0e})")
            if e > BF16_ATOL or rel > BF16_REL_RMS:
                fail(f"{label}: bf16 caches disagree with the f32 stream")
            del sm32, y32
        if H == 1:
            if fused:  # the hop at the clock 1023 on random caches, as in phase 4
                for c in state[:2 * n_blocks]:
                    c.copy_(torch.randn(c.shape, device=dev, generator=gen))
                state[2 * n_blocks].fill_(1023)
            chunk = chunks[0].cpu().numpy()
            st = [state]

            def hop():
                st[0] = srv.step(st[0], chunk)[0]  # noqa: B023
            t = _stats(host_times(hop))
            times[f"{label} server hop ms"] = t
            print(f"[3j] {label}: server hop (int16 numpy chunk in, a new y tensor out"
                  f"{', clock 1023' if fused else ''}): {_fmt(t)} against the "
                  f"{HOP_BUDGET_MS:g} ms hop ({t['median'] / HOP_BUDGET_MS:.1%} of it)")
            if not t["median"] < HOP_BUDGET_MS:
                fail(f"{label}: the server hop misses the {HOP_BUDGET_MS:g} ms budget")
        del srv, sm, state, y, y_live


def _cli_export(dev, art, tmp, fail, launches):
    from deepxi_tpu_torch.config import preset
    from deepxi_tpu_torch.training import TrainState, make_optimizer, save_checkpoint
    ver = "resnet-1.1c"
    d = {k: os.path.join(tmp, "cli", k) for k in ("model", "data", "serving")}
    cfg = preset(ver)
    save_checkpoint(os.path.join(d["model"], ver), 0, TrainState.create(
        art.params, make_optimizer(cfg.network_type, cfg.d_model, cfg.warmup_steps)))
    os.makedirs(d["data"])
    shutil.copy(os.path.join(FLAGSHIP_ROOT, "stats.npz"),
                os.path.join(d["data"], f"{ver}_stats.npz"))
    argv = [sys.executable, "-m", "deepxi_tpu_torch", "--ver", ver, "--export", "1",
            "--test_epoch", "1", "--export_path", d["serving"], "--model_path", d["model"],
            "--data_path", d["data"]]
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": ROOT})
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"python3 -m deepxi_tpu_torch --export 1 failed (rc {r.returncode}):\n"
             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    server = serving.load_server(d["serving"])
    x = art.noisy[None]
    before = _counts()
    y = server(x)
    torch.cuda.synchronize()
    got = _delta(before)
    launches.setdefault("fused_block_group_whole", {})[
        "resnet-1.1c --export 1 bundle, 4 s"] = got.get("fused_block_group_whole", 0)
    xp = np.zeros((server.batch, server.bucket_for(x.shape[1])), np.int16)
    xp[0, :x.shape[1]] = x[0]
    y_live = make_enhancer(art.inp_tgt, art.net, "mmse-lsa",
                           apply_fn=tcn_fused.resnetv2_apply_fused,
                           device=dev)(art.params, xp).cpu().numpy()[:1, :y.shape[1]]
    err = np.abs(y - y_live).max()
    print(f"[3j] python3 -m deepxi_tpu_torch --ver {ver} --export 1 --test_epoch 1: rc "
          f"{r.returncode}, {wall:.1f} s; {r.stdout.strip().splitlines()[-1]!r}; manifest "
          f"batch {server.batch}, buckets {server.manifest['buckets']}; the 4 s utterance "
          f"through it: launches {got}, against the live enhancer max abs {err:.3e} (tol "
          f"{SAME_ATOL:.0e})")
    if got != {"fused_block_group_whole": 40} or err > SAME_ATOL or not np.isfinite(y).all():
        fail("the --export 1 bundle does not match the live enhancer")


def serving_phase(device, fail) -> dict:
    """Phase 3j (see the module docstring); `fail(msg)` is called on a
    failed check."""
    dev = torch.device(device)
    arts = {"resnet-1.1c": load_flagship_artifact(device=dev),
            "mhanet-1.1c": load_artifact(device=dev)}
    launches, times = {}, {}
    tmp = tempfile.mkdtemp(prefix="deepxi_serving_")
    t0 = time.perf_counter()
    try:
        _enhancers(dev, arts, tmp, fail, launches, times)
        _streams(dev, arts, tmp, fail, launches, times)
        _cli_export(dev, arts["resnet-1.1c"], tmp, fail, launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[3j] serving on the card: {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "times": times}


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    from deepxi_tpu_torch.ops.kernels import _build, mha_fused

    def _fail(msg):
        print(f"FAIL: {msg}")
        sys.exit(1)

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build([tcn_fused.build_spec("tcn_fused", 256, 64, 3),
                  mha_block_fused.build_spec(8, 32, 1024),
                  ("mha_cache", mha_fused.head_defines(8, 32))])
    print(serving_phase("cuda", _fail))
