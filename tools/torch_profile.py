#!/usr/bin/env python3
"""Where the time of the PyTorch port's main paths goes on the card.

    python3 tools/torch_profile.py enhance [--ver resnet-1.1c|mhanet-1.1c] [--batch 96|64] [--seconds 10] [--iters 5] [--timed 30] [--plain]
    python3 tools/torch_profile.py train [--batch 8] [--seconds 4.096] [--iters 5] [--timed 30] [--plain]
    python3 tools/torch_profile.py stream [--ver mhanet-1.1c|resnet-1.1c] [--batch 1] [--cache f32|bf16] [--iters 5] [--timed 30] [--plain]
    python3 tools/torch_profile.py kernels [--iters 20]

`enhance` runs offline enhancement of `--batch` copies of the checked-in
trained artifact's noisy utterance (resnet-1.1c, or mhanet-1.1c), tiled or
cut to `--seconds`, through the fused main path (or, with `--plain`, the
plain network). `train` runs train steps (example synthesis, forward,
backward, update) at full width on `--batch` synthetic utterances of
`--seconds`, with seeded initial weights and map statistics fitted on the
batch, through the fused training stack (or, with `--plain`, autograd of the
plain ResNetV2). `stream` runs one streaming hop (`step`) of `--batch`
channels of the checked-in artifact: for mhanet-1.1c at the clock 1023 with
random K/V caches (`--cache` f32 or bf16) through the KV-cache kernel (or,
with `--plain`, the einsum route); for resnet-1.1c from zero delay lines.

After warm-up it times `--timed` calls without the profiler (host clock,
each call synchronised: min, median, max), then runs `--iters` calls under
`torch.profiler` and prints the device time by kernel (grouped into layers),
the profiled window's wall time and idle share, and the unprofiled median's
idle share given the traced device time per call. Needs one NVIDIA card.

`kernels` times the redesigned kernels (the TCN forward's four routes, the
TCN backward in saved and replay mode, the fused transformer block and both
attentions) and their library yardsticks at
chip_smoke.py phase 4's shapes, each two ways: CUDA events around `--iters`
back-to-back calls (chip_smoke.py's `cuda_ms`: what the host adds between
launches included), and the device-only time, the summed device durations
of the operations a call launches under torch.profiler (`device_ms`), with
their count per call; for the TCN backward and the transformer block, the
device time of each kernel they launch.
"""

import argparse
import os
import re
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

MATMUL = ("gemm", "gemv", "xmma", "cutlass", "sm90")


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespace and
    parameter list: `mha_attention_kernel<1, float>`."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name).strip()
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def device_ms(fn, iters=20, warmup=3, by_name=False):
    """(ms, operations) per call on the device alone: the summed device
    durations of the kernels and copies `fn` launches over `iters` calls
    under torch.profiler, after warm-up, and their count, per call. Host
    time between launches is left out; raises when the trace holds no
    device time. With `by_name`, a third item: {short name: (ms, launches)
    per call}."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = [(short_name(e.name), e.time_range.elapsed_us()) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        raise RuntimeError("the trace holds no device time")
    total = (sum(t for _, t in ops) / 1e3 / iters, len(ops) / iters)
    if not by_name:
        return total
    split = {}
    for name, t in ops:
        ms, n = split.get(name, (0.0, 0))
        split[name] = (ms + t / 1e3 / iters, n + 1 / iters)
    return (*total, split)


def kernel_calls():
    """(row, shape, kernel call, library call or None) of PERF.md rows 1-5
    and 8-10 at chip_smoke.py phase 4's shapes, seeded."""
    from deepxi_tpu_torch.models.attention import NEG_INF_V2
    from deepxi_tpu_torch.models.tcn import cyclic_dilation
    from deepxi_tpu_torch.ops.kernels import (mha_block_fused, mha_flash_stream,
                                              mha_fused, tcn_fused, tcn_fused_train)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    dil = [cyclic_dilation(i, 16) for i in range(10)]
    w5 = tcn_fused.random_block_weights(5, gen, dev)
    w10 = tcn_fused.random_block_weights(10, gen, dev)
    calls = []
    for B, T in ((1, 250), (96, 625)):
        x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(dev)
        calls += [
            ("1 fused_block_group_whole", f"B={B} T={T} G=5",
             lambda x=x: tcn_fused.fused_block_group_whole(x, w5, dil[:5]), None),
            ("3 fused_block_group_whole_pack2", f"B={B} T={T} G=5",
             lambda x=x: tcn_fused.fused_block_group_whole_pack2(x, w5, dil[:5]), None)]
    G = tcn_fused.TILED_GROUP

    def tiled(x):  # the five blocks as the route runs them, G a launch
        for g0 in range(0, 5, G):
            x = tcn_fused.fused_block_group(x, w5[g0:g0 + G], dil[g0:min(g0 + G, 5)])
        return x
    for B, T in ((1, 1250), (96, 625)):
        x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(dev)
        calls.append(("2 fused_block_group", f"B={B} T={T} 5 blocks, G={G} a launch",
                      lambda x=x: tiled(x), None))
    x = torch.relu(torch.randn(8, 256, 256, generator=gen)).to(dev)
    calls.append(("4 fused_block_group_whole_saved", "B=8 T=256 G=10",
                  lambda x=x: tcn_fused_train.fused_block_group_whole_saved(x, w10, dil),
                  None))
    dout = torch.randn(8, 256, 256, generator=gen).to(dev)
    _, hs = tcn_fused_train.fused_block_group_whole_saved(x, w10, dil)
    calls += [
        ("5 fused_block_group_bwd", "B=8 T=256 G=10 saved",
         lambda x=x, dout=dout, hs=hs: tcn_fused_train.fused_block_group_bwd(
             x, dout, w10, dil, saved_h=hs), None),
        ("5 fused_block_group_bwd", "B=8 T=256 G=10 replay",
         lambda x=x, dout=dout: tcn_fused_train.fused_block_group_bwd(x, dout, w10, dil),
         None)]

    wm = mha_block_fused.random_block_weights(gen, dev)
    layer = torch.nn.TransformerEncoderLayer(
        256, 8, 1024, dropout=0.0, activation="relu", layer_norm_eps=1e-6,
        batch_first=True).to(dev).eval()
    for B, T in ((1, 250), (64, 625)):
        Tp = -(-T // 128) * 128
        valid = (torch.arange(Tp, device=dev) < T)[None].repeat(B, 1)
        x = torch.randn(B, Tp, 256, generator=gen).to(dev) * valid[:, :, None]
        vf = valid[:, None, :].float()
        allowed = (valid[:, :, None] & valid[:, None, :]
                   & torch.ones(Tp, Tp, dtype=torch.bool, device=dev).tril())
        mask = (NEG_INF_V2 * (1.0 - allowed.float())).repeat_interleave(8, 0)
        calls.append(("8 fused_transformer_block", f"B={B} T={T} (Tp {Tp}) causal",
                      lambda x=x, vf=vf: mha_block_fused.fused_transformer_block(
                          x, vf, wm, True),
                      lambda x=x, mask=mask: layer(x, src_mask=mask)))
    for T in (250, 2250):
        valid = torch.ones(1, T, dtype=torch.bool, device=dev)
        q, k, v = (torch.randn(1, T, 8, 32, generator=gen).to(dev) for _ in range(3))
        q = q * 32 ** -0.5
        mask = (NEG_INF_V2 * (1.0 - torch.ones(T, T, device=dev).tril()))[None, None]
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(qh=qh, kh=kh, vh=vh, mask=mask):
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=1.0)
        calls += [
            ("9 flash_attention", f"B=1 T={T} causal",
             lambda q=q, k=k, v=v, valid=valid: mha_fused.flash_attention(
                 q, k, v, valid, True), sdpa),
            ("10 flash_attention_streaming", f"B=1 T={T} causal",
             lambda q=q, k=k, v=v, valid=valid: mha_flash_stream.flash_attention_streaming(
                 q, k, v, valid, True), sdpa)]
    return sorted(calls, key=lambda c: int(c[0].split()[0]))


def kernels_report(iters):
    from chip_smoke import cuda_ms

    """Print each kernel's and its library call's CUDA-events and device-only
    times (`kernel_calls`); for the rows whose call launches several
    kernels (5, the TCN backward, and 8, the transformer block), the device
    time of each kernel."""
    print(f"card: {torch.cuda.get_device_name(0)}; CUDA events over {iters} calls, "
          f"device-only over {iters} profiled calls")
    with torch.no_grad():
        for row, shape, call, lib in kernel_calls():
            ev, (dev_ms, ops, split) = cuda_ms(call, iters), device_ms(call, iters,
                                                                       by_name=True)
            line = (f"row {row} {shape}: events {ev:.4f} ms, device {dev_ms:.4f} ms "
                    f"({ops:g} operations a call)")
            if row.split()[0] in ("5", "8"):
                line += "; by kernel: " + ", ".join(
                    f"{name} {ms:.4f} ms ({n:g} a call)"
                    for name, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0]))
            if lib is not None:
                lev, (ldev, lops) = cuda_ms(lib, iters), device_ms(lib, iters)
                line += (f"; library events {lev:.4f} ms, device {ldev:.4f} ms "
                         f"({lops:g} operations a call)")
            print(line, flush=True)


def layer_enhance(n: str) -> str:
    if "tcn_window_kernel" in n:
        return "tcn kernels"
    if "mha_qkv_kernel" in n:
        return "transformer block: q/k/v projections"
    if "mha_attention_kernel" in n:
        return "attention kernel"
    if "mha_post_kernel" in n:
        return "transformer block: output projection, LN, FFN"
    if "softmax" in n:
        return "softmax (plain attention)"
    if any(s in n for s in MATMUL):
        return "matmul (DFT, in/out convs; plain: projections, FFN, logits)"
    return "elementwise/reduction/copy"


def layer_train(n: str) -> str:
    if "tcn_window_kernel" in n:
        return "tcn forward (saving)"
    if "tcn_bwd" in n:
        return "tcn backward kernels"
    if any(s in n for s in MATMUL):
        return "matmul (ff_conv, out_conv, their gradients)"
    if "fft" in n:
        return "FFT (example spectra)"
    return "elementwise/reduction/copy (mixing, maps, LN, loss, Adam)"


def layer_stream(n: str) -> str:
    if "mha_cache" in n:
        return "KV-cache attention kernel"
    if "softmax" in n:
        return "softmax (plain cache attention)"
    if any(s in n for s in MATMUL):
        return "matmul (DFT, projections, FFN, convs; plain: cache attention)"
    return "elementwise/reduction/copy (LN, gain, cache writes, delay lines)"


def stream_call(args):
    """The stream workload: (one hop, its description)."""
    from deepxi_tpu_torch.compat.artifact import (load_artifact,
                                                  load_flagship_artifact)
    from deepxi_tpu_torch.streaming import StreamingEnhancer, StreamingMHANet

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    chunk = torch.randint(-3000, 3000, (args.batch, 256), dtype=torch.int16, device=dev,
                          generator=gen)
    if args.ver == "resnet-1.1c":
        if args.plain or args.cache != "f32":
            sys.exit("--plain and --cache apply to mhanet-1.1c")
        art = load_flagship_artifact(device=dev)
        s = StreamingEnhancer(art.inp_tgt, art.net, art.params, device=dev)
        st = s.init_state(args.batch)
        return (lambda: s.step(st, chunk)), "resnet-1.1c streaming hop"
    art = load_artifact(device=dev)
    s = StreamingMHANet(art.inp_tgt, art.net, art.params, fused=not args.plain,
                        cache_dtype={"f32": torch.float32, "bf16": torch.bfloat16}[args.cache],
                        device=dev)
    st = s.init_state(args.batch)
    for c in st.k_caches + st.v_caches:
        c.copy_(torch.randn(c.shape, device=dev, generator=gen))
    st = st._replace(t=1023)
    return (lambda: s.step(st, chunk)), (
        f"mhanet-1.1c streaming hop ({'plain' if args.plain else 'fused'}, {args.cache} "
        f"caches, t=1023)")


def enhance_call(args):
    """The enhance workload: (one call, its description)."""
    from deepxi_tpu_torch.compat.artifact import (load_artifact,
                                                  load_flagship_artifact)
    from deepxi_tpu_torch.enhance import make_enhancer
    from deepxi_tpu_torch.ops.kernels.mha_block_fused import mhanetv3_apply_fused
    from deepxi_tpu_torch.ops.kernels.tcn_fused import resnetv2_apply_fused

    if args.ver == "mhanet-1.1c":
        art, fused = load_artifact(device="cuda"), mhanetv3_apply_fused
    else:
        art, fused = load_flagship_artifact(device="cuda"), resnetv2_apply_fused
    enhance = make_enhancer(art.inp_tgt, art.net, "mmse-lsa",
                            apply_fn=None if args.plain else fused)
    n = int(args.seconds * 16000)
    x = np.tile(art.noisy, -(-n // len(art.noisy)))[:n][None].repeat(args.batch, 0)
    return (lambda: enhance(art.params, x)), (
        f"{args.ver} {'plain' if args.plain else 'fused'} enhance call")


def train_call(args):
    """The train workload: (one step, its description)."""
    from deepxi_tpu_torch.inp_tgt import MagXi
    from deepxi_tpu_torch.models.tcn import ResNetV2, init_flax_like
    from deepxi_tpu_torch.ops.kernels.tcn_fused_train import \
        resnetv2_apply_fused_train
    from deepxi_tpu_torch.ops.maps import NormalCDF
    from deepxi_tpu_torch.training import (TrainState, make_optimizer,
                                           make_train_step)
    from synth_corpus import synth_noise, synth_utterance

    dev = torch.device("cuda")
    n = int(args.seconds * 16000)
    rng = np.random.RandomState(0)
    s = np.stack([synth_utterance(rng, args.seconds) for _ in range(args.batch)])[:, :n]
    d = np.stack([synth_noise(rng, "pink", args.seconds) for _ in range(args.batch)])[:, :n]
    lens = torch.full((args.batch,), n, dtype=torch.int32)
    snr = torch.as_tensor(rng.choice(np.arange(-10, 21), args.batch).astype(np.float32))
    s_f, d_f = (s / 32768.0).astype(np.float32), (d / 32768.0).astype(np.float32)
    it = MagXi(xi_map=NormalCDF(use_db=True)).with_stats(s_f, d_f, s_f, lens.numpy(),
                                                         device=dev)
    net = init_flax_like(ResNetV2(257, 257), torch.Generator().manual_seed(0)).to(dev)
    tx = make_optimizer("ResNetV2")
    apply_fn = None if args.plain else (
        lambda p, m: resnetv2_apply_fused_train(p, m, save_acts=True))
    step = make_train_step(net, it, tx, apply_fn=apply_fn)
    box = [TrainState.create(dict(net.state_dict()), tx)]
    batch = (torch.as_tensor(s, device=dev), torch.as_tensor(d, device=dev), lens,
             lens, snr)
    offs = torch.zeros(args.batch, dtype=torch.int64)

    def call():
        box[0], _ = step(box[0], *batch, offsets=offs)
    return call, f"{'plain' if args.plain else 'fused'} train step"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", choices=("enhance", "train", "stream", "kernels"))
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--iters", type=int, help="profiled calls (5; kernels: 20)")
    ap.add_argument("--timed", type=int, default=30)
    ap.add_argument("--ver", choices=("resnet-1.1c", "mhanet-1.1c"), default="resnet-1.1c",
                    help="enhance, stream: the checked-in artifact to run")
    ap.add_argument("--cache", choices=("f32", "bf16"), default="f32",
                    help="stream: the MHANet K/V cache type")
    ap.add_argument("--plain", action="store_true", help="the plain network")
    args = ap.parse_args()
    train = args.path == "train"
    args.batch = args.batch or (8 if train else 1 if args.path == "stream"
                                else 64 if args.ver == "mhanet-1.1c" else 96)
    args.seconds = args.seconds or (4.096 if train else 10.0)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    if args.path == "kernels":
        kernels_report(args.iters or 20)
        return
    args.iters = args.iters or 5

    call, what = {"enhance": enhance_call, "train": train_call,
                  "stream": stream_call}[args.path](args)
    layer_of = {"enhance": layer_enhance, "train": layer_train,
                "stream": layer_stream}[args.path]
    for _ in range(3):
        call()
    torch.cuda.synchronize()

    ts = []
    for _ in range(args.timed):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts = np.asarray(ts)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(sum(v) for v in kernels.values())
    per = args.iters
    print(f"card: {torch.cuda.get_device_name(0)}; {what}, batch {args.batch}"
          + ("" if args.path == "stream" else f" x {args.seconds} s"))
    print(f"unprofiled: {args.timed} calls, ms per call min {ts.min():.3f} median "
          f"{np.median(ts):.3f} max {ts.max():.3f}")
    if busy_ms == 0:
        sys.exit("the trace holds no device time")
    n_ops = sum(len(v) for v in kernels.values())
    print(f"profiled: {per} calls, window {wall_ms:.3f} ms wall ({wall_ms / per:.3f} ms "
          f"per call), device busy {busy_ms / per:.3f} ms per call, idle share "
          f"{1 - busy_ms / wall_ms:.1%}; {n_ops / per:.0f} device operations (kernels "
          f"and copies) per call")
    print(f"traced device time per call over the unprofiled median: idle share "
          f"{1 - busy_ms / per / np.median(ts):.1%} (estimate: two windows of one "
          f"process)")
    layers = {}
    for name, t in kernels.items():
        layers[layer_of(name.lower())] = layers.get(layer_of(name.lower()), 0.0) + sum(t)
    for layer, ms in sorted(layers.items(), key=lambda kv: -kv[1]):
        print(f"  layer {layer}: {ms / per:.3f} ms per call, {ms / busy_ms:.1%} of "
              f"device time")
    print("top kernels (ms per call, launches per call):")
    for name, t in sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:12]:
        print(f"  {sum(t) / per:9.4f} ms  {len(t) / per:6.1f}  {name[:100]}")


if __name__ == "__main__":
    main()
