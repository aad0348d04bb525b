#!/usr/bin/env python3
"""Where the time of the PyTorch port's main paths goes on the card.

    python3 tools/torch_profile.py enhance [--ver resnet-1.1c|mhanet-1.1c] [--batch 96|64] [--seconds 10] [--iters 5] [--timed 30] [--plain]
    python3 tools/torch_profile.py train [--batch 8] [--seconds 4.096] [--iters 5] [--timed 30] [--plain]

`enhance` runs offline enhancement of `--batch` copies of the checked-in
trained artifact's noisy utterance (resnet-1.1c, or mhanet-1.1c), tiled or
cut to `--seconds`, through the fused main path (or, with `--plain`, the
plain network). `train` runs train steps (example synthesis, forward,
backward, update) at full width on `--batch` synthetic utterances of
`--seconds`, with seeded initial weights and map statistics fitted on the
batch, through the fused training stack (or, with `--plain`, autograd of the
plain ResNetV2).

After warm-up it times `--timed` calls without the profiler (host clock,
each call synchronised: min, median, max), then runs `--iters` calls under
`torch.profiler` and prints the device time by kernel (grouped into layers),
the profiled window's wall time and idle share, and the unprofiled median's
idle share given the traced device time per call. Needs one NVIDIA card.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

MATMUL = ("gemm", "gemv", "xmma", "cutlass", "sm90")


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
    ap.add_argument("path", choices=("enhance", "train"))
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--timed", type=int, default=30)
    ap.add_argument("--ver", choices=("resnet-1.1c", "mhanet-1.1c"), default="resnet-1.1c",
                    help="enhance: the checked-in artifact to run")
    ap.add_argument("--plain", action="store_true", help="the plain network")
    args = ap.parse_args()
    train = args.path == "train"
    args.batch = args.batch or (8 if train else 64 if args.ver == "mhanet-1.1c" else 96)
    args.seconds = args.seconds or (4.096 if train else 10.0)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")

    call, what = (train_call if train else enhance_call)(args)
    layer_of = layer_train if train else layer_enhance
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
    print(f"card: {torch.cuda.get_device_name(0)}; {what}, batch {args.batch} x "
          f"{args.seconds} s")
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
