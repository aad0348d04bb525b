#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit, torch and CUDA versions, and
     the build of every CUDA kernel from `deepxi_tpu_torch/ops/kernels/csrc`
     at the flagship widths and at phase 3f's (one nvcc per source and set
     of widths, all started together);
  2. each kernel against its plain PyTorch version on the card at full width
     (d_model 256, d_f 64, k 3, seeded weights with nonzero biases): the two
     inference kernels (the per-block one at B=4 T=250, B=1 T=1, B=3 T=37
     and B=96 T=625; the halo-tiled one in groups of two blocks over 10, at
     B=4 T=1250 and B=1 T=1100), the training stack's saving forward, and
     its backward with saved block inputs and with a replayed forward (the
     two, and a second saved call, bitwise equal); then
     the MHANet kernels (d_model 256, 8 heads of 32, d_ff 1024, LN scales
     != 1, padded tails of zero frames): the fused transformer block at
     B=4 T=250 and T=2048, the main path's B=1 T=250 and B=64 T=625, and
     its launch shapes' edges (T=1, T=17, 111 rows, every row invalid, B=2
     lengths [250, 83]), flash_attention at T=250 and T=700, the streaming
     attention at T=2250, causal and not, and both attentions at T=1, T=17,
     every row invalid and B=2 lengths [250, 83] (the streaming one at
     256/512 and 64/128 tiles); the KV-cache attention step of streaming
     MHANet at B=3, L=2048 with f32 and bf16 caches, the clock at 0, 700,
     2047 and 2500 (past the cap), every cache row nonzero; the pack2 TCN
     kernel (two batch rows a CTA) at B=3 (odd) and 4, T=250 and 1024, and
     at B=96 T=625, G=20, both LayerNorm modes; the
     spectral kernels (an FFT a frame: |X| of hop rows, and gain times
     spectrum through the inverse FFT) at B=4, T=1, 250 and 625, at
     (N_s, K) = (256, 512), (128, 256), (200, 512) and (768, 2048), every row
     within the gate;
  3. the enhancement path: the checked-in trained resnet-1.1c artifact
     enhances its 4 s noisy utterance (T=250, per-block kernel) and the same
     utterance tiled five times (T=1250, halo-tiled kernel); both kernels
     must launch, the outputs must agree with the port's plain path on the
     same card, and the enhanced SNR must beat the noisy SNR;
  3c. the MHANet path: `DeepXiTorch(preset("mhanet-1.1c")).infer()` enhances
     a test directory with the checked-in trained mhanet-1.1c artifact's 4 s
     utterance (T=256 after bucketing: fused transformer blocks) and the same
     utterance tiled 9 times (36 s, T=2272 > 2048: streaming attention), then
     the 4 s utterance with attention_impl "fused" (flash_attention); each
     kernel must launch, network outputs on valid frames and the written
     waveforms must agree with the plain MHANetV3 on the same card, and the
     enhanced SNR must beat the noisy SNR;
  3b. the training path: `DeepXiTorch.train()` at full width (resnet-1.1c,
     B=8, 2 epochs of 2 steps) on a synthetic corpus written to a temporary
     directory; both training kernels must launch, the losses must be
     finite, the first step's gradients must agree with autograd of the
     plain ResNetV2 (on a crop of the batch; on the whole batch, against
     float64 as closely as the plain path does), 30 steps on one batch must
     lower its loss, and a restored checkpoint must give the same next-step
     loss;
  3d. the streaming path: the trained mhanet-1.1c artifact's 4 s utterance
     hop by hop (prime, 249 steps, one zero chunk) through
     `StreamingMHANet(fused=True)`, which must launch the KV-cache kernel
     once a block and hop and give the port's offline enhancer's waveform
     (plain MHANetV3) and an SNR above the noisy one; then with bf16 caches
     (against the f32 stream, the JAX test's limits), through `step_block`
     of 8 hops and with fused=False (against the steps); the trained
     resnet-1.1c through `StreamingEnhancer.step`, against the offline
     enhancer and the noisy SNR;
  3e. the last three kernels' paths: resnet-1.1c enhancement of the 4 s
     utterance and of B=96 distinct 10 s rows (T=625) through
     `resnetv2_apply_fused(pack2=True)`, once per LayerNorm mode (the pack2
     kernel must launch and the unpacked one must not; waveforms against
     the unpacked route and the plain path; SNR); `make_xi_estimator` with
     `fast_apply()` on both artifacts' 4 s utterances (|X| from one
     stft_mag_fused launch a call; network output against the plain route on
     the card, the largest ξ̂ difference in dB printed); and the
     spectral-kernel route of resnet-1.1c enhancement (stft_mag_fused, the
     fused TCN, the gain, enhance_frames_fused, overlap-add) against
     `make_enhancer`'s waveform;
  3f. every width on its own kernels (the fault C1; tools/torch_small_widths.py):
     every kernel built for small widths (TCN 32/16/3 and 48/12/2, MHANet 4
     heads of 8 and 12 of 4) against its plain version; then at d_model 32
     resnet-1.1c trains (`DeepXiTorch.train`, one epoch) and infers, an
     MHANetV3 with 4 heads of 8 runs its fused blocks and "full", "fused" and
     "stream" attention, and StreamingMHANet(fused=True) streams, on the card
     and on the CPU; each route's kernels must launch and the results agree;
  4. times from CUDA events after warm-up (and, for the TCN forward's four
     rows, the fused block and both attentions with their library calls,
     the device-only time: the summed device durations of a call's
     operations under torch.profiler): each kernel and its plain version
     at the main-path shapes (and the inference kernels at B=96, T=625), the
     end-to-end enhance, and one train step, fused against plain (median,
     min and max over 30 and 10 steps); the MHANet kernels with their plain
     versions and a library yardstick (nn.TransformerEncoderLayer, or
     scaled_dot_product_attention with the same float mask; checked first
     on valid rows) and mhanet-1.1c enhancement, fused against plain; the
     KV-cache kernel at B=1 and B=256, t=1023, f32 and bf16 caches, against
     its plain version and scaled_dot_product_attention; streaming hops on
     the host clock against the 16 ms hop: MHANet `step` at B=1 (f32) and
     B=256 (bf16 caches, t=1023), `step_block` of 8 hops at B=256 against
     its 128 ms, and the ResNet `step` at B=1 and B=4096; the pack2 kernel
     (both modes) beside the unpacked kernel and its plain version, and the
     spectral kernels (in turns with cuFFT) beside their plain versions and
     two yardsticks, cuFFT (torch.stft and abs; torch.fft.irfft of the
     gained spectrum times the synthesis window) and the port's matmul
     formulation (`stft_mag`; `apply_gain_reim` and torch.matmul), at B=1
     T=250 and B=96 T=625, against the bytes they must move; resnet-1.1c
     `make_enhancer`, `make_xi_estimator` and the spectral-kernel route end
     to end at B=1 x 4 s and B=96 x 10 s; resnet-1.1c enhancement at B=96 x
     10 s, pack2 against unpacked.
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
# A library yardstick against the kernel on valid rows before it is timed:
# cuBLAS/SDPA f32 sums in other orders, through two LayerNorms.
LIB_TOL_REL = 1e-3

# (N_s, K) at which the spectral kernels are held to their plain versions:
# the main path's; 8 kHz; N_d = 400 < K with 32 not dividing N_s; a 48 ms hop.
SPECTRAL_SHAPES = ((256, 512), (128, 256), (200, 512), (768, 2048))

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3;
# and f32-accurate products on the tensor cores, three dense TF32 products
# (495 TFLOP/s) for one (csrc/mma_tf32x3.cuh), the bound of the kernels
# that take their products there (the TCN forward, the attention).
PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
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
# Streaming: one hop is 16 ms of audio; a block of 8 hops 128 ms.
HOP_BUDGET_MS = 16.0
# bf16 caches against the f32 stream (tests/test_streaming_mha.py's limits).
BF16_ATOL, BF16_REL_RMS = 2e-2, 0.05
# Product FLOPs of one MHANet transformer block per row: q, k, v and output
# projections 256x256 each, FFN 256->1024->256; attention adds 4 * 256 per
# (row, key). Floats of one block's weights.
MHA_BLOCK_FLOPS_PER_ROW = 2 * (3 * 256 * 256 + 256 * 256 + 2 * 256 * 1024)
MHA_BLOCK_FLOATS = 4 * 8 * 256 * 32 + 4 * 256 + 256 * 1024 + 1024 + 1024 * 256 + 256

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


def roofline_ms(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(ms, bound_by): product FLOPs at `peak` (the f32 peak) or bytes at the
    HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound_ms(B, T, G, peak=PEAK_F32_FLOPS):
    """Least time for one group call: x read once, y written once, weights
    read once."""
    return roofline_ms(BLOCK_FLOPS_PER_ROW * B * T * G,
                       4 * (2 * B * T * 256 + G * BLOCK_FLOATS), peak)


def train_bound_ms(B, T, G, flops_per_row, act_rows, grads, peak=PEAK_F32_FLOPS):
    """Least time of a training kernel call: `flops_per_row` product FLOPs
    per row and block; `act_rows` [B, T, 256] activation tensors read or
    written once, weights in and, with `grads`, their gradients out."""
    return roofline_ms(flops_per_row * B * T * G,
                       4 * (act_rows * B * T * 256
                            + (2 if grads else 1) * G * BLOCK_FLOATS), peak)


def keys_needed(T, causal):
    """Mean keys a valid query row needs: all T, or (T + 1) / 2 when causal
    (row t needs keys 0..t)."""
    return (T + 1) / 2 if causal else T


def mha_block_bound_ms(B, T, causal, peak=PEAK_F32_FLOPS):
    """Least time of one transformer block on B x T valid rows: x read and
    the output written once, the weights read once."""
    flops = B * T * (MHA_BLOCK_FLOPS_PER_ROW + 4 * 256 * keys_needed(T, causal))
    return roofline_ms(flops, 4 * (2 * B * T * 256 + MHA_BLOCK_FLOATS), peak)


def attention_bound_ms(B, T, causal, peak=PEAK_F32_FLOPS):
    """Least time of the masked attention on B x T valid rows: q, k, v read
    and the output written once."""
    return roofline_ms(B * T * 4 * 256 * keys_needed(T, causal), 4 * 4 * B * T * 256,
                       peak)


def cache_bound_ms(B, n_valid, itemsize):
    """Least time of one KV-cache step: K and V of the n_valid written rows
    (8 heads of 32 values each) read once, q read and the output written
    once; 4 * 256 FLOP a written row."""
    return roofline_ms(4 * 256 * n_valid * B,
                       B * n_valid * 256 * 2 * itemsize + 2 * 4 * B * 256)


def errs(pairs):
    """(max abs error, max error over each reference's max abs) of
    (value, reference) pairs."""
    ab = max((a - r).abs().max().item() for a, r in pairs)
    rel = max((a - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
              for a, r in pairs)
    return ab, rel


def encoder_layer(w, dev):
    """nn.TransformerEncoderLayer holding one MHANet block's weights (zero
    in/out projection biases): the library yardstick of the fused block."""
    layer = torch.nn.TransformerEncoderLayer(
        256, 8, 1024, dropout=0.0, activation="relu", layer_norm_eps=1e-6,
        batch_first=True, norm_first=False).to(dev).eval()
    flat = [t.permute(1, 0, 2).reshape(256, 256) for t in (w.qk, w.kk, w.vk)]
    layer.self_attn.in_proj_weight.copy_(torch.cat([f.T for f in flat], 0))
    layer.self_attn.in_proj_bias.zero_()
    layer.self_attn.out_proj.weight.copy_(w.ok.reshape(256, 256).T)
    layer.self_attn.out_proj.bias.zero_()
    for lin, wt, b in ((layer.linear1, w.ff1_w, w.ff1_b), (layer.linear2, w.ff2_w, w.ff2_b)):
        lin.weight.copy_(wt.T)
        lin.bias.copy_(b)
    for ln, sc, b in ((layer.norm1, w.ln1_s, w.ln1_b), (layer.norm2, w.ln2_s, w.ln2_b)):
        ln.weight.copy_(sc)
        ln.bias.copy_(b)
    return layer


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
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    if not os.path.isdir(os.path.join(ROOT, "deepxi_tpu_torch")):
        fail("deepxi_tpu_torch/ is not beside this script: run it from the repository")

    from deepxi_tpu_torch.compat.artifact import FLAGSHIP_ROOT, load_flagship_artifact
    from deepxi_tpu_torch.enhance import make_enhancer, make_xi_estimator
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
    from deepxi_tpu_torch.ops.gains import gfunc
    from deepxi_tpu_torch.ops.kernels import spectral
    from deepxi_tpu_torch.ops.kernels.spectral import apply_gain_reim, stft_mag, stft_reim
    from deepxi_tpu_torch.sig.stft import (_hamming_np, _synthesis_window_np,
                                           hop_rows, overlap_and_add)
    from deepxi_tpu_torch.sig.mix import normalise
    from deepxi_tpu_torch.compat.artifact import MHANET_ROOT, load_artifact
    from deepxi_tpu_torch.data.loader import bucket_length
    from deepxi_tpu_torch.data.wavio import read_wav, save_wav
    from deepxi_tpu_torch.models.attention import sequence_valid_mask
    from deepxi_tpu_torch.ops.kernels import (mha_block_fused, mha_cache,
                                              mha_flash_stream, mha_fused)
    from deepxi_tpu_torch.streaming import StreamingEnhancer, StreamingMHANet

    dev = torch.device("cuda")
    card = card_line()

    # 1. device and build -------------------------------------------------
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    # every kernel at the flagship widths, and at phase 3f's small widths
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_small_widths
    from torch_profile import device_ms
    flagship = [tcn_fused.build_spec("tcn_fused", 256, 64, 3),
                tcn_fused.build_spec("tcn_fused", 256, 128, 3),  # weights read from memory
                tcn_fused.build_spec("tcn_fused_train", 256, 64, 3), "spectral",
                ("mha_attention", mha_fused.head_defines(8, 32)),
                mha_block_fused.build_spec(8, 32, 1024),
                ("mha_cache", mha_fused.head_defines(8, 32))]
    build_s = _build.build(flagship + torch_small_widths.build_specs())
    print(f"[1] build: {time.perf_counter() - t0:.1f} s wall, {len(build_s)} libraries "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in build_s.items())})")
    for spec in flagship:
        with open(_build.log_path(spec)) as f:
            for line in f:
                if any(w in line for w in ("registers", "spill", "entry function")):
                    print(f"[1] ptxas {_build.tag(spec)}: {line.strip()}")

    # 2. each kernel against its plain version at full width ----------------
    gen = torch.Generator().manual_seed(0)
    dil = [cyclic_dilation(i, 16) for i in range(40)]
    checks = {}
    def tiled_groups(fn):
        """The halo-tiled route over a stack, TILED_GROUP blocks a call, as
        `resnetv2_apply_fused` runs it."""
        G = tcn_fused.TILED_GROUP

        def run(x, w, ds):
            for g0 in range(0, len(ds), G):
                x = fn(x, w[g0:g0 + G], ds[g0:g0 + G])
            return x
        return run

    # the per-block kernel: the main path's shapes, T = 1, a ragged T under
    # one tile, and at B <= 3 16-row tiles, which the d = 16 conv reaches 32
    # rows past; the halo-tiled kernel over 10 blocks (every group of two
    # blocks of the cycle, halos 8 to 48)
    cases = (
        ("fused_block_group_whole", tcn_fused.fused_block_group_whole,
         tcn_fused.fused_block_group_whole_ref, 20,
         ((4, 250), (1, 1), (3, 37), (96, 625))),
        ("fused_block_group", tiled_groups(tcn_fused.fused_block_group),
         tiled_groups(tcn_fused.fused_block_group_ref), 10, ((4, 1250), (1, 1100))),
    )
    for kname, kernel, ref, G, shapes_ in cases:
        ws = {64: tcn_fused.random_block_weights(G, gen, dev)}
        # d_f 128: weights too wide to stage beside the window, read from memory
        ws[128] = tcn_fused.random_block_weights(G, gen, dev, d_f=128)
        for (B, T), d_f in [(bt, 64) for bt in shapes_] + [((2, 300), 128)]:
            w = ws[d_f]
            x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(dev)
            y, y_ref = kernel(x, w, dil[:G]), ref(x, w, dil[:G])
            torch.cuda.synchronize()
            err = (y - y_ref).abs().max().item()
            scale = y_ref.abs().max().item()
            print(f"[2] {kname}: B={B} T={T} G={G} d_f {d_f}: max abs err {err:.3e}, "
                  f"max rel err {err / scale:.3e} (tol {KERNEL_TOL_REL:.0e} rel), "
                  f"finite {bool(torch.isfinite(y).all())}")
            if not (err <= KERNEL_TOL_REL * scale and torch.isfinite(y).all()):
                fail(f"{kname} disagrees with its plain version")
            checks[kname] = max(checks.get(kname, 0.0), err)
            if (B, T, d_f) == (4, 250, 64):  # f32 accuracy of the split products
                y64 = ref(x.double(), [tcn_fused.BlockWeights(*(t.double() for t in bw))
                                       for bw in w], dil[:G])
                print(f"[2] {kname}: B={B} T={T} G={G}: from float64, the kernel "
                      f"{(y - y64).abs().max().item() / y64.abs().max().item():.3e} and "
                      f"plain f32 {(y_ref - y64).abs().max().item() / y64.abs().max().item():.3e}"
                      f" of scale")

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
    dh2, dw2 = tcn_fused_train.fused_block_group_bwd(x, dout, w, dil[:G], saved_h=hs)
    again = all(torch.equal(a, b) for a, b in
                zip(modes["saved"], [dh2] + [a for g in range(G) for a in dw2[g]]))
    print(f"[2] fused_block_group_bwd: replay and saved modes bitwise equal: {same}; "
          f"a second saved call bitwise equal (fixed-order split sums): {again}")
    if not (same and again):
        fail("fused_block_group_bwd is not bitwise the same across modes and calls")

    # the MHANet kernels at full width, inputs with padded tails of zero
    # frames (invalid), every row compared
    def padded(B, T, lengths):
        return torch.arange(T)[None, :] < torch.as_tensor(lengths)[:, None]

    def heads(B, T, lengths):
        """q (scaled), k, v [B, T, 8, 32], zero past each length, and valid."""
        valid = padded(B, T, lengths)
        q, k, v = (torch.randn(B, T, 8, 32, generator=gen) * valid[:, :, None, None]
                   for _ in range(3))
        return [t.to(dev) for t in (q * 32 ** -0.5, k, v, valid)]

    def check(kname, label, y, y_ref, per_row=False):
        """y within KERNEL_TOL_REL of y_ref's max abs (with `per_row`, of each
        row's own max abs)."""
        torch.cuda.synchronize()
        diff = (y - y_ref).abs()
        err = diff.max().item()
        rel = ((diff.amax(-1) / y_ref.abs().amax(-1).clamp_min(1e-30)).max().item()
               if per_row else err / y_ref.abs().max().item())
        print(f"[2] {kname}: {label}: max abs err {err:.3e}, max rel err "
              f"{'of a row ' if per_row else ''}{rel:.3e} (tol {KERNEL_TOL_REL:.0e} rel), "
              f"finite {bool(torch.isfinite(y).all())}")
        if not (rel <= KERNEL_TOL_REL and torch.isfinite(y).all()):
            fail(f"{kname} disagrees with its plain version")
        checks[kname] = max(checks.get(kname, 0.0), err)

    # the block at the main path's shapes (B=1 T=250: 16-row slabs, the post
    # kernel a cluster of 8 CTAs a slab; B=64 T=625: 64-row CTAs) and at the
    # edges: part of one slab (T = 1, 17), 111 rows, every row invalid
    w_mha = mha_block_fused.random_block_weights(gen, dev)
    for B, T, lengths, pad in ((4, 250, [250, 250, 201, 128], 128),
                               (4, 2048, [2048, 1990, 1500, 700], 128),
                               (1, 250, [250], 128), (64, 625, [625] * 64, 128),
                               (1, 1, [1], 1), (1, 17, [17], 1), (3, 37, [37, 20, 5], 1),
                               (2, 17, [0, 0], 1), (2, 250, [250, 83], 128)):
        Tp = -(-T // pad) * pad
        valid = padded(B, Tp, lengths)
        x = (torch.randn(B, Tp, 256, generator=gen) * valid[:, :, None]).to(dev)
        vf = valid[:, None, :].float().to(dev)
        for causal in (True, False) if B < 64 else (True,):
            check("fused_transformer_block", f"B={B} T={T} (Tp {Tp}, lengths "
                  f"{lengths if B < 5 else '...'}), causal {causal}, launch shapes "
                  f"{mha_block_fused.block_grid(B, Tp)}",
                  mha_block_fused.fused_transformer_block(x, vf, w_mha, causal),
                  mha_block_fused.fused_transformer_block_ref(x, vf, w_mha, causal))

    def from_f64(kname, label, y, y_ref, y64, valid):
        """The kernel's and plain f32's distance from float64 over the valid
        rows, of float64's scale there (an invalid row's -1e10 mask is exact
        in float64 and absorbs q.k in f32, so those rows differ by design)."""
        torch.cuda.synchronize()
        m = valid.to(dev)
        scale = y64[m].abs().max().item()
        e_k, e_p = ((t.double() - y64)[m].abs().max().item() / scale for t in (y, y_ref))
        print(f"[2] {kname}: {label}: from float64 on the valid rows, the kernel "
              f"{e_k:.3e} and plain f32 {e_p:.3e} of scale (tol {KERNEL_TOL_REL:.0e})")
        if not e_k <= KERNEL_TOL_REL:
            fail(f"{kname} is further than {KERNEL_TOL_REL:.0e} of scale from float64")

    # f32 accuracy of the split products on the card: the block at B=1
    # T=250 (Tp 256) and the attention at B=4 T=250
    valid = padded(1, 256, [250])
    x = (torch.randn(1, 256, 256, generator=gen) * valid[:, :, None]).to(dev)
    vf = valid[:, None, :].float().to(dev)
    w64 = mha_block_fused.BlockWeights(*(t.double() for t in w_mha))
    from_f64("fused_transformer_block", "B=1 T=250 (Tp 256), causal",
             mha_block_fused.fused_transformer_block(x, vf, w_mha, True),
             mha_block_fused.fused_transformer_block_ref(x, vf, w_mha, True),
             mha_block_fused.fused_transformer_block_ref(x.double(), vf.double(), w64, True),
             valid)
    q, k, v, valid = heads(4, 250, [250, 230, 128, 61])
    from_f64("flash_attention", "B=4 T=250 (lengths [250, 230, 128, 61]), causal",
             mha_fused.flash_attention(q, k, v, valid, True),
             mha_fused.flash_attention_ref(q, k, v, valid, True),
             mha_fused.flash_attention_ref(q.double(), k.double(), v.double(), valid, True),
             valid.cpu())
    attention_cases = (
        ("flash_attention", mha_fused.flash_attention, mha_fused.flash_attention_ref,
         {}, 4, ((250, [250, 230, 128, 61]), (700, [700, 650, 333, 64]))),
        ("flash_attention_streaming", mha_flash_stream.flash_attention_streaming,
         mha_flash_stream.flash_attention_streaming_ref,
         {"block_q": 256, "block_k": 512}, 2, ((2250, [2250, 1700]),)))
    for kname, kernel, ref, kw, B, shapes_ in attention_cases:
        for T, lengths in shapes_:
            q, k, v, valid = heads(B, T, lengths)
            for causal in (True, False):
                check(kname, f"B={B} T={T} (lengths {lengths}) {kw or ''}, "
                      f"causal {causal}", kernel(q, k, v, valid, causal, **kw),
                      ref(q, k, v, valid, causal, **kw))
    # edge shapes of the attention kernel: part of one 16-row slab (T = 1,
    # 17), every row invalid (with values: each row the mean of the keys it
    # visits), a second row a third as long; the streaming kernel also at
    # 64/128 tiles
    for B, T, lengths in ((1, 1, [1]), (1, 17, [17]), (2, 17, [0, 0]),
                          (2, 250, [250, 83])):
        q, k, v, valid = heads(B, T, lengths)
        if not any(lengths):
            q, k, v = (torch.randn(q.shape, generator=gen).to(dev) for _ in range(3))
        for kname, kernel, ref, kw, _, _ in attention_cases:
            for kw_ in (kw, {"block_q": 64, "block_k": 128}) if kw else (kw,):
                for causal in (True, False):
                    check(kname, f"B={B} T={T} (lengths {lengths}) {kw_ or ''}, "
                          f"causal {causal}", kernel(q, k, v, valid, causal, **kw_),
                          ref(q, k, v, valid, causal, **kw_))

    # the KV-cache step: rows past the clock hold values, so only the mask
    # (or, in the kernel, the n_valid limit) leaves them out
    q = (torch.randn(3, 8, 32, generator=gen) * 32 ** -0.5).to(dev)
    kv = [torch.randn(3, 2048, 8, 32, generator=gen).to(dev) for _ in range(2)]
    for dtype in (torch.float32, torch.bfloat16):
        kc, vc = (c.to(dtype) for c in kv)
        for t in (0, 700, 2047, 2500):
            check("mha_cache_step", f"B=3 L=2048 {dtype} caches, t={t}",
                  mha_cache.mha_cache_step(q, kc, vc, t),
                  mha_cache.mha_cache_step_ref(q, kc, vc, t))
    del kv, kc, vc

    # the pack2 kernel: an odd B gives the last CTA a zero second row; the
    # rows differ, so a pair's rows swapped would show. Two windows of 32
    # rows and the d = 16 reach do not fit beside the weights, so every
    # shape takes the 16-row tile.
    w = tcn_fused.random_block_weights(20, gen, dev)
    pack2_rows = tcn_fused._lib(256, 64, 3).tcn_max_window_rows(0)
    for B, T in ((3, 250), (3, 1024), (4, 250), (4, 1024), (96, 625)):
        x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(dev)
        for ln in tcn_fused.PACK2_LN_MODES:
            check("fused_block_group_whole_pack2",
                  f"B={B} T={T} G=20 ({tcn_fused._pack2_tile(x, 32, pack2_rows)}-row "
                  f"tiles), ln_mode {ln}",
                  tcn_fused.fused_block_group_whole_pack2(x, w, dil[:20], ln_mode=ln),
                  tcn_fused.fused_block_group_whole_pack2_ref(x, w, dil[:20], ln_mode=ln))
    # the spectral kernels on a random waveform's hop rows and spectrum at
    # each (N_s, K) of the tests (the main path's 512: 257 bins and 514
    # spectrum columns, no multiple of 4; N_d < K with N_s = 200), every row
    # held to the gate; T = 1 takes one frame a CTA, 250 and 625 (ragged) four
    for N_s, K in SPECTRAL_SHAPES:
        N_d = 2 * N_s
        for T in (1, 250, 625):
            wave = (torch.randn(4, T * N_s, generator=gen) * 0.1).to(dev)
            x2d, Y = hop_rows(wave, N_s), stft_reim(wave, N_d, N_s, K)
            gain = torch.rand(4, T, K // 2 + 1, generator=gen).to(dev)
            check("stft_mag_fused", f"B=4 T={T} N_s={N_s} K={K}",
                  spectral.stft_mag_fused(x2d, N_d, K),
                  spectral.stft_mag_fused_ref(x2d, N_d, K), per_row=True)
            check("enhance_frames_fused", f"B=4 T={T} N_s={N_s} K={K}, gain in [0, 1]",
                  spectral.enhance_frames_fused(Y, gain, N_d, N_s, K),
                  spectral.enhance_frames_fused_ref(Y, gain, N_d, N_s, K), per_row=True)

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

    # 3c. the MHANet path ---------------------------------------------------
    art_m = load_artifact(device=dev)
    mha_counted = {"fused_transformer_block": mha_block_fused.fused_transformer_block,
                   "flash_attention": mha_fused.flash_attention,
                   "flash_attention_streaming": mha_flash_stream.flash_attention_streaming}
    counted.update(mha_counted)
    utts_m = {"c012_white_5dB": (art_m.noisy, art_m.clean),
              "c012_white_5dB_x9": (np.tile(art_m.noisy, 9), np.tile(art_m.clean, 9))}
    tmp = tempfile.mkdtemp(prefix="deepxi_chip_smoke_mha_")
    try:
        dirs = {k: os.path.join(tmp, k) for k in ("test", "test_4s", "data")}
        for utt, (x, _) in utts_m.items():
            save_wav(os.path.join(dirs["test"], utt + ".wav"), x, 16000)
        save_wav(os.path.join(dirs["test_4s"], "c012_white_5dB.wav"), art_m.noisy, 16000)
        os.makedirs(dirs["data"])
        shutil.copy(os.path.join(MHANET_ROOT, "stats.npz"),
                    os.path.join(dirs["data"], "mhanet-1.1c_stats.npz"))
        cfg_m = preset("mhanet-1.1c", data_path=dirs["data"],
                       out_path=os.path.join(tmp, "out"))
        runs = {}
        for impl, test_dir in (("full", dirs["test"]), ("fused", dirs["test_4s"])):
            dx_m = DeepXiTorch(cfg_m.replace(attention_impl=impl,
                                             out_path=os.path.join(tmp, "out", impl)),
                               device=dev)
            for fn in counted.values():
                fn.launches = 0
            t0 = time.perf_counter()
            written = dx_m.infer(params=art_m.params, test_x_path=test_dir)
            torch.cuda.synchronize()
            n = {k: fn.launches for k, fn in mha_counted.items()}
            print(f"[3c] DeepXiTorch(preset('mhanet-1.1c', attention_impl={impl!r}))"
                  f".infer(): {len(written)} wavs in {(time.perf_counter() - t0) * 1e3:.1f} "
                  f"ms; launches {n}")
            runs[impl] = (dx_m, {os.path.basename(p)[:-4]: p for p in written}, n)
        launches.update({k: runs["full"][2][k] for k in
                         ("fused_transformer_block", "flash_attention_streaming")})
        launches["flash_attention"] = runs["fused"][2]["flash_attention"]
        for kname in mha_counted:
            if launches[kname] < 1:
                fail(f"{kname} was not launched on its route through DeepXiTorch.infer")

        enhance_plain_m = make_enhancer(art_m.inp_tgt, art_m.net, "mmse-lsa", device=dev)
        for label, impl, utt in (("4 s, fused transformer blocks", "full", "c012_white_5dB"),
                                 ("36 s, streaming attention", "full", "c012_white_5dB_x9"),
                                 ("4 s, flash_attention", "fused", "c012_white_5dB")):
            dx_m, written, _ = runs[impl]
            x, clean = utts_m[utt]
            xp = np.zeros((1, bucket_length(len(x), 256)), np.int16)
            xp[0, :len(x)] = x
            mag = stft_mag(normalise(torch.as_tensor(xp, device=dev)), 512, 256, 512)
            apply = dx_m.fast_apply() or (
                lambda p, m: functional_call(dx_m.network, p, (m,)))  # noqa: B023
            with torch.no_grad():
                valid = sequence_valid_mask(mag)[0]
                net_err = (apply(art_m.params, mag) - art_m.net(mag))[0][valid].abs().max().item()
            n_out = (-(-len(x) // 256) + 1) * 256
            y_plain = enhance_plain_m(art_m.params, xp)[0, :n_out].cpu().numpy()
            y_plain = np.asarray(y_plain * 32768.0, np.int16) / 32768.0  # as save_wav
            y = read_wav(written[utt])[0] / 32768.0
            w_err = np.abs(y - y_plain).max()
            w_rel = np.sqrt(np.mean((y - y_plain) ** 2) / np.mean(y_plain ** 2))
            snr_noisy, snr_enh = snr_db(clean, x / 32768.0), snr_db(clean, y)
            print(f"[3c] {label}: T={mag.shape[1]} ({int(valid.sum())} valid frames), "
                  f"wav {y.shape[0]} samples; net max abs err on valid frames "
                  f"{net_err:.3e} (tol {NET_ATOL:.0e}), wave max abs err {w_err:.3e} (tol "
                  f"{WAVE_ATOL:.0e}), rel RMS {w_rel:.3e} (tol {WAVE_REL_RMS:.0e}); "
                  f"SNR noisy {snr_noisy:.3f} dB -> enhanced {snr_enh:.3f} dB")
            if not np.isfinite(y).all() or y.shape[0] != n_out:
                fail(f"{label}: output not finite or of the wrong length")
            if net_err > NET_ATOL or w_err > WAVE_ATOL or w_rel > WAVE_REL_RMS:
                fail(f"{label}: the kernel route disagrees with the plain MHANetV3")
            if snr_enh <= snr_noisy:
                fail(f"{label}: enhanced SNR does not beat noisy SNR")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

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

    # 3d. the streaming path --------------------------------------------------
    def stream_steps(s, wav, launches_per_step=None):
        """prime, a step per hop after the first and one on a zero chunk;
        with `launches_per_step`, every step must add that many launches of
        the KV-cache kernel."""
        xd = torch.as_tensor(wav, device=dev)[None]
        state = s.prime(s.init_state(1), xd[:, :256])
        outs = []
        for i in range(1, xd.shape[1] // 256 + 1):
            n0 = mha_cache.mha_cache_step.launches
            chunk = xd[:, i * 256:(i + 1) * 256] if i < xd.shape[1] // 256 else \
                torch.zeros(1, 256, dtype=xd.dtype, device=dev)
            state, y = s.step(state, chunk)
            outs.append(y)
            if (launches_per_step is not None
                    and mha_cache.mha_cache_step.launches - n0 != launches_per_step):
                fail(f"hop {i}: the KV-cache kernel launched "
                     f"{mha_cache.mha_cache_step.launches - n0} times, not {launches_per_step}")
        torch.cuda.synchronize()
        return torch.cat(outs, dim=1)[0]

    def stream_blocks(s, wav, H):
        """prime, then `step_block` over the hops after the first and one
        zero chunk, H hops a call (a shorter last block)."""
        xd = torch.as_tensor(wav, device=dev)[None]
        rest = torch.cat([xd[:, 256:], torch.zeros(1, 256, dtype=xd.dtype, device=dev)], 1)
        state = s.prime(s.init_state(1), xd[:, :256])
        outs = []
        for i in range(0, rest.shape[1], 256 * H):
            state, y = s.step_block(state, rest[:, i:i + 256 * H])
            outs.append(y)
        torch.cuda.synchronize()
        return torch.cat(outs, dim=1)[0]

    def wave_errs(y, ref):
        return ((y - ref).abs().max().item(),
                ((y - ref).square().mean() / ref.square().mean()).sqrt().item())

    counted["mha_cache_step"] = mha_cache.mha_cache_step
    for label, art_s, offline, ctor in (
            ("mhanet-1.1c, StreamingMHANet(fused=True)", art_m, enhance_plain_m,
             lambda a, **kw: StreamingMHANet(a.inp_tgt, a.net, a.params, fused=True,
                                             device=dev, **kw)),
            ("resnet-1.1c, StreamingEnhancer", art, enhance_plain,
             lambda a, **kw: StreamingEnhancer(a.inp_tgt, a.net, a.params, device=dev))):
        s = ctor(art_s)
        n_hops = art_s.noisy.shape[0] // 256
        is_mha = isinstance(s, StreamingMHANet)
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        y = stream_steps(s, art_s.noisy, len(s.blocks) if is_mha else None)
        wall = time.perf_counter() - t0
        n = {k: fn.launches for k, fn in counted.items() if fn.launches}
        if is_mha:
            launches["mha_cache_step"] = n.get("mha_cache_step", 0)
            if launches["mha_cache_step"] != len(s.blocks) * n_hops:
                fail("the KV-cache kernel did not launch once a block and hop")
        y_off = offline(art_s.params, art_s.noisy[None])[0, :y.shape[0]]
        w_err, w_rel = wave_errs(y, y_off)
        y_np = y.cpu().numpy()
        snr_noisy, snr_enh = snr_db(art_s.clean, art_s.noisy / 32768.0), snr_db(art_s.clean, y_np)
        print(f"[3d] {label}: {n_hops} hops in {wall:.2f} s ({wall / n_hops * 1e3:.2f} ms a "
              f"hop), launches {n}; wave against the offline enhancer: max abs err "
              f"{w_err:.3e} (tol {WAVE_ATOL:.0e}), rel RMS {w_rel:.3e} (tol "
              f"{WAVE_REL_RMS:.0e}); SNR noisy {snr_noisy:.3f} dB -> enhanced {snr_enh:.3f} dB")
        if not np.isfinite(y_np).all() or y.shape[0] != n_hops * 256:
            fail(f"{label}: output not finite or of the wrong length")
        if w_err > WAVE_ATOL or w_rel > WAVE_REL_RMS:
            fail(f"{label}: the stream disagrees with the offline enhancer")
        if snr_enh <= snr_noisy:
            fail(f"{label}: enhanced SNR does not beat noisy SNR")
        if not is_mha:
            continue
        variants = (
            ("bf16 caches against the f32 stream", BF16_ATOL, BF16_REL_RMS,
             stream_steps(ctor(art_s, cache_dtype=torch.bfloat16), art_s.noisy)),
            ("step_block of 8 hops against the steps", WAVE_ATOL, WAVE_REL_RMS,
             stream_blocks(s, art_s.noisy, 8)),
            ("fused=False against fused=True", WAVE_ATOL, WAVE_REL_RMS,
             stream_steps(StreamingMHANet(art_s.inp_tgt, art_s.net, art_s.params,
                                          device=dev), art_s.noisy)))
        for what, atol, rel_tol, y_v in variants:
            err, rel = wave_errs(y_v, y)
            print(f"[3d] {label}, {what}: max abs err {err:.3e} (tol {atol:.0e}), "
                  f"rel RMS {rel:.3e} (tol {rel_tol:.0e})")
            if not (torch.isfinite(y_v).all() and err <= atol and rel <= rel_tol):
                fail(f"{label}: {what} disagrees")

    # 3e. the last three kernels' paths ---------------------------------------
    counted.update({"fused_block_group_whole_pack2": tcn_fused.fused_block_group_whole_pack2,
                    "stft_mag_fused": spectral.stft_mag_fused,
                    "enhance_frames_fused": spectral.enhance_frames_fused})

    def counts():
        return {k: fn.launches for k, fn in counted.items() if fn.launches}

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0

    # B=96 distinct 10 s rows (each the utterance tiled and rotated), T=625
    long = np.tile(art.noisy, -(-160000 // art.noisy.shape[0]))[:160000]
    batches = {"4 s, B=1 T=250": art.noisy[None],
               "B=96 x 10 s, T=625": np.stack([np.roll(long, 997 * i) for i in range(96)])}
    y_fused = {k: enhance(art.params, x) for k, x in batches.items()}
    y_plain = {k: enhance_plain(art.params, x) for k, x in batches.items()}

    def hold(label, y, k, against):
        """y (batch k) against the unpacked fused and/or plain waveforms and,
        for the 4 s utterance, the noisy SNR."""
        msg = []
        for what, ref in against:
            err, rel = wave_errs(y, ref[k])
            msg.append(f"against {what}: max abs err {err:.3e}, rel RMS {rel:.3e}")
            if not (torch.isfinite(y).all() and y.shape == ref[k].shape
                    and err <= WAVE_ATOL and rel <= WAVE_REL_RMS):
                fail(f"{label}, {k}: disagrees with {what}")
        if k.startswith("4 s"):
            snr_noisy = snr_db(art.clean, art.noisy / 32768.0)
            snr_enh = snr_db(art.clean, y[0].cpu().numpy())
            msg.append(f"SNR noisy {snr_noisy:.3f} dB -> enhanced {snr_enh:.3f} dB")
            if snr_enh <= snr_noisy:
                fail(f"{label}, {k}: enhanced SNR does not beat noisy SNR")
        print(f"[3e] {label}, {k}: " + "; ".join(msg) + f" (tol {WAVE_ATOL:.0e}, "
              f"{WAVE_REL_RMS:.0e})")

    # (a) resnet-1.1c enhancement through the pack2 kernel
    for ln in tcn_fused.PACK2_LN_MODES:
        apply_p2 = (lambda p, m, ln=ln: tcn_fused.resnetv2_apply_fused(
            p, m, pack2=True, pack2_ln=ln))
        enhance_p2 = make_enhancer(art.inp_tgt, art.net, "mmse-lsa", apply_fn=apply_p2,
                                   device=dev)
        zero_counts()
        outs = {k: enhance_p2(art.params, x) for k, x in batches.items()}
        torch.cuda.synchronize()
        n = counts()
        print(f"[3e] resnet-1.1c enhance, resnetv2_apply_fused(pack2=True, pack2_ln={ln!r}): "
              f"launches {n}")
        if n.get("fused_block_group_whole_pack2", 0) < 1 or "fused_block_group_whole" in n:
            fail("the pack2 route did not go through the pack2 kernel alone")
        launches.setdefault("fused_block_group_whole_pack2",
                            n["fused_block_group_whole_pack2"])
        for k in batches:
            hold(f"pack2 ({ln})", outs[k], k, (("the unpacked fused route", y_fused),
                                               ("the plain path", y_plain)))
    del outs

    # (b) the xi-hat estimator with the fast path's network on both artifacts
    tmp = tempfile.mkdtemp(prefix="deepxi_chip_smoke_xi_")
    try:
        shutil.copy(os.path.join(FLAGSHIP_ROOT, "stats.npz"),
                    os.path.join(tmp, "resnet-1.1c_stats.npz"))
        dx_r = DeepXiTorch(preset("resnet-1.1c", data_path=tmp), device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, art_x, dxi in (("resnet-1.1c", art, dx_r), ("mhanet-1.1c", art_m, runs["full"][0])):
        seen = {}

        def apply_seen(p, m, fast=dxi.fast_apply(), seen=seen):
            seen["tgt"] = fast(p, m)
            return seen["tgt"]
        estimate = make_xi_estimator(art_x.inp_tgt, art_x.net, apply_fn=apply_seen, device=dev)
        zero_counts()
        xi = estimate(art_x.params, art_x.noisy[None])
        torch.cuda.synchronize()
        n = counts()
        if n.get("stft_mag_fused") != 1:
            fail(f"{label} estimator: stft_mag_fused launched {n.get('stft_mag_fused', 0)} "
                 "times, not once")
        launches.setdefault("stft_mag_fused", n["stft_mag_fused"])
        with torch.no_grad():
            x = normalise(torch.as_tensor(art_x.noisy[None], device=dev))
            mag_p = spectral.stft_mag_fused_ref(hop_rows(x, 256), 512, 512)
            tgt_p = art_x.net(mag_p)
        valid = sequence_valid_mask(mag_p)[0]
        net_err = (seen["tgt"] - tgt_p)[0][valid].abs().max().item()
        mid = (tgt_p >= 1e-3) & (tgt_p <= 1 - 1e-3)
        xi_db = (10 * torch.log10(xi / art_x.inp_tgt.xi_hat(tgt_p)))[mid].abs().max().item()
        print(f"[3e] {label} make_xi_estimator(fast_apply()): xi_hat {tuple(xi.shape)}, "
              f"launches {n}; network output against the plain route (plain |X|, plain "
              f"network) on {int(valid.sum())} valid frames: max abs err {net_err:.3e} (tol "
              f"{NET_ATOL:.0e}); largest xi_hat difference {xi_db:.3e} dB over the "
              f"{mid.float().mean().item():.1%} of bins whose output lies in [1e-3, 1-1e-3]")
        if not (torch.isfinite(xi).all() and xi.shape == tgt_p.shape) or net_err > NET_ATOL:
            fail(f"{label} estimator disagrees with its plain route")

    # (c) the spectral-kernel route of resnet-1.1c enhancement
    def spectral_route(x_int16):
        x = normalise(torch.as_tensor(x_int16, device=dev))
        with torch.no_grad():
            mag = spectral.stft_mag_fused(hop_rows(x, 256), 512, 512)
            xi_hat = art.inp_tgt.xi_hat(fused(art.params, mag))
            frames = spectral.enhance_frames_fused(
                stft_reim(x, 512, 256, 512), gfunc(xi_hat, xi_hat + 1.0, "mmse-lsa"),
                512, 256, 512)
        return overlap_and_add(frames, 256)

    zero_counts()
    outs = {k: spectral_route(x) for k, x in batches.items()}
    torch.cuda.synchronize()
    n = counts()
    print(f"[3e] spectral-kernel route of resnet-1.1c enhancement: launches {n}")
    if n.get("stft_mag_fused") != 2 or n.get("enhance_frames_fused") != 2:
        fail("the spectral-kernel route did not launch each spectral kernel once a call")
    launches["enhance_frames_fused"] = n["enhance_frames_fused"]
    for k in batches:
        hold("spectral-kernel route", outs[k], k, (("make_enhancer's waveform", y_fused),))
    del outs, y_plain

    # 3f. the fault C1: every width runs its own kernels --------------------
    # The kernels are built for each set of widths. (a) Each kernel at small
    # widths (TCN 32/16/3 and 48/12/2, MHANet 4 heads of 8 and 12 heads of 4)
    # against its plain version. (b) The routes at d_model 32, counted:
    # resnet-1.1c (d_f 16, 3 blocks) through `DeepXiTorch.train` and
    # `infer`, an MHANetV3 with 4 heads of 8 through `mhanetv3_apply_fused`
    # and "full", "fused" and "stream" attention, and
    # StreamingMHANet(fused=True); each of their kernels must launch, and the
    # card must give the CPU's results (tools/torch_small_widths.py).
    c1_checks = torch_small_widths.kernel_checks(dev)
    for name, err in c1_checks.items():
        tol = torch_small_widths.BWD_TOL_REL if "bwd" in name else KERNEL_TOL_REL
        print(f"[3f] {name}: max rel err {err:.3e} (tol {tol:.0e})")
        if not err <= tol:
            fail(f"{name} disagrees with its plain version")
    tmp = tempfile.mkdtemp(prefix="deepxi_chip_smoke_c1_")
    try:
        zero_counts()
        t0 = time.perf_counter()
        got = torch_small_widths.small_widths_run(dev, tmp)
        torch.cuda.synchronize()
        n, wall = counts(), time.perf_counter() - t0
        ref = torch_small_widths.small_widths_run("cpu", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [k for k in torch_small_widths.ROUTE_KERNELS if not n.get(k)]
    c1_rel, c1_worst, wav_steps = torch_small_widths.compare_runs(got, ref)
    print(f"[3f] d_model 32 on the card ({wall:.1f} s): {len(got)} outputs (resnet-1.1c "
          f"train and infer, MHANetV3 fused blocks and full/fused/stream attention, "
          f"StreamingMHANet(fused=True)); launches {n}; against the CPU: worst rel err "
          f"{c1_rel:.3e} ({c1_worst}; tol {KERNEL_TOL_REL:.0e}), written wavs within "
          f"{wav_steps:g} int16 steps (tol 1)")
    if missing:
        fail(f"no launch at d_model 32 of {missing}")
    if not (c1_rel <= KERNEL_TOL_REL and wav_steps <= 1):
        fail("the card's results at d_model 32 differ from the CPU's")

    # 4. times --------------------------------------------------------------
    print(f"[4] times on {card}")
    kernels = []
    # five blocks (dilations 1..16) a timed call; the halo-tiled route takes
    # them TILED_GROUP blocks a launch
    shapes = {"fused_block_group_whole": [(1, 250), (96, 625)],
              "fused_block_group": [(1, 1250), (96, 625)]}
    G = 5
    for kname, kernel, ref, _, _ in cases:
        w = tcn_fused.random_block_weights(G, gen, dev)
        row = {"name": kname, "route": "cuda",
               "source": "deepxi_tpu_torch/ops/kernels/csrc/tcn_fused.cu",
               "replaces": ("deepxi_tpu/ops/kernels/tcn_fused.py:57"
                            if kname.endswith("whole")
                            else "deepxi_tpu/ops/kernels/tcn_fused.py:289"),
               "launches": launches[kname], "max_abs_err": checks[kname]}
        for i, (B, T) in enumerate(shapes[kname]):
            x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(dev)
            ms = cuda_ms(lambda: kernel(x, w, dil[:G]))
            dev_ms, ops = device_ms(lambda: kernel(x, w, dil[:G]))
            plain = cuda_ms(lambda: ref(x, w, dil[:G]))
            bound, by = bound_ms(B, T, G)
            tc = bound_ms(B, T, G, PEAK_TF32X3_FLOPS)[0]
            print(f"[4] {kname}: {G} blocks at B={B} T={T}: "
                  f"{ms:.4f} ms (device only {dev_ms:.4f} ms, {ops:g} operations); "
                  f"plain {plain:.4f} ms; bound {bound:.4f} ms ({by}); "
                  f"{bound / ms:.1%} of the bound; tensor-core bound {tc:.4f} ms, "
                  f"{tc / ms:.1%} of it")
            keys = (dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound,
                         bound_by=by, tc_bound_ms=tc, library_ms=None,
                         shape={"B": B, "T": T, "G": G})
                    if i == 0 else {"at_b96_t625": dict(ms=ms, device_ms=dev_ms,
                                                         plain_ms=plain, bound_ms=bound,
                                                         tc_bound_ms=tc)})
            row.update(keys)
        kernels.append(row)

    # pack2 (both LayerNorm modes) against the unpacked kernel, in turns
    row = {"name": "fused_block_group_whole_pack2", "route": "cuda",
           "source": "deepxi_tpu_torch/ops/kernels/csrc/tcn_fused.cu",
           "replaces": "deepxi_tpu/ops/kernels/tcn_fused.py:160",
           "launches": launches["fused_block_group_whole_pack2"],
           "max_abs_err": checks["fused_block_group_whole_pack2"]}
    pack2 = tcn_fused.fused_block_group_whole_pack2
    for i, (B, T) in enumerate(shapes["fused_block_group_whole"]):
        x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(dev)
        unpacked = [cuda_ms(lambda: tcn_fused.fused_block_group_whole(x, w, dil[:G]))]
        ms = cuda_ms(lambda: pack2(x, w, dil[:G]))
        dev_ms, ops = device_ms(lambda: pack2(x, w, dil[:G]))
        ms_mm = cuda_ms(lambda: pack2(x, w, dil[:G], ln_mode="matmul"))
        unpacked.append(cuda_ms(lambda: tcn_fused.fused_block_group_whole(x, w, dil[:G])))
        plain = cuda_ms(lambda: tcn_fused.fused_block_group_whole_pack2_ref(x, w, dil[:G]))
        bound, by = bound_ms(B, T, G)
        tc = bound_ms(B, T, G, PEAK_TF32X3_FLOPS)[0]
        print(f"[4] fused_block_group_whole_pack2: one call of G={G} blocks at B={B} T={T}: "
              f"{ms:.4f} ms (slice; device only {dev_ms:.4f} ms, {ops:g} operations), "
              f"{ms_mm:.4f} ms (matmul); unpacked kernel "
              f"{unpacked[0]:.4f}, {unpacked[1]:.4f} ms (before, after); plain {plain:.4f} "
              f"ms; bound {bound:.4f} ms ({by}); {bound / ms:.1%} of the bound")
        times = dict(ms=ms, device_ms=dev_ms, tc_bound_ms=tc, matmul_ms=ms_mm, plain_ms=plain, bound_ms=bound, bound_by=by,
                     library_ms=None, unpacked_ms=float(np.mean(unpacked)),
                     shape={"B": B, "T": T, "G": G})
        row.update(times if i == 0 else {"at_b96_t625": times})
    kernels.append(row)

    # the spectral kernels. Their bound is the functions' least work: an FFT
    # takes ~2.5 K log2 K FLOP a frame, far under the bytes, so bytes bound
    # them. Two yardsticks, each checked against the kernel first: cuFFT
    # (torch.stft, torch.fft.irfft) and the port's matmul formulation.
    w_ana = torch.as_tensor(_hamming_np(512), device=dev)
    w_syn = torch.as_tensor(_synthesis_window_np(512, 256), device=dev)
    fft_flops = 2.5 * 512 * np.log2(512)
    for kname, src_line in (("stft_mag_fused", 116), ("enhance_frames_fused", 168)):
        row = {"name": kname, "route": "cuda",
               "source": "deepxi_tpu_torch/ops/kernels/csrc/spectral.cu",
               "replaces": f"deepxi_tpu/ops/kernels/spectral.py:{src_line}",
               "launches": launches[kname], "max_abs_err": checks[kname]}
        for i, (B, T) in enumerate(((1, 250), (96, 625))):
            wave = (torch.randn(B, T * 256, generator=gen) * 0.1).to(dev)
            if kname == "stft_mag_fused":
                x2d = hop_rows(wave, 256)
                x1d = x2d.reshape(B, -1)
                fns = (lambda: spectral.stft_mag_fused(x2d, 512, 512),  # noqa: B023
                       lambda: spectral.stft_mag_fused_ref(x2d, 512, 512),  # noqa: B023
                       lambda: torch.stft(x1d, 512, 256, 512, w_ana, center=False,  # noqa: B023
                                          return_complex=True).abs().transpose(1, 2),
                       lambda: stft_mag(wave, 512, 256, 512))  # noqa: B023
                lib_names = ("torch.stft (cuFFT) + abs",
                             "stft_mag (framing, torch.matmul, magnitude)")
                flops = B * T * (512 + fft_flops + 3 * 257)
                nbytes = 4 * (B * (T + 1) * 256 + B * T * 257 + 512)
            else:
                Y = stft_reim(wave, 512, 256, 512)
                gain = torch.rand(B, T, 257, generator=gen).to(dev)
                S = spectral._on_device("synthesis", (512, 256, 512), dev)
                fns = (lambda: spectral.enhance_frames_fused(Y, gain, 512, 256, 512),  # noqa: B023
                       lambda: spectral.enhance_frames_fused_ref(Y, gain, 512, 256, 512),  # noqa: B023
                       lambda: torch.fft.irfft(torch.complex(Y[..., :257], Y[..., 257:])  # noqa: B023
                                               * gain, n=512) * w_syn,  # noqa: B023
                       lambda: torch.matmul(apply_gain_reim(Y, gain, 512), S))  # noqa: B023
                lib_names = ("gain x complex spectrum, torch.fft.irfft (cuFFT), window",
                             "apply_gain_reim + torch.matmul")
                flops = B * T * (2 * 257 + fft_flops + 512)
                nbytes = 4 * (B * T * (514 + 257 + 512) + 512)
            y = fns[0]()
            lib_rel = [((f() - y).abs().max() / y.abs().max()).item() for f in fns[2:]]
            for name, rel in zip(lib_names, lib_rel):
                if rel > LIB_TOL_REL:
                    fail(f"{name} is not {kname}'s function ({rel:.3e})")
            # in turns: kernel, cuFFT, kernel, cuFFT; then plain and matmul
            ms_runs, lib_runs = [], []
            for _ in range(2):
                ms_runs.append(cuda_ms(fns[0]))
                lib_runs.append(cuda_ms(fns[2]))
            plain, lib_mm = cuda_ms(fns[1]), cuda_ms(fns[3])
            ms, lib = float(np.mean(ms_runs)), float(np.mean(lib_runs))
            bound, by = roofline_ms(flops, nbytes)
            print(f"[4] {kname}: B={B} T={T}: {ms_runs[0]:.4f}, {ms_runs[1]:.4f} ms; "
                  f"{lib_names[0]} {lib_runs[0]:.4f}, {lib_runs[1]:.4f} ms (within "
                  f"{lib_rel[0]:.1e} rel; kernel {lib / ms:.2f}x as fast); plain {plain:.4f} "
                  f"ms; {lib_names[1]} {lib_mm:.4f} ms (within {lib_rel[1]:.1e} rel); bound "
                  f"{bound:.4f} ms ({by}); {bound / ms:.1%} of the bound")
            times = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib,
                         matmul_library_ms=lib_mm,
                         shape={"B": B, "T": T})
            row.update(times if i == 0 else {"at_b96_t625": times})
        kernels.append(row)

    for B, n in ((1, art.noisy.shape[0]), (96, 160000)):
        x = np.tile(art.noisy, -(-n // art.noisy.shape[0]))[:n][None].repeat(B, 0)
        t_fused = host_ms(lambda: enhance(art.params, x))
        t_plain = host_ms(lambda: enhance_plain(art.params, x))
        audio_s = B * n / 16000.0
        print(f"[4] enhance B={B} x {n / 16000:.1f} s: fused {t_fused:.3f} ms "
              f"({audio_s / t_fused * 1e3:.1f} audio-s/s), plain {t_plain:.3f} ms "
              f"({audio_s / t_plain * 1e3:.1f} audio-s/s)")
    # the xi-hat estimator (make_xi_estimator with fast_apply(): |X| by
    # stft_mag_fused) and the spectral-kernel route end to end beside
    # make_enhancer, on 3e's batches, in turns forward then back
    estimate_r = make_xi_estimator(art.inp_tgt, art.net, apply_fn=dx_r.fast_apply(),
                                   device=dev)
    for k, x in batches.items():
        arms = (("make_enhancer", lambda: enhance(art.params, x)),  # noqa: B023
                ("make_xi_estimator", lambda: estimate_r(art.params, x)),  # noqa: B023
                ("spectral-kernel route", lambda: spectral_route(x)))  # noqa: B023
        e2e = {name: [] for name, _ in arms}
        for name, fn in arms + arms[::-1]:
            e2e[name].append(host_ms(fn))
        print(f"[4] resnet-1.1c {k}, median of 10 a turn: " + "; ".join(
            f"{name} {', '.join(f'{t:.3f}' for t in ts)} ms" for name, ts in e2e.items()))
    # resnet-1.1c enhancement at B=96 x 10 s (distinct rows), pack2 against
    # unpacked, in turns
    x = batches["B=96 x 10 s, T=625"]
    enhance_p2 = make_enhancer(art.inp_tgt, art.net, "mmse-lsa", device=dev,
                               apply_fn=lambda p, m: tcn_fused.resnetv2_apply_fused(
                                   p, m, pack2=True))
    turns = [("unpacked", enhance), ("pack2", enhance_p2), ("pack2", enhance_p2),
             ("unpacked", enhance)]
    e2e = {}
    for arm, fn in turns:
        e2e.setdefault(arm, []).append(host_ms(lambda: fn(art.params, x)))  # noqa: B023
    print("[4] enhance B=96 x 10 s (distinct rows), median of 10 a turn: " + "; ".join(
        f"{arm} {', '.join(f'{t:.3f}' for t in ts)} ms "
        f"({96 * 10 / np.mean(ts) * 1e3:.1f} audio-s/s)" for arm, ts in e2e.items()))
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
    # both run every product on the tensor cores: their TC bounds put the
    # FLOPs at the split-TF32 rate
    tc_flops = {"fused_block_group_whole_saved": (BLOCK_FLOPS_PER_ROW, 2 + G, False),
                "fused_block_group_bwd": (BWD_FLOPS_PER_ROW, 2 + G, True),
                "replay": (BLOCK_FLOPS_PER_ROW + BWD_FLOPS_PER_ROW, 3, True)}
    times = {}
    for kname, (kernel, ref, (bound, by)) in timed.items():
        ms, plain = cuda_ms(kernel), cuda_ms(ref)
        dev_ms, ops, split = device_ms(kernel, by_name=True)
        tc = train_bound_ms(B, T, G, *tc_flops[kname], PEAK_TF32X3_FLOPS)[0]
        times[kname] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound,
                            bound_by=by, tc_bound_ms=tc)
        print(f"[4] {kname if kname != 'replay' else 'fused_block_group_bwd (replay)'}: "
              f"one call of G={G} blocks at B={B} T={T}: {ms:.4f} ms (device only "
              f"{dev_ms:.4f} ms, {ops:g} operations: "
              + ", ".join(f"{n[:40]} {t:.4f} ms ({c:g})" for n, (t, c) in sorted(
                  split.items(), key=lambda kv: -kv[1][0])[:5])
              + f"); plain {plain:.4f} ms; bound {bound:.4f} ms ({by}), TC bound "
              f"{tc:.4f} ms; {bound / ms:.1%} of the bound, {tc / ms:.1%} of the TC bound")
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

    # the MHANet kernels (causal, all rows valid) and mhanet-1.1c enhancement
    neg = mha_fused.NEG_INF_V2
    with torch.no_grad():
        layer = encoder_layer(w_mha, dev)
        row = {"name": "fused_transformer_block", "route": "cuda",
               "source": "deepxi_tpu_torch/ops/kernels/csrc/mha_block_fused.cu",
               "replaces": "deepxi_tpu/ops/kernels/mha_block_fused.py:72",
               "launches": launches["fused_transformer_block"],
               "max_abs_err": checks["fused_transformer_block"]}
        for i, (B, T) in enumerate(((1, 250), (64, 625))):
            Tp = -(-T // 128) * 128
            valid = padded(B, Tp, [T] * B).to(dev)
            x = (torch.randn(B, Tp, 256, generator=gen).to(dev) * valid[:, :, None])
            vf = valid[:, None, :].float()
            allowed = (valid[:, :, None] & valid[:, None, :]
                       & torch.ones(Tp, Tp, dtype=torch.bool, device=dev).tril())
            mask = (neg * (1.0 - allowed.float())).repeat_interleave(8, 0)
            y = mha_block_fused.fused_transformer_block(x, vf, w_mha, True)
            lib_rel = ((layer(x, src_mask=mask) - y)[valid].abs().max()
                       / y[valid].abs().max()).item()
            if lib_rel > LIB_TOL_REL:
                fail(f"nn.TransformerEncoderLayer is not the block's function ({lib_rel:.3e})")
            ms = cuda_ms(lambda: mha_block_fused.fused_transformer_block(x, vf, w_mha, True))
            plain = cuda_ms(lambda: mha_block_fused.fused_transformer_block_ref(
                x, vf, w_mha, True))
            lib = cuda_ms(lambda: layer(x, src_mask=mask))
            dev_ms, ops, split = device_ms(lambda: mha_block_fused.fused_transformer_block(
                x, vf, w_mha, True), by_name=True)
            lib_dev, lib_ops = device_ms(lambda: layer(x, src_mask=mask))
            bound, by = mha_block_bound_ms(B, T, True)
            # every product (row kernels and attention) on the tensor cores
            tc = mha_block_bound_ms(B, T, True, PEAK_TF32X3_FLOPS)[0]
            grid = mha_block_fused.block_grid(B, Tp)
            print(f"[4] fused_transformer_block: launch shapes at B={B} Tp={Tp}: {grid}")
            print(f"[4] fused_transformer_block: one block at B={B} T={T} (Tp {Tp}): "
                  f"{ms:.4f} ms (device only {dev_ms:.4f} ms, {ops:g} operations: "
                  + ", ".join(f"{n} {t:.4f} ms" for n, (t, _) in split.items())
                  + "); "
                  f"plain {plain:.4f} ms; nn.TransformerEncoderLayer {lib:.4f} ms "
                  f"(device only {lib_dev:.4f} ms, {lib_ops:g} operations; valid rows "
                  f"within {lib_rel:.1e} rel); bound {bound:.4f} ms ({by}); "
                  f"{bound / ms:.1%} of the bound; TC bound {tc:.4f} ms, "
                  f"{tc / ms:.1%} of it")
            times = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound,
                         bound_by=by, tc_bound_ms=tc, library_ms=lib,
                         library_device_ms=lib_dev, grid=grid,
                         shape={"B": B, "T": T, "causal": True})
            row.update(times if i == 0 else {"at_b64_t625": times})
        kernels.append(row)
        del layer, mask

        for kname, kernel, ref, kw, _, _ in attention_cases:
            row = {"name": kname, "route": "cuda",
                   "source": "deepxi_tpu_torch/ops/kernels/csrc/mha_attention.cu",
                   "replaces": ("deepxi_tpu/ops/kernels/mha_fused.py:49"
                                if kname == "flash_attention" else
                                "deepxi_tpu/ops/kernels/mha_flash_stream.py:53"),
                   "launches": launches[kname], "max_abs_err": checks[kname]}
            for i, T in enumerate((250, 2250)):
                q, k, v, valid = heads(1, T, [T])
                allowed = (valid[:, :, None] & valid[:, None, :]
                           & torch.ones(T, T, dtype=torch.bool, device=dev).tril())
                mask = (neg * (1.0 - allowed.float()))[:, None]
                qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask, scale=1.0)  # noqa: B023
                y = kernel(q, k, v, valid, True, **kw)
                lib_rel = ((sdpa().transpose(1, 2) - y).abs().max() / y.abs().max()).item()
                if lib_rel > LIB_TOL_REL:
                    fail(f"scaled_dot_product_attention is not {kname}'s function")
                ms = cuda_ms(lambda: kernel(q, k, v, valid, True, **kw))  # noqa: B023
                plain = cuda_ms(lambda: ref(q, k, v, valid, True, **kw))  # noqa: B023
                lib = cuda_ms(sdpa)
                dev_ms, ops = device_ms(lambda: kernel(q, k, v, valid, True, **kw))  # noqa: B023
                lib_dev, lib_ops = device_ms(sdpa)
                bound, by = attention_bound_ms(1, T, True)
                tc = attention_bound_ms(1, T, True, PEAK_TF32X3_FLOPS)[0]
                print(f"[4] {kname}: B=1 T={T} causal: {ms:.4f} ms (device only "
                      f"{dev_ms:.4f} ms, {ops:g} operations); plain {plain:.4f} ms; "
                      f"scaled_dot_product_attention {lib:.4f} ms (device only "
                      f"{lib_dev:.4f} ms, {lib_ops:g} operations; within {lib_rel:.1e} "
                      f"rel); bound {bound:.4f} ms ({by}); {bound / ms:.1%} of the bound; "
                      f"tensor-core bound {tc:.4f} ms, {tc / ms:.1%} of it")
                times = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound,
                             bound_by=by, tc_bound_ms=tc, library_ms=lib,
                             library_device_ms=lib_dev,
                             shape={"B": 1, "T": T, "causal": True})
                row.update(times if i == 0 else {"at_b1_t2250": times})
            kernels.append(row)

    enhance_fused_m = runs["full"][0].fast_enhancer("mmse-lsa")
    for B, n in ((1, art_m.noisy.shape[0]), (64, 160000)):
        x = np.tile(art_m.noisy, -(-n // art_m.noisy.shape[0]))[:n][None].repeat(B, 0)
        t_fused = host_ms(lambda: enhance_fused_m(art_m.params, x))
        t_plain = host_ms(lambda: enhance_plain_m(art_m.params, x))
        audio_s = B * n / 16000.0
        print(f"[4] mhanet-1.1c enhance B={B} x {n / 16000:.1f} s: fused {t_fused:.3f} ms "
              f"({audio_s / t_fused * 1e3:.1f} audio-s/s), plain {t_plain:.3f} ms "
              f"({audio_s / t_plain * 1e3:.1f} audio-s/s)")

    # the KV-cache kernel at the clock 1023 (1,024 written rows of 2,048);
    # the yardstick is scaled_dot_product_attention over the same numbers as
    # f32 with the same float mask (scale 1: q is pre-scaled)
    gcu = torch.Generator(device=dev).manual_seed(0)
    t_clock = 1023
    neg_mask = (mha_fused.NEG_INF_V2
                * (torch.arange(2048, device=dev) > t_clock).float()).view(1, 1, 1, -1)
    row = {"name": "mha_cache_step", "route": "cuda",
           "source": "deepxi_tpu_torch/ops/kernels/csrc/mha_cache.cu",
           "replaces": "deepxi_tpu/ops/kernels/mha_cache.py:29",
           "launches": launches["mha_cache_step"], "max_abs_err": checks["mha_cache_step"]}
    with torch.no_grad():
        for B in (1, 256):
            q = (torch.randn(B, 8, 32, generator=gen) * 32 ** -0.5).to(dev)
            kv = [torch.randn(B, 2048, 8, 32, device=dev, generator=gcu) for _ in range(2)]
            for dtype in (torch.float32, torch.bfloat16):
                kc, vc = (c.to(dtype) for c in kv)
                kh, vh = (c.to(torch.float32).transpose(1, 2) for c in (kc, vc))

                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(
                        q[:, :, None], kh, vh, attn_mask=neg_mask, scale=1.0)[:, :, 0]  # noqa: B023
                y = mha_cache.mha_cache_step(q, kc, vc, t_clock)
                lib_rel = ((sdpa() - y).abs().max() / y.abs().max()).item()
                if lib_rel > LIB_TOL_REL:
                    fail(f"scaled_dot_product_attention is not mha_cache_step's function "
                         f"({lib_rel:.3e})")
                ms = cuda_ms(lambda: mha_cache.mha_cache_step(q, kc, vc, t_clock))  # noqa: B023
                plain = cuda_ms(lambda: mha_cache.mha_cache_step_ref(q, kc, vc, t_clock))  # noqa: B023
                lib = cuda_ms(sdpa)
                bound, by = cache_bound_ms(B, t_clock + 1, kc.element_size())
                cache = "f32" if dtype == torch.float32 else "bf16"
                print(f"[4] mha_cache_step: B={B} L=2048 t={t_clock} {cache} caches: {ms:.4f} ms; "
                      f"plain {plain:.4f} ms; scaled_dot_product_attention {lib:.4f} ms "
                      f"(within {lib_rel:.1e} rel); bound {bound:.4f} ms ({by}); "
                      f"{bound / ms:.1%} of the bound")
                times = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                             library_ms=lib, shape={"B": B, "L": 2048, "t": t_clock,
                                                    "cache": cache})
                row.update(times if (B, cache) == (1, "f32") else {f"at_b{B}_{cache}": times})
            del kv, kc, vc, kh, vh
    kernels.append(row)

    # streaming hops on the host clock, each synchronised, from states whose
    # clock and caches were set directly
    def hop_times(label, fn, budget_ms):
        n0 = mha_cache.mha_cache_step.launches
        fn()
        per_hop = mha_cache.mha_cache_step.launches - n0
        ts = host_times(fn, iters=20)
        med = float(np.median(ts))
        print(f"[4] {label}: median {med:.3f} ms (20 calls, min {ts.min():.3f}, max "
              f"{ts.max():.3f}) against {budget_ms:g} ms of audio ({med / budget_ms:.1%} of "
              f"it); KV-cache kernel launches a call: {per_hop}")

    def ready(s, B):
        st = s.init_state(B)
        for c in st.k_caches + st.v_caches:
            c.copy_(torch.randn(c.shape, device=dev, generator=gcu))
        return st._replace(t=t_clock)

    chunks = {(B, n): torch.randint(-3000, 3000, (B, n), dtype=torch.int16, device=dev,
                               generator=gcu)
              for B, n in ((1, 256), (256, 256), (256, 8 * 256), (4096, 256))}
    for B, cache_dtype in ((1, torch.float32), (256, torch.bfloat16)):
        routes = {route: StreamingMHANet(art_m.inp_tgt, art_m.net, art_m.params,
                                         fused=route == "fused", cache_dtype=cache_dtype,
                                         device=dev)
                  for route in ("fused", "plain einsum route")}
        st = ready(routes["fused"], B)
        cache = "f32" if cache_dtype == torch.float32 else "bf16"
        for route, s in routes.items():
            hop_times(f"mhanet-1.1c step ({route}, {cache} caches) B={B} t={t_clock}",
                      lambda: s.step(st, chunks[B, 256]), HOP_BUDGET_MS)  # noqa: B023
        if B == 256:
            hop_times(f"mhanet-1.1c step_block of 8 hops ({cache} caches) B={B} t={t_clock}",
                      lambda: routes["fused"].step_block(st, chunks[B, 8 * 256]),  # noqa: B023
                      8 * HOP_BUDGET_MS)
        del st, routes
    s_r = StreamingEnhancer(art.inp_tgt, art.net, art.params, device=dev)
    for B in (1, 4096):
        st = s_r.init_state(B)
        hop_times(f"resnet-1.1c step B={B}",
                  lambda: s_r.step(st, chunks[B, 256]), HOP_BUDGET_MS)  # noqa: B023

    print(f"[4] chip_smoke.py wall time: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
