"""Command line of the port (follows deepxi_tpu/cli.py):

    python -m deepxi_tpu_torch --ver resnet-1.1c --train 1
    python -m deepxi_tpu_torch --ver resnet-1.1c --infer 1 --test_epoch 200 --gain mmse-lsa
    python -m deepxi_tpu_torch --ver resnet-1.1c --test 1
    python -m deepxi_tpu_torch --enhance artifacts/mhanet-1.1c-big2400-e400 --in_wavs a.wav
    python -m deepxi_tpu_torch --ver resnet-1.1c --export 1 --test_epoch 200
    python -m deepxi_tpu_torch --prelim 1 --platform cpu
    python -m deepxi_tpu_torch --inp_tgt_type MagPhonemes --train 1 --ali_path a.ali \
        --lexicon_path lexicon.txt
    python -m deepxi_tpu_torch --infer 1 --out_type hybrid_mixmax --mixmax_stats g.npz

    torchrun --nproc_per_node 4 -m deepxi_tpu_torch --train 1 --n_data_shards 4

The parser takes every flag of the JAX package's, so a command line written
for one parses in the other, and gives the same Config values for every
field both have (but `tcn_fused`, on by default in the port). It runs on the
CUDA card unless ``--platform cpu``. `--d_b` and `--d_ff` are taken and read
by no network, as in the JAX package. Under a launcher (`torchrun`) `main`
joins the process group (`parallel.init_distributed`): training runs on the
("data", "model") mesh of `--n_data_shards` x `--n_model_shards`, one
process a card, and the other modes run on rank 0 alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import sys
from typing import List, Optional

from deepxi_tpu_torch.config import (VERSION_PRESETS, Config, preset, str_to_bool,
                                     str_to_list)

PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deepxi_tpu_torch",
                                description="Deep Xi speech enhancement in PyTorch "
                                            "on an NVIDIA card")
    p.add_argument("--ver", type=str, default="resnet-1.1c", help="Model version/preset")
    p.add_argument("--test_epoch", type=str_to_list, default=None, help="Epoch(s) to test")
    p.add_argument("--train", type=str_to_bool, default=False)
    p.add_argument("--infer", type=str_to_bool, default=False)
    p.add_argument("--test", type=str_to_bool, default=False)
    p.add_argument("--spect_dist", type=str_to_bool, default=False)
    p.add_argument("--export", type=str_to_bool, default=False,
                   help="serving export: write the fused enhancer of --test_epoch "
                        "as torch.export programs (deepxi_tpu_torch.serving)")
    p.add_argument("--export_path", type=str, default=None)
    p.add_argument("--prelim", type=str_to_bool, default=False)
    p.add_argument("--enhance", type=str, default=None,
                   help="artifact dir with a meta.json; enhance --in_wavs into --out_dir")
    p.add_argument("--in_wavs", type=str, nargs="+", default=None,
                   help="wav files, dirs, or globs to enhance")
    p.add_argument("--out_dir", type=str, default="enhanced")
    p.add_argument("--sd_snr_levels", type=str_to_list, default=None)
    p.add_argument("--sd_target", type=str_to_list, default=None,
                   help="spectral-distortion target(s): xi and/or gamma")
    p.add_argument("--network_type", type=str, default=None)
    p.add_argument("--inp_tgt_type", type=str, default=None)
    # train
    p.add_argument("--mbatch_size", type=int, default=None)
    p.add_argument("--sample_size", type=int, default=None)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--resume_epoch", type=int, default=None)
    p.add_argument("--save_model", type=str_to_bool, default=None)
    p.add_argument("--save_every", type=int, default=None)
    p.add_argument("--val_every", type=int, default=None)
    p.add_argument("--log_iter", type=str_to_bool, default=None,
                   help="kept for flag parity: neither package's trainer reads it")
    p.add_argument("--eval_example", type=str_to_bool, default=None)
    p.add_argument("--val_flag", type=str_to_bool, default=None)
    p.add_argument("--reset_inp_tgt", type=str_to_bool, default=None)
    p.add_argument("--reset_sample", type=str_to_bool, default=None)
    p.add_argument("--seed", type=int, default=None)
    # outputs
    p.add_argument("--out_type", type=str, default=None)
    p.add_argument("--gain", type=str_to_list, default=None)
    # paths
    for flag in ("model_path", "set_path", "log_path", "data_path",
                 "test_x_path", "test_s_path", "test_d_path", "out_path",
                 "saved_data_path", "ali_path", "lexicon_path",
                 "mixmax_stats", "vts_stats"):
        p.add_argument(f"--{flag}", type=str, default=None)
    # features
    for flag in ("min_snr", "max_snr", "snr_inter", "f_s", "T_d", "T_s", "n_filters"):
        p.add_argument(f"--{flag}", type=int, default=None)
    # network
    for flag in ("d_model", "n_blocks", "n_heads", "d_b", "d_f", "d_ff", "k",
                 "max_d_rate", "warmup_steps", "length", "m_1", "max_len",
                 "Noutp"):
        p.add_argument(f"--{flag}", type=int, default=None)
    p.add_argument("--causal", type=str_to_bool, default=None)
    p.add_argument("--unit_type", type=str, default=None)
    p.add_argument("--loss_fnc", type=str, default=None)
    p.add_argument("--outp_act", type=str, default=None)
    # map
    p.add_argument("--map_type", type=str_to_list, default=None)
    p.add_argument("--map_params", type=str_to_list, default=None)
    # parallelism
    p.add_argument("--n_data_shards", type=int, default=None,
                   help="data-parallel ranks of the training mesh (default "
                        "gcd(mbatch_size, world size // n_model_shards))")
    p.add_argument("--n_model_shards", type=int, default=None,
                   help="ranks over which the training mesh shards each weight's "
                        "output channels")
    p.add_argument("--metric_workers", type=int, default=None,
                   help="host metric processes in --test (0=auto, 1=serial)")
    p.add_argument("--platform", type=str, default=None,
                   help="cpu, or cuda (alias gpu; the default): the device to run on")
    p.add_argument("--attention_impl", type=str, default=None,
                   help="MHANetV2/V3 attention: 'full', 'block' (query blocks of "
                        "--block_q), 'fused' (flash_attention) or 'stream' (key tiles; "
                        "long audio)")
    p.add_argument("--block_q", type=int, default=None)
    p.add_argument("--mha_fused", type=str_to_bool, default=None,
                   help="the fused transformer-block kernels in MHANet inference")
    p.add_argument("--tcn_fused", type=str_to_bool, default=None,
                   help="the fused TCN kernels in ResNetV2 inference (default on; 0: "
                        "the plain network)")
    p.add_argument("--tcn_fused_train", type=str_to_bool, default=None,
                   help="the fused TCN forward/backward kernels in the ResNetV2 train step")
    p.add_argument("--dft_precision", type=str, default=None,
                   choices=["highest", "high", "default"],
                   help="a TPU matmul-precision knob of the JAX package; accepted and "
                        "ignored: the port's DFT is float32 throughout")
    p.add_argument("--import_stats", type=str, default=None,
                   help="a reference <ver>_inp_tgt.p statistics pickle to adopt "
                        "(reading it needs TensorFlow)")
    return p


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise SystemExit for a `--platform` the port does not run on."""
    if args.platform is not None and args.platform not in PLATFORMS:
        raise SystemExit(f"--platform {args.platform}: the port runs on "
                         f"{', '.join(PLATFORMS)}")


def config_from_args(argv: Optional[List[str]] = None) -> Config:
    """The Config of a command line: the `--ver` preset (or the defaults
    with that ver) with every given flag the Config has as an override."""
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    base = preset(args.ver) if args.ver in VERSION_PRESETS else Config(ver=args.ver)
    field_names = {f.name for f in dataclasses.fields(Config)}
    overrides = {k: v for k, v in vars(args).items()
                 if k in field_names and v is not None}
    # booleans parsed with default False must still override presets
    for k in ("train", "infer", "test", "spect_dist", "prelim", "export"):
        overrides[k] = getattr(args, k)
    return base.replace(**overrides)


def wav_paths(in_wavs: Optional[List[str]]) -> List[str]:
    """Files, the .wav/.flac files of directories (sorted), and globs."""
    paths: List[str] = []
    for pat in in_wavs or []:
        if os.path.isdir(pat):
            paths += [os.path.join(pat, f) for f in sorted(os.listdir(pat))
                      if f.endswith((".wav", ".flac"))]
        elif any(c in pat for c in "*?["):
            paths += sorted(glob.glob(pat))
        else:
            paths.append(pat)
    return paths


def run_artifact_enhance(artifact: str, in_wavs: List[str], out_dir: str,
                         gain: str, device=None) -> int:
    """Enhance wavs with a `meta.json` artifact: each input is read at the
    artifact's rate (resampled and downmixed by `read_wav`), the batch,
    padded to a whole hop, goes through `make_enhancer` with the kernels'
    network forward (`framework.fast_apply_fn` of the artifact's preset),
    and each output, cut to its input's length, is written under `out_dir`
    with its input's basename at the rate `read_wav` returned for it (the
    artifact's, as in the JAX package). An artifact without a meta.json
    raises FileNotFoundError."""
    import numpy as np

    from deepxi_tpu_torch.compat.artifact import artifact_meta, load_artifact
    from deepxi_tpu_torch.data.wavio import read_wav, save_wav
    from deepxi_tpu_torch.enhance import make_enhancer
    from deepxi_tpu_torch.framework import fast_apply_fn

    paths = wav_paths(in_wavs)
    if not paths:
        print("--enhance needs --in_wavs (files, dirs, or globs)")
        return 1
    _, cfg = artifact_meta(artifact)
    art = load_artifact(artifact, device=device)
    it = art.inp_tgt
    enhance = make_enhancer(it, art.net, gain, apply_fn=fast_apply_fn(cfg),
                            device=device)
    wavs, rates = zip(*(read_wav(p, it.f_s) for p in paths))
    lens = [len(w) for w in wavs]
    L = -(-max(lens) // it.N_s) * it.N_s
    x = np.zeros((len(wavs), L), np.int16)
    for i, w in enumerate(wavs):
        x[i, : len(w)] = w
    y = enhance(art.params, x).cpu().numpy()
    os.makedirs(out_dir, exist_ok=True)
    for i, p in enumerate(paths):
        save_wav(os.path.join(out_dir, os.path.basename(p)), y[i, : lens[i]], rates[i])
    print(f"wrote {len(paths)} enhanced wavs to {out_dir}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    device = None if args.platform is None else PLATFORMS[args.platform]  # None: the card
    if args.enhance:
        gain = args.gain[0] if isinstance(args.gain, list) and args.gain \
            else (args.gain or "mmse-lsa")
        return run_artifact_enhance(args.enhance, args.in_wavs, args.out_dir, gain,
                                    device=device)
    cfg = config_from_args(argv)
    from deepxi_tpu_torch.framework import mesh_size
    from deepxi_tpu_torch.parallel import init_distributed, is_primary
    init_distributed(backend="gloo" if device == "cpu" else None)
    mesh_size(cfg)  # a mesh that does not fit the group fails before any work
    primary = is_primary()
    print(f"Version: {cfg.ver} ({cfg.network_type}, {cfg.inp_tgt_type})")
    if not (cfg.train or cfg.infer or cfg.test or cfg.spect_dist or cfg.prelim
            or cfg.export):
        print("nothing to do: pass --train 1, --infer 1, --test 1, "
              "--spect_dist 1, --export 1 and/or --prelim 1")
        return 1

    # every rank builds the framework (its mesh is made by all of them);
    # every mode but training runs on rank 0 alone
    needs_framework = cfg.train or cfg.infer or cfg.test or cfg.spect_dist or cfg.export
    if not primary:
        cfg = cfg.replace(prelim=False, infer=False, test=False, spect_dist=False,
                          export=False)
    if cfg.prelim:
        from deepxi_tpu_torch.prelim import run_prelim
        run_prelim(cfg.network_type, device=device)
    if not needs_framework:
        return 0

    from deepxi_tpu_torch.data.listing import batch_list, batch_list_labelled
    from deepxi_tpu_torch.framework import PHONEME_TYPES, DeepXiTorch

    train_s_list = train_d_list = None
    if cfg.train:
        clean_dir = os.path.join(cfg.set_path, "train_clean_speech")
        if cfg.inp_tgt_type in PHONEME_TYPES:
            # the labelled list of a forced alignment and a lexicon
            if not (cfg.ali_path and cfg.lexicon_path):
                print("MagPhonemes training needs --ali_path and --lexicon_path")
                return 1
            train_s_list = batch_list_labelled(clean_dir, cfg.ali_path, cfg.lexicon_path,
                                               "clean_speech", cfg.data_path,
                                               frame_ms=cfg.T_s)
        else:
            train_s_list = batch_list(clean_dir, "clean_speech", cfg.data_path)
        train_d_list = batch_list(os.path.join(cfg.set_path, "train_noise"),
                                  "noise", cfg.data_path)

    deepxi = DeepXiTorch(cfg, train_s_list, train_d_list, device=device)
    if cfg.import_stats:
        print(f"adopted reference statistics from {cfg.import_stats}")
    if cfg.train:
        deepxi.train()
    if cfg.infer:
        written = deepxi.infer()
        print(f"wrote {len(written)} outputs")
    if cfg.test:
        deepxi.test()
    if cfg.spect_dist:
        targets = cfg.sd_target if isinstance(cfg.sd_target, list) else [cfg.sd_target]
        for tgt in targets:
            deepxi.spectral_distortion(target=tgt)
    if cfg.export:
        written = deepxi.export_serving(out_dir=cfg.export_path)
        print(f"exported {len(written)} serving artifacts")
    return 0


if __name__ == "__main__":
    sys.exit(main())
