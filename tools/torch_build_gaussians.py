"""Build the per-phoneme log-STMS Gaussian statistics of the hybrid MixMax
and VTS modes with the PyTorch port (follows tools/build_gaussians.py; no
JAX).

Frame-level phoneme labels from a forced alignment assign each STFT frame's
log-magnitude spectrum to a phoneme class; each class gets its mean, std
and occupancy. A noise Gaussian comes from a noise corpus. One npz serves
both modes:

    python tools/torch_build_gaussians.py --clean set/train_clean_speech \\
        --ali out.ali --lexicon lexicon.txt --noise set/train_noise \\
        --out data/gaussians.npz [--platform cpu]

Output keys: means/stds/probs [P, F] / [P] (MixMax,
`DeepXiTorch._load_mixmax_model`) and x_mu/x_sigma/prio_p/g_mu/g_sigma
(VTS, `DeepXiTorch._load_vts_model`). The spectra are computed on the card
unless `--platform cpu`; the list caches go to a temporary directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deepxi_tpu_torch import resolve_device  # noqa: E402
from deepxi_tpu_torch.data.listing import batch_list, batch_list_labelled  # noqa: E402
from deepxi_tpu_torch.data.wavio import read_wav  # noqa: E402
from deepxi_tpu_torch.sig.stft import polar_analysis  # noqa: E402


def log_stms(wav_i16: np.ndarray, N_d=512, N_s=256, K=512, device="cpu") -> np.ndarray:
    """[T, K//2+1] log short-time magnitude spectrum of an int16 waveform
    (float32, floored at eps)."""
    x = torch.as_tensor(wav_i16.astype(np.float32) / 32768.0, device=device)
    mag = polar_analysis(x, N_d, N_s, K)[0].cpu().numpy()
    return np.log(np.maximum(mag, np.finfo(np.float32).eps))


def accumulate(clean_dir: str, ali_path: str, lexicon_path: str, n_phonemes: int,
               frame_ms: float = 16.0, device="cpu"):
    """(means [P, F], stds [P, F], probs [P]) float32 of the labelled frames;
    a class seen in at most one frame takes the Gaussian of all frames."""
    with tempfile.TemporaryDirectory() as cache:
        items = batch_list_labelled(clean_dir, ali_path, lexicon_path, "gaussians",
                                    data_path=cache, frame_ms=frame_ms)
    if not items:
        raise SystemExit("no labelled utterances found")
    sums = cnts = sqs = None
    for it in items:
        lm = log_stms(read_wav(it["file_path"])[0], device=device)
        if sums is None:
            sums = np.zeros((n_phonemes, lm.shape[1]))
            sqs = np.zeros((n_phonemes, lm.shape[1]))
            cnts = np.zeros(n_phonemes)
        lab = np.clip(it["labels"][: len(lm)], 0, n_phonemes - 1)
        lm = lm[: len(lab)]
        np.add.at(sums, lab, lm)
        np.add.at(sqs, lab, lm ** 2)
        np.add.at(cnts, lab, 1.0)
    seen = cnts > 1
    mu = np.where(seen[:, None], sums / np.maximum(cnts, 1.0)[:, None], 0.0)
    var = np.where(seen[:, None], sqs / np.maximum(cnts, 1.0)[:, None] - mu ** 2, 1.0)
    std = np.sqrt(np.maximum(var, 1e-4))
    probs = cnts / max(cnts.sum(), 1.0)
    # unseen classes take the Gaussian of all frames, so the mixture stays proper
    glob_mu = sums.sum(0) / max(cnts.sum(), 1.0)
    glob_sq = sqs.sum(0) / max(cnts.sum(), 1.0)
    mu[~seen] = glob_mu
    std[~seen] = np.sqrt(np.maximum(glob_sq - glob_mu ** 2, 1e-4))
    probs = np.maximum(probs, 1e-6)
    probs /= probs.sum()
    return mu.astype(np.float32), std.astype(np.float32), probs.astype(np.float32)


def noise_gaussian(noise_dir: str, device="cpu"):
    """(mean [F], std [F]) float32 of every frame of the noise corpus, the
    std floored at 1e-2."""
    with tempfile.TemporaryDirectory() as cache:
        items = batch_list(noise_dir, "gaussians_noise", cache)
    if not items:
        raise SystemExit("no noise files found")
    lm = np.concatenate([log_stms(read_wav(it["file_path"])[0], device=device)
                         for it in items])
    return lm.mean(0).astype(np.float32), np.maximum(lm.std(0), 1e-2).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--clean", required=True, help="labelled clean-speech dir")
    ap.add_argument("--ali", required=True, help="forced-alignment file")
    ap.add_argument("--lexicon", required=True, help="phoneme lexicon")
    ap.add_argument("--noise", required=True, help="noise corpus dir")
    ap.add_argument("--out", required=True, help="output npz path")
    ap.add_argument("--n_phonemes", type=int, default=98)
    ap.add_argument("--frame_ms", type=float, default=16.0)
    ap.add_argument("--platform", default=None, help="cpu, or cuda (the default)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.platform)
    mu, std, probs = accumulate(args.clean, args.ali, args.lexicon, args.n_phonemes,
                                args.frame_ms, dev)
    g_mu, g_std = noise_gaussian(args.noise, dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, means=mu, stds=std, probs=probs,     # MixMax keys
             x_mu=mu, x_sigma=std, prio_p=probs,              # VTS keys
             g_mu=g_mu, g_sigma=g_std)
    print(f"wrote {args.out}: {mu.shape[0]} classes x {mu.shape[1]} bins")
    return 0


if __name__ == "__main__":
    sys.exit(main())
