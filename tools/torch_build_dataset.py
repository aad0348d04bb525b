"""Dataset builder on the port's wav I/O (follows tools/build_dataset.py,
without JAX): construct the Deep Xi on-disk training layout from
user-provided clean-speech and noise corpora.

Python equivalent of the reference's MATLAB builders
(ref: set/deep_xi_train_set.m:1-249, set/deep_xi_test_set.m:1-73): seeded
RNG, train dirs copied/linked as-is, validation pairs written as
identically-named clean/noise files with the `_<snr>dB` suffix the
val_wav_batch contract requires (ref: deepxi/utils.py:136-202), and a noisy
test set named `<clean>_<noise>_<snr>dB.wav`.

Usage:
  python tools/torch_build_dataset.py --clean DIR --noise DIR --out set \
      --val_fraction 0.05 --snr -10 20 5 [--test_fraction 0.02]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from deepxi_tpu_torch.data.wavio import read_wav, save_wav  # noqa: E402


def list_wavs(d):
    out = []
    for root, _, files in os.walk(d):
        for f in sorted(files):
            if f.lower().endswith((".wav", ".flac", ".mp3")):
                out.append(os.path.join(root, f))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clean", required=True, help="clean speech corpus dir")
    ap.add_argument("--noise", required=True, help="noise corpus dir")
    ap.add_argument("--out", default="set")
    ap.add_argument("--val_fraction", type=float, default=0.05)
    ap.add_argument("--test_fraction", type=float, default=0.0)
    ap.add_argument("--snr", nargs=3, type=int, default=[-10, 20, 5],
                    metavar=("MIN", "MAX", "STEP"))
    ap.add_argument("--seed", type=int, default=43)  # ref: deep_xi_train_set.m rng seed
    ap.add_argument("--f_s", type=int, default=16000)
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    snrs = list(range(args.snr[0], args.snr[1] + 1, args.snr[2]))
    clean = list_wavs(args.clean)
    noise = list_wavs(args.noise)
    if not clean or not noise:
        raise SystemExit("no clean or noise files found")
    rng.shuffle(clean)
    n_val = int(len(clean) * args.val_fraction)
    n_test = int(len(clean) * args.test_fraction)
    val, test, train = (clean[:n_val], clean[n_val:n_val + n_test],
                        clean[n_val + n_test:])

    def put(sub):
        p = os.path.join(args.out, sub)
        os.makedirs(p, exist_ok=True)
        return p

    train_s = put("train_clean_speech")
    train_d = put("train_noise")
    val_s = put("val_clean_speech")
    val_d = put("val_noise")

    for p in train:
        w, _ = read_wav(p, args.f_s)
        save_wav(os.path.join(train_s, os.path.basename(p)), w, args.f_s)
    for p in noise:
        w, _ = read_wav(p, args.f_s)
        save_wav(os.path.join(train_d, os.path.basename(p)), w, args.f_s)

    # validation: paired clean/noise files, same name, SNR in the suffix
    for p in val:
        s, _ = read_wav(p, args.f_s)
        while True:
            q = noise[rng.randint(len(noise))]
            d, _ = read_wav(q, args.f_s)
            if len(d) >= len(s):
                break
        off = rng.randint(0, len(d) - len(s) + 1)
        d = d[off:off + len(s)]
        snr = snrs[rng.randint(len(snrs))]
        base = os.path.splitext(os.path.basename(p))[0]
        name = f"{base}_{snr}dB.wav"
        save_wav(os.path.join(val_s, name), s, args.f_s)
        save_wav(os.path.join(val_d, name), d, args.f_s)

    if test:
        test_s = put("test_clean_speech")
        test_x = put("test_noisy_speech")
        test_d = put("test_noise")
        for p in test:
            s, _ = read_wav(p, args.f_s)
            while True:
                q = noise[rng.randint(len(noise))]
                d, _ = read_wav(q, args.f_s)
                if len(d) >= len(s):
                    break
            off = rng.randint(0, len(d) - len(s) + 1)
            d = d[off:off + len(s)].astype(np.float64)
            s64 = s.astype(np.float64)
            snr = snrs[rng.randint(len(snrs))]
            # exact-SNR scaling, same formula as the training mixer
            # (ref: deepxi/sig.py:258-284)
            alpha = np.sqrt(np.mean(s64 ** 2)
                            / max(np.mean(d ** 2) * 10 ** (snr / 10), 1e-12))
            x = np.clip(s64 + alpha * d, -32768, 32767).astype(np.int16)
            base = os.path.splitext(os.path.basename(p))[0]
            nbase = os.path.splitext(os.path.basename(q))[0].replace("_", "-")
            save_wav(os.path.join(test_s, base + ".wav"), s, args.f_s)
            save_wav(os.path.join(test_d, f"{base}_{nbase}_{snr}dB.wav"),
                     (alpha * d).astype(np.int16), args.f_s)
            save_wav(os.path.join(test_x, f"{base}_{nbase}_{snr}dB.wav"),
                     x, args.f_s)
    print(f"train {len(train)} | val {len(val)} | test {len(test)} "
          f"| noise {len(noise)} -> {args.out}")


if __name__ == "__main__":
    main()
