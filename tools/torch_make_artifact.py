"""Package a checkpoint that `deepxi_tpu_torch` trained as an artifact
(follows tools/make_artifact.py, without JAX).

The artifact (`artifacts/<name>/` or anywhere) carries the parameters as
`params.npz` (leaves `p0, p1, ..` in Flax tree-flatten order,
`compat/artifact.flax_order`), the version's map statistics as `stats.npz`,
one clean/noisy wav pair from the work directory's test set and a
`meta.json` naming the preset, its epoch, the pair and the leaf count: the
layout both packages' `load_artifact` read, and what `python -m
deepxi_tpu_torch --enhance <artifact>` takes.

    python tools/torch_make_artifact.py --work WORK --ver reslstm-1.0c \
        --epoch 3 --pair c012 --out artifacts/reslstm-1.0c-e3

`WORK` holds `model/<ver>/epoch-<epoch - 1>/state.pt` (the port's
`save_checkpoint`), `data/<ver>_stats.npz` and `set/test_clean_speech/`,
`set/test_noisy_speech/`. It runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--work", required=True)
    ap.add_argument("--ver", required=True)
    ap.add_argument("--epoch", type=int, required=True)
    ap.add_argument("--pair", default="c012",
                    help="test-set basename; <pair>.wav (clean) and the "
                         "matching <pair>_<noise>_<snr>dB.wav are copied")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from deepxi_tpu_torch.compat.artifact import flax_order
    from deepxi_tpu_torch.config import preset
    from deepxi_tpu_torch.framework import build_network
    from deepxi_tpu_torch.inp_tgt import inp_tgt_selector
    from deepxi_tpu_torch.training import TrainState, make_optimizer, restore_checkpoint

    cfg = preset(args.ver)
    it = inp_tgt_selector(cfg.inp_tgt_type, cfg.N_d, cfg.N_s, cfg.K, cfg.f_s,
                          map_type=cfg.map_type, map_params=cfg.map_params)
    net = build_network(cfg, it.n_feat, it.n_outp)
    tx = make_optimizer(cfg.network_type, cfg.d_model or 256, cfg.warmup_steps)
    state = TrainState.create(dict(net.state_dict()), tx)
    model_dir = os.path.join(args.work, "model", args.ver)
    state = restore_checkpoint(model_dir, args.epoch - 1, state)
    if set(state.params) != set(net.state_dict()):
        raise ValueError(f"the checkpoint's parameters are not {args.ver}'s network's")

    os.makedirs(args.out, exist_ok=True)
    keys = flax_order(state.params)
    np.savez(os.path.join(args.out, "params.npz"),
             **{f"p{i}": state.params[k].numpy() for i, k in enumerate(keys)})
    shutil.copy(os.path.join(args.work, "data", f"{args.ver}_stats.npz"),
                os.path.join(args.out, "stats.npz"))

    clean_dir = os.path.join(args.work, "set", "test_clean_speech")
    noisy_dir = os.path.join(args.work, "set", "test_noisy_speech")
    noisy_name = next(n for n in sorted(os.listdir(noisy_dir))
                      if n.startswith(args.pair + "_"))
    shutil.copy(os.path.join(clean_dir, args.pair + ".wav"), args.out)
    shutil.copy(os.path.join(noisy_dir, noisy_name), args.out)

    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump({"ver": args.ver, "epoch": args.epoch,
                   "clean": args.pair + ".wav", "noisy": noisy_name,
                   "n_leaves": len(keys),
                   "created_from": os.path.abspath(args.work)}, f, indent=1)
    print(f"artifact written to {args.out} ({len(keys)} leaves)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
