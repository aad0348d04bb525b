"""The weight bridge and the checked-in trained artifacts (follows
deepxi_tpu/compat/artifact.py).

`artifacts/resnet-1.1c-synth300/` holds the resnet-1.1c checkpoint as
`params.npz` (leaves `p0..p244` in Flax tree-flatten order), the DBNormalCDF
map statistics as `stats.npz`, and a 5 dB white-noise test pair.
`artifacts/mhanet-1.1c-big2400-e400/` is laid out the same way, with a
`meta.json` that names its preset, leaf count and test pair
(`load_artifact`, which builds the preset's family and network and restores
every map's statistics).
"""

from __future__ import annotations

import json
import os
from dataclasses import replace
from typing import Dict, Mapping, NamedTuple

import numpy as np
import torch

from deepxi_tpu_torch import resolve_device
from deepxi_tpu_torch.data.wavio import read_wav
from deepxi_tpu_torch.inp_tgt import MAP_ATTRS, inp_tgt_selector
from deepxi_tpu_torch.models.tcn import ResNetV2

ARTIFACTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts")
FLAGSHIP_ROOT = os.path.join(ARTIFACTS, "resnet-1.1c-synth300")
FLAGSHIP_PARAMS = 1_949_953
MHANET_ROOT = os.path.join(ARTIFACTS, "mhanet-1.1c-big2400-e400")
# parameter count of each network `load_artifact` builds, by preset
PRESET_PARAMS = {"mhanet-1.1c": 4_600_321, "resnet-1.1c": FLAGSHIP_PARAMS}


class Artifact(NamedTuple):
    inp_tgt: object          # the family, with its maps' statistics
    net: torch.nn.Module     # weights loaded, on the device
    params: Dict[str, torch.Tensor]  # net's state dict
    noisy: np.ndarray        # int16, 16 kHz
    clean: np.ndarray


def flax_order(keys) -> list:
    """State-dict keys (`module.leaf`, or deeper as `block0_lstm.cell.hi.kernel`)
    in Flax tree-flatten order, which sorts dict keys at every level:
    `block10_*` before `block2_*`, `bias` before `kernel`."""
    return sorted(keys, key=lambda k: tuple(k.split(".")))


def from_flax_params(tree: Mapping, mesh=None) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters, as nested dicts of numpy arrays
    ({'params': {module: {leaf: array}}}, nested to any depth), as a flat
    dict of CPU tensors keyed by the dotted path (`module.leaf`). Layouts
    are shared, so no array is transposed. With a ("data", "model") `mesh`,
    this rank's part of each leaf (`parallel.shard_params`), as the JAX
    package's `shard_params` places the tree; `training.gather_state` and
    `save_checkpoint` write the whole state back in the usual layout."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = torch.as_tensor(np.array(v))

    walk(tree.get("params", tree), "")
    if mesh is not None:
        from deepxi_tpu_torch.parallel.mesh import shard_params
        out = shard_params(mesh, out)
    return out


def restore_stats(it, stats: Mapping, device=None):
    """`it` with every map's fields replaced by a stats file's keys
    `<map attribute>.<field>` (e.g. `xi_map.mu`), as tensors on `device`; a
    key for a map the family lacks raises."""
    for m in MAP_ATTRS:
        updates = {k.split(".", 1)[1]: torch.as_tensor(np.array(stats[k]), device=device)
                   for k in stats.keys() if k.startswith(m + ".")}
        if updates:
            mp = getattr(it, m, None)
            if mp is None:
                raise ValueError(f"the statistics carry {m} but {type(it).__name__} "
                                 f"has no {m}")
            it = replace(it, **{m: replace(mp, **updates)})
    return it


def _load(root: str, net: torch.nn.Module, n_params, dev: torch.device,
          noisy: str, clean: str, it) -> Artifact:
    """`net` with the weights of `root/params.npz` (leaf i = the i-th key in
    Flax order, each shape asserted; `n_params` parameters unless None), `it`
    with the map statistics, and the test pair read at `it.f_s`, on `dev`."""
    shapes = {k: v.shape for k, v in net.state_dict().items()}
    z = np.load(os.path.join(root, "params.npz"))
    keys = flax_order(shapes)
    if len(z.files) != len(keys):
        raise ValueError(f"{root}: {len(z.files)} leaves, expected {len(keys)}")
    state = {}
    for i, key in enumerate(keys):
        arr = z[f"p{i}"]
        if arr.shape != shapes[key]:
            raise ValueError(f"p{i} ({key}): shape {arr.shape}, "
                             f"expected {tuple(shapes[key])}")
        state[key] = torch.as_tensor(arr)
    n = sum(v.numel() for v in state.values())
    if n_params is not None and n != n_params:
        raise ValueError(f"{n} parameters, expected {n_params}")
    net.load_state_dict(state)
    net.to(dev).eval()

    it = restore_stats(it, np.load(os.path.join(root, "stats.npz")), dev)
    noisy_wav, _ = read_wav(os.path.join(root, noisy), it.f_s)
    clean_wav, _ = read_wav(os.path.join(root, clean), it.f_s)
    return Artifact(it, net, dict(net.state_dict()), noisy_wav, clean_wav)


def load_flagship_artifact(root: str = None, device=None) -> Artifact:
    """The checked-in trained resnet-1.1c with its map statistics and test
    pair, on `device` (the card unless ``device="cpu"``)."""
    net = ResNetV2(257, 257, n_blocks=40, d_model=256, d_f=64, k=3,
                   max_d_rate=16, outp_act="Sigmoid")
    it = inp_tgt_selector("MagXi", 512, 256, 512, 16000, map_type="DBNormalCDF")
    return _load(root or FLAGSHIP_ROOT, net, FLAGSHIP_PARAMS,
                 resolve_device(device), "c012_white_5dB.wav", "c012.wav", it)


def artifact_meta(root: str = None):
    """(meta.json's contents, the Config of the preset it names) of a
    `meta.json` artifact (by default the checked-in trained mhanet-1.1c).
    An artifact without a meta.json raises FileNotFoundError, as the JAX
    package's `load_artifact` does."""
    from deepxi_tpu_torch.config import preset

    with open(os.path.join(root or MHANET_ROOT, "meta.json")) as f:
        meta = json.load(f)
    return meta, preset(meta["ver"])


def load_artifact(root: str = None, device=None) -> Artifact:
    """A `meta.json` artifact (by default the checked-in trained
    mhanet-1.1c): the preset named in `meta["ver"]` builds the family (its
    `inp_tgt_type`, maps and gain) and the network, whose Flax-ordered
    leaves must number `meta["n_leaves"]`; every map's statistics come from
    `stats.npz`; the test pair is the one meta names."""
    from deepxi_tpu_torch.framework import build_network

    root = root or MHANET_ROOT
    meta, cfg = artifact_meta(root)
    it = inp_tgt_selector(cfg.inp_tgt_type, cfg.N_d, cfg.N_s, cfg.K, cfg.f_s,
                          map_type=cfg.map_type, map_params=cfg.map_params,
                          gain=cfg.gain if isinstance(cfg.gain, str) else cfg.gain[0])
    net = build_network(cfg, it.n_feat, it.n_outp)
    if len(net.state_dict()) != meta["n_leaves"]:
        raise ValueError(f"{root}: meta.json has {meta['n_leaves']} leaves, "
                         f"{cfg.ver} has {len(net.state_dict())}")
    return _load(root, net, PRESET_PARAMS.get(cfg.ver), resolve_device(device),
                 meta["noisy"], meta["clean"], it)
