"""The system under test, `deepxi_tpu_torch`, built for a configuration
through its public entry points: the port's `Config` with the
configuration's values, its network at its family's widths, the family
with the map statistics the benchmark hands it, and the inference fast
path's network forward. The drivers take the rest (`make_enhancer`,
`make_train_step`, the streaming export and server) from the port
themselves."""

from __future__ import annotations

import dataclasses

import torch


def port_config(cfg: dict):
    """The port's `Config`: its preset of the configuration's name where it
    has one, with every value of the configuration that is a field of
    `Config` (numbers, strings and switches)."""
    from deepxi_tpu_torch.config import VERSION_PRESETS, Config, preset
    fields = {f.name for f in dataclasses.fields(Config)} - {"ver"}
    kw = {k: v for k, v in cfg.items()
          if k in fields and isinstance(v, (bool, int, float, str))}
    if cfg["name"] in VERSION_PRESETS:
        return preset(cfg["name"], **kw)
    return Config(ver=cfg["name"], **kw)


def family(cfg: dict, stats: dict, device):
    """The configuration's input-target family with the map's statistics
    (`stats`: the statistics file's arrays by name)."""
    from deepxi_tpu_torch.compat.artifact import restore_stats
    from deepxi_tpu_torch.inp_tgt import inp_tgt_selector
    it = inp_tgt_selector(cfg["inp_tgt_type"], cfg["N_d"], cfg["N_s"], cfg["K"], cfg["f_s"],
                          map_type=cfg["map_type"])
    return restore_stats(it, {k: v.cpu().numpy() for k, v in stats.items()}, device)


def network(pcfg, it, device) -> torch.nn.Module:
    """The configured network at the family's feature and output widths."""
    from deepxi_tpu_torch.framework import build_network
    return build_network(pcfg, it.n_feat, it.n_outp).to(device).eval()


def fast_apply(pcfg):
    from deepxi_tpu_torch.framework import fast_apply_fn
    return fast_apply_fn(pcfg)
