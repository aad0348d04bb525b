"""Checks the port's command-line tests share: a command line's Config
against the JAX package's, and a mesh larger than the process group refused
as JAX's `make_mesh` refuses it."""

import dataclasses
import math

import jax
import pytest

from deepxi_tpu import cli as cli_j
from deepxi_tpu.config import Config as ConfigJ
from deepxi_tpu.parallel import make_mesh as make_mesh_j
from deepxi_tpu_torch import cli
from deepxi_tpu_torch.config import VERSION_PRESETS, Config

# The one field whose default differs (README): outside the presets the
# port's ResNetV2 inference takes the fused TCN kernels unless `--tcn_fused
# 0`; the JAX package's default is off. The presets carry the same value.
PORT_DEFAULTS = {"tcn_fused": True}


def assert_config_matches_jax(argv):
    """Every field both Configs have takes the same value, but a
    `PORT_DEFAULTS` field that neither the command line nor a preset sets."""
    cfg, cfg_j = cli.config_from_args(argv), cli_j.config_from_args(argv)
    shared = {f.name for f in dataclasses.fields(Config)} & \
        {f.name for f in dataclasses.fields(ConfigJ)}
    assert shared == {f.name for f in dataclasses.fields(Config)}
    for name in sorted(shared):
        want = getattr(cfg_j, name)
        if (name in PORT_DEFAULTS and f"--{name}" not in argv
                and cfg.ver not in VERSION_PRESETS):
            want = PORT_DEFAULTS[name]
        assert getattr(cfg, name) == want, name
    return cfg, cfg_j


def assert_mesh_refused_as_jax(argv):
    """`cli.main` in a process of one rank raises the ValueError JAX's
    `make_mesh` gives on one device for the same shard counts (data shards
    by default gcd(mbatch_size, devices // model shards)), before any work."""
    cfg_j = cli_j.config_from_args(argv)
    n_data = cfg_j.n_data_shards or math.gcd(cfg_j.mbatch_size,
                                             max(1 // cfg_j.n_model_shards, 1))
    with pytest.raises(ValueError, match="exceeds") as e_j:
        make_mesh_j(n_data, cfg_j.n_model_shards, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="exceeds") as e:
        cli.main(argv + ["--test", "1", "--platform", "cpu"])
    assert str(e.value) == str(e_j.value)
