"""The port's process group and mesh in one process (as
tests/test_parallel.py:181-209 tests the JAX package's): explicit
arguments make a failure fatal, auto-detection without a launcher stays
single-process and logs why, NCCL never gives way to gloo; `make_mesh`'s
shapes and errors against JAX's `make_mesh` on one device;
`param_sharding` of flax-shaped parameters against JAX's specs; a
world-size-1 gloo group, where the train step and `DeepXiTorch.train` on
the 1 x 1 mesh equal the unsharded ones bitwise (the card runs them so,
over NCCL, in chip_smoke.py phase 3n); and a scan of the port, chip_smoke.py
and the card's tools for any import of JAX or of the JAX package."""

import ast
import glob
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from deepxi_tpu.models import network_selector
from deepxi_tpu.parallel import make_mesh as make_mesh_j
from deepxi_tpu.parallel import param_sharding as param_sharding_j
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.parallel import (batch_sharding, distributed, init_distributed,
                                       is_primary, local_batch_slice, make_mesh,
                                       param_sharding, replicated, shard_batch, shard_params)
from deepxi_tpu_torch.parallel import mesh as meshlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_mp_worker as W  # noqa: E402


@pytest.fixture()
def no_launcher(monkeypatch):
    for k in distributed.LAUNCH_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)


def test_explicit_args_propagate_failure(monkeypatch, no_launcher):
    def boom(*a, **kw):
        raise RuntimeError("rendezvous unreachable")
    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="rendezvous"):
        init_distributed("tcp://10.0.0.1:1234", world_size=4, rank=0, backend="gloo")
    # a launcher's environment that does not rendezvous is fatal too
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "4"), ("MASTER_ADDR", "10.0.0.1"),
                 ("MASTER_PORT", "1234")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="rendezvous"):
        init_distributed(backend="gloo")


def test_auto_detect_falls_back_quietly(monkeypatch, no_launcher, caplog):
    called = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: called.append(a))
    with caplog.at_level(logging.INFO, logger="deepxi_tpu_torch.parallel.distributed"):
        init_distributed(backend="gloo")  # must not raise
    assert not called and not dist.is_initialized()
    assert any("single-process" in r.message for r in caplog.records)
    assert is_primary() and local_batch_slice(8) == slice(0, 8)


def test_nccl_never_falls_back_to_gloo(monkeypatch, no_launcher):
    """Without a card the default backend raises, with explicit arguments
    or a launcher's environment; it never takes gloo instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: pytest.fail("joined"))
    with pytest.raises(RuntimeError, match="NCCL"):
        init_distributed("tcp://127.0.0.1:1", world_size=2, rank=0)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="NCCL"):
        init_distributed()


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (4, 2), (2, 2)])
def test_make_mesh_exceeds_as_jax_on_one_device(shape):
    """With no group the world is one rank: JAX's error on one device."""
    with pytest.raises(ValueError, match="exceeds") as e_j:
        make_mesh_j(*shape, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="exceeds") as e:
        make_mesh(*shape)
    assert str(e.value) == str(e_j.value)


def test_mesh_must_cover_every_rank(monkeypatch):
    """A mesh smaller than the group raises (a rank outside it would have
    nothing to do), and a 1 x 1 mesh needs a group to be built on."""
    monkeypatch.setattr(meshlib, "process_count", lambda: 4)
    with pytest.raises(ValueError, match="leaves 2 of 4 ranks out"):
        meshlib.check_mesh_size(2, 1)
    meshlib.check_mesh_size(2, 2)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1)


def _flax_params(kind):
    kw = dict(causal=True, outp_act="Sigmoid")
    net = (network_selector("MHANetV3", 257, **W.MHANET, **kw) if kind == "mhanet" else
           network_selector("ResNetV2", 257, unit_type="ReLU->LN->W+b", **W.RESNET, **kw))
    return jax.tree_util.tree_map(np.asarray,
                                  net.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 257))))


@pytest.mark.parametrize("n_model", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["resnet", "mhanet"])
def test_param_sharding_matches_jax_specs(kind, n_model):
    """Each flax-shaped leaf's placements against JAX's PartitionSpec on a
    mesh of the same shape (the port's mesh unbacked: its shape is all
    `param_sharding` reads)."""
    n_data = 8 // n_model
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(n_data, n_model),
                      mesh_dim_names=("data", "model"), _init_backend=False, _rank=0)
    mesh_j = make_mesh_j(n_data, n_model)
    params = _flax_params(kind)
    flat = from_flax_params(params)
    leaves = dict(zip(sorted(flat), [None] * len(flat)))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params["params"])[0]:
        leaves[".".join(p.key for p in path)] = leaf
    n_sharded = 0
    for k, v in flat.items():
        spec = tuple(param_sharding_j(mesh_j, leaves[k]).spec)
        want = ((Replicate(), Shard(v.ndim - 1)) if "model" in spec
                else (Replicate(), Replicate()))
        assert param_sharding(mesh, v) == want, k
        n_sharded += "model" in spec
    assert (n_sharded > 0) == (n_model > 1)


@pytest.fixture()
def world1(tmp_path):
    """A one-rank gloo group for the test, destroyed after it."""
    init_distributed(f"file://{tmp_path}/rendezvous", world_size=1, rank=0, backend="gloo")
    yield make_mesh()
    dist.destroy_process_group()


def test_world1_mesh_step_is_the_unsharded_step(world1, tmp_path):
    """`make_mesh()` in a one-rank group is 1 x 1 (the batch and every
    parameter whole on the one rank), and a train step of each small net
    on it equals the unsharded step bitwise."""
    assert meshlib.mesh_shape(world1) == {"data": 1, "model": 1}
    assert batch_sharding(world1) == (Shard(0), Replicate())
    assert replicated(world1) == (Replicate(), Replicate())
    assert is_primary() and local_batch_slice(8) == slice(0, 8)
    x = torch.arange(24.0).reshape(8, 3)
    assert torch.equal(shard_batch(world1, x), x)
    assert all(torch.equal(a, x) for a in shard_batch(world1, (x, x)))
    assert torch.equal(shard_params(world1, {"w": x})["w"], x)
    with pytest.raises(ValueError, match="exceeds 1 devices"):
        make_mesh(1, 2)
    params = {k: {n: v.numpy() for n, v in from_flax_params(_flax_params(k)).items()}
              for k in ("resnet", "mhanet")}
    params["seq"] = {}
    W.write_inputs(str(tmp_path / "in.npz"), params, np.zeros(257, np.float32) + 5,
                   np.ones(257, np.float32) * 10)
    z = np.load(tmp_path / "in.npz")
    for kind in ("resnet", "mhanet"):
        loss, st = W.train_step(z, kind, world1)
        loss_1, st_1 = W.train_step(z, kind)
        assert loss == loss_1
        assert all(torch.equal(st.params[k], st_1.params[k]) for k in st.params)
        assert all(torch.equal(st.opt_state["nu"][k], st_1.opt_state["nu"][k])
                   for k in st.params)


def test_world1_deepxi_train_is_the_unsharded_train(world1, tmp_path):
    """`DeepXiTorch.train` of a tiny resnet-1.1c (the fused training stack's
    plain versions) in a one-rank group, on its 1 x 1 mesh, against the
    same run with no group: the same losses and parameters, bitwise."""
    from synth_corpus import synth_noise, synth_utterance

    from deepxi_tpu_torch.config import preset
    from deepxi_tpu_torch.data.listing import batch_list
    from deepxi_tpu_torch.data.wavio import save_wav
    from deepxi_tpu_torch.framework import DeepXiTorch
    rng = np.random.RandomState(1)
    for d in ("clean", "noise"):
        os.makedirs(tmp_path / d)
    for i in range(4):
        save_wav(str(tmp_path / "clean" / f"s{i}.wav"), synth_utterance(rng, 0.6), 16000)
    save_wav(str(tmp_path / "noise" / "n.wav"), synth_noise(rng, "white", 2.0), 16000)
    runs = {}
    for name in ("mesh", "none"):
        cfg = preset("resnet-1.1c", d_model=32, n_blocks=3, d_f=16, max_d_rate=2,
                     mbatch_size=2, sample_size=4, max_epochs=1, val_flag=False,
                     **{f"{k}_path": str(tmp_path / name / k) for k in ("data", "model", "log")})
        s_list = batch_list(str(tmp_path / "clean"), "clean", cfg.data_path)
        d_list = batch_list(str(tmp_path / "noise"), "noise", cfg.data_path)
        dx = DeepXiTorch(cfg, s_list, d_list, device="cpu")
        assert (dx.mesh is not None) == (name == "mesh")
        runs[name] = (dx.train(verbose=False), dx._state.params)
        if name == "mesh":
            dist.destroy_process_group()
    assert runs["mesh"][0] == runs["none"][0]
    assert all(torch.equal(runs["mesh"][1][k], runs["none"][1][k]) for k in runs["none"][1])
    init_distributed(f"file://{tmp_path}/rendezvous2", world_size=1, rank=0, backend="gloo")


def test_port_imports_no_jax():
    """No module of the port, chip_smoke.py, or a tool the card runs
    (tools/torch_*.py, the worker among them) imports JAX, flax, optax or
    the JAX package (comments and strings aside)."""
    files = (glob.glob(os.path.join(ROOT, "deepxi_tpu_torch", "**", "*.py"), recursive=True)
             + [os.path.join(ROOT, "chip_smoke.py")]
             + glob.glob(os.path.join(ROOT, "tools", "torch_*.py")))
    assert os.path.join(ROOT, "tools", "torch_mp_worker.py") in files and len(files) > 60
    banned = ("jax", "flax", "optax", "deepxi_tpu")
    found = []
    for f in files:
        for node in ast.walk(ast.parse(open(f).read())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            found += [(os.path.relpath(f, ROOT), node.lineno, m) for m in mods
                      if m.split(".")[0] in banned]
    assert not found
