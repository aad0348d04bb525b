"""One rank of the port's parallel layer on the CPU (gloo), with no JAX:
the counterpart of tools/mp_worker.py for `deepxi_tpu_torch.parallel`.

Every rank of an N-rank group runs

    python tools/torch_mp_worker.py --rank R --world 4 \
        --init file:///tmp/rendezvous --inputs in.npz --work DIR

with the same inputs (weights, statistics, batches and signals made by the
caller from a seed; `write_inputs` makes them in that layout), and rank 0
writes every result to DIR/results.npz:

  * dp_<net>_<n_data>x<n_model>_loss / _p.<leaf>: one train step of the
    small ResNetV2 and MHANetV3 (`train_step`) on the 4x1 and 2x2 meshes;
  * ckpt_<n_data>x<n_model>_loss, ckpt1_...: the next-step loss of a
    checkpoint saved under 2x2, and of the caller's saved in one process
    (DIR/ckpt1), restored on each mesh (`next_step_loss`);
  * seq_y and seq_err_*: the sequence-sharded enhancer of the small causal
    ResNetV2 over 4 ranks on 10.3 s, and its refusals;
  * ring_causal / ring_full, ring_apply, ring_y: `ring_attention`,
    `mhanet_ring_apply` and `make_ring_mha_enhancer` over 4 ranks;
  * serve_y and serve_err_*: a bundle exported under the 4x1 mesh at batch
    4 and served, and its refusals;
  * cli_rc: `cli.main --train 1 --n_data_shards 2 --n_model_shards 2` on the
    caller's corpus (its losses are in DIR/cli/log/loss).

tests/test_torch_parallel.py spawns the ranks and holds each result to the
port's single-process run and to the JAX package.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

# the small nets of tests/test_parallel.py, tests/test_seq_enhance.py and
# tests/test_ring_attention.py (ring and DP MHANetV3 at max_len 64, so
# that positions wrap)
RESNET = dict(d_model=32, n_blocks=2, d_f=16, k=3, max_d_rate=2)
MHANET = dict(d_model=32, n_blocks=2, n_heads=4, max_len=64)
SEQ_RESNET = dict(d_model=32, n_blocks=6, d_f=16, k=3, max_d_rate=4)
MESHES = ((4, 1), (2, 2))
B, L = 8, 4096
N_SEQ = 4 * 256 * 40 + 1000           # every shard longer than the halo; ragged
RING = dict(B=2, T=4 * 24, H=4, d=8, block_q=16)
RING_T = 4 * 32                       # frames of mhanet_ring_apply's input
SERVE_BATCH, SERVE_BUCKET = 4, 8192
CLI_SHARDS = ["--n_data_shards", "2", "--n_model_shards", "2"]


def write_inputs(path: str, params: dict, mu: np.ndarray, sigma: np.ndarray) -> None:
    """The seeded inputs in the layout `main` reads: `params` maps "resnet",
    "mhanet" and "seq" to flat state dicts (numpy), `mu` and `sigma` are the
    MagXi map's statistics; the batch, signals and ring tensors are drawn
    here."""
    rng = np.random.RandomState(0)
    z = {f"{net}.{k}": v for net, p in params.items() for k, v in p.items()}
    z["mu"], z["sigma"] = mu, sigma
    z["s"] = (rng.randn(B, L) * 3000).astype(np.int16)
    z["d"] = (rng.randn(B, L) * 1000).astype(np.int16)
    z["lens"] = np.array([L, 3000, L, 2500, L, 4000, 3500, L], np.int32)
    z["snr"] = np.linspace(0.0, 15.0, B).astype(np.float32)
    z["x_seq"] = (rng.randn(N_SEQ) * 3000).astype(np.int16)
    R = RING
    for k in ("q", "k", "v"):
        z[f"ring_{k}"] = rng.randn(R["B"], R["T"], R["H"], R["d"]).astype(np.float32)
    z["ring_valid"] = (np.arange(R["T"])[None, :]
                       < np.array([[R["T"]], [70]])).astype(np.float32)
    mag = np.abs(rng.randn(1, RING_T, 257)).astype(np.float32)
    mag[0, 100:] = 0.0
    z["ring_mag"] = mag
    z["x_serve"] = (rng.randn(3, 6000) * 3000).astype(np.int16)
    np.savez(path, **z)


def _params(z, net: str) -> dict:
    p = f"{net}."
    return {k[len(p):]: torch.as_tensor(z[k]) for k in z.files if k.startswith(p)}


def _flax_tree(z, net: str) -> dict:
    """The flax parameter tree of `net` that the caller flattened."""
    tree: dict = {}
    for k, v in _params(z, net).items():
        *path, leaf = k.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v.numpy()
    return {"params": tree}


def magxi(z):
    from deepxi_tpu_torch.inp_tgt import MagXi
    from deepxi_tpu_torch.ops.maps import NormalCDF
    return MagXi(N_d=512, N_s=256, K=512, xi_map=NormalCDF(
        use_db=True, mu=torch.as_tensor(z["mu"]), sigma=torch.as_tensor(z["sigma"])))


def network(kind: str, causal: bool = True):
    from deepxi_tpu_torch.models.attention import MHANetV2, MHANetV3
    from deepxi_tpu_torch.models.tcn import ResNetV2
    if kind == "mhanet":
        return MHANetV3(257, 257, causal=True, outp_act="Sigmoid", **MHANET)
    if kind == "mhanetv2":
        return MHANetV2(257, 257, d_model=32, n_blocks=1, n_heads=4, causal=True)
    kw = RESNET if kind == "resnet" else SEQ_RESNET
    return ResNetV2(257, 257, causal=causal, unit_type="ReLU->LN->W+b", **kw)


def train_step(z, kind: str, mesh=None, state=None):
    """One train step of `kind` ("resnet": ResNetV2 with Adam 1e-3;
    "mhanet": MHANetV3 with the Transformer schedule, warmup 100) on the
    whole batch of `z`, noise as long as each utterance (offsets 0), on
    `mesh` or in one process, from the flax tree (this rank's part of it on
    a mesh, `from_flax_params(tree, mesh)`) or from a whole `state`.
    Returns (loss, the whole state after it)."""
    from deepxi_tpu_torch.compat.artifact import from_flax_params
    from deepxi_tpu_torch.training import (TrainState, gather_state, make_optimizer,
                                           make_train_step, shard_state, shardings_of)
    tx = make_optimizer("ResNetV2") if kind == "resnet" else make_optimizer("MHANetV3", 32,
                                                                            100)
    shardings = None if mesh is None else shardings_of(mesh, _params(z, kind))
    if state is None:
        state = TrainState.create(from_flax_params(_flax_tree(z, kind), mesh), tx)
    elif mesh is not None:
        state = shard_state(mesh, state, shardings)
    step = make_train_step(network(kind), magxi(z), tx, mesh=mesh, shardings=shardings)
    lens = torch.as_tensor(z["lens"])
    state, m = step(state, torch.as_tensor(z["s"]), torch.as_tensor(z["d"]), lens, lens,
                    torch.as_tensor(z["snr"]), offsets=torch.zeros(B, dtype=torch.int64))
    if mesh is not None:
        state = gather_state(mesh, state, shardings)
    return float(m["loss"]), state


def next_step_loss(z, ckpt_dir: str, mesh=None) -> float:
    """The resnet checkpoint of epoch 0 in `ckpt_dir` restored (on `mesh`,
    or in one process) and stepped once."""
    from deepxi_tpu_torch.training import TrainState, make_optimizer, restore_checkpoint
    template = TrainState.create(_params(z, "resnet"), make_optimizer("ResNetV2"))
    state = restore_checkpoint(ckpt_dir, 0, template)
    assert state.step == 1
    return train_step(z, "resnet", mesh, state)[0]


def seq_enhancer(z, mesh, net=None):
    from deepxi_tpu_torch.ops.kernels.tcn_fused import resnetv2_apply_fused
    from deepxi_tpu_torch.parallel.seq_enhance import make_seq_sharded_enhancer
    kw = dict(n_blocks=6, max_d_rate=4, k=3)
    return make_seq_sharded_enhancer(
        magxi(z), net or network("seq"), "mmse-lsa", mesh=mesh, **kw,
        apply_fn=lambda p, m: resnetv2_apply_fused(p, m, **kw), device="cpu")


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def run(a) -> dict:
    import torch.distributed as dist

    from deepxi_tpu_torch import cli
    from deepxi_tpu_torch.parallel import init_distributed, is_primary, make_mesh
    from deepxi_tpu_torch.parallel.mesh import DATA_AXIS, Axis
    from deepxi_tpu_torch.parallel.ring_attention import (make_ring_mha_enhancer,
                                                          mhanet_ring_apply, ring_attention)
    from deepxi_tpu_torch.serving import export_enhancer, load_server
    from deepxi_tpu_torch.training import save_checkpoint

    # collectives give up instead of hanging when a rank has failed
    init_distributed(a.init, a.world, a.rank, backend="gloo",
                     timeout=datetime.timedelta(seconds=120))
    z = np.load(a.inputs)
    res = {}
    meshes = {shape: make_mesh(*shape) for shape in MESHES}

    for kind in ("resnet", "mhanet"):
        for (n_d, n_m), mesh in meshes.items():
            loss, state = train_step(z, kind, mesh)
            res[f"dp_{kind}_{n_d}x{n_m}_loss"] = loss
            res.update({f"dp_{kind}_{n_d}x{n_m}_p.{k}": v.numpy()
                        for k, v in state.params.items()})

    # a checkpoint saved under 2x2 by rank 0, and the caller's saved in one
    # process (ckpt1), each restored on each mesh
    ckpt = os.path.join(a.work, "ckpt")
    _, state = train_step(z, "resnet", meshes[2, 2])
    if is_primary():
        save_checkpoint(ckpt, 0, state)
    dist.barrier()
    for (n_d, n_m), mesh in meshes.items():
        for name in ("ckpt", "ckpt1"):
            res[f"{name}_{n_d}x{n_m}_loss"] = next_step_loss(z, os.path.join(a.work, name),
                                                            mesh)

    mesh = meshes[4, 1]
    data = Axis(mesh, DATA_AXIS)
    seq = _params(z, "seq")
    res["seq_y"] = seq_enhancer(z, mesh)(seq, z["x_seq"]).numpy()
    res["seq_err_network"] = _error(lambda: seq_enhancer(z, mesh, network("mhanetv2")))
    res["seq_err_causal"] = _error(lambda: seq_enhancer(z, mesh, network("seq", False)))
    res["seq_err_short"] = _error(lambda: seq_enhancer(z, mesh)(
        seq, np.zeros(4 * 256 * 2, np.int16)))

    R = RING
    Ts = R["T"] // data.size
    rows = slice(data.index * Ts, (data.index + 1) * Ts)
    qkv = [torch.as_tensor(z[f"ring_{k}"])[:, rows] for k in ("q", "k", "v")]
    valid = torch.as_tensor(z["ring_valid"])[:, rows]
    for causal in (True, False):
        out = ring_attention(*qkv, valid, data.index * Ts, data, data.size, causal,
                             t_total=R["T"], block_q=R["block_q"])
        res["ring_causal" if causal else "ring_full"] = data.all_gather(out, 1).numpy()
    mha = _params(z, "mhanet")
    Tm = RING_T // data.size
    mag = torch.as_tensor(z["ring_mag"])[:, data.index * Tm:(data.index + 1) * Tm]
    y = mhanet_ring_apply(mha, mag, data.index * Tm, data, data.size, n_blocks=2,
                          n_heads=4, d_model=32, max_len=64, causal=True, block_q=16)
    res["ring_apply"] = data.all_gather(y, 1).numpy()
    enhance = make_ring_mha_enhancer(magxi(z), mesh, "mmse-lsa", n_blocks=2, n_heads=4,
                                     d_model=32, max_len=64, block_q=64, device="cpu")
    res["ring_y"] = enhance(mha, z["x_seq"]).numpy()

    from deepxi_tpu_torch.ops.kernels.tcn_fused import resnetv2_apply_fused
    bundle = os.path.join(a.work, "bundle4")
    kw = dict(buckets=(SERVE_BUCKET,), device="cpu", ver="test-tiny",
              apply_fn=lambda p, m: resnetv2_apply_fused(p, m, n_blocks=2, max_d_rate=2))
    export_enhancer(magxi(z), network("resnet"), _params(z, "resnet"), bundle,
                    batch=SERVE_BATCH, mesh=mesh, **kw)
    res["serve_y"] = load_server(bundle, mesh=mesh)(z["x_serve"])
    res["serve_err_batch"] = _error(lambda: export_enhancer(
        magxi(z), network("resnet"), _params(z, "resnet"), os.path.join(a.work, "b3"),
        batch=3, mesh=mesh, **kw))
    res["serve_err_mesh"] = _error(lambda: load_server(bundle))

    res["cli_rc"] = cli.main(cli_argv(a.corpus, os.path.join(a.work, "cli")) + CLI_SHARDS)
    return res


def cli_argv(corpus: str, out: str) -> list:
    """A tiny resnet-1.1c command line (the fused training stack's plain
    versions on the CPU) training 2 epochs on `corpus`, writing under `out`."""
    return ["--ver", "resnet-1.1c", "--d_model", "32", "--n_blocks", "3", "--d_f", "16",
            "--max_d_rate", "2", "--mbatch_size", "4", "--sample_size", "8",
            "--max_epochs", "2", "--min_snr", "0", "--max_snr", "10", "--snr_inter", "5",
            "--val_flag", "0", "--train", "1", "--platform", "cpu",
            "--set_path", corpus] + [f"--{k}_path={os.path.join(out, k)}"
                                     for k in ("data", "model", "log")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="rendezvous, e.g. file:///tmp/x")
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--work", required=True)
    ap.add_argument("--corpus", required=True)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist
    try:
        res = run(a)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    if a.rank == 0:
        np.savez(os.path.join(a.work, "results.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
