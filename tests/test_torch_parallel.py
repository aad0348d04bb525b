"""The port's parallel layer (`deepxi_tpu_torch.parallel`) over 4 CPU ranks
(gloo) against the port's single-process runs and the JAX package on the
virtual CPU mesh of tests/conftest.py.

One module-scoped fixture writes seeded inputs (flax-initialised small
nets with biases moved off zero, the MagXi statistics, a batch, signals,
a tiny corpus), spawns 4 fresh interpreters of the JAX-free worker
tools/torch_mp_worker.py over a `file://` rendezvous, and computes the JAX
and single-process references while they run; rank 0 writes every result
to one npz. The limits are the JAX package's own (tests/test_parallel.py,
tests/test_seq_enhance.py, tests/test_ring_attention.py): a train step's
loss rtol 1e-6 and parameters atol 2e-5, a restored checkpoint's next-step
loss rtol 1e-5, the sharded enhancers atol 2e-5 (of the scale for the
ring), the ring attention and `mhanet_ring_apply` 3e-5 on valid rows, and
the 4-rank bundle 1e-6 of the single-card bundle.
"""

import os
import signal
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.enhance import make_enhancer as make_enhancer_j
from deepxi_tpu.inp_tgt import inp_tgt_selector
from deepxi_tpu.models import network_selector
from deepxi_tpu.models.attention import sequence_valid_mask
from deepxi_tpu.parallel import make_mesh as make_mesh_j
from deepxi_tpu.parallel import shard_batch as shard_batch_j
from deepxi_tpu.parallel import shard_params as shard_params_j
from deepxi_tpu.parallel.ring_attention import make_ring_mha_enhancer as ring_enhancer_j
from deepxi_tpu.parallel.seq_enhance import make_seq_sharded_enhancer as seq_enhancer_j
from deepxi_tpu.serving import load_server as load_server_j
from deepxi_tpu.training import TrainState as TrainStateJ
from deepxi_tpu.training import make_optimizer as make_optimizer_j
from deepxi_tpu.training import make_train_step as make_train_step_j
from deepxi_tpu_torch import cli
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.data.wavio import save_wav
from deepxi_tpu_torch.enhance import make_enhancer
from deepxi_tpu_torch.ops.kernels.tcn_fused import resnetv2_apply_fused
from deepxi_tpu_torch.serving import export_enhancer, load_server
from deepxi_tpu_torch.training import save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_mp_worker as W  # noqa: E402
from synth_corpus import synth_noise, synth_utterance  # noqa: E402

WORLD = 4
TIMEOUT_S = 300
MESHES = [f"{a}x{b}" for a, b in W.MESHES]


def _flax_nets():
    """(flax network, params with biases moved off zero) of each small net."""
    nets = {
        "resnet": network_selector("ResNetV2", 257, causal=True, unit_type="ReLU->LN->W+b",
                                   outp_act="Sigmoid", **W.RESNET),
        "mhanet": network_selector("MHANetV3", 257, causal=True, outp_act="Sigmoid",
                                   **W.MHANET),
        "seq": network_selector("ResNetV2", 257, causal=True, unit_type="ReLU->LN->W+b",
                                outp_act="Sigmoid", **W.SEQ_RESNET),
    }
    out = {}
    for i, (k, net) in enumerate(nets.items()):
        p = net.init(jax.random.PRNGKey(i), jnp.zeros((1, 16, 257)))
        out[k] = (net, jax.tree_util.tree_map(
            lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a), p))
    return out


def _corpus(root):
    """8 clean utterances of 0.5-0.9 s and 2 noise clips, the set layout."""
    rng = np.random.RandomState(4)
    for d in ("train_clean_speech", "train_noise"):
        os.makedirs(os.path.join(root, d))
    for i in range(8):
        save_wav(os.path.join(root, "train_clean_speech", f"sp{i}.wav"),
                 synth_utterance(rng, 0.5 + 0.1 * (i % 5)), 16000)
    for j in range(2):
        save_wav(os.path.join(root, "train_noise", f"n{j}.wav"),
                 synth_noise(rng, ("white", "pink")[j], 2.0), 16000)


def _spawn(work, corpus):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "torch_mp_worker.py"), "--rank", str(r),
         "--world", str(WORLD), "--init", f"file://{work}/rendezvous", "--inputs",
         f"{work}/inputs.npz", "--work", work, "--corpus", corpus],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(WORLD)]


def _wait(procs):
    """Every rank's output; all killed if one fails or the time runs out."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
            if p.returncode != 0:
                break
    except subprocess.TimeoutExpired:
        logs.append(f"timed out after {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


def _jax_step(net, params, it_j, kind, z, shape):
    """JAX's train step on an n_data x n_model mesh of the virtual devices,
    noise as long as each utterance (offsets 0): (loss, flat params)."""
    tx = make_optimizer_j("ResNetV2") if kind == "resnet" else make_optimizer_j("MHANetV3",
                                                                                32, 100)
    mesh = make_mesh_j(*shape)
    state = TrainStateJ.create(shard_params_j(mesh, params), tx)
    s, d = shard_batch_j(mesh, (jnp.asarray(z["s"]), jnp.asarray(z["d"])))
    lens = jnp.asarray(z["lens"])
    state, m = jax.jit(make_train_step_j(net, it_j, tx))(
        state, jax.random.PRNGKey(0), s, d, lens, lens, jnp.asarray(z["snr"]))
    return float(m["loss"]), {k: v.numpy() for k, v in from_flax_params(
        jax.device_get(state.params)).items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("mp"))
    corpus = os.path.join(work, "set")
    _corpus(corpus)
    nets = _flax_nets()
    it_j = inp_tgt_selector("MagXi", N_d=512, N_s=256, K=512, f_s=16000,
                            map_type="DBNormalCDF", map_params=None)
    sample = (np.abs(np.random.RandomState(0).randn(64, 257)) ** 2).astype(np.float32)
    it_j = it_j.replace(xi_map=it_j.xi_map.with_stats(jnp.asarray(sample)))
    W.write_inputs(os.path.join(work, "inputs.npz"),
                   {k: {n: v.numpy() for n, v in from_flax_params(p).items()}
                    for k, (_, p) in nets.items()},
                   np.asarray(it_j.xi_map.mu), np.asarray(it_j.xi_map.sigma))
    z = np.load(os.path.join(work, "inputs.npz"))
    save_checkpoint(os.path.join(work, "ckpt1"), 0, W.train_step(z, "resnet")[1])
    procs = _spawn(work, corpus)
    try:
        ref = {}
        # JAX on the same meshes of the virtual devices
        for kind in ("resnet", "mhanet"):
            for shape, name in zip(W.MESHES, MESHES):
                ref[f"jax_{kind}_{name}"] = _jax_step(*nets[kind], it_j, kind, z, shape)
            ref[f"port_{kind}"] = W.train_step(z, kind)
        mesh4 = make_mesh_j(4, 1)
        net, params = nets["seq"]
        ref["jax_seq"] = np.asarray(seq_enhancer_j(
            it_j, net, "mmse-lsa", mesh=mesh4, n_blocks=6, max_d_rate=4, k=3)(
                params, jnp.asarray(z["x_seq"])))
        errs = {}
        for what, fn in (
                ("network", lambda: seq_enhancer_j(it_j, network_selector(
                    "MHANetV2", 257, d_model=32, n_blocks=1, n_heads=4, causal=True,
                    outp_act="Sigmoid"), mesh=mesh4)),
                ("causal", lambda: seq_enhancer_j(it_j, network_selector(
                    "ResNetV2", 257, causal=False, unit_type="ReLU->LN->W+b",
                    outp_act="Sigmoid", **W.SEQ_RESNET), mesh=mesh4)),
                ("short", lambda: seq_enhancer_j(it_j, net, mesh=mesh4, n_blocks=6,
                                                 max_d_rate=4, k=3)(
                    params, jnp.zeros(4 * 256 * 2, jnp.int16)))):
            with pytest.raises(ValueError) as e:
                fn()
            errs[what] = str(e.value)
        ref["jax_seq_err"] = errs
        it = W.magxi(z)
        seq = W._params(z, "seq")
        ref["port_seq"] = make_enhancer(
            it, W.network("seq"), apply_fn=lambda p, m: resnetv2_apply_fused(
                p, m, n_blocks=6, max_d_rate=4), device="cpu")(
            seq, z["x_seq"][None])[0, :W.N_SEQ].numpy()
        net_m, params_m = nets["mhanet"]
        ref["flax_apply"] = np.asarray(net_m.apply(params_m, jnp.asarray(z["ring_mag"])))
        ref["jax_ring"] = np.asarray(ring_enhancer_j(
            it_j, mesh=mesh4, n_blocks=2, n_heads=4, d_model=32, max_len=64,
            precision="highest", block_q=64)(params_m, jnp.asarray(z["x_seq"])))
        ref["port_offline_mha"] = make_enhancer(it, W.network("mhanet"), device="cpu")(
            W._params(z, "mhanet"), z["x_seq"][None])[0, :W.N_SEQ].numpy()
        single = os.path.join(work, "bundle1")
        export_enhancer(it, W.network("resnet"), W._params(z, "resnet"), single,
                        batch=W.SERVE_BATCH, buckets=(W.SERVE_BUCKET,), device="cpu",
                        ver="test-tiny", apply_fn=lambda p, m: resnetv2_apply_fused(
                            p, m, n_blocks=2, max_d_rate=2))
        ref["serve_single"] = load_server(single)(z["x_serve"])
        with pytest.raises(ValueError) as e:
            from deepxi_tpu.serving import export_enhancer as export_enhancer_j
            export_enhancer_j(it_j, nets["resnet"][0], nets["resnet"][1],
                              os.path.join(work, "b3_j"), batch=3, buckets=(8192,),
                              mesh=mesh4)
        ref["jax_serve_err_batch"] = str(e.value)
        four = os.path.join(work, "four_j")
        os.makedirs(four)
        with open(os.path.join(four, "manifest.json"), "w") as f:
            f.write('{"batch": 4, "N_s": 256, "n_devices": 4, "buckets": []}')
        with pytest.raises(ValueError) as e:
            load_server_j(four)
        ref["jax_serve_err_mesh"] = str(e.value)
        assert cli.main(W.cli_argv(corpus, os.path.join(work, "cli_single"))) == 0
    finally:
        _wait(procs)
    res = dict(np.load(os.path.join(work, "results.npz")))
    ref["port_ckpt_world1"] = W.next_step_loss(z, os.path.join(work, "ckpt"))
    ref["port_ckpt1_world1"] = W.next_step_loss(z, os.path.join(work, "ckpt1"))
    return types.SimpleNamespace(res=res, ref=ref, z=z, work=work)


def _params_of(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _assert_step(loss, params, loss_ref, params_ref):
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-6)
    assert params.keys() == params_ref.keys()
    for k in params:
        np.testing.assert_allclose(params[k], params_ref[k], rtol=0, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", ["resnet", "mhanet"])
def test_dp_step_matches_single_process(run, kind, mesh):
    """The step on the mesh (batch rows over "data", output channels over
    "model") against the port's step in one process."""
    loss, state = run.ref[f"port_{kind}"]
    _assert_step(float(run.res[f"dp_{kind}_{mesh}_loss"]),
                 _params_of(run.res, f"dp_{kind}_{mesh}_p."),
                 loss, {k: v.numpy() for k, v in state.params.items()})


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", ["resnet", "mhanet"])
def test_dp_step_matches_jax(run, kind, mesh):
    """The step on the mesh against JAX's step on the same mesh shape."""
    _assert_step(float(run.res[f"dp_{kind}_{mesh}_loss"]),
                 _params_of(run.res, f"dp_{kind}_{mesh}_p."), *run.ref[f"jax_{kind}_{mesh}"])


@pytest.mark.parametrize("saved", ["ckpt", "ckpt1"])
def test_checkpoint_restores_across_meshes(run, saved):
    """Saved under 2x2 (rank 0 writes the gathered state; "ckpt") or in one
    process ("ckpt1"), restored under 4x1, 2x2 and in one process: the next
    step's losses agree."""
    base = run.ref[f"port_{saved}_world1"]
    for mesh in MESHES:
        np.testing.assert_allclose(float(run.res[f"{saved}_{mesh}_loss"]), base, rtol=1e-5)
    np.testing.assert_allclose(run.ref["port_ckpt_world1"], run.ref["port_ckpt1_world1"],
                               rtol=1e-5)


def test_seq_sharded_matches_offline_and_jax(run):
    y = run.res["seq_y"]
    assert y.shape == (W.N_SEQ,) and np.abs(y).max() > 1e-3
    np.testing.assert_allclose(y, run.ref["port_seq"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(y, run.ref["jax_seq"], rtol=0, atol=2e-5)


@pytest.mark.parametrize("what", ["network", "causal", "short"])
def test_seq_sharded_refusals_match_jax(run, what):
    assert str(run.res[f"seq_err_{what}"]) == run.ref["jax_seq_err"][what]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_full_softmax(run, causal):
    """Over 4 ranks against full softmax on the gathered sequence, valid
    rows (global-position causal mask, additive -1e10)."""
    z = run.z
    q, k, v = (torch.as_tensor(z[f"ring_{n}"]) for n in ("q", "k", "v"))
    valid = torch.as_tensor(z["ring_valid"]) > 0
    T = q.shape[1]
    logits = torch.einsum("btHd,bsHd->bHts", q, k)
    m = valid[:, None, :] & valid[:, :, None]
    if causal:
        m = m & torch.ones(T, T, dtype=torch.bool).tril()[None]
    logits = logits + (-1.0e10) * (1.0 - m[:, None].float())
    ref = torch.einsum("bHts,bsHd->btHd", torch.softmax(logits, -1), v).numpy()
    out = run.res["ring_causal" if causal else "ring_full"]
    vm = valid.numpy()
    np.testing.assert_allclose(out[vm], ref[vm], rtol=0, atol=3e-5)


def test_mhanet_ring_apply_matches_flax(run):
    """`mhanet_ring_apply` over 4 ranks against flax MHANetV3.apply on the
    gathered input (128 frames: positions wrap at max_len 64), valid frames."""
    valid = np.asarray(sequence_valid_mask(jnp.asarray(run.z["ring_mag"])))
    np.testing.assert_allclose(run.res["ring_apply"][valid], run.ref["flax_apply"][valid],
                               rtol=0, atol=3e-5)


def test_ring_enhancer_matches_offline_and_jax(run):
    y = run.res["ring_y"]
    assert y.shape == (W.N_SEQ,)
    for ref in (run.ref["port_offline_mha"], run.ref["jax_ring"]):
        scale = np.abs(ref).max() + 1e-12
        np.testing.assert_allclose(y / scale, ref / scale, rtol=0, atol=2e-5)


def test_bundle_on_four_ranks_matches_single_card(run):
    y = run.res["serve_y"]
    assert y.shape == run.ref["serve_single"].shape == (3, 25 * 256)
    np.testing.assert_allclose(y, run.ref["serve_single"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("what", ["batch", "mesh"])
def test_bundle_refusals_match_jax(run, what):
    assert str(run.res[f"serve_err_{what}"]) == run.ref[f"jax_serve_err_{what}"]


def _losses(root):
    rows = open(os.path.join(root, "log", "loss", "resnet-1.1c.csv")).read().split()
    return np.array([float(r.split(",")[1]) for r in rows[1:]])


def test_cli_train_on_2x2_mesh_matches_single_process(run):
    """`cli.main --train 1 --n_data_shards 2 --n_model_shards 2` on 4 ranks
    (the fused training stack's plain versions): rank 0 writes the loss CSV
    and the checkpoints, and the epoch losses are the single-process run's."""
    assert int(run.res["cli_rc"]) == 0
    multi, single = (os.path.join(run.work, d) for d in ("cli", "cli_single"))
    assert len(_losses(multi)) == 2
    np.testing.assert_allclose(_losses(multi), _losses(single), rtol=1e-6)
    for e in (0, 1):
        assert os.path.exists(os.path.join(multi, "model", "resnet-1.1c", f"epoch-{e}",
                                           "state.pt"))
