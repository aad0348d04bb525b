"""The port's serving exports (`deepxi_tpu_torch.serving`) against the JAX
package's (`deepxi_tpu.serving`) on the CPU: the exported offline enhancer
and the exported streaming step on the JAX tests' small nets (biases moved
off zero), the same inputs drawn by numpy from a seed and the weights
carried by `from_flax_params`; the errors and manifests; the `deepxi::`
kernel ops in every exported graph; a bundle loaded by a fresh interpreter,
and the first parallel MKL VML call of fresh interpreters, which once made
such a child's output differ;
`DeepXiTorch.export_serving` through `--export 1`; and `utils.profiling`
against `deepxi_tpu.utils`. The card's checks (each op against its wrapper,
the server's CUDA graph against the eager hop) are in
tests/test_torch_cuda.py."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.enhance import make_enhancer as make_enhancer_j
from deepxi_tpu.inp_tgt import inp_tgt_selector
from deepxi_tpu.models import network_selector
from deepxi_tpu.ops.kernels import mha_block_fused as block_j
from deepxi_tpu.ops.kernels import tcn_fused as tcn_j
from deepxi_tpu.serving import export_enhancer as export_enhancer_j
from deepxi_tpu.serving import export_streaming as export_streaming_j
from deepxi_tpu.serving import load_server as load_server_j
from deepxi_tpu.serving import load_streaming_server as load_streaming_server_j
from deepxi_tpu.streaming import StreamingEnhancer as StreamingEnhancerJ
from deepxi_tpu.streaming import StreamingMHANet as StreamingMHANetJ
from deepxi_tpu.utils import StageTimer as StageTimerJ
from deepxi_tpu_torch import cli, serving
from deepxi_tpu_torch.compat.artifact import from_flax_params
from deepxi_tpu_torch.enhance import make_enhancer
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models.attention import MHANetV3
from deepxi_tpu_torch.models.tcn import ResNetV2
from deepxi_tpu_torch.ops.kernels import OP_NAMESPACE
from deepxi_tpu_torch.ops.kernels.mha_block_fused import mhanetv3_apply_fused
from deepxi_tpu_torch.ops.kernels.tcn_fused import resnetv2_apply_fused
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.streaming import StreamingEnhancer, StreamingMHANet
from deepxi_tpu_torch.training import TrainState, make_optimizer, save_checkpoint
from deepxi_tpu_torch.utils import StageTimer, annotate, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_serving.py's net and buckets; the input forces the 16384
# bucket, its padding and the trim
SMALL_TCN = dict(d_model=32, n_blocks=4, d_f=16, k=3, max_d_rate=4)
SMALL_MHA = dict(d_model=32, n_blocks=2, n_heads=4, causal=True, max_len=128)
BUCKETS, BATCH, N_IN = (8192, 16384), 4, 10000


@pytest.fixture(scope="module")
def its():
    """The JAX tests' MagXi (DBNormalCDF stats of a seeded sample) and the
    port's with the same statistics."""
    it_j = inp_tgt_selector("MagXi", N_d=512, N_s=256, K=512, f_s=16000,
                            map_type="DBNormalCDF", map_params=None)
    sample = (np.abs(np.random.RandomState(0).randn(64, 257)) ** 2).astype(np.float32)
    it_j = it_j.replace(xi_map=it_j.xi_map.with_stats(jnp.asarray(sample)))
    stats = {k: torch.as_tensor(np.array(getattr(it_j.xi_map, k))) for k in ("mu", "sigma")}
    return it_j, MagXi(xi_map=NormalCDF(use_db=True, **stats))


def _shifted(params):
    """Biases and LayerNorm terms moved off their initial values."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
                                  params)


@pytest.fixture(scope="module")
def tcn():
    net_j = network_selector("ResNetV2", 257, causal=True, unit_type="ReLU->LN->W+b",
                             outp_act="Sigmoid", **SMALL_TCN)
    params = _shifted(net_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 257))))
    return net_j, params, ResNetV2(257, 257, **SMALL_TCN), from_flax_params(params)


@pytest.fixture(scope="module")
def mha():
    net_j = network_selector("MHANetV3", 257, outp_act="Sigmoid", **SMALL_MHA)
    params = _shifted(net_j.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 257))))
    return net_j, params, MHANetV3(257, 257, **SMALL_MHA), from_flax_params(params)


def _tcn_apply(**kw):
    return lambda p, m: resnetv2_apply_fused(p, m, n_blocks=4, max_d_rate=4, **kw)


def _mha_apply(p, m):
    return mhanetv3_apply_fused(p, m, n_blocks=2, n_heads=4, d_model=32, max_len=128)


def _noisy(seed, B, n):
    return (np.random.RandomState(seed).randn(B, n) * 3000).astype(np.int16)


def _padded(x, L):
    xp = np.zeros((BATCH, L), np.int16)
    xp[:x.shape[0], :x.shape[1]] = x
    return xp


@pytest.fixture(scope="module")
def tcn_bundles(its, tcn, tmp_path_factory):
    """The port's and the JAX package's bundles of the small ResNetV2
    through their fused TCN forwards (the JAX kernel in interpret mode)."""
    (it_j, it), (net_j, params_j, net, params) = its, tcn
    out, out_j = (str(tmp_path_factory.mktemp(n)) for n in ("port", "jax"))
    paths = serving.export_enhancer(it, net, params, out, batch=BATCH, buckets=BUCKETS,
                                    apply_fn=_tcn_apply(), ver="test-tiny", device="cpu")
    export_enhancer_j(it_j, net_j, params_j, out_j, batch=BATCH, buckets=BUCKETS,
                      apply_fn=lambda p, m: tcn_j.resnetv2_apply_fused(
                          p, m, n_blocks=4, max_d_rate=4), ver="test-tiny")
    return out, out_j, paths


# Measured on the CPU: 3.9e-7 max abs against the JAX server; the live
# enhancer gives the bundle's numbers exactly. Held to 1e-5 and 1e-6.
def test_enhancer_bundle_matches_jax_server(its, tcn, tcn_bundles):
    out, out_j, paths = tcn_bundles
    assert [os.path.basename(p) for p in paths] == ["enhancer_L8192.pt2",
                                                    "enhancer_L16384.pt2"]
    x = _noisy(1, 2, N_IN)
    server, server_j = serving.load_server(out), load_server_j(out_j)
    assert server.bucket_for(N_IN) == server_j.bucket_for(N_IN) == 16384
    y, y_j = server(x), server_j(x)
    assert isinstance(y, np.ndarray) and y.shape == y_j.shape == (2, 41 * 256)
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-5)
    live = make_enhancer(its[1], tcn[2], apply_fn=_tcn_apply(), device="cpu")
    y_live = live(tcn[3], _padded(x, 16384)).numpy()[:2, :y.shape[1]]
    np.testing.assert_allclose(y, y_live, rtol=0, atol=1e-6)


# Measured on the CPU: 1.3e-7 max abs. Held to 1e-5.
def test_mhanet_enhancer_bundle_matches_jax(its, mha, tmp_path):
    """The small causal MHANetV3 through `mhanetv3_apply_fused` against the
    JAX enhancer with its fused-block apply (Pallas interpret mode)."""
    (it_j, it), (net_j, params_j, net, params) = its, mha
    serving.export_enhancer(it, net, params, str(tmp_path), batch=BATCH,
                            buckets=(16384,), apply_fn=_mha_apply, device="cpu")
    x = _noisy(2, 2, N_IN)
    y = serving.load_server(str(tmp_path))(x)
    live_j = make_enhancer_j(it_j, net_j, "mmse-lsa", precision="highest",
                             apply_fn=lambda p, m: block_j.mhanetv3_apply_fused(
                                 p, m, n_blocks=2, n_heads=4, d_model=32, max_len=128))
    y_j = np.asarray(live_j(params_j, jnp.asarray(_padded(x, 16384))))[:2, :y.shape[1]]
    assert y.shape == (2, 41 * 256)
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-5)


def _drive(step, state, chunks):
    outs = []
    for c in chunks:
        state, y = step(state, c)
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)


def _streamers(case, its, tcn, mha):
    """(port streamer, JAX streamer, hop_batch) of a case."""
    (it_j, it), (net_j, params_j, net, params) = its, (tcn if case == "resnet" else mha)
    if case == "resnet":
        return (StreamingEnhancer(it, net, params, device="cpu"),
                StreamingEnhancerJ(it_j, net_j, params_j), 1)
    sm_j = StreamingMHANetJ(it_j, net_j, params_j, "mmse-lsa")
    if case == "mhanet_hop_batch2":
        return StreamingMHANet(it, net, params, device="cpu"), sm_j, 2
    return StreamingMHANet(it, net, params, fused=True, device="cpu"), sm_j, 1


# Measured on the CPU: 1.5e-7 (resnet), 4.5e-8 (hop_batch 2) and 5.2e-8
# (fused) max abs against the JAX server; the live streamer gives the
# server's numbers exactly. Held to 1e-5, tests/test_serving_streaming.py's
# limit, and 1e-6.
@pytest.mark.parametrize("case", ["resnet", "mhanet_hop_batch2", "mhanet_fused"])
def test_streaming_bundle_matches_jax(its, tcn, mha, tmp_path, case):
    """Both servers on the same chunks from their zeroed states, 5 steps
    of B=2: the ResNet hop, MHANet's step_block of 2 hops, and the fused
    MHANet hop (the KV-cache op); the manifests carry the JAX keys (and the
    port's cache dtype for MHANet)."""
    sm, sm_j, H = _streamers(case, its, tcn, mha)
    out, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    serving.export_streaming(sm, out, batch=2, hop_batch=H, ver="t")
    export_streaming_j(sm_j, out_j, batch=2, hop_batch=H, ver="t")
    srv, srv_j = serving.load_streaming_server(out), load_streaming_server_j(out_j)
    assert (srv.batch, srv.hop_batch, srv.N_s) == (srv_j.batch, srv_j.hop_batch, 256)
    extra = set(srv.manifest) - set(srv_j.manifest)
    assert set(srv_j.manifest) <= set(srv.manifest)
    assert extra == (set() if case == "resnet" else {"cache_dtype"})
    assert srv.manifest["platforms"] == ["cpu"]
    chunks = [_noisy(10 + i, 2, H * 256) for i in range(5)]
    y = _drive(srv.step, srv.init_state(), chunks)
    y_j = _drive(srv_j.step, srv_j.init_state(), chunks)
    assert y.shape == y_j.shape == (2, 5 * H * 256)
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-5)
    step = sm.step if H == 1 else sm.step_block
    np.testing.assert_allclose(y, _drive(step, sm.init_state(2), chunks), rtol=0, atol=1e-6)


def test_errors_match_jax(its, tcn, tcn_bundles, tmp_path):
    out, out_j, _ = tcn_bundles
    for srv in (serving.load_server(out), load_server_j(out_j)):
        with pytest.raises(ValueError, match="exceeds"):
            srv(np.zeros((1, 20000), np.int16))
        with pytest.raises(ValueError, match="batch"):
            srv(np.zeros((5, 1000), np.int16))
    sm = StreamingEnhancer(its[1], tcn[2], tcn[3], device="cpu")
    with pytest.raises(ValueError, match="step_block"):
        serving.export_streaming(sm, str(tmp_path / "s"), batch=1, hop_batch=4)
    # the multi-card refusals: a batch that does not divide over a 4-way
    # data axis (the port's mesh, a 4 x 1 DeviceMesh, needs no group for
    # that check), and a bundle exported for 4 devices loaded without a mesh
    from torch.distributed.device_mesh import DeviceMesh

    from deepxi_tpu.parallel import make_mesh as make_mesh_j
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(4, 1), mesh_dim_names=("data", "model"),
                      _init_backend=False, _rank=0)
    errors = []
    for export, it, net, p, kw in (
            (serving.export_enhancer, its[1], tcn[2], tcn[3], dict(mesh=mesh, device="cpu")),
            (export_enhancer_j, its[0], tcn[0], tcn[1], dict(mesh=make_mesh_j(4, 1)))):
        with pytest.raises(ValueError, match="4-way data axis") as e:
            export(it, net, p, str(tmp_path / "m"), batch=3, buckets=BUCKETS, **kw)
        errors.append(str(e.value))
    for d, load in ((out, serving.load_server), (out_j, load_server_j)):
        four = tmp_path / ("four_" + os.path.basename(d))
        shutil.copytree(d, four)
        m = json.load(open(four / "manifest.json"))
        json.dump(dict(m, n_devices=4), open(four / "manifest.json", "w"))
        with pytest.raises(ValueError, match="exported for 4 devices") as e:
            load(str(four))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and errors[2] == errors[3]


def test_manifest_keys_match_jax(tcn_bundles):
    out, out_j, _ = tcn_bundles
    m, m_j = (json.load(open(os.path.join(d, "manifest.json"))) for d in (out, out_j))
    assert set(m) == set(m_j)
    assert m["platforms"] == ["cpu"] and m["n_devices"] == 1
    for k in ("ver", "gain", "batch", "buckets", "f_s", "N_s"):
        assert m[k] == m_j[k], k


def _ops(path):
    """The `deepxi::` op calls of an exported program, by op name."""
    ep = torch.export.load(path)
    names = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    ops = {}
    for name in names:
        if name.startswith(OP_NAMESPACE + "."):
            op = name.split(".")[1]
            ops[op] = ops.get(op, 0) + 1
    return ops


ROUTES = {
    # route: (network, apply_fn or the module's attention, the op calls)
    "resnet_whole": ("tcn", _tcn_apply(), {"fused_block_group_whole": 1}),
    "resnet_tiled": ("tcn", _tcn_apply(whole_max_t=32), {"fused_block_group": 2}),
    "resnet_pack2": ("tcn", _tcn_apply(pack2=True), {"fused_block_group_whole_pack2": 1}),
    "mhanet_blocks": ("mha", _mha_apply, {"fused_transformer_block": 2}),
    "mhanet_fused_attention": ("mha", "fused", {"flash_attention": 2}),
    "mhanet_stream_attention": ("mha", "stream", {"flash_attention_streaming": 2}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_exported_graphs_call_the_kernel_ops(its, tcn, mha, tmp_path, route):
    """Each kernel route's export holds its `deepxi::` op where the kernel
    sits (so the program is not the plain composition) and gives the live
    enhancer's output (exactly, measured; held to 1e-6)."""
    kind, apply, want = ROUTES[route]
    _, _, net, params = tcn if kind == "tcn" else mha
    if isinstance(apply, str):
        net = MHANetV3(257, 257, attention_impl=apply, **SMALL_MHA)
        apply = None
    (path,) = serving.export_enhancer(its[1], net, params, str(tmp_path), batch=2,
                                      buckets=(16384,), apply_fn=apply, device="cpu")
    assert _ops(path) == want
    x = _noisy(3, 2, N_IN)
    y = serving.load_server(str(tmp_path))(x)
    live = make_enhancer(its[1], net, apply_fn=apply, device="cpu")
    xp = np.zeros((2, 16384), np.int16)
    xp[:, :N_IN] = x
    np.testing.assert_allclose(y, live(params, xp).numpy()[:, :y.shape[1]], rtol=0,
                               atol=1e-6)


def test_streaming_graphs_call_the_cache_op(its, mha, tmp_path):
    """The fused MHANet step exports one KV-cache op a block and writes the
    caches in place; the einsum route exports none."""
    for fused in (True, False):
        sm = StreamingMHANet(its[1], mha[2], mha[3], fused=fused, device="cpu")
        d = str(tmp_path / str(fused))
        serving.export_streaming(sm, d, batch=1)
        ops = _ops(os.path.join(d, "stream_step.pt2"))
        assert ops == ({"mha_cache_step": 2} if fused else {})
        srv = serving.load_streaming_server(d)
        state = srv.init_state()
        caches = state[:4]
        new, _ = srv.step(state, _noisy(4, 1, 256))
        assert all(a is b for a, b in zip(new[:4], caches))
        assert all(c[0, 0].abs().sum() > 0 for c in caches)
        assert int(new[4]) == 1 and new[4].dtype == torch.int32


def test_fresh_interpreter_loads_a_bundle(its, tcn, tmp_path):
    """A process that imports only `deepxi_tpu_torch.serving` loads the
    bundle and gives the same output; one that registers no `deepxi::` op
    cannot load it. The bundle is this test's own (no other test's files),
    and each child process is given the import path of this checkout
    explicitly rather than through its working directory, as the other
    fresh-interpreter checks do (tests/test_torch_metrics.py)."""
    _, _, net, params = tcn
    out = str(tmp_path / "bundle")
    paths = serving.export_enhancer(its[1], net, params, out, batch=BATCH, buckets=BUCKETS,
                                    apply_fn=_tcn_apply(), ver="test-tiny", device="cpu")
    x = _noisy(5, 3, 7000)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    code = ("import sys, numpy as np\n"
            "from deepxi_tpu_torch.serving import load_server\n"
            "y = load_server(sys.argv[1])(np.load(sys.argv[2]))\n"
            "np.save(sys.argv[3], y)\n")
    r = subprocess.run([sys.executable, "-c", code, out, str(tmp_path / "x.npy"),
                        str(tmp_path / "y.npy")], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), serving.load_server(out)(x))
    r = subprocess.run([sys.executable, "-c", "import sys, torch; "
                        "torch.export.load(sys.argv[1])", paths[0]], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "not registered" in r.stderr


VML_CHILD = """
import numpy as np, torch
import deepxi_tpu_torch  # noqa: F401  (what every entry point imports first)
a = torch.from_numpy(np.random.RandomState(0).rand(1 << 18).astype(np.float32) * 100)
y = torch.sqrt(a)                                   # parallel: 8 chunks, 8 threads
ref = torch.cat([torch.sqrt(c) for c in a.split(4096)])  # one thread, below the grain
print(int((y != ref).sum()))
"""


def test_first_parallel_vml_call_of_a_fresh_process_is_exact():
    """The cause of the fresh interpreter's rare other output above: ATen
    hands `sqrt` (and exp, log, erfinv, ...) to MKL's VML, and where VML's
    first call in a process comes from several OpenMP threads at once, one
    thread now and then computes its chunk at VML's lower accuracy (up to
    2.4e-3 on values up to 100; in 5-12 of 120 fresh processes run 8 at a
    time on an 8-core host, and the served output then differs in one
    utterance). Importing `deepxi_tpu_torch` runs those functions once on
    one thread first: 32 fresh interpreters, 8 at a time, each give a
    parallel `torch.sqrt` bitwise equal to the same values taken one chunk
    at a time."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("OMP_NUM_THREADS", None)
    counts = []
    for _ in range(4):
        procs = [subprocess.Popen([sys.executable, "-c", VML_CHILD], cwd=ROOT, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for _ in range(8)]
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err
            counts.append(int(out.split()[-1]))
    assert counts == [0] * 32, counts


def test_cli_export_round_trips(tmp_path, tcn, its):
    """`--export 1` on a tiny epoch (a checkpoint and map statistics as
    training writes them) writes the bundle of `export_serving`, which
    gives the live enhancer's output."""
    _, _, net, params = tcn
    it = its[1]
    data, model, out = (str(tmp_path / d) for d in ("data", "model", "serving"))
    os.makedirs(data)
    np.savez(os.path.join(data, "tiny_stats.npz"), **{
        "xi_map.mu": it.xi_map.mu.numpy(), "xi_map.sigma": it.xi_map.sigma.numpy()})
    save_checkpoint(os.path.join(model, "tiny"), 0,
                    TrainState.create(params, make_optimizer("ResNetV2")))
    argv = ["--ver", "tiny", "--network_type", "ResNetV2", "--d_model", "32",
            "--n_blocks", "4", "--d_f", "16", "--k", "3", "--max_d_rate", "4",
            "--unit_type", "ReLU->LN->W+b", "--test_epoch", "1", "--export", "1",
            "--export_path", out, "--platform", "cpu", "--data_path", data,
            "--model_path", model]
    assert cli.main(argv) == 0
    m = json.load(open(os.path.join(out, "manifest.json")))
    assert (m["ver"], m["gain"], m["batch"]) == ("tiny", "mmse-lsa", 32)
    assert m["buckets"] == [8192, 16384, 32768, 65536, 131072, 262144]
    assert _ops(os.path.join(out, "enhancer_L8192.pt2")) == {"fused_block_group_whole": 1}
    x = _noisy(6, 2, 5000)
    y = serving.load_server(out)(x)
    xp = np.zeros((32, 8192), np.int16)
    xp[:2, :5000] = x
    live = make_enhancer(it, net, apply_fn=_tcn_apply(), device="cpu")
    np.testing.assert_allclose(y, live(params, xp).numpy()[:2, :y.shape[1]], rtol=0,
                               atol=1e-6)


def test_stage_timer_matches_jax():
    """The same calls give the same counts, and the same totals the same
    report, line for line."""
    t, t_j = StageTimer(), StageTimerJ()
    for timer, block in ((t, {"y": torch.ones(64, 64).sum()}), (t_j, jnp.ones(3).sum())):
        with timer.stage("a"):
            pass
        with timer.stage("a", block_on=block):
            pass
        with timer.stage("b"):
            pass
    assert t.counts == t_j.counts == {"a": 2, "b": 1}
    t.totals, t_j.totals = {"a": 1.25, "b": 0.5}, {"a": 1.25, "b": 0.5}
    assert t.report() == t_j.report()
    assert t.report().splitlines()[0].startswith("a ")
    t.reset()
    assert not t.totals and not t.counts


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    with trace(None):
        torch.ones(4).sum()
    d = tmp_path / "trace"
    with trace(str(d)):
        with annotate("serving_region"):
            torch.ones(256, 256).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.load(open(d / files[0]))["traceEvents"]
    assert any(e.get("name") == "serving_region" for e in events)


def test_dft_tables_are_made_outside_the_trace_and_fakes_are_not_kept():
    """`dft_tables` keys the DFT matrices by a tensor's own device, so an
    export finds them made (on the card an unmade one is a fake tensor, which
    export refuses); a table first asked for under fake tensors is not kept
    for later eager calls."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from deepxi_tpu_torch.ops.kernels import spectral

    class Stft(torch.nn.Module):
        def forward(self, x):
            return spectral.stft_reim(x, 512, 256, 512)

    x = torch.randn(1, 2048)
    saved = dict(spectral._DEVICE_TABLES)
    spectral._DEVICE_TABLES.clear()
    try:
        with FakeTensorMode():
            fake = spectral._on_device("analysis", (512, 512), x.device)
        assert type(fake) is not torch.Tensor and not spectral._DEVICE_TABLES
        spectral.dft_tables(512, 256, 512, "cpu")
        made = dict(spectral._DEVICE_TABLES)
        assert len(made) == 2 and all(key[2] == x.device for key in made)
        ep = torch.export.export(Stft(), (x,))
        assert spectral._DEVICE_TABLES == made
        assert all(type(c) is torch.Tensor for c in ep.constants.values())
        torch.testing.assert_close(ep.module()(x), spectral.stft_reim(x, 512, 256, 512),
                                   rtol=0, atol=0)
    finally:
        spectral._DEVICE_TABLES.clear()
        spectral._DEVICE_TABLES.update(saved)
