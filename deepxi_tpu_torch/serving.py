"""Serving exports (follows deepxi_tpu/serving.py): the offline enhancer
and the real-time streaming step written as `torch.export` programs that
load and run without any model code or re-trace.

The kernels on these paths are `deepxi::` ops (`ops.kernels.kernel_op`), so
an exported program calls the hand-written kernels on the card and their
plain versions on the CPU; it is never the plain PyTorch composition. The
loaders register the ops (`ops.kernels.load_ops`) before they load.

Layout under ``out_dir``::

    manifest.json          {"ver", "gain", "batch", "buckets", "platforms",
                            "n_devices", "f_s", "N_s"}
    enhancer_L<L>.pt2      x: int16[batch, L] -> float32[batch, (T+1)*N_s]

    stream_manifest.json   {"ver", "kind", "batch", "hop_batch", "N_s",
                            "platforms"[, "cache_dtype"]}
    stream_init.pt2        () -> the zeroed stream state, a flat tuple
    stream_step.pt2        (state, int16[batch, hop_batch*N_s])
                           -> (state, float32[batch, hop_batch*N_s])

The weights are in each program. A bundle runs on the device it was
exported on (`platforms`: ["cuda"] or ["cpu"]); export it where it serves.
On the card `StreamingServer.step` captures the loaded step once as a CUDA
graph and replays it every hop, this card's counterpart of the one compiled
dispatch a hop of the JAX artifact.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from deepxi_tpu_torch import resolve_device
from deepxi_tpu_torch.ops.kernels import load_ops
from deepxi_tpu_torch.utils.profiling import annotate

# Warm-up steps on a side stream before the streaming step is captured (as
# tools/torch_profile.captured): the first calls allocate what later calls
# reuse, which must not happen under capture.
WARMUPS = 3


class _Enhancer(torch.nn.Module):
    """`enhance(params, x)` with the weights held as buffers, so that the
    exported program carries them."""

    def __init__(self, enhance: Callable, params):
        super().__init__()
        self.enhance, self.names = enhance, list(params)
        for i, name in enumerate(self.names):
            self.register_buffer(f"w{i}", params[name])

    def forward(self, x):
        return self.enhance({n: getattr(self, f"w{i}") for i, n in enumerate(self.names)}, x)


def export_enhancer(inp_tgt, network, params, out_dir: str,
                    gain: str = "mmse-lsa", batch: int = 32,
                    buckets: Sequence[int] = (8192, 16384, 32768, 65536,
                                              131072, 262144),
                    apply_fn: Optional[Callable] = None,
                    mesh=None, ver: str = "model", device=None) -> list:
    """Export `enhance.make_enhancer` (with `apply_fn`, e.g. the kernels'
    `resnetv2_apply_fused`) at each bucket length on `device` (the card
    unless ``device="cpu"``); returns the written paths. There is no
    `precision`: the port's DFT is float32. A ResLSTM or ResBiLSTM network
    exports its recurrence as one `deepxi::masked_lstm` call a direction a
    block.

    With a ("data", "model") `mesh` the bundle is multi-card: the program
    is the one each rank runs on its batch / n_data rows, the manifest's
    `n_devices` is the mesh's size, and `load_server` needs a mesh of that
    size. Every rank calls it; rank 0 writes the bundle."""
    import torch.distributed as dist

    from deepxi_tpu_torch.enhance import make_enhancer
    from deepxi_tpu_torch.ops.kernels.spectral import dft_tables
    from deepxi_tpu_torch.parallel import is_primary
    from deepxi_tpu_torch.parallel.mesh import DATA_AXIS, mesh_shape

    n_devices, rows = 1, batch
    if mesh is not None:
        n_data = mesh_shape(mesh)[DATA_AXIS]
        n_devices = mesh.size()
        if batch % n_data:
            raise ValueError(f"batch {batch} must divide over the "
                             f"{n_data}-way data axis")
        rows = batch // n_data
    dev = resolve_device(device)
    dft_tables(inp_tgt.N_d, inp_tgt.N_s, inp_tgt.K, dev)
    module = _Enhancer(make_enhancer(inp_tgt, network, gain, apply_fn=apply_fn, device=dev),
                       {k: v.to(dev) for k, v in params.items()})
    primary = mesh is None or is_primary()  # on a mesh, rank 0 writes
    os.makedirs(out_dir, exist_ok=True)
    written = []
    with torch.no_grad():
        for L in buckets:
            path = os.path.join(out_dir, f"enhancer_L{int(L)}.pt2")
            if primary:
                x = torch.zeros(rows, int(L), dtype=torch.int16, device=dev)
                torch.export.save(torch.export.export(module, (x,)), path)
            written.append(path)
    if primary:
        manifest = {"ver": ver, "gain": gain, "batch": batch,
                    "buckets": [int(b) for b in buckets], "platforms": [dev.type],
                    "n_devices": n_devices, "f_s": int(inp_tgt.f_s),
                    "N_s": int(inp_tgt.N_s)}
        with open(os.path.join(out_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
    if mesh is not None:
        dist.barrier()
    return written


def _load(path: str):
    """The exported program at `path`, callable (the `deepxi::` ops
    registered first)."""
    load_ops()
    return torch.export.load(path).module()


class EnhancerServer:
    """Loaded export bundle: call with int16 [B, n] (B <= batch), get the
    enhanced float waveform [B, n'] (numpy) trimmed to the per-utterance
    iSTFT length convention of the offline driver.

    A multi-card bundle (`n_devices` > 1) needs a mesh of that size: every
    rank calls the server with the same input, pads it to the global batch,
    runs its rows on its card, and all-gathers the rows over "data"."""

    def __init__(self, out_dir: str, mesh=None):
        with open(os.path.join(out_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.batch = int(self.manifest["batch"])
        self.N_s = int(self.manifest["N_s"])
        n_dev = int(self.manifest.get("n_devices", 1))
        self._data = None
        if n_dev > 1:
            if mesh is None or mesh.size() != n_dev:
                raise ValueError(
                    f"bundle was exported for {n_dev} devices; pass a mesh "
                    f"of that size to load_server(..., mesh=...)")
            from deepxi_tpu_torch.parallel.mesh import DATA_AXIS, Axis
            self._data = Axis(mesh, DATA_AXIS)
        self.device = resolve_device(self.manifest["platforms"][0])
        self._fns = {int(L): _load(os.path.join(out_dir, f"enhancer_L{L}.pt2"))
                     for L in self.manifest["buckets"]}

    def bucket_for(self, n: int) -> int:
        for L in sorted(self._fns):
            if n <= L:
                return L
        raise ValueError(f"input of {n} samples exceeds the largest "
                         f"exported bucket ({max(self._fns)})")

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.int16)
        B, n = x.shape
        if B > self.batch:
            raise ValueError(f"batch {B} > exported batch {self.batch}")
        L = self.bucket_for(n)
        xp = np.zeros((self.batch, L), np.int16)
        xp[:B, :n] = x
        with torch.no_grad():
            if self._data is None:
                y = self._fns[L](torch.from_numpy(xp).to(self.device))
            else:
                per = self.batch // self._data.size
                i = self._data.index
                y = self._data.all_gather(self._fns[L](
                    torch.from_numpy(xp[i * per:(i + 1) * per]).to(self.device)))
            y = y.cpu().numpy()
        n_frames = -(-n // self.N_s)
        return y[:B, : (n_frames + 1) * self.N_s]


def load_server(out_dir: str, mesh=None) -> EnhancerServer:
    return EnhancerServer(out_dir, mesh=mesh)


class _StreamInit(torch.nn.Module):
    def __init__(self, sm, batch: int):
        super().__init__()
        self.sm, self.batch = sm, batch

    def forward(self):
        return tuple(pytree.tree_leaves(self.sm.init_state(self.batch)))


class _StreamStep(torch.nn.Module):
    """A step on the state as a flat tuple of tensors."""

    def __init__(self, step: Callable, spec):
        super().__init__()
        self.step, self.spec = step, spec

    def forward(self, flat, chunk):
        state, y = self.step(pytree.tree_unflatten(list(flat), self.spec), chunk)
        return tuple(pytree.tree_leaves(state)), y


def export_streaming(sm, out_dir: str, batch: int = 64,
                     hop_batch: int = 1, ver: str = "model") -> list:
    """Export a real-time streaming step on `sm`'s device.

    ``sm`` is a `streaming.StreamingEnhancer` or `streaming.StreamingMHANet`
    (weights in the programs). Two programs are written, `stream_init`
    (() -> the zeroed state of ``batch`` streams, a flat tuple of tensors)
    and `stream_step` ((state, int16[batch, hop_batch*N_s]) -> (state,
    float32[batch, hop_batch*N_s])). ``hop_batch > 1`` exports the chunked
    `step_block` (MHANet only): H hops a call, H x 16 ms added latency. As
    `sm.step`, the step writes the MHANet caches in place and the state it
    returns shares them; a `StreamingMHANet(fused=True)` calls the KV-cache
    kernel as the op `deepxi::mha_cache_step`. Returns the written paths."""
    step_fn = sm.step
    if hop_batch > 1:
        if not hasattr(sm, "step_block"):
            raise ValueError("hop_batch > 1 needs a chunked step_block "
                             "(StreamingMHANet)")
        step_fn = sm.step_block
    os.makedirs(out_dir, exist_ok=True)
    state0 = sm.init_state(batch)
    flat, spec = pytree.tree_flatten(state0)
    chunk = torch.zeros(batch, hop_batch * sm.N_s, dtype=torch.int16, device=sm.device)
    paths = []
    with torch.no_grad():
        for name, module, args in (("stream_init", _StreamInit(sm, batch), ()),
                                   ("stream_step", _StreamStep(step_fn, spec),
                                    (tuple(flat), chunk))):
            path = os.path.join(out_dir, f"{name}.pt2")
            torch.export.save(torch.export.export(module, args), path)
            paths.append(path)
    manifest = {"ver": ver, "kind": "streaming", "batch": batch,
                "hop_batch": hop_batch, "N_s": int(sm.N_s),
                "platforms": [sm.device.type]}
    if hasattr(sm, "cache_dtype"):
        manifest["cache_dtype"] = str(sm.cache_dtype).removeprefix("torch.")
    with open(os.path.join(out_dir, "stream_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return paths


class StreamingServer:
    """Loaded streaming bundle: ``init_state()`` then repeated
    ``state, y = server.step(state, chunk)``; chunk is int16
    [B, hop_batch*N_s], y the enhanced float32 hop(s).

    `step` consumes `state`, as the port's streaming does. On the card the
    first step captures the loaded step as one CUDA graph (after WARMUPS
    warm-up steps on a side stream), and every step replays it: the chunk is
    copied into the captured input, the graph replayed, every tensor of the
    returned state copied into the captured state (the MHANet caches are
    written in place, so they are the same tensors), and y returned as a new
    tensor. The state a step returns is the server's captured state, so a
    server carries one batch of streams at a time: a state it did not
    return is first copied into the captured one. A capture that fails
    raises; the server never carries on eagerly on the card. On the CPU the
    loaded program runs eagerly."""

    def __init__(self, out_dir: str):
        with open(os.path.join(out_dir, "stream_manifest.json")) as f:
            self.manifest = json.load(f)
        self.batch = int(self.manifest["batch"])
        self.hop_batch = int(self.manifest["hop_batch"])
        self.N_s = int(self.manifest["N_s"])
        self.device = resolve_device(self.manifest["platforms"][0])
        self._init = _load(os.path.join(out_dir, "stream_init.pt2"))
        self._step = _load(os.path.join(out_dir, "stream_step.pt2"))
        self._graph = None
        self.replays = 0

    def init_state(self):
        with torch.no_grad():
            return tuple(self._init())

    def step(self, state, chunk):
        with annotate("deepxi.stream.step"), torch.no_grad():
            chunk = torch.as_tensor(chunk, device=self.device).to(torch.int16)
            state = tuple(state)
            if self.device.type != "cuda":
                new, y = self._step(state, chunk)
                return tuple(new), y
            if self._graph is None:
                self._capture(state, chunk)
            else:
                self._chunk.copy_(chunk)
                with annotate("deepxi.stream.state"):
                    for a, b in zip(self._state, state):
                        if a is not b:
                            a.copy_(b)
            with annotate("deepxi.stream.replay"):
                self._graph.replay()
            self.replays += 1
            with annotate("deepxi.stream.state"):
                for a, b in zip(self._state, self._new):
                    if a is not b:
                        a.copy_(b)
            return self._state, self._y.clone()

    def _capture(self, state, chunk) -> None:
        """Capture one step on `state` (which becomes the captured state)
        and a copy of `chunk`. The warm-ups write the cache row that the
        first replay writes again, from the same state and chunk."""
        with annotate("deepxi.stream.capture"):
            self._state, self._chunk = state, chunk.clone()
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(WARMUPS):
                    self._step(self._state, self._chunk)
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                new, self._y = self._step(self._state, self._chunk)
            self._new, self._graph = tuple(new), graph


def load_streaming_server(out_dir: str) -> StreamingServer:
    return StreamingServer(out_dir)
