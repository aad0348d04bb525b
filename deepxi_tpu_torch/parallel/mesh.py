"""The ("data", "model") device mesh and its shardings (follows
deepxi_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` of n_data x n_model
ranks over the whole process group, one process a card: rank r sits at
(r // n_model, r % n_model). Tensors stay plain local tensors; a sharding
is a pair of DTensor placements, one for each mesh axis, and the
collectives run explicitly on the axes' sub-groups (`Axis`).

  * "data": the batch's rows are split over it; gradients are all-reduced
    over it.
  * "model": a weight of two or more dimensions whose last (output-channel)
    axis divides by n_model is split over it; everything else is
    replicated.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from deepxi_tpu_torch.parallel.distributed import process_count

DATA_AXIS = "data"
MODEL_AXIS = "model"
Placements = Tuple[Union[Replicate, Shard], Union[Replicate, Shard]]


def check_mesh_size(n_data: int, n_model: int) -> None:
    """Raise ValueError unless an n_data x n_model mesh covers the process
    group (a world of 1 in a process with no group) exactly."""
    world = process_count()
    if n_data * n_model > world:
        raise ValueError(f"mesh {n_data}x{n_model} exceeds {world} devices")
    if n_data * n_model < world:
        raise ValueError(f"mesh {n_data}x{n_model} leaves {world - n_data * n_model} "
                         f"of {world} ranks out: the port runs one process a card, and "
                         f"a rank outside the mesh would have nothing to do")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DeviceMesh:
    """A ("data", "model") mesh over the process group (`init_distributed`).
    It must cover every rank: each process drives one card, so a rank
    outside the mesh would have nothing to do. Raises ValueError when
    n_data x n_model exceeds the world size (1 in a process with no group)
    or falls short of it, and RuntimeError with no group to build it on."""
    if n_data is None:
        n_data = process_count() // n_model
    check_mesh_size(n_data, n_model)
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "parallel.init_distributed() first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """{"data": n_data, "model": n_model}, as a JAX mesh's `shape`."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


class Axis:
    """One axis of a mesh as this rank sees it: its size, this rank's index
    along it, the global ranks along it, and the collectives on its
    sub-group (the counterparts of `psum`, `all_gather` and `ppermute`)."""

    def __init__(self, mesh: DeviceMesh, name: str):
        dim = list(mesh.mesh_dim_names).index(name)
        coord = list(mesh.get_coordinate())
        index = [slice(None) if i == dim else c for i, c in enumerate(coord)]
        self.ranks: List[int] = mesh.mesh[tuple(index)].tolist()
        self.size = len(self.ranks)
        self.index = coord[dim]
        self.group = mesh.get_group(name)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis, in place."""
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The axis's tensors concatenated along `dim`, in axis order."""
        if self.size == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def exchange(self, sends: Mapping[int, torch.Tensor],
                 recvs: Mapping[int, torch.Tensor]) -> None:
        """One batch of point-to-point transfers: `sends[j]` to the rank at
        index j of the axis, `recvs[j]` filled from index j."""
        # as bytes: NCCL has no int16 (the waveforms)
        ops = [dist.P2POp(dist.isend, t.contiguous().view(torch.uint8), self.ranks[j],
                          self.group) for j, t in sends.items()]
        ops += [dist.P2POp(dist.irecv, t.view(torch.uint8), self.ranks[j], self.group)
                for j, t in recvs.items()]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def shift(self, t: torch.Tensor, step: int, wrap: bool = False) -> torch.Tensor:
        """The `ppermute` of index i -> i + step: what index - step sent
        (zeros at the ends unless `wrap`)."""
        i, n = self.index, self.size
        to, frm = i + step, i - step
        if wrap:
            to, frm = to % n, frm % n
        if n == 1 and wrap:
            return t
        out = torch.zeros_like(t)
        sends = {to: t} if 0 <= to < n else {}
        recvs = {frm: out} if 0 <= frm < n else {}
        self.exchange(sends, recvs)
        return out


def batch_sharding(mesh: DeviceMesh) -> Placements:
    """Batch tensors: leading axis over "data"."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> Placements:
    return (Replicate(), Replicate())


def param_sharding(mesh: DeviceMesh, tensor: torch.Tensor) -> Placements:
    """A weight's placements: its last (output-channel) axis over "model"
    when n_model > 1, it has two or more dimensions and that axis divides
    by n_model; else replicated (always with n_model = 1)."""
    n_model = mesh_shape(mesh)[MODEL_AXIS]
    if n_model > 1 and tensor.ndim >= 2 and tensor.shape[-1] % n_model == 0:
        return (Replicate(), Shard(tensor.ndim - 1))
    return (Replicate(), Replicate())


def local_shard(mesh: DeviceMesh, tensor: torch.Tensor,
                placements: Sequence) -> torch.Tensor:
    """This rank's part of a whole tensor under `placements`."""
    for name, pl in zip((DATA_AXIS, MODEL_AXIS), placements):
        if isinstance(pl, Shard):
            ax = Axis(mesh, name)
            tensor = tensor.chunk(ax.size, dim=pl.dim)[ax.index]
    return tensor.contiguous()


def shard_params(mesh: DeviceMesh, params: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """This rank's part of each parameter under `param_sharding`."""
    return {k: local_shard(mesh, v, param_sharding(mesh, v)).clone()
            for k, v in params.items()}


def gather_params(mesh: DeviceMesh, local: Mapping[str, torch.Tensor],
                  shardings: Mapping[str, Placements]) -> Dict[str, torch.Tensor]:
    """The whole parameters from every rank's parts (`shardings`: each
    whole parameter's `param_sharding`); a collective over "model"."""
    model = Axis(mesh, MODEL_AXIS)
    out = {}
    for k, v in local.items():
        pl = shardings[k][1]
        out[k] = model.all_gather(v, pl.dim) if isinstance(pl, Shard) else v
    return out


def shard_batch(mesh: DeviceMesh, batch):
    """This rank's rows of a batch tensor, or of each of a tuple of them
    (leading axis over "data"; the batch must divide)."""
    data = Axis(mesh, DATA_AXIS)

    def rows(a):
        if a.shape[0] % data.size:
            raise ValueError(f"batch {a.shape[0]} must divide over the {data.size}-way "
                             f"data axis")
        per = a.shape[0] // data.size
        return a[data.index * per:(data.index + 1) * per]

    return tuple(rows(a) for a in batch) if isinstance(batch, (tuple, list)) else rows(batch)
