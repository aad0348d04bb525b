"""Process-group initialisation (follows deepxi_tpu/parallel/distributed.py).

The port runs one process per card, started by a launcher such as

    torchrun --nproc_per_node 4 -m deepxi_tpu_torch --train 1 --n_data_shards 4

or by a caller that passes the rendezvous itself. The group's backend is
NCCL on the cards and gloo only when the caller asks for the CPU; NCCL never
gives way to gloo. Rank r works on card `LOCAL_RANK` (cuda:LOCAL_RANK).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# what a launcher (torchrun, or a scheduler's wrapper) exports for env://
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _card(backend: str, rank: int) -> Optional[torch.device]:
    """For NCCL, the process's card, made the current device: `LOCAL_RANK`,
    else the rank modulo the cards the host has; None for gloo."""
    if backend != "nccl":
        return None
    local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: Optional[datetime.timedelta] = None) -> None:
    """Join the process group; a no-op where one is already joined.

    With no argument the launcher's environment (`LAUNCH_ENV`) is read, and
    without it the process stays single-process and logs why. Explicit
    arguments (an `init_method` such as ``tcp://host:port`` or
    ``file:///path``, or a world size above 1) make any failure fatal, and
    so does a launcher's environment that does not rendezvous. `backend`:
    "nccl" (the default: the cards) or "gloo" (the CPU). `timeout`: how long
    a collective waits for the other ranks (torch's default if None)."""
    if dist.is_initialized():
        return
    backend = backend or "nccl"
    auto = init_method is None and world_size in (None, 1) and rank is None
    missing = [k for k in LAUNCH_ENV if k not in os.environ]
    if auto and missing:
        logger.info("no launcher environment (%s unset): running single-process",
                    ", ".join(missing))
        return
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs CUDA cards; pass backend='gloo' "
                           "to run the group on the CPU")
    if auto:
        dist.init_process_group(backend, init_method="env://", timeout=timeout,
                                device_id=_card(backend, int(os.environ["RANK"])))
    else:
        card = _card(backend, int(os.environ.get("RANK", 0)) if rank is None else rank)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=-1 if world_size is None else world_size,
                                rank=-1 if rank is None else rank, timeout=timeout,
                                device_id=card)


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and outputs."""
    return process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a batch split over the processes."""
    per = global_batch // process_count()
    i = process_index()
    return slice(i * per, (i + 1) * per)
