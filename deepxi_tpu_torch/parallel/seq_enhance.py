"""Sequence-parallel enhancement: the TIME axis of one long recording split
over the mesh's "data" axis (follows deepxi_tpu/parallel/seq_enhance.py).

The causal ResNet family reads at most `receptive_field_frames` past
frames, so each rank enhances its time shard after taking that much left
context (the halo) from rank - 1 and one frame's overhang from rank + 1,
both in one point-to-point exchange; the result is the offline
pipeline's. The halo is recomputation, not communication. Each shard runs
the port's `enhance.make_enhancer` with the caller's `apply_fn`
(`framework.fast_apply_fn`: the fused TCN kernels on the card). Attention
attends over its whole past and has no finite halo: `ring_attention`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from deepxi_tpu_torch import resolve_device
from deepxi_tpu_torch.models.tcn import cyclic_dilation
from deepxi_tpu_torch.parallel.mesh import DATA_AXIS, Axis


def receptive_field_frames(n_blocks: int, max_d_rate: int, k: int = 3) -> int:
    """Causal receptive field of the ResNet TCN stack in frames: the output
    at frame t reads frames [t - R + 1, t], R = 1 + the blocks' reaches."""
    return 1 + sum((k - 1) * cyclic_dilation(i, max_d_rate) for i in range(n_blocks))


def make_seq_sharded_enhancer(inp_tgt, network, gtype: str = "mmse-lsa", mesh=None,
                              halo_frames: Optional[int] = None, n_blocks: int = 40,
                              max_d_rate: int = 16, k: int = 3,
                              apply_fn: Optional[Callable] = None,
                              device=None) -> Callable:
    """Build `enhance(params, x_int16[n]) -> y[n]` with time split over the
    mesh's "data" axis; every rank calls it with the whole recording and
    gets the whole enhanced waveform back (all-gathered).

    The input is padded to a multiple of n_shards * N_s and the output cut
    back to n. Each rank runs the offline enhancer on [halo + shard +
    overhang] samples and keeps its shard's hop rows. `halo_frames`
    defaults to the stack's receptive field. There is no `precision`: the
    port's DFT is float32."""
    from deepxi_tpu_torch.enhance import make_enhancer

    if mesh is None:
        raise ValueError("a mesh is required")
    name = type(network).__name__
    if name not in ("ResNet", "ResNetV2", "ResNetV3"):
        raise ValueError(
            f"sequence sharding needs a finite-receptive-field causal TCN "
            f"(ResNet family), got {name}; attention attends over its whole "
            f"past and has no finite halo")
    if not getattr(network, "causal", False):
        raise ValueError("sequence sharding requires a causal network")
    dev = resolve_device(device)
    N_s = inp_tgt.N_s
    data = Axis(mesh, DATA_AXIS)
    n_sh = data.size
    if halo_frames is None:
        halo_frames = receptive_field_frames(n_blocks, max_d_rate, k)
    halo = halo_frames * N_s
    right = inp_tgt.N_d - N_s  # a frame reads N_d samples a hop of N_s
    core = make_enhancer(inp_tgt, network, gtype, apply_fn=apply_fn, device=dev)

    @torch.no_grad()
    def enhance(params, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=dev)
        n = x.shape[-1]
        chunk = n_sh * N_s
        n_pad = -(-n // chunk) * chunk
        if n_pad // n_sh < halo:
            raise ValueError(
                f"input of {n} samples gives {n_pad // n_sh}-sample shards, "
                f"shorter than the {halo}-sample halo (receptive field "
                f"{halo_frames} frames); sequence sharding needs long audio "
                f"-- use the batch path for short utterances")
        x = F.pad(x, (0, n_pad - n))
        Ls = n_pad // n_sh
        x_sh = x[data.index * Ls:(data.index + 1) * Ls]
        # the halo from rank - 1 (zeros on rank 0: the start of the audio)
        # and the last frame's overhang from rank + 1 (zeros on the last
        # rank: the offline pipeline's pad_end zeros), in one exchange
        left_h = torch.zeros(halo, dtype=x.dtype, device=dev)
        right_h = torch.zeros(right, dtype=x.dtype, device=dev)
        i = data.index
        sends, recvs = {}, {}
        if i + 1 < n_sh:
            sends[i + 1] = x_sh[-halo:]
            recvs[i + 1] = right_h
        if i > 0:
            sends[i - 1] = x_sh[:right]
            recvs[i - 1] = left_h
        data.exchange(sends, recvs)
        y = core(params, torch.cat([left_h, x_sh, right_h])[None])[0, halo:halo + Ls]
        if i == 0:
            # the first halo hops: rank 0's zero-sample halo is not the
            # offline stack's zero-activation padding (zero samples still
            # give bias and LN activations), so they come from an offline
            # pass over the prefix
            head = core(params, x[None, :halo + right])[0, :halo]
            y = torch.cat([head, y[halo:]])
        return data.all_gather(y.contiguous())[:n]

    return enhance
