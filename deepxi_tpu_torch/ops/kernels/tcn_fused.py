"""Fused ResNetV2 block groups (follows deepxi_tpu/ops/kernels/tcn_fused.py).

Two CUDA kernels for Hopper (`csrc/tcn_fused.cu`) replace the two Pallas
kernels of the inference path:

  * `fused_block_group_whole`: for T <= `whole_max_t`; one launch per block,
    each CTA a time tile plus the 2d rows its dilated conv reaches back.
  * `fused_block_group`: the halo-tiled group; one launch per group, each CTA
    carrying the shrinking window of its tile through all G blocks.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
version (`*_ref`, the same arithmetic in PyTorch) for a CPU tensor. Each has
a plain-integer `launches` counter that counts kernel launches.

These are inference routes: like `pallas_call`, they have no backward, and
with autograd on they raise when an input or weight requires grad, on both
devices. Training takes `tcn_fused_train.resnetv2_apply_fused_train`.

The TPU layout knobs of the JAX module (`pack2`, `batch_group`) are left
out: they reshape work for the TPU's matrix unit and do not change the
function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Sequence

import torch

from deepxi_tpu_torch.models.tcn import (cyclic_dilation, layer_norm,
                                         output_activation)

# The kernels are built for resnet-1.1c's widths.
KERNEL_D_MODEL, KERNEL_D_F, KERNEL_K = 256, 64, 3

# Group and tile of the halo-tiled route. A CTA's window is (tile_t + halo)
# rows of 1,592 bytes (h, two d_f buffers, LN moments), and a Hopper block
# holds 227 KB: 146 rows. The JAX defaults (G = 20, tile 640, halo 248) need
# 888 rows; G = 5 has halo 62 -> 64, leaving a tile of 80.
TILED_GROUP, TILED_TILE_T = 5, 80


class BlockWeights(NamedTuple):
    """One bottleneck block (kernel layouts as in the JAX model)."""
    w1: torch.Tensor  # [1, d_model, d_f]
    b1: torch.Tensor  # [d_f]
    w2: torch.Tensor  # [k, d_f, d_f]
    b2: torch.Tensor  # [d_f]
    w3: torch.Tensor  # [1, d_f, d_model]
    b3: torch.Tensor  # [d_model]


def random_block_weights(G: int, generator: torch.Generator, device,
                         d_model: int = KERNEL_D_MODEL, d_f: int = KERNEL_D_F,
                         k: int = KERNEL_K) -> List[BlockWeights]:
    """G blocks of N(0, 1/fan_in) kernels and N(0, 0.1^2) biases (nonzero, as
    in a trained net), drawn on the CPU from `generator`."""

    def rnd(*shape, std):
        return (torch.randn(*shape, generator=generator) * std).to(device)

    return [BlockWeights(rnd(1, d_model, d_f, std=d_model ** -0.5),
                         rnd(d_f, std=0.1),
                         rnd(k, d_f, d_f, std=(k * d_f) ** -0.5),
                         rnd(d_f, std=0.1),
                         rnd(1, d_f, d_model, std=d_f ** -0.5),
                         rnd(d_model, std=0.1)) for _ in range(G)]


def _block(h, bw: BlockWeights, d: int, k: int, zero_rows: torch.Tensor = None):
    """One block on [N, W, C] rows; returns the W - (k-1)d newest rows of the
    output. `zero_rows` ([N, W, 1] bool) marks pre-sequence rows of a2."""
    reach = (k - 1) * d
    a2 = layer_norm(torch.relu(layer_norm(torch.relu(h)) @ bw.w1[0] + bw.b1))
    if zero_rows is not None:
        a2 = torch.where(zero_rows, 0.0, a2)
    W_out = a2.shape[1] - reach
    y = a2[:, reach:] @ bw.w2[k - 1]
    for j in range(k - 1):
        y = y + a2[:, j * d: j * d + W_out] @ bw.w2[j]
    a3 = layer_norm(torch.relu(y + bw.b2))
    return h[:, reach:] + (a3 @ bw.w3[0] + bw.b3)


def fused_block_group_whole_ref(x: torch.Tensor,
                                weights: Sequence[BlockWeights],
                                dilations: Sequence[int],
                                k: int = 3) -> torch.Tensor:
    """Plain version of the whole-sequence group: each dilated conv
    zero-pads its own input by its reach, as the model's causal padding."""
    h = x
    for bw, d in zip(weights, dilations):
        reach = (k - 1) * d
        hp = torch.nn.functional.pad(h, (0, 0, reach, 0))
        pre = torch.zeros(1, hp.shape[1], 1, dtype=torch.bool, device=h.device)
        pre[:, :reach] = True
        h = _block(hp, bw, d, k, pre)
    return h


def _halo(dilations: Sequence[int], k: int) -> int:
    halo = sum((k - 1) * d for d in dilations)
    return -(-halo // 8) * 8


def fused_block_group_ref(x: torch.Tensor, weights: Sequence[BlockWeights],
                          dilations: Sequence[int], k: int = 3,
                          tile_t: int = TILED_TILE_T) -> torch.Tensor:
    """Plain version of the halo-tiled group: every tile carries a window of
    `halo` rows before it through the G blocks, shrinking by each block's
    reach; on the first tile the pre-sequence rows of a2 are zeroed before
    every dilated conv."""
    B, T, C = x.shape
    halo = _halo(dilations, k)
    n_tiles = -(-T // tile_t)
    xp = torch.nn.functional.pad(x, (0, 0, halo, n_tiles * tile_t - T))
    # [B, n_tiles, C, tile_t + halo] -> [B * n_tiles, tile_t + halo, C]
    h = xp.unfold(1, tile_t + halo, tile_t).permute(0, 1, 3, 2)
    h = h.reshape(B * n_tiles, tile_t + halo, C)
    first = (torch.arange(B * n_tiles, device=x.device) % n_tiles == 0)
    rows = torch.arange(tile_t + halo, device=x.device)
    off = halo
    for bw, d in zip(weights, dilations):
        pre = first[:, None, None] & (rows[None, :h.shape[1], None] < off)
        h = _block(h, bw, d, k, pre)
        off -= (k - 1) * d
    return h[:, off:].reshape(B, n_tiles * tile_t, C)[:, :T]


def _check(x: torch.Tensor, weights: Sequence[BlockWeights],
           dilations: Sequence[int], k: int) -> torch.Tensor:
    """Validate what the kernels take; returns the weights packed as
    [G, block_floats] in BlockWeights order."""
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 [B, T, C] tensor")
    if x.shape[2] != KERNEL_D_MODEL or k != KERNEL_K:
        raise ValueError(f"the kernels take d_model {KERNEL_D_MODEL} and k "
                         f"{KERNEL_K}, not {x.shape[2]} and {k}")
    if len(weights) != len(dilations) or not weights:
        raise ValueError("one dilation per block, at least one block")
    shapes = BlockWeights((1, KERNEL_D_MODEL, KERNEL_D_F), (KERNEL_D_F,),
                          (KERNEL_K, KERNEL_D_F, KERNEL_D_F), (KERNEL_D_F,),
                          (1, KERNEL_D_F, KERNEL_D_MODEL), (KERNEL_D_MODEL,))
    for bw in weights:
        for w, shape in zip(bw, shapes):
            if (tuple(w.shape) != shape or w.dtype != torch.float32
                    or w.device != x.device):
                raise ValueError(f"block weight of shape {tuple(w.shape)} "
                                 f"{w.dtype} on {w.device}; expected {shape} "
                                 f"float32 on {x.device}")
    return torch.cat([w.reshape(-1) for bw in weights for w in bw]).reshape(
        len(weights), -1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernels, typed; checks that the C side packs a block's
    weights as `_check` does."""
    from deepxi_tpu_torch.ops.kernels import _build
    lib = _build.load("tcn_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tcn_max_window_rows.argtypes, lib.tcn_max_window_rows.restype = [i], i
    lib.tcn_block_floats.argtypes, lib.tcn_block_floats.restype = [], i
    lib.tcn_error_string.argtypes = [i]
    lib.tcn_error_string.restype = ctypes.c_char_p
    lib.tcn_block_forward.argtypes = [p, p, p, i, i, i, i, p]
    lib.tcn_block_forward.restype = i
    lib.tcn_group_forward.argtypes = [p, p, p, ctypes.POINTER(i), i, i, i,
                                      i, i, p]
    lib.tcn_group_forward.restype = i
    C, F, K = KERNEL_D_MODEL, KERNEL_D_F, KERNEL_K
    if lib.tcn_block_floats() != C * F + F + K * F * F + F + F * C + C:
        raise RuntimeError("csrc/tcn_fused.cu packs block weights differently")
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.tcn_error_string(rc).decode()})")


def _refuse_autograd(tensors, what: str) -> None:
    """Raise when autograd would record through an inference route."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward (as the Pallas kernel it replaces); run it "
            "under torch.no_grad(), or train through "
            "tcn_fused_train.resnetv2_apply_fused_train")


def _whole_tile(x: torch.Tensor) -> int:
    """Time tile of the per-block kernel: the largest of 64/32/16 rows that
    still gives every SM a CTA, so short batches spread over the card."""
    B, T, _ = x.shape
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    for tile in (64, 32):
        if B * -(-T // tile) >= n_sm:
            return tile
    return 16


def fused_block_group_whole(x: torch.Tensor, weights: Sequence[BlockWeights],
                            dilations: Sequence[int],
                            k: int = 3) -> torch.Tensor:
    """Apply a group of causal ReLU->LN->W+b bottleneck blocks, one kernel
    launch per block ([B, T, d_model] -> same)."""
    _refuse_autograd([x, *(w for bw in weights for w in bw)],
                     "fused_block_group_whole")
    if x.device.type == "cpu":
        return fused_block_group_whole_ref(x, weights, dilations, k)
    packed = _check(x, weights, dilations, k)
    lib = _lib()
    B, T, _ = x.shape
    tile = _whole_tile(x)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    src = x
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for g, d in enumerate(dilations):
            dst = bufs[g % 2]
            _raise_on(lib, lib.tcn_block_forward(
                src.data_ptr(), dst.data_ptr(), packed[g].data_ptr(), d, B, T,
                tile, stream), "tcn_block_forward")
            fused_block_group_whole.launches += 1
            src = dst
    return src


fused_block_group_whole.launches = 0


def fused_block_group(x: torch.Tensor, weights: Sequence[BlockWeights],
                      dilations: Sequence[int], k: int = 3,
                      tile_t: int = TILED_TILE_T) -> torch.Tensor:
    """Apply a group of causal ReLU->LN->W+b bottleneck blocks tiled over
    time with a causal halo of sum (k-1)d rounded up to 8, one kernel launch
    per group. Raises ValueError when the halo exceeds the tile (as the JAX
    kernel does) or, on the card, when the window does not fit a CTA."""
    _refuse_autograd([x, *(w for bw in weights for w in bw)], "fused_block_group")
    halo = _halo(dilations, k)
    if halo > tile_t:
        raise ValueError(f"group dilation reach {halo} exceeds tile_t "
                         f"{tile_t}; reduce the group size or grow the tile")
    if x.device.type == "cpu":
        return fused_block_group_ref(x, weights, dilations, k, tile_t)
    packed = _check(x, weights, dilations, k)
    lib = _lib()
    B, T, _ = x.shape
    G = len(dilations)
    out = torch.empty_like(x)
    dil = (ctypes.c_int * G)(*dilations)
    with torch.cuda.device(x.device):
        max_rows = lib.tcn_max_window_rows(torch.cuda.current_device())
        if tile_t + halo > max_rows:
            raise ValueError(f"window of tile_t {tile_t} + halo {halo} rows "
                             f"does not fit one CTA ({max_rows} rows); reduce "
                             "the group size or the tile")
        _raise_on(lib, lib.tcn_group_forward(
            x.data_ptr(), out.data_ptr(), packed.data_ptr(), dil, G, B, T,
            tile_t, halo, torch.cuda.current_stream().cuda_stream),
            "tcn_group_forward")
        fused_block_group.launches += 1
    return out


fused_block_group.launches = 0


def block_weights(params: Dict[str, torch.Tensor], i: int) -> BlockWeights:
    """Block i's weights from a flat ResNetV2 parameter dict."""
    return BlockWeights(*(params[f"block{i}_u{u}_conv.{leaf}"]
                          for u in (1, 2, 3) for leaf in ("kernel", "bias")))


def resnetv2_apply_fused(params: Dict[str, torch.Tensor], x: torch.Tensor,
                         n_blocks: int = 40, max_d_rate: int = 16, k: int = 3,
                         group: int = TILED_GROUP,
                         tile_t: int = TILED_TILE_T, whole_max_t: int = 1024,
                         outp_act: str = "Sigmoid") -> torch.Tensor:
    """ResNetV2 forward (causal, ReLU->LN->W+b) with the block stack run by
    the fused group kernels; `params` is the flat dict of
    `models.tcn.ResNetV2.state_dict()`. Sequences of at most `whole_max_t`
    frames take the per-block kernel, longer ones the halo-tiled kernel with
    `group` blocks per launch. `ff_conv` and `out_conv` stay matmuls.
    Forward only: raises under autograd when `x` or a parameter requires
    grad."""
    _refuse_autograd([x, *params.values()], "resnetv2_apply_fused")
    whole = x.shape[1] <= whole_max_t
    h = x @ params["ff_conv.kernel"][0] + params["ff_conv.bias"]
    h = torch.relu(layer_norm(h) * params["ff_ln.scale"])
    dil = [cyclic_dilation(i, max_d_rate) for i in range(n_blocks)]
    for g0 in range(0, n_blocks, group):
        idx = range(g0, min(g0 + group, n_blocks))
        weights = [block_weights(params, i) for i in idx]
        if whole:
            h = fused_block_group_whole(h, weights, [dil[i] for i in idx], k)
        else:
            h = fused_block_group(h, weights, [dil[i] for i in idx], k, tile_t)
    out = h @ params["out_conv.kernel"][0] + params["out_conv.bias"]
    return output_activation(out, outp_act)
