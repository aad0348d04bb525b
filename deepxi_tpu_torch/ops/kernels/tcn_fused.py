"""Fused ResNetV2 block groups (follows deepxi_tpu/ops/kernels/tcn_fused.py).

CUDA kernels for Hopper (`csrc/tcn_fused.cu`) replace the three Pallas
kernels of the inference path:

  * `fused_block_group_whole`: for T <= `whole_max_t`; one launch per block,
    each CTA a time tile plus the 2d rows its dilated conv reaches back.
  * `fused_block_group_whole_pack2`: the same route with two batch rows per
    CTA (the JAX kernel packs them into the d_f lanes), and the JAX kernel's
    `ln_mode` for the two segmented LayerNorms; `resnetv2_apply_fused` takes
    it with `pack2=True`.
  * `fused_block_group`: the halo-tiled group; one launch per group, each CTA
    carrying the shrinking window of its tile through all G blocks.

Each wrapper calls its `deepxi::` op (`ops.kernels.kernel_op`), which
launches the kernel for a CUDA tensor and takes the plain version (`*_ref`,
the same arithmetic in PyTorch) for a CPU tensor; an exported program calls
the same ops. The op boundary takes the blocks' weights as one flat tensor
list, six a block in `BlockWeights` order. Each wrapper has a plain-integer
`launches` counter that counts kernel launches (in the CUDA implementation,
so a CUDA graph's replay counts none).

The kernels' widths (d_model, d_f, k) are compile-time constants: a wrapper
builds one library per set of widths at first use, so every width that
`kernel_takes` accepts runs its own kernel; at any other width it raises
ValueError on the card.

These are inference routes: like `pallas_call`, they have no backward, and
with autograd on they raise when an input or weight requires grad, on both
devices. Training takes `tcn_fused_train.resnetv2_apply_fused_train`.

The JAX module's `batch_group` (batch rows per grid cell of the unpacked
whole-sequence kernel) is left out: it reshapes work for the TPU's matrix
unit, does not change the function and is no kernel of its own.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Sequence

import torch

from deepxi_tpu_torch.models.tcn import (cyclic_dilation, layer_norm,
                                         output_activation)
from deepxi_tpu_torch.ops.kernels import (_build, kernel_op, launch_context,
                                          raw_stream, refuse_autograd)

# resnet-1.1c's widths, the defaults of `random_block_weights`.
KERNEL_D_MODEL, KERNEL_D_F, KERNEL_K = 256, 64, 3


def kernel_takes(d_model: int, d_f: int, k: int) -> bool:
    """Whether the TCN kernels (`csrc/tcn_common.cuh`, shared with
    `tcn_fused_train`) can be built for these widths: d_model and d_f
    multiples of 4 up to 1024 (a thread owns 4 output columns of a product,
    and a CTA's 256 threads span a row), any k >= 1."""
    return (all(w % 4 == 0 and 4 <= w <= 1024 for w in (d_model, d_f))
            and k >= 1)


def build_spec(name: str, d_model: int, d_f: int, k: int):
    """The `_build` spec of `csrc/<name>.cu` ("tcn_fused" or
    "tcn_fused_train") at these widths."""
    return name, {"TCN_C": d_model, "TCN_DF": d_f, "TCN_KS": k}

# Group and tile of the halo-tiled route. A CTA holds one unit's weights
# (74 KB at the flagship widths) and a window of (tile_t + halo) rows of
# 1,592 bytes (h, two d_f buffers, LN moments) in a Hopper block's 227 KB:
# 99 rows. The JAX defaults (G = 20, tile 640, halo 248) need 888 rows; the
# tile must cover the halo, and two blocks (dilations 8 and 16: halo 48)
# leave a tile of 48.
TILED_GROUP, TILED_TILE_T = 2, 48


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


PACK2_LN_MODES = ("slice", "matmul")


def _pack2_ln(u: torch.Tensor, ln_mode: str) -> torch.Tensor:
    """The pack2 kernel's segmented LayerNorm of each row's d_f features:
    two-pass ("slice"), or ("matmul") mean and E[x^2] from products with
    1/d_f and the variance E[x^2] - mean^2, unclipped, as the JAX kernel's
    block-average product computes them."""
    if ln_mode == "slice":
        return layer_norm(u)
    inv = 1.0 / u.shape[-1]
    m = (u * inv).sum(-1, keepdim=True)
    v = (u * u * inv).sum(-1, keepdim=True) - m * m
    return (u - m) * torch.rsqrt(v + 1e-6)


def fused_block_group_whole_pack2_ref(x: torch.Tensor,
                                      weights: Sequence[BlockWeights],
                                      dilations: Sequence[int], k: int = 3,
                                      ln_mode: str = "slice") -> torch.Tensor:
    """Plain version of the lane-packed whole-sequence group, as the JAX
    kernel computes it: B padded to even with zero rows, the LN of h
    two-pass, the segmented LNs by `ln_mode`, biases added where it adds
    them. Its block-diagonal zeros add exact 0.0 terms, so each row is
    computed on its own."""
    if ln_mode not in PACK2_LN_MODES:
        raise ValueError(f"ln_mode must be one of {PACK2_LN_MODES}, not {ln_mode!r}")
    B, T, _ = x.shape
    h = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, B % 2))
    for bw, d in zip(weights, dilations):
        reach = (k - 1) * d
        u1 = layer_norm(torch.relu(h)) @ bw.w1[0] + bw.b1
        a2 = torch.nn.functional.pad(_pack2_ln(torch.relu(u1), ln_mode),
                                     (0, 0, reach, 0))
        y = a2[:, reach:reach + T] @ bw.w2[k - 1]
        for j in range(k - 1):
            y = y + a2[:, j * d:j * d + T] @ bw.w2[j]
        y = y + bw.b2
        h = h + _pack2_ln(torch.relu(y), ln_mode) @ bw.w3[0] + bw.b3
    return h[:B]


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
           dilations: Sequence[int], k: int):
    """Validate what the kernels take; returns the weights packed as
    [G, block_floats] in BlockWeights order and the widths (d_model, d_f,
    k), d_f read from the first block's W1."""
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 [B, T, C] tensor")
    if len(weights) != len(dilations) or not weights:
        raise ValueError("one dilation per block, at least one block")
    C, F = x.shape[2], weights[0].w1.shape[-1]
    if not kernel_takes(C, F, k):
        raise ValueError(f"the kernels take d_model and d_f multiples of 4 up "
                         f"to 1024 and k >= 1, not {C}, {F} and {k}")
    shapes = BlockWeights((1, C, F), (F,), (k, F, F), (F,), (1, F, C), (C,))
    for bw in weights:
        for w, shape in zip(bw, shapes):
            if (tuple(w.shape) != shape or w.dtype != torch.float32
                    or w.device != x.device):
                raise ValueError(f"block weight of shape {tuple(w.shape)} "
                                 f"{w.dtype} on {w.device}; expected {shape} "
                                 f"float32 on {x.device}")
    packed = torch.cat([w.reshape(-1) for bw in weights for w in bw])
    return packed.reshape(len(weights), -1), (C, F, k)


@functools.lru_cache(maxsize=None)
def _lib(d_model: int, d_f: int, k: int) -> ctypes.CDLL:
    """The kernels built for these widths; checks that the C side packs a
    block's weights as `_check` does."""
    lib = _build.load(*build_spec("tcn_fused", d_model, d_f, k))
    C, F, K = d_model, d_f, k
    if lib.tcn_block_floats() != C * F + F + K * F * F + F + F * C + C:
        raise RuntimeError("csrc/tcn_fused.cu packs block weights differently")
    return lib


def _refuse_autograd(tensors, what: str) -> None:
    refuse_autograd(tensors, what, "tcn_fused_train.resnetv2_apply_fused_train")


def _whole_tile(x: torch.Tensor, reach: int, max_rows: int) -> int:
    """Time tile of a per-block kernel whose CTA holds the tile and the
    `reach` rows before it, at most `max_rows`: the largest of 64/32/16 rows
    that fits and still gives every SM a CTA, so short batches spread over
    the card (8 when only that fits). Raises ValueError when none fits."""
    B, T, _ = x.shape
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    fits = [tile for tile in (64, 32, 16, 8) if tile + reach <= max_rows]
    if not fits:
        raise ValueError(f"a window of 8 + {reach} rows does not fit one CTA "
                         f"({max_rows} rows at these widths)")
    return next(tile for tile in fits if tile <= 16 or B * -(-T // tile) >= n_sm)


def whole_tile(lib: ctypes.CDLL, x: torch.Tensor, dilations: Sequence[int],
               k: int) -> int:
    """`_whole_tile` for `tcn_block_forward` on x's device."""
    return _whole_tile(x, (k - 1) * max(dilations),
                       lib.tcn_max_window_rows(x.device.index or 0))


def flat_weights(weights: Sequence[BlockWeights]) -> List[torch.Tensor]:
    """The blocks' weights as the ops take them: six tensors a block."""
    return [w for bw in weights for w in bw]


def _blocks(flat: List[torch.Tensor]) -> List[BlockWeights]:
    return [BlockWeights(*flat[i:i + 6]) for i in range(0, len(flat), 6)]


def _whole_cuda(x: torch.Tensor, weights: List[torch.Tensor], dilations: List[int],
                k: int) -> torch.Tensor:
    blocks = _blocks(weights)
    packed, widths = _check(x, blocks, dilations, k)
    lib = _lib(*widths)
    B, T, _ = x.shape
    tile = whole_tile(lib, x, dilations, k)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    src = x
    with launch_context(x.device):
        stream = raw_stream(x.device)
        for g, d in enumerate(dilations):
            dst = bufs[g % 2]
            _build.check(lib, lib.tcn_block_forward(
                src.data_ptr(), dst.data_ptr(), packed[g].data_ptr(), d, B, T,
                tile, stream), "tcn_block_forward")
            fused_block_group_whole.launches += 1
            src = dst
    return src


_whole_op = kernel_op(
    "fused_block_group_whole", _whole_cuda,
    lambda x, weights, dilations, k: fused_block_group_whole_ref(
        x, _blocks(weights), dilations, k))


def fused_block_group_whole(x: torch.Tensor, weights: Sequence[BlockWeights],
                            dilations: Sequence[int],
                            k: int = 3) -> torch.Tensor:
    """Apply a group of causal ReLU->LN->W+b bottleneck blocks, one kernel
    launch per block ([B, T, d_model] -> same)."""
    _refuse_autograd([x, *flat_weights(weights)], "fused_block_group_whole")
    return _whole_op(x, flat_weights(weights), [int(d) for d in dilations], k)


fused_block_group_whole.launches = 0


def _pack2_tile(x: torch.Tensor, reach: int, max_rows: int) -> int:
    """Time tile of the pack2 kernel, whose CTA holds two windows of the
    tile and the `reach` rows before it in `max_rows`: 32 rows when that fits
    and the row pairs alone give every SM a CTA, else the larger of 16 and
    8 that fits. Raises ValueError when none fits."""
    B, T, _ = x.shape
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    fits = [tile for tile in (32, 16, 8) if 2 * (tile + reach) + 1 <= max_rows]
    if not fits:
        raise ValueError(f"two windows of 8 + {reach} rows do not fit one CTA "
                         f"({max_rows} rows at these widths)")
    return next(tile for tile in fits
                if tile <= 16 or -(-B // 2) * -(-T // tile) >= n_sm)


def _pack2_cuda(x: torch.Tensor, weights: List[torch.Tensor], dilations: List[int],
                k: int, ln_mode: str) -> torch.Tensor:
    packed, widths = _check(x, _blocks(weights), dilations, k)
    lib = _lib(*widths)
    B, T, _ = x.shape
    tile = _pack2_tile(x, (k - 1) * max(dilations),
                       lib.tcn_max_window_rows(x.device.index or 0))
    bufs = (torch.empty_like(x), torch.empty_like(x))
    src = x
    with launch_context(x.device):
        stream = raw_stream(x.device)
        for g, d in enumerate(dilations):
            dst = bufs[g % 2]
            _build.check(lib, lib.tcn_block_forward_pack2(
                src.data_ptr(), dst.data_ptr(), packed[g].data_ptr(), d, B, T,
                tile, int(ln_mode == "matmul"), stream), "tcn_block_forward_pack2")
            fused_block_group_whole_pack2.launches += 1
            src = dst
    return src


_pack2_op = kernel_op(
    "fused_block_group_whole_pack2", _pack2_cuda,
    lambda x, weights, dilations, k, ln_mode: fused_block_group_whole_pack2_ref(
        x, _blocks(weights), dilations, k, ln_mode))


def fused_block_group_whole_pack2(x: torch.Tensor,
                                  weights: Sequence[BlockWeights],
                                  dilations: Sequence[int], k: int = 3,
                                  ln_mode: str = "slice") -> torch.Tensor:
    """`fused_block_group_whole` with rows 2b and 2b+1 in one CTA (one
    launch per block): each weight fragment feeds both rows' products. `ln_mode`
    ("slice" or "matmul") picks the segmented LayerNorm as in the JAX
    kernel. Raises ValueError when a CTA cannot hold two windows."""
    _refuse_autograd([x, *flat_weights(weights)], "fused_block_group_whole_pack2")
    if ln_mode not in PACK2_LN_MODES:
        raise ValueError(f"ln_mode must be one of {PACK2_LN_MODES}, not {ln_mode!r}")
    return _pack2_op(x, flat_weights(weights), [int(d) for d in dilations], k, ln_mode)


fused_block_group_whole_pack2.launches = 0


def _group_cuda(x: torch.Tensor, weights: List[torch.Tensor], dilations: List[int],
                k: int, tile_t: int) -> torch.Tensor:
    packed, widths = _check(x, _blocks(weights), dilations, k)
    lib = _lib(*widths)
    B, T, _ = x.shape
    G, halo = len(dilations), _halo(dilations, k)
    out = torch.empty_like(x)
    dil = (ctypes.c_int * G)(*dilations)
    with launch_context(x.device):
        max_rows = lib.tcn_max_window_rows(torch.cuda.current_device())
        if tile_t + halo > max_rows:
            raise ValueError(f"window of tile_t {tile_t} + halo {halo} rows "
                             f"does not fit one CTA ({max_rows} rows); reduce "
                             "the group size or the tile")
        _build.check(lib, lib.tcn_group_forward(
            x.data_ptr(), out.data_ptr(), packed.data_ptr(), dil, G, B, T,
            tile_t, halo, raw_stream(x.device)),
            "tcn_group_forward")
        fused_block_group.launches += 1
    return out


_group_op = kernel_op(
    "fused_block_group", _group_cuda,
    lambda x, weights, dilations, k, tile_t: fused_block_group_ref(
        x, _blocks(weights), dilations, k, tile_t))


def fused_block_group(x: torch.Tensor, weights: Sequence[BlockWeights],
                      dilations: Sequence[int], k: int = 3,
                      tile_t: int = TILED_TILE_T) -> torch.Tensor:
    """Apply a group of causal ReLU->LN->W+b bottleneck blocks tiled over
    time with a causal halo of sum (k-1)d rounded up to 8, one kernel launch
    per group. Raises ValueError when the halo exceeds the tile (as the JAX
    kernel does) or, on the card, when the window does not fit a CTA."""
    _refuse_autograd([x, *flat_weights(weights)], "fused_block_group")
    halo = _halo(dilations, k)
    if halo > tile_t:
        raise ValueError(f"group dilation reach {halo} exceeds tile_t "
                         f"{tile_t}; reduce the group size or grow the tile")
    return _group_op(x, flat_weights(weights), [int(d) for d in dilations], k, tile_t)


fused_block_group.launches = 0


def block_weights(params: Dict[str, torch.Tensor], i: int) -> BlockWeights:
    """Block i's weights from a flat ResNetV2 parameter dict."""
    return BlockWeights(*(params[f"block{i}_u{u}_conv.{leaf}"]
                          for u in (1, 2, 3) for leaf in ("kernel", "bias")))


def resnetv2_apply_fused(params: Dict[str, torch.Tensor], x: torch.Tensor,
                         n_blocks: int = 40, max_d_rate: int = 16, k: int = 3,
                         group: int = TILED_GROUP,
                         tile_t: int = TILED_TILE_T, whole_max_t: int = 1024,
                         pack2: bool = False, pack2_ln: str = "slice",
                         outp_act: str = "Sigmoid") -> torch.Tensor:
    """ResNetV2 forward (causal, ReLU->LN->W+b) with the block stack run by
    the fused group kernels; `params` is the flat dict of
    `models.tcn.ResNetV2.state_dict()`. Sequences of at most `whole_max_t`
    frames take the per-block kernel, all blocks in one call (with `pack2`,
    its two-rows-per-CTA form and the segmented LayerNorm `pack2_ln`),
    longer ones the halo-tiled kernel with `group` blocks per launch,
    whatever `pack2` says. `ff_conv`
    and `out_conv` stay matmuls. Forward only: raises under autograd when
    `x` or a parameter requires grad.

    `pack2` is kept for parity with the JAX kernel and its numerics (the
    "matmul" LayerNorm); it has no speed case on an H100: the unpacked
    kernel already feeds each weight fragment to 32 rows, and pack2 is
    slower at B=1 and B=96 (PERF.md, row 3)."""
    _refuse_autograd([x, *params.values()], "resnetv2_apply_fused")
    whole = x.shape[1] <= whole_max_t
    h = x @ params["ff_conv.kernel"][0] + params["ff_conv.bias"]
    h = torch.relu(layer_norm(h) * params["ff_ln.scale"])
    dil = [cyclic_dilation(i, max_d_rate) for i in range(n_blocks)]
    weights = [block_weights(params, i) for i in range(n_blocks)]
    if whole and pack2:
        h = fused_block_group_whole_pack2(h, weights, dil, k, pack2_ln)
    elif whole:
        h = fused_block_group_whole(h, weights, dil, k)
    else:
        for g0 in range(0, n_blocks, group):
            h = fused_block_group(h, weights[g0:g0 + group], dil[g0:g0 + group],
                                  k, tile_t)
    out = h @ params["out_conv.kernel"][0] + params["out_conv.bias"]
    return output_activation(out, outp_act)
