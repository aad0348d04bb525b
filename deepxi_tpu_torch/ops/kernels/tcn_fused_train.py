"""Differentiable fused ResNetV2 stack for training
(follows deepxi_tpu/ops/kernels/tcn_fused_train.py).

Two wrappers stand for the two Pallas kernels of the training path:

  * `fused_block_group_whole_saved`: the group forward that also returns
    every block's input [B, G, T, C]. On the card it launches
    `tcn_block_forward` (`csrc/tcn_fused.cu`) once per block, each launch
    writing the next block's input into a [G, B, T, C] save buffer.
  * `fused_block_group_bwd`: the group backward, dh and the block weight
    gradients summed over the batch, from the saved inputs or by replaying
    the forward first. On the card it makes one call of `tcn_group_backward`
    (`csrc/tcn_fused_train.cu`) a group, which walks the blocks in reverse,
    three kernel launches each, every product on the tensor cores (the
    recompute through the forward's own product, so its ReLU masks are the
    forward's); the weight gradients are summed in a fixed order, so they
    are bitwise the same from run to run.

Each wrapper takes its plain version (`*_ref`, the same arithmetic in
PyTorch) for a CPU tensor and has a plain-integer `launches` counter of
kernel launches. Like `tcn_fused`'s, the kernels are built for each set of
widths that `tcn_fused.kernel_takes` accepts. `_FusedStack` (a
`torch.autograd.Function`) stands for the JAX `custom_vjp` `_stack`: its
forward keeps only the group inputs, plus every block's input with
`save_acts`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deepxi_tpu_torch.models.tcn import (cyclic_dilation, layer_norm,
                                         output_activation)
from deepxi_tpu_torch.ops.kernels import _build, launch_context, raw_stream, tcn_fused
from deepxi_tpu_torch.ops.kernels.tcn_fused import BlockWeights, block_weights

_EPS = 1e-6
# ReLU inputs within this of 0 are ties: two f32 evaluations of one
# pre-activation (192- or 256-term products summed in other orders, ~1e-6
# apart at the blocks' O(1) scale) can fall on opposite sides of 0, and so
# can the backward's mask.
TIE_TOL = 1e-5
# Splits of the B*T rows in the weight-gradient kernel: 11 output tiles times
# up to 12 splits fill the 132 SMs; at least 128 rows a split.
_MAX_SPLITS, _ROWS_PER_SPLIT = 12, 128


def _ln_bwd(u: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Backward of the affine-free LayerNorm at pre-norm input z:
    dz = invs * (u - mean(u) - zhat * mean(u * zhat)) over the last axis."""
    mu = z.mean(dim=-1, keepdim=True)
    invs = torch.rsqrt(torch.square(z - mu).mean(dim=-1, keepdim=True) + _EPS)
    zhat = (z - mu) * invs
    return invs * (u - u.mean(dim=-1, keepdim=True)
                   - zhat * (u * zhat).mean(dim=-1, keepdim=True))


def fused_block_group_whole_saved_ref(x: torch.Tensor,
                                      weights: Sequence[BlockWeights],
                                      dilations: Sequence[int], k: int = 3
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the saving forward: (out, hs [B, G, T, C])."""
    hs, h = [], x
    for bw, d in zip(weights, dilations):
        hs.append(h)
        h = tcn_fused.fused_block_group_whole_ref(h, [bw], [d], k)
    return h, torch.stack(hs, dim=1)


def _block_preacts(h: torch.Tensor, bw: BlockWeights, dil: int, k: int):
    """A block's forward up to its ReLU inputs: (a, u1, a2p, y), a2p with
    the conv's (k-1)*dil zero rows before t = 0."""
    T = h.shape[1]
    a = layer_norm(torch.relu(h))
    u1 = a @ bw.w1[0] + bw.b1
    a2p = F.pad(layer_norm(torch.relu(u1)), (0, 0, (k - 1) * dil, 0))
    y = bw.b2 + sum(a2p[:, j * dil: j * dil + T] @ bw.w2[j] for j in range(k))
    return a, u1, a2p, y


def _block_bwd_ref(h: torch.Tensor, d: torch.Tensor, bw: BlockWeights,
                   dil: int, k: int, flips: Sequence[Tuple[str, tuple]] = ()
                   ) -> Tuple[torch.Tensor, BlockWeights]:
    """One block's backward at block input h and output gradient d, the
    arithmetic of the Pallas body (tcn_fused_train.py:207-246). `flips`
    lists ("u1" or "y", (b, t, f)) ReLU inputs whose mask is inverted."""
    T = h.shape[1]
    r = (k - 1) * dil
    z0 = torch.relu(h)
    a, u1, a2p, y = _block_preacts(h, bw, dil, k)
    z1, z2 = torch.relu(u1), torch.relu(y)
    a3 = layer_norm(z2)
    masks = {"u1": u1 > 0, "y": y > 0}
    for name, idx in flips:
        masks[name][idx] = ~masks[name][idx]

    da3 = d @ bw.w3[0].T
    dw3 = torch.einsum("btf,btc->fc", a3, d)[None]
    dy = _ln_bwd(da3, z2) * masks["y"]
    dw2 = torch.stack([torch.einsum("btf,btg->fg", a2p[:, j * dil: j * dil + T], dy)
                       for j in range(k)])
    dyp = F.pad(dy, (0, 0, 0, r))
    da2 = sum(dyp[:, (k - 1 - j) * dil: (k - 1 - j) * dil + T] @ bw.w2[j].T
              for j in range(k))
    du1 = _ln_bwd(da2, z1) * masks["u1"]
    dw1 = torch.einsum("btc,btf->cf", a, du1)[None]
    dh = d + _ln_bwd(du1 @ bw.w1[0].T, z0) * (h > 0)
    return dh, BlockWeights(dw1, du1.sum((0, 1)), dw2, dy.sum((0, 1)), dw3,
                            d.sum((0, 1)))


def fused_block_group_bwd_ref(h0: torch.Tensor, dout: torch.Tensor,
                              weights: Sequence[BlockWeights],
                              dilations: Sequence[int], k: int = 3,
                              saved_h: Optional[torch.Tensor] = None,
                              flips: Sequence[Tuple[int, str, tuple]] = ()
                              ) -> Tuple[torch.Tensor, List[BlockWeights]]:
    """Plain version of the group backward: replays the forward when
    `saved_h` is None, then walks the blocks in reverse. `flips` lists
    (block, "u1" or "y", (b, t, f)) ReLU masks to invert (see `relu_ties`)."""
    if saved_h is None:
        _, saved_h = fused_block_group_whole_saved_ref(h0, weights, dilations, k)
    d, dws = dout, [None] * len(weights)
    for g in range(len(weights) - 1, -1, -1):
        d, dws[g] = _block_bwd_ref(saved_h[:, g], d, weights[g], dilations[g], k,
                                   [f[1:] for f in flips if f[0] == g])
    return d, dws


def relu_ties(saved_h: torch.Tensor, weights: Sequence[BlockWeights],
              dilations: Sequence[int], k: int = 3, tol: float = TIE_TOL
              ) -> List[Tuple[int, str, tuple]]:
    """The group's ReLU inputs u1 and y within `tol` of 0, as
    (block, "u1" or "y", (b, t, f)), from the block inputs `saved_h`."""
    ties = []
    for g, (bw, dil) in enumerate(zip(weights, dilations)):
        _, u1, _, y = _block_preacts(saved_h[:, g], bw, dil, k)
        for name, v in (("u1", u1), ("y", y)):
            ties += [(g, name, tuple(i)) for i in
                     torch.nonzero(v.abs() <= tol).tolist()]
    return ties


def _worst_rel(got, ref) -> float:
    """Worst over dh and every weight-gradient leaf of max |got - ref| over
    the leaf's max abs, for (dh, [BlockWeights]) pairs."""
    pairs = [(got[0], ref[0])] + [(a, r) for gw, rw in zip(got[1], ref[1])
                                  for a, r in zip(gw, rw)]
    return max((a - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
               for a, r in pairs)


def bwd_ref_up_to_ties(got, h0: torch.Tensor, dout: torch.Tensor,
                       weights: Sequence[BlockWeights],
                       dilations: Sequence[int], saved_h: torch.Tensor,
                       rel: float, k: int = 3):
    """Hold a backward `got` = (dh, [BlockWeights]) against the plain
    version at the block inputs `saved_h`, letting each ReLU tie take the
    side `got` took: while the worst leaf error exceeds `rel`, a tie's mask
    is inverted in the plain version where that lowers the error. Returns
    (the plain (dh, [BlockWeights]), its worst leaf error, the flips kept).
    A wrong gradient is not explained by ties, which change only the rows
    and leaves a near-zero ReLU input reaches."""
    ref = fused_block_group_bwd_ref(h0, dout, weights, dilations, k, saved_h)
    err, kept = _worst_rel(got, ref), []
    if err > rel:
        for tie in relu_ties(saved_h, weights, dilations, k):
            trial = fused_block_group_bwd_ref(h0, dout, weights, dilations, k,
                                              saved_h, kept + [tie])
            e = _worst_rel(got, trial)
            if e < err:
                ref, err, kept = trial, e, kept + [tie]
            if err <= rel:
                break
    return ref, err, kept


@functools.lru_cache(maxsize=None)
def _lib(d_model: int, d_f: int, k: int) -> ctypes.CDLL:
    """The backward built for these widths; checks that the C side packs a
    block's weights (and their transposes) as the wrappers do."""
    lib = _build.load(*tcn_fused.build_spec("tcn_fused_train", d_model, d_f, k))
    C, F_, K = d_model, d_f, k
    if (lib.tcn_train_block_floats() != C * F_ + F_ + K * F_ * F_ + F_ + F_ * C + C
            or lib.tcn_train_block_t_floats() != 2 * C * F_ + K * F_ * F_):
        raise RuntimeError("csrc/tcn_fused_train.cu packs block weights differently")
    return lib


def _saved_forward(x: torch.Tensor, packed: torch.Tensor,
                   dilations: Sequence[int], widths: Tuple[int, int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `tcn_block_forward` once per block: block g reads buffer slot g
    and writes slot g+1 (the last writes `out`). Returns (out, [G, B, T, C])."""
    lib = tcn_fused._lib(*widths)
    B, T, _ = x.shape
    G = len(dilations)
    tile = tcn_fused.whole_tile(lib, x, dilations, widths[2])
    buf = torch.empty((G,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[0].copy_(x)
    out = torch.empty_like(x)
    with launch_context(x.device):
        stream = raw_stream(x.device)
        for g, d in enumerate(dilations):
            dst = buf[g + 1] if g + 1 < G else out
            _build.check(lib, lib.tcn_block_forward(
                buf[g].data_ptr(), dst.data_ptr(), packed[g].data_ptr(), d, B,
                T, tile, stream), "tcn_block_forward")
    return out, buf


def fused_block_group_whole_saved(x: torch.Tensor,
                                  weights: Sequence[BlockWeights],
                                  dilations: Sequence[int], k: int = 3
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The group forward that also returns every block's input:
    x [B, T, d_model] -> (out [B, T, d_model], hs [B, G, T, d_model]). On the
    card hs is a view of a [G, B, T, d_model] buffer. No autograd."""
    tcn_fused._refuse_autograd([x, *(w for bw in weights for w in bw)],
                               "fused_block_group_whole_saved")
    if x.device.type == "cpu":
        return fused_block_group_whole_saved_ref(x, weights, dilations, k)
    packed, widths = tcn_fused._check(x, weights, dilations, k)
    out, buf = _saved_forward(x, packed, dilations, widths)
    fused_block_group_whole_saved.launches += len(dilations)
    return out, buf.permute(1, 0, 2, 3)


fused_block_group_whole_saved.launches = 0


def _transposed(weights: Sequence[BlockWeights]) -> torch.Tensor:
    """[G, block_t_floats]: W1^T [d_f, d_model], W2[j]^T, W3^T [d_model, d_f]
    per block, the operands of the input-gradient products (a stack and a
    transposing copy for each of the three, whatever G)."""
    G, (_, C, F), k = len(weights), weights[0].w1.shape, weights[0].w2.shape[0]
    w1 = weights[0].w1
    wt = torch.empty(G, 2 * C * F + k * F * F, dtype=w1.dtype, device=w1.device)
    o2, o3 = F * C, F * C + k * F * F
    wt[:, :o2].view(G, F, C).copy_(torch.stack([bw.w1[0] for bw in weights]).transpose(1, 2))
    wt[:, o2:o3].view(G, k, F, F).copy_(torch.stack([bw.w2 for bw in weights]).transpose(2, 3))
    wt[:, o3:].view(G, C, F).copy_(torch.stack([bw.w3[0] for bw in weights]).transpose(1, 2))
    return wt


def fused_block_group_bwd(h0: torch.Tensor, dout: torch.Tensor,
                          weights: Sequence[BlockWeights],
                          dilations: Sequence[int], k: int = 3,
                          saved_h: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, List[BlockWeights]]:
    """Backward of the group forward.

    Args:
      h0: [B, T, C] the group's input (its checkpoint).
      dout: [B, T, C] gradient with respect to the group's output.
      saved_h: optional [B, G, T, C] block inputs from
        `fused_block_group_whole_saved`; without it the forward is replayed
        first (on the card into a [G, B, T, C] scratch).
    Returns:
      (dh0 [B, T, C], per block BlockWeights of gradients summed over the
      batch).
    """
    if h0.device.type == "cpu":
        return fused_block_group_bwd_ref(h0, dout, weights, dilations, k, saved_h)
    packed, widths = tcn_fused._check(h0, weights, dilations, k)
    B, T, C = h0.shape
    G = len(dilations)
    dout = dout.contiguous()
    if dout.shape != h0.shape or dout.dtype != h0.dtype or dout.device != h0.device:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} on {dout.device}; "
                         f"expected {tuple(h0.shape)} {h0.dtype} on {h0.device}")
    if any(t.data_ptr() % 16 for t in (h0, dout) + (() if saved_h is None else (saved_h,))):
        raise ValueError("h0, dout and saved_h must start on 16-byte boundaries")
    lib = _lib(*widths)
    if saved_h is None:
        _, buf = _saved_forward(h0, packed, dilations, widths)
        fused_block_group_bwd.launches += G
        inputs = [buf[g] for g in range(G)]
    else:
        if (tuple(saved_h.shape) != (B, G, T, C) or saved_h.dtype != h0.dtype
                or saved_h.device != h0.device):
            raise ValueError(f"saved_h {tuple(saved_h.shape)}; expected "
                             f"{(B, G, T, C)} {h0.dtype} on {h0.device}")
        inputs = [saved_h[:, g].contiguous() for g in range(G)]
    wt = _transposed(weights)
    N = B * T
    splits = max(1, min(_MAX_SPLITS, -(-N // _ROWS_PER_SPLIT)))
    new = functools.partial(torch.empty, device=h0.device, dtype=torch.float32)
    u1s, a2s, a3s, dys, du1s = (new(N, widths[1]) for _ in range(5))
    hst, part = new(N, 2), new(splits, packed.shape[1])
    counters = torch.zeros(lib.tcn_train_wgrad_tiles(), dtype=torch.int32,
                           device=h0.device)
    dpacked = torch.empty_like(packed)
    bufs = (torch.empty_like(h0), torch.empty_like(h0))
    tile = tcn_fused._whole_tile(h0, (k - 1) * max(dilations),
                                 lib.tcn_train_max_window_rows(h0.device.index or 0))
    hs = (ctypes.c_void_p * G)(*(t.data_ptr() for t in inputs))
    dil = (ctypes.c_int * G)(*dilations)
    launched = ctypes.c_int(0)
    with launch_context(h0.device):
        rc = lib.tcn_group_backward(
            hs, dout.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
            packed.data_ptr(), wt.data_ptr(), dil, G, B, T, tile, splits,
            u1s.data_ptr(), a2s.data_ptr(), a3s.data_ptr(), dys.data_ptr(),
            du1s.data_ptr(), hst.data_ptr(), part.data_ptr(), counters.data_ptr(),
            dpacked.data_ptr(), raw_stream(h0.device), ctypes.byref(launched))
    fused_block_group_bwd.launches += launched.value
    _build.check(lib, rc, "tcn_group_backward")
    d = bufs[0]
    dws = []
    for g, bw in enumerate(weights):
        parts = torch.split(dpacked[g], [w.numel() for w in bw])
        dws.append(BlockWeights(*(p.view_as(w) for p, w in zip(parts, bw))))
    return d, dws


fused_block_group_bwd.launches = 0


def _groups(n_blocks: int, group: int) -> List[range]:
    return [range(g0, min(g0 + group, n_blocks))
            for g0 in range(0, n_blocks, group)]


class _FusedStack(torch.autograd.Function):
    """The block stack with the fused forward and backward; saves the group
    inputs (and, with `save_acts`, every block's input) for the backward."""

    @staticmethod
    def forward(ctx, h, static, *flat):
        dilations, k, group, save_acts = static
        weights = [BlockWeights(*flat[6 * i: 6 * i + 6])
                   for i in range(len(dilations))]
        checkpoints, saved = [], []
        for idx in _groups(len(dilations), group):
            checkpoints.append(h)
            gw = [weights[i] for i in idx]
            gd = [dilations[i] for i in idx]
            if save_acts:
                h, hs = fused_block_group_whole_saved(h, gw, gd, k)
                saved.append(hs)
            else:
                h = tcn_fused.fused_block_group_whole(h, gw, gd, k)
        ctx.static = static
        ctx.n_groups = len(checkpoints)
        ctx.save_for_backward(*checkpoints, *saved, *flat)
        return h

    @staticmethod
    def backward(ctx, dout):
        dilations, k, group, save_acts = ctx.static
        tensors = ctx.saved_tensors
        n = ctx.n_groups
        checkpoints = tensors[:n]
        saved = tensors[n: 2 * n] if save_acts else [None] * n
        flat = tensors[2 * n:] if save_acts else tensors[n:]
        weights = [BlockWeights(*flat[6 * i: 6 * i + 6])
                   for i in range(len(dilations))]
        dflat = [None] * len(flat)
        d = dout.contiguous()
        for gi, idx in reversed(list(enumerate(_groups(len(dilations), group)))):
            d, dws = fused_block_group_bwd(
                checkpoints[gi], d, [weights[i] for i in idx],
                [dilations[i] for i in idx], k, saved_h=saved[gi])
            for i, dw in zip(idx, dws):
                dflat[6 * i: 6 * i + 6] = list(dw)
        return (d, None, *dflat)


def resnetv2_apply_fused_train(params: Dict[str, torch.Tensor], x: torch.Tensor,
                               n_blocks: int = 40, max_d_rate: int = 16,
                               k: int = 3, group: int = 10,
                               save_acts: bool = False,
                               outp_act: str = "Sigmoid") -> torch.Tensor:
    """Differentiable ResNetV2 forward (causal, ReLU->LN->W+b) with the block
    stack run by the fused forward/backward pair; `params` is the flat dict
    of `models.tcn.ResNetV2` (tensors that may require grad). `group` blocks
    share one checkpoint; `save_acts` keeps every block's input in the
    forward and skips the backward's replay. `ff_conv` and `out_conv` stay
    matmuls under autograd."""
    h = x @ params["ff_conv.kernel"][0] + params["ff_conv.bias"]
    h = torch.relu(layer_norm(h) * params["ff_ln.scale"])
    dilations = tuple(cyclic_dilation(i, max_d_rate) for i in range(n_blocks))
    flat = [w for i in range(n_blocks) for w in block_weights(params, i)]
    h = _FusedStack.apply(h.contiguous(), (dilations, k, group, save_acts), *flat)
    out = h @ params["out_conv.kernel"][0] + params["out_conv.bias"]
    return output_activation(out, outp_act)
