"""Ring-sharded attention: MHANet enhancement of one long recording with
its TIME axis split over the mesh's "data" axis (follows
deepxi_tpu/parallel/ring_attention.py).

Attention has no finite halo, so each rank keeps its query shard and its
online-softmax state (m, l, acc) while the key/value chunks and their
validity rotate one rank a step around the axis, one point-to-point
exchange a step; after n_shards steps every query has seen every key once.
Everything else of MHANetV2/V3 is frame-pointwise and runs locally.

As in the JAX module, which is plain `jnp` inside `shard_map` (no Pallas
kernel), the products are `torch.matmul`/`einsum` in float32:
  * additive masking ``logits += -1e10 (1 - mask)``: every logit stays
    finite, so the rescaling is exact and a fully masked row averages every
    key it visits (discarded downstream: compare on valid frames);
  * frame validity from the local shard's network input;
  * the causal mask compares GLOBAL frame positions (shard offset + local
    index); the positional embedding wraps at ``(q_pos0 + t) % max_len``;
  * the LayerNorms take the variance in two passes, E[(x - E[x])^2].
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from deepxi_tpu_torch import resolve_device
from deepxi_tpu_torch.models.attention import NEG_INF_V2, layer_norm_two_pass
from deepxi_tpu_torch.models.tcn import output_activation
from deepxi_tpu_torch.parallel.mesh import DATA_AXIS, Axis


def ring_attention(qp, kp, vp, valid, q_pos0: int, axis: Axis, n_sh: int,
                   causal: bool, t_total: int, block_q: int = 512) -> torch.Tensor:
    """Online-softmax attention over key/value chunks rotating around
    `axis` (this rank's view of the mesh's "data" axis, `n_sh` ranks).

    Shapes on each rank: qp/kp/vp [B, Ts, H, d] the local heads (q scaled),
    valid [B, Ts] float 1/0 validity of the local frames, q_pos0 the global
    index of the shard's first frame. Query tiles of `block_q` bound the
    live logits at [B, H, block_q, Ts]. Returns [B, Ts, H, d]."""
    if axis.size != n_sh:
        raise ValueError(f"the axis has {axis.size} ranks, not {n_sh}")
    B, Ts, H, d = qp.shape
    dev = qp.device
    bq = min(block_q, Ts)
    Tq = -(-Ts // bq) * bq
    qpad = F.pad(qp, (0, 0, 0, 0, 0, Tq - Ts))
    vq = F.pad(valid, (0, Tq - Ts))
    q_pos = q_pos0 + torch.arange(Tq, device=dev)
    m = torch.full((B, H, Tq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Tq, d), dtype=torch.float32, device=dev)

    # K, V and validity travel as one buffer
    chunk = torch.cat([kp.reshape(B, -1), vp.reshape(B, -1), valid], dim=1)
    n_kv = Ts * H * d
    for r in range(n_sh):
        kc = chunk[:, :n_kv].reshape(B, Ts, H, d)
        vc = chunk[:, n_kv:2 * n_kv].reshape(B, Ts, H, d)
        vkc = chunk[:, 2 * n_kv:]
        # the chunk held now came from shard (index - r) mod n_sh
        src = (axis.index - r) % n_sh
        k_pos = src * Ts + torch.arange(Ts, device=dev)
        for t0 in range(0, Tq, bq):
            sl = slice(t0, t0 + bq)
            logits = torch.einsum("btHd,bsHd->bHts", qpad[:, sl], kc)
            mask = vq[:, sl, None] * vkc[:, None, :]          # [B, bq, Ts]
            if causal:
                mask = mask * (k_pos[None, None, :] <= q_pos[sl][None, :, None]).float()
            logits = logits + NEG_INF_V2 * (1.0 - mask[:, None])
            mt = m[:, :, sl]
            m_new = torch.maximum(mt, logits.amax(dim=-1))
            alpha = torch.exp(mt - m_new)
            p = torch.exp(logits - m_new[..., None])
            l[:, :, sl] = l[:, :, sl] * alpha + p.sum(dim=-1)
            acc[:, :, sl] = (acc[:, :, sl] * alpha[..., None]
                             + torch.einsum("bHts,bsHd->bHtd", p, vc))
            m[:, :, sl] = m_new
        if r != n_sh - 1:  # rotate one step around the ring
            chunk = axis.shift(chunk, 1, wrap=True)
    out = (acc / l[..., None]).transpose(1, 2)   # [B, Tq, H, d]
    return out[:, :Ts]


def mhanet_ring_apply(params, mag, q_pos0: int, axis: Axis, n_sh: int,
                      n_blocks: int = 5, n_heads: int = 8, d_model: int = 256,
                      max_len: int = 2048, causal: bool = True,
                      positional: bool = True, outp_act: str = "Sigmoid",
                      block_q: int = 512) -> torch.Tensor:
    """MHANetV3 (V2 with positional=False) on a time shard [B, Ts, F] of its
    input, ring attention in place of the local attention; `params` is the
    network's state dict (flax names and layouts)."""
    p = params
    B, Ts, _ = mag.shape
    valid = (mag != 0.0).any(dim=-1).to(torch.float32)
    h = torch.matmul(mag, p["in_conv.kernel"][0])
    h = torch.relu(layer_norm_two_pass(h, p["in_ln.scale"], p["in_ln.bias"]))
    if positional:
        pos = (q_pos0 + torch.arange(Ts, device=mag.device)) % max_len
        h = h + p["pos_emb.embedding"][pos][None]
    scale = float(d_model // n_heads) ** -0.5
    for i in range(n_blocks):
        blk = lambda name: p[f"block{i}_{name}"]  # noqa: E731
        qp = torch.einsum("btI,HId->btHd", h, blk("mha.query_kernel")) * scale
        kp = torch.einsum("bsI,HId->bsHd", h, blk("mha.key_kernel"))
        vp = torch.einsum("bsI,HId->bsHd", h, blk("mha.value_kernel"))
        att = ring_attention(qp, kp, vp, valid, q_pos0, axis, n_sh, causal,
                             t_total=n_sh * Ts, block_q=block_q)
        att = torch.einsum("btHd,Hdo->bto", att, blk("mha.projection_kernel"))
        h = layer_norm_two_pass(h + att, blk("ln1.scale"), blk("ln1.bias"))
        f = torch.relu(torch.matmul(h, blk("ff1.kernel")) + blk("ff1.bias"))
        f = torch.matmul(f, blk("ff2.kernel")) + blk("ff2.bias")
        h = layer_norm_two_pass(h + f, blk("ln2.scale"), blk("ln2.bias"))
    out = torch.matmul(h, p["out_conv.kernel"][0]) + p["out_conv.bias"]
    return output_activation(out, outp_act)


def make_ring_mha_enhancer(inp_tgt, mesh=None, gtype: str = "mmse-lsa",
                           n_blocks: int = 5, n_heads: int = 8, d_model: int = 256,
                           max_len: int = 2048, causal: bool = True,
                           positional: bool = True, outp_act: str = "Sigmoid",
                           block_q: int = 512, device=None) -> Callable:
    """Build `enhance(params, x_int16[n]) -> y[n]`: one long recording
    enhanced by MHANetV2/V3 (MagXi gain-form synthesis) with time split over
    the mesh's "data" axis; every rank calls it with the whole recording and
    gets the whole waveform back.

    Each rank frames its shard with the one-frame STFT overhang from rank
    + 1, runs `mhanet_ring_apply`, and overlap-adds its frames; the
    N_s-sample tail that lands in the next shard goes to rank + 1. The DFT
    products are float32 (`spectral._analysis_matrix`,
    `_synthesis_matrix`): the JAX module at precision "highest". Takes N_d
    = 2 N_s, as the JAX module does."""
    from deepxi_tpu_torch.ops.gains import gfunc
    from deepxi_tpu_torch.ops.kernels.spectral import _on_device
    from deepxi_tpu_torch.sig.mix import normalise

    if mesh is None:
        raise ValueError("a mesh is required")
    dev = resolve_device(device)
    N_d, N_s, K = inp_tgt.N_d, inp_tgt.N_s, inp_tgt.K
    nb = K // 2 + 1
    data = Axis(mesh, DATA_AXIS)
    n_sh = data.size
    right = N_d - N_s

    @torch.no_grad()
    def enhance(params, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=dev)
        n = x.shape[-1]
        chunk = n_sh * N_s
        n_pad = -(-n // chunk) * chunk
        x = F.pad(x, (0, n_pad - n))
        L = n_pad // n_sh
        Ts = L // N_s
        x_sh = x[data.index * L:(data.index + 1) * L]
        # the STFT overhang: the next shard's first samples (zeros on the
        # last rank: the offline pipeline's pad_end zeros)
        right_h = data.shift(x_sh[:right], -1)
        xw = normalise(torch.cat([x_sh, right_h]))[None]
        fr = xw.unfold(-1, N_d, N_s)                            # [1, Ts, N_d]
        Y = torch.matmul(fr, _on_device("analysis", (N_d, K), dev))
        re, im = Y[..., :nb], Y[..., nb:]
        mag = torch.sqrt(re * re + im * im)
        tgt = mhanet_ring_apply(params, mag, data.index * Ts, data, n_sh,
                                n_blocks=n_blocks, n_heads=n_heads, d_model=d_model,
                                max_len=max_len, causal=causal, positional=positional,
                                outp_act=outp_act, block_q=block_q)
        xi_hat = inp_tgt.xi_map.inverse(tgt)
        G = gfunc(xi_hat, xi_hat + 1.0, gtype)
        frames = torch.matmul(torch.cat([re * G, im * G], dim=-1),
                              _on_device("synthesis", (N_d, N_s, K), dev))
        # frame-linear overlap-add: the shard's output is L + N_s samples,
        # and its tail lands in the next shard's head
        h1 = frames[0, :, :N_s].reshape(L)
        h2 = frames[0, :, N_s:].reshape(L)                      # shifted by N_s
        y = h1 + torch.cat([torch.zeros(N_s, device=dev), h2[:-N_s]])
        tail_in = data.shift(h2[-N_s:].contiguous(), 1)
        y = torch.cat([y[:N_s] + tail_in, y[N_s:]])
        return data.all_gather(y)[:n]

    return enhance
