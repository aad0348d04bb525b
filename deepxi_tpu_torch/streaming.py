"""Streaming (frame-by-frame) causal enhancement (follows
deepxi_tpu/streaming.py).

  * `StreamingEnhancer` -- ResNetV2 (resnet-1.1c): a per-frame step with a
    delay line for every dilated convolution;
  * `StreamingMHANet` -- MHANetV2/V3 (mhanet-1.1c): a per-frame step with
    per-block K/V caches of `max_len` frames; with ``fused=True`` each
    block's cache attention is one call of `ops.kernels.mha_cache`
    (`csrc/mha_cache.cu` on the card).

The serving loop, one [B, N_s] hop in and one enhanced hop out, N_d - N_s
samples late (N_d = 32 ms analysis window, N_s = 16 ms hop)::

    state = s.prime(s.init_state(B), chunk0)   # no network run
    state, y = s.step(state, chunk)            # every further hop

A step consumes its input state: the MHANet caches are written in place at
the clock's row, as the JAX package's bench donates them (copying
[B, 2048, 8, 32] caches every hop would double the traffic), and the state a
step returns shares them. The clock `t` is a 0-d int32 tensor on the
stream's device, as the JAX package's `[] int32` array, shared by all
streams of a batch: each hop takes its cache row, its positional row and
the attention mask from it on the device, so with ``fused=True`` on the card
a hop reads no device value back (no host synchronisation) and can be
captured in a CUDA graph and replayed hop after hop. `stream` is the parity
harness: prime with chunk 0, step over chunks 1 .. T-1 and one zero chunk,
which gives the offline enhancer's first T * N_s samples when the length is
a whole number of hops.

Past the cap (t >= max_len) the functions are the JAX ones, whose cache
writes clamp their start row (`dynamic_update_slice`): `step` writes row
L - 1 and every row is then valid; `step_block` writes its H frames at
L - H when t + H > L. Positions index the embedding at (t + i) % max_len.

Each class takes the port's network, its `module.leaf` state dict (as
`compat.artifact` and `from_flax_params` give it) and `device` (the card
unless ``device="cpu"``).
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple, Tuple

import torch

from deepxi_tpu_torch import resolve_device
from deepxi_tpu_torch.models.attention import NEG_INF_V2, layer_norm_two_pass
from deepxi_tpu_torch.models.tcn import layer_norm
from deepxi_tpu_torch.ops.gains import gfunc
from deepxi_tpu_torch.ops.kernels.mha_cache import (CACHE_DTYPES,
                                                    mha_cache_step,
                                                    mha_cache_step_ref)
from deepxi_tpu_torch.ops.kernels.spectral import _on_device
from deepxi_tpu_torch.sig.mix import normalise


class _Hops:
    """What both networks share: 50% overlap framing, the windowed DFT of
    each frame, the gain and the inverse DFT with overlap-add."""

    def __init__(self, inp_tgt, gtype: str, device):
        if inp_tgt.N_d != 2 * inp_tgt.N_s:
            raise ValueError("streaming assumes 50% overlap (N_d == 2*N_s)")
        self.device = dev = resolve_device(device)
        m = inp_tgt.xi_map
        self.it = replace(inp_tgt, xi_map=replace(m, mu=m.mu.to(dev),
                                                  sigma=m.sigma.to(dev)))
        self.gtype = gtype
        self.N_d, self.N_s, self.K = inp_tgt.N_d, inp_tgt.N_s, inp_tgt.K
        self.nb = self.K // 2 + 1
        self.A = _on_device("analysis", (self.N_d, self.K), dev)
        self.S = _on_device("synthesis", (self.N_d, self.N_s, self.K), dev)

    def _samples(self, chunk) -> torch.Tensor:
        """int16 samples (or float32, passed through unscaled) on the device."""
        x = torch.as_tensor(chunk, device=self.device)
        return x if x.dtype == torch.float32 else normalise(x)

    def _spectrum(self, frames: torch.Tensor):
        """(re, im, |X|) of [..., N_d] frames."""
        Y = frames @ self.A
        re, im = Y[..., :self.nb], Y[..., self.nb:]
        return re, im, torch.sqrt(re * re + im * im)

    def _resynthesis(self, re, im, xi_bar) -> torch.Tensor:
        """[..., N_d] windowed frames of the gained spectrum."""
        xi_hat = self.it.xi_hat(xi_bar)
        G = gfunc(xi_hat, xi_hat + 1.0, self.gtype)
        return torch.cat([re * G, im * G], dim=-1) @ self.S

    def prime(self, state, chunk):
        """Load the first hop into the analysis tail WITHOUT running the
        network: the first frame spans chunks 0 and 1, and a half-zero
        warm-up frame would pollute the network's state."""
        return state._replace(wav_tail=self._samples(chunk))

    def _hop(self, state, chunk):
        """(new wav_tail, re, im, |X|) of the frame [wav_tail || chunk]."""
        x = self._samples(chunk)
        return (x, *self._spectrum(torch.cat([state.wav_tail, x], dim=1)))

    @torch.no_grad()
    def stream(self, wav) -> torch.Tensor:
        """A whole waveform [B, T * N_s] through prime and T steps (the last
        on a zero chunk, the offline pad_end frame): [B, T * N_s]."""
        wav = torch.as_tensor(wav, device=self.device)
        B, n = wav.shape
        T = n // self.N_s
        chunks = wav[:, :T * self.N_s].reshape(B, T, self.N_s)
        state = self.prime(self.init_state(B), chunks[:, 0])
        outs = []
        for i in range(1, T + 1):
            chunk = chunks[:, i] if i < T else torch.zeros(B, self.N_s, device=self.device)
            state, y = self.step(state, chunk)
            outs.append(y)
        return torch.cat(outs, dim=1)


class StreamState(NamedTuple):
    """Per-stream state: conv delay lines and the analysis/synthesis carry."""
    conv_bufs: Tuple[torch.Tensor, ...]  # each [B, (k-1)*d, d_f], oldest frame first
    wav_tail: torch.Tensor               # [B, N_d - N_s] last input samples
    ola_tail: torch.Tensor               # [B, N_d - N_s] synthesis carry


class StreamingEnhancer(_Hops):
    """Frame-by-frame enhancement with a causal ResNetV2 ξ estimator.

    Each block's dilated conv keeps the last (k-1)*d inputs of its conv,
    oldest first: tap j reads row j*d and the line rolls one frame a hop.
    LayerNorms as the JAX streaming step: two-pass variance, `ff_ln` with a
    scale only. The network must be a causal ResNetV2 with ReLU->LN->W+b
    units and a Sigmoid head."""

    def __init__(self, inp_tgt, net, params, gtype: str = "mmse-lsa", device=None):
        if type(net).__name__ != "ResNetV2":
            raise ValueError(f"streaming takes a ResNetV2, not a {type(net).__name__}")
        if not getattr(net, "causal", True):
            raise ValueError("streaming requires a causal network")
        if getattr(net, "unit_type", "ReLU->LN->W+b") != "ReLU->LN->W+b":
            raise ValueError("streaming supports the ReLU->LN->W+b unit order")
        if net.outp_act != "Sigmoid":
            raise ValueError("streaming implements the Sigmoid output head")
        super().__init__(inp_tgt, gtype, device)
        p = {k: v.to(self.device) for k, v in params.items()}
        self.k, _, self.d_f = p["block0_u2_conv.kernel"].shape
        self.ff = (p["ff_conv.kernel"][0], p["ff_conv.bias"], p["ff_ln.scale"])
        self.out = (p["out_conv.kernel"][0], p["out_conv.bias"])
        self.blocks = []   # (d, W1, b1, [k*d_f, d_f] taps W2, b2, W3, b3)
        for i in range(net.n_blocks):
            w2 = p[f"block{i}_u2_conv.kernel"]
            self.blocks.append((
                getattr(net, f"block{i}_u2_conv").d,
                p[f"block{i}_u1_conv.kernel"][0], p[f"block{i}_u1_conv.bias"],
                w2.reshape(-1, w2.shape[2]), p[f"block{i}_u2_conv.bias"],
                p[f"block{i}_u3_conv.kernel"][0], p[f"block{i}_u3_conv.bias"]))

    def init_state(self, batch: int) -> StreamState:
        pad = self.N_d - self.N_s
        bufs = tuple(torch.zeros(batch, (self.k - 1) * blk[0], self.d_f,
                                 device=self.device) for blk in self.blocks)
        return StreamState(bufs, torch.zeros(batch, pad, device=self.device),
                           torch.zeros(batch, pad, device=self.device))

    def _net_step(self, bufs, feat):
        """One frame [B, n_feat] through the causal TCN: (new delay lines,
        sigmoid output)."""
        w, b, scale = self.ff
        x = torch.relu(layer_norm(torch.addmm(b, feat, w)) * scale)
        new_bufs = []
        for (d, w1, b1, w2, b2, w3, b3), buf in zip(self.blocks, bufs):
            h = torch.addmm(b1, layer_norm(torch.relu(x)), w1)
            h2 = layer_norm(torch.relu(h))[:, None]
            # taps at t-(k-1)d .. t-d (rows 0, d, .. of the line), then t
            y = torch.addmm(b2, torch.cat([buf[:, ::d], h2], dim=1).flatten(1), w2)
            new_bufs.append(torch.cat([buf[:, 1:], h2], dim=1))
            x = x + torch.addmm(b3, layer_norm(torch.relu(y)), w3)
        w, b = self.out
        return tuple(new_bufs), torch.sigmoid(torch.addmm(b, x, w))

    @torch.no_grad()
    def step(self, state: StreamState, chunk) -> Tuple[StreamState, torch.Tensor]:
        """One hop: chunk [B, N_s] int16 (or float32) samples -> (new state,
        [B, N_s] float32 enhanced samples, N_d - N_s samples late)."""
        x, re, im, mag = self._hop(state, chunk)
        bufs, xi_bar = self._net_step(state.conv_bufs, mag)
        syn = self._resynthesis(re, im, xi_bar)
        return (StreamState(bufs, x, syn[:, self.N_s:]),
                syn[:, :self.N_s] + state.ola_tail)


class MHAStreamState(NamedTuple):
    """Per-stream MHANet state: per-block K/V caches (written in place), the
    frame clock and the analysis/synthesis carry."""
    k_caches: Tuple[torch.Tensor, ...]  # each [B, max_len, H, dk]
    v_caches: Tuple[torch.Tensor, ...]
    t: torch.Tensor                     # [] int32: frames processed so far
    wav_tail: torch.Tensor              # [B, N_d - N_s]
    ola_tail: torch.Tensor              # [B, N_d - N_s]


class _Block(NamedTuple):
    """One transformer block's weights, laid out for a frame step."""
    wqkv: torch.Tensor  # [C, 3 * H * dk]: query, key, value kernels
    wo: torch.Tensor    # [H * dk, C]
    ln1_s: torch.Tensor
    ln1_b: torch.Tensor
    ff1_w: torch.Tensor
    ff1_b: torch.Tensor
    ff2_w: torch.Tensor
    ff2_b: torch.Tensor
    ln2_s: torch.Tensor
    ln2_b: torch.Tensor


class StreamingMHANet(_Hops):
    """Frame-by-frame enhancement with a causal MHANetV2/V3 ξ estimator.

    Causal self-attention attends over its whole past, so each block keeps
    its projected keys and values for `max_len` frames (the offline model's
    positional cap; 2048 for V2 too), appended one frame a hop; the additive
    -1e10 mask of the unwritten rows gives the offline outputs to float
    rounding while t < max_len. ``fused=True`` runs each block's cache
    attention through `mha_cache_step` (on the card, the CUDA kernel);
    ``fused=False`` is the JAX package's einsum route. ``cache_dtype``
    torch.bfloat16 halves the cache traffic; logits and softmax stay float32
    either way. LayerNorms two-pass, as the JAX streaming step."""

    def __init__(self, inp_tgt, net, params, gtype: str = "mmse-lsa",
                 fused: bool = False, cache_dtype=torch.float32, device=None):
        name = type(net).__name__
        if name not in ("MHANetV2", "MHANetV3"):
            raise ValueError(f"StreamingMHANet supports MHANetV2/V3, got {name}")
        if not net.causal:
            raise ValueError("streaming requires a causal network")
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype must be one of {CACHE_DTYPES}")
        super().__init__(inp_tgt, gtype, device)
        self.fused, self.cache_dtype = fused, cache_dtype
        p = {k: v.to(self.device) for k, v in params.items()}
        self.H, C, self.dk = p["block0_mha.query_kernel"].shape
        self.max_len = getattr(net, "max_len", 2048)
        self.pos = p["pos_emb.embedding"] if name == "MHANetV3" else None
        self.in_ = (p["in_conv.kernel"][0], p["in_ln.scale"], p["in_ln.bias"])
        self.out = (p["out_conv.kernel"][0], p["out_conv.bias"])
        self.blocks = []
        for i in range(net.n_blocks):
            m = f"block{i}_mha."
            qkv = [p[m + n].permute(1, 0, 2).reshape(C, -1)
                   for n in ("query_kernel", "key_kernel", "value_kernel")]
            self.blocks.append(_Block(
                torch.cat(qkv, dim=1), p[m + "projection_kernel"].reshape(-1, C),
                *(p[f"block{i}_{mod}.{leaf}"] for mod, leaf in (
                    ("ln1", "scale"), ("ln1", "bias"), ("ff1", "kernel"),
                    ("ff1", "bias"), ("ff2", "kernel"), ("ff2", "bias"),
                    ("ln2", "scale"), ("ln2", "bias")))))

    def init_state(self, batch: int) -> MHAStreamState:
        def caches():
            return tuple(torch.zeros(batch, self.max_len, self.H, self.dk,
                                     dtype=self.cache_dtype, device=self.device)
                         for _ in self.blocks)
        pad = self.N_d - self.N_s
        return MHAStreamState(caches(), caches(),
                              torch.zeros((), dtype=torch.int32, device=self.device),
                              torch.zeros(batch, pad, device=self.device),
                              torch.zeros(batch, pad, device=self.device))

    def _embed(self, feat, rows):
        """in_conv (no bias), LN, ReLU and the positional embedding's `rows`
        ([n] row indices on the device: 1 for a frame, Hn for a block)."""
        w, s, b = self.in_
        x = torch.relu(layer_norm_two_pass(feat @ w, s, b))
        return x if self.pos is None else x + self.pos.index_select(0, rows)

    def _write(self, kc, vc, rows, kv):
        """Write k and v (kv [B, n, 2, H, dk], cast to the caches' type in
        one operation) into the caches at the [n] int64 device rows."""
        kv = kv.to(kc.dtype)
        kc.index_copy_(1, rows, kv[:, :, 0])
        vc.index_copy_(1, rows, kv[:, :, 1])

    def _post(self, x, o, blk: _Block):
        """Output projection, residual + LN1, FFN, residual + LN2."""
        x = layer_norm_two_pass(x + o @ blk.wo, blk.ln1_s, blk.ln1_b)
        h = torch.relu(x @ blk.ff1_w + blk.ff1_b) @ blk.ff2_w + blk.ff2_b
        return layer_norm_two_pass(x + h, blk.ln2_s, blk.ln2_b)

    def _qkv(self, x, blk: _Block):
        """q (scaled by dk^-1/2) [..., H, dk] and k, v [..., 2, H, dk] of
        x [..., C]."""
        qkv = (x @ blk.wqkv).unflatten(-1, (3, self.H, self.dk))
        return qkv[..., 0, :, :] * (float(self.dk) ** -0.5), qkv[..., 1:, :, :]

    def _net_step(self, state: MHAStreamState, feat):
        """One frame [B, n_feat] through the MHANet at the clock state.t;
        writes each block's k and v at row min(t, max_len - 1)."""
        t = state.t
        t64 = t.long().view(1)
        attend = mha_cache_step if self.fused else mha_cache_step_ref
        x = self._embed(feat, t64 % self.max_len)
        row = t64.clamp(max=self.max_len - 1)
        for blk, kc, vc in zip(self.blocks, state.k_caches, state.v_caches):
            q, kv = self._qkv(x, blk)
            self._write(kc, vc, row, kv[:, None])
            o = attend(q.contiguous(), kc, vc, t)
            x = self._post(x, o.flatten(1), blk)
        w, b = self.out
        return torch.sigmoid(x @ w + b)

    def _net_step_block(self, state: MHAStreamState, feat):
        """Hn frames [B, Hn, n_feat] in one pass, the same math as Hn steps:
        each block's cache is read once for all Hn queries (the plain einsum
        route, as in JAX); query i (position t + i) sees rows j <= t + i."""
        t, Hn, L = state.t, feat.shape[1], self.max_len
        if Hn > L:
            raise ValueError(f"a block of {Hn} hops exceeds the {L}-frame cache")
        steps = torch.arange(Hn, device=self.device)
        rows = t.clamp(max=L - Hn) + steps   # dynamic_update_slice clamps the start
        pos = t + steps
        valid = (torch.arange(L, device=self.device)[None, :] <= pos[:, None]).to(torch.float32)
        x = self._embed(feat, pos % L)
        for blk, kc, vc in zip(self.blocks, state.k_caches, state.v_caches):
            q, kv = self._qkv(x, blk)
            self._write(kc, vc, rows, kv)
            logits = torch.einsum("btHd,bLHd->bHtL", q, kc.to(torch.float32))
            w = torch.softmax(logits + NEG_INF_V2 * (1.0 - valid), dim=-1)
            o = torch.einsum("bHtL,bLHd->btHd", w, vc.to(torch.float32))
            x = self._post(x, o.flatten(2), blk)
        w, b = self.out
        return torch.sigmoid(x @ w + b)

    @torch.no_grad()
    def step(self, state: MHAStreamState, chunk) -> Tuple[MHAStreamState, torch.Tensor]:
        """One hop: chunk [B, N_s] int16 (or float32) samples -> (new state,
        [B, N_s] float32 enhanced samples). Consumes `state`: its caches are
        written in place and shared by the returned state; the clock is not
        advanced in place, the returned state holds a new tensor t + 1."""
        x, re, im, mag = self._hop(state, chunk)
        syn = self._resynthesis(re, im, self._net_step(state, mag))
        return (state._replace(t=state.t + 1, wav_tail=x, ola_tail=syn[:, self.N_s:]),
                syn[:, :self.N_s] + state.ola_tail)

    @torch.no_grad()
    def step_block(self, state: MHAStreamState, chunk
                   ) -> Tuple[MHAStreamState, torch.Tensor]:
        """Hn hops in one pass (chunked streaming): chunk [B, Hn * N_s] ->
        (new state, [B, Hn * N_s] enhanced samples), equal to Hn `step`s to
        float rounding with Hn hops of latency. Consumes `state` (its caches;
        the returned clock is a new tensor t + Hn)."""
        x = self._samples(chunk)
        B, n = x.shape
        if n % self.N_s:
            raise ValueError(f"a block is a whole number of {self.N_s}-sample hops")
        Hn = n // self.N_s
        full = torch.cat([state.wav_tail, x], dim=1)
        re, im, mag = self._spectrum(full.unfold(1, self.N_d, self.N_s))  # [B, Hn, .]
        syn = self._resynthesis(re, im, self._net_step_block(state, mag))
        heads, tails = syn[..., :self.N_s], syn[..., self.N_s:]
        prev = torch.cat([state.ola_tail[:, None], tails[:, :-1]], dim=1)
        new = state._replace(t=state.t + Hn, wav_tail=full[:, Hn * self.N_s:],
                             ola_tail=tails[:, -1])
        return new, (heads + prev).reshape(B, n)
