"""Histogram-mode noise trackers (follows deepxi_tpu/dsp/histnoise.py).

A ring buffer holds the last `frame_L` smoothed periodograms of every bin;
the noise estimate follows the mode of a histogram of up to 40 buckets over
the pool, in three variants: plain, SNR-masked and threshold-masked. The
tracker is a Python loop over frames with the histogram of every bin one
set of tensor operations. The warm-up (the first `frame_L` frames, where
every variant reports the pool mean) is a host decision on the frame
index, so the loop reads nothing back from the device.

As in the JAX package, the mode and mean recursions are independent, and
variant 1 applies its SNR mask whichever pool entries it excludes (the
reference aliases the two recursions and skips the mask when exactly pool
entry 0 is excluded).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class HistParams(NamedTuple):
    alpha_d: float = 0.8
    alpha_s: float = 0.9
    frame_L: int = 40
    delta: float = 8.0
    delta_snr: float = 2.5
    n_buckets: int = 40


class HistOutputs(NamedTuple):
    """[T, F] trajectories: `noiseX` is the histogram-mode noise PSD and
    `meanX`/`stdX` the pool statistics of the plain (X empty), SNR-masked
    (1) and threshold-masked (2) variants."""
    noise: torch.Tensor
    mean: torch.Tensor
    std: torch.Tensor
    noise1: torch.Tensor
    mean1: torch.Tensor
    std1: torch.Tensor
    noise2: torch.Tensor
    mean2: torch.Tensor
    std2: torch.Tensor


def _moments(pool: torch.Tensor, mask: torch.Tensor):
    """(mean, std, count) of every bin over the masked pool [L, F]."""
    cnt = torch.sum(mask, dim=0)
    safe_cnt = torch.clamp(cnt, min=1.0)
    mean = torch.sum(pool * mask, dim=0) / safe_cnt
    var = torch.sum(torch.square(pool - mean[None]) * mask, dim=0) / safe_cnt
    return mean, torch.sqrt(torch.clamp(var, min=0.0)), cnt


def _masked_mode(pool: torch.Tensor, mask: torch.Tensor, n_buckets: int) -> Tuple:
    """Per-bin histogram mode (the mode bucket's left edge), mean, std and
    count over the masked pool [L, F]; each output [F]. A bin's histogram
    has min(count, n_buckets) equal buckets over its masked range, the
    maximum in the last one (as np.histogram); a bucket index is the
    truncation of the offset over the width."""
    mean, std, cnt = _moments(pool, mask)
    big = torch.amax(pool, dim=0) + 1.0
    lo = torch.amin(torch.where(mask > 0, pool, big[None]), dim=0)
    hi = torch.amax(torch.where(mask > 0, pool, (lo - 1.0)[None]), dim=0)
    nb = torch.clamp(cnt, 1.0, float(n_buckets))
    width = torch.clamp(hi - lo, min=1e-12) / nb
    # clamped before the cast: truncation, then the bucket range, as the
    # JAX package's int32 cast and clip give for every masked entry
    idx = torch.clamp((pool - lo[None]) / width[None], 0.0, n_buckets - 1.0).to(torch.int32)
    idx = torch.minimum(idx, nb[None].to(torch.int32) - 1)
    buckets = torch.arange(n_buckets, dtype=torch.int32, device=pool.device)
    hist = torch.sum((idx[..., None] == buckets).to(pool.dtype) * mask[..., None], dim=0)
    mode = lo + torch.argmax(hist, dim=-1).to(pool.dtype) * width
    return mode, mean, std, cnt


def histogram_track(pwr: torch.Tensor, params: HistParams = HistParams(),
                    S0: Optional[torch.Tensor] = None) -> HistOutputs:
    """All three histogram trackers over a [T, F] periodogram. During the
    warm-up (t < frame_L) every variant reports the mean of the pool's
    first max(t, 1) entries (the current frame's among them only at t = 0)
    and its std floored at eps. `S0` seeds the smoothed periodogram
    (default: the first frame)."""
    L, n_bins = params.frame_L, pwr.shape[-1]
    dt, dev = pwr.dtype, pwr.device
    S = pwr[0] if S0 is None else torch.as_tensor(S0, dtype=dt, device=dev)
    pool = torch.zeros((L, n_bins), dtype=dt, device=dev)
    full = torch.ones((L, n_bins), dtype=dt, device=dev)
    eps = torch.finfo(dt).eps
    st = None
    outs = []

    def upd(prev, new):
        return params.alpha_d * prev + (1 - params.alpha_d) * new

    for t in range(pwr.shape[0]):
        S = params.alpha_s * S + (1 - params.alpha_s) * pwr[t]
        pool[t % L] = S
        if t < L:
            warm = (torch.arange(L, device=dev) < max(t, 1)).to(dt)[:, None] * full
            w_mean, w_std, _ = _moments(pool, warm)
            w_std = torch.clamp(w_std, min=eps)
            st = HistOutputs(*(w_mean, w_mean, w_std) * 3)
            outs.append(st)
            continue
        # variant 0: the mode of the whole pool
        mode0, mean0, std0, _ = _masked_mode(pool, full, params.n_buckets)
        noise, mean, std = upd(st.noise, mode0), upd(st.mean, mean0), upd(st.std, std0)
        # variant 1: the pool below delta_snr times the last estimate;
        # updates gated on how many pool entries survive
        prev1 = torch.clamp(st.noise1, min=1e-16)
        snr_mask = (pool / prev1[None] < params.delta_snr).to(dt)
        mode1, mean1_, std1_, cnt1 = _masked_mode(pool, snr_mask, params.n_buckets)
        noise1 = torch.where(cnt1 > 5, upd(st.noise1, mode1), st.noise1)
        mean1 = torch.where(cnt1 > 2, upd(st.mean1, mean1_), st.mean1)
        std1 = torch.where(cnt1 > 2, upd(st.std1, std1_), st.std1)
        # variant 2: the pool below a threshold
        thr = torch.minimum(noise1 + params.delta, torch.mean(pool, dim=0))
        thr_mask = (pool < thr[None]).to(dt)
        mode2, mean2_, std2_, cnt2 = _masked_mode(pool, thr_mask, params.n_buckets)
        noise2 = torch.where(cnt2 > 5, upd(st.noise2, mode2), st.noise2)
        mean2 = torch.where(cnt2 > 2, upd(st.mean2, mean2_), st.mean2)
        std2 = torch.where(cnt2 > 2, upd(st.std2, std2_), st.std2)
        st = HistOutputs(noise, mean, std, noise1, mean1, std1, noise2, mean2, std2)
        outs.append(st)
    return HistOutputs(*(torch.stack(o) for o in zip(*outs)))
