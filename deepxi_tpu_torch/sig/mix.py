"""Waveform scaling, SNR mixing and instantaneous SNR (follows
deepxi_tpu/sig/mix.py).

The random noise offset of `add_noise` is a separate draw from a
`torch.Generator` on the host (the JAX package draws it from a `jax.random`
key, whose bits torch cannot reproduce); `add_noise_batch` also takes the
offsets explicitly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def normalise(x: torch.Tensor) -> torch.Tensor:
    """int16 waveform -> float32 in [-1, 1) by dividing by 32768."""
    return x.to(torch.float32) / 32768.0


def xi(S: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Instantaneous a priori SNR: S^2 / max(D^2, 1e-12)."""
    return torch.square(S) / torch.clamp(torch.square(D), min=1e-12)


def _masked_mean_power(w: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Mean of w^2 over the first ``length`` samples of each padded row."""
    mask = torch.arange(w.shape[-1], device=w.device) < length[..., None]
    return (torch.sum(torch.square(w) * mask, dim=-1)
            / torch.clamp(length.to(torch.float32), min=1.0))


def noise_offsets(s_len: torch.Tensor, d_len: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Random noise offsets i ~ U{0, max(d_len - s_len, 0)}, one per row,
    drawn on the host from `generator`."""
    hi = torch.clamp(d_len.cpu().to(torch.int64) - s_len.cpu().to(torch.int64),
                     min=0)
    u = torch.rand(hi.shape, generator=generator, dtype=torch.float64)
    return torch.minimum((u * (hi + 1).to(torch.float64)).to(torch.int64), hi)


def add_noise(s: torch.Tensor, d: torch.Tensor, s_len: int, d_len: int,
              snr_db_level: float, generator: Optional[torch.Generator] = None,
              offset: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One waveform: returns (x, d_scaled), both [L] (see add_noise_batch)."""
    lens = [torch.tensor([n]) for n in (s_len, d_len)]
    x, _, d_scaled = add_noise_batch(
        s[None], d[None], *lens, torch.tensor([float(snr_db_level)]), generator,
        None if offset is None else torch.tensor([offset]))
    return x[0], d_scaled[0]


def add_noise_batch(s: torch.Tensor, d: torch.Tensor, s_len: torch.Tensor,
                    d_len: torch.Tensor, snr_db_level: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    offsets: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mix a noise segment into each clean row at an exact SNR; returns
    (x, s_masked, d_scaled), all [B, L] and zero beyond s_len.

    Row b takes the noise segment d[b, i:i+s_len] (i from `offsets`, else
    drawn by `noise_offsets`), scaled by
    alpha = sqrt(P_s / max(P_d * 10^(snr/10), 1e-12)).
    INVARIANT: d_len >= s_len; the callers check it.

    Args:
      s: [B, L] float32 padded clean speech; d: [B, L_d] float32 padded noise.
      s_len, d_len: [B] valid lengths. snr_db_level: [B] SNRs (dB).
    """
    if offsets is None:
        offsets = noise_offsets(s_len, d_len, generator)
    L, L_d = s.shape[-1], d.shape[-1]
    dev = s.device
    s_len = s_len.to(dev)
    snr_lin = torch.pow(10.0, snr_db_level.to(dev, torch.float32) / 10.0)
    # d rolled left by i (jnp.roll(d, -i)[:L]); beyond s_len masked below
    idx = (torch.arange(L, device=dev)[None, :] + offsets.to(dev)[:, None]) % L_d
    d_seg = torch.gather(d, 1, idx)
    mask = (torch.arange(L, device=dev)[None, :] < s_len[:, None]).to(s.dtype)
    s = s * mask
    d_seg = d_seg * mask
    P_s = _masked_mean_power(s, s_len)
    P_d = _masked_mean_power(d_seg, s_len)
    alpha = torch.sqrt(P_s / torch.clamp(P_d * snr_lin, min=1e-12))
    d_scaled = d_seg * alpha[:, None]
    return s + d_scaled, s, d_scaled


def mix(s: torch.Tensor, d: torch.Tensor, s_len: torch.Tensor,
        d_len: torch.Tensor, snr_db_level: torch.Tensor, N_s: int,
        generator: Optional[torch.Generator] = None,
        offsets: Optional[torch.Tensor] = None):
    """Normalise int16 [B, L] inputs, mix at SNR, and count frames:
    returns (s, d, x, n_frames) with n_frames = ceil(s_len / N_s)."""
    x, s, d = add_noise_batch(normalise(s), normalise(d), s_len, d_len,
                              snr_db_level, generator, offsets)
    nf = torch.ceil(s_len.to(s.device, torch.float32) / float(N_s)).to(torch.int32)
    return s, d, x, nf


def snr_db(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Actual SNR (dB) between speech and noise."""
    P_s = torch.mean(torch.square(s), dim=-1)
    P_d = torch.mean(torch.square(d), dim=-1)
    return 10.0 * torch.log10(P_s / P_d)
