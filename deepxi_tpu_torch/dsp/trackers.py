"""Minima-controlled noise-PSD trackers (MCRA, MCRA-2, IMCRA, MCRA-TBRR)
and the OM-LSA gain rule (follows deepxi_tpu/dsp/trackers.py).

Each tracker is a Python loop over the frames of a [T, F] periodogram with
every bin's update one tensor operation on the device the periodogram is
on, where the JAX package runs one `lax.scan`. The frame index decides the
minimum windows' resets: it is a host integer, so those decisions are
Python branches and the loop reads nothing back from the device. Every
other decision (S / S_min > delta, IMCRA's indicators, MCRA-2's `rising`)
is a `torch.where` on the device, as in the JAX package.

Algorithms: Cohen & Berdugo, "Noise estimation by minima controlled
recursive averaging for robust speech enhancement" (2002); Cohen, "Noise
spectrum estimation in adverse environments: improved minima controlled
recursive averaging" (2003); OM-LSA gain G^p * G_min^(1-p).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepxi_tpu_torch.ops.gains import mmse_lsa

_ALPHA_SNR = 0.92  # decision-directed smoothing
# Hanning(7) taps of the frequency smoothing (the outer two are 0)
_HANN7 = tuple(float(a) for a in np.hanning(7))

Tracked = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _freq_smooth(p: torch.Tensor) -> torch.Tensor:
    """Hanning(7)-banded smoothing over the last axis, truncated at the
    edges (a bin's missing neighbours count as 0)."""
    a = _HANN7

    def shift(x, k):  # x[..., f - k], zero outside
        return F.pad(x[..., :-k], (k, 0)) if k > 0 else F.pad(x[..., -k:], (0, -k))

    return (a[3] * p + a[2] * shift(p, 1) + a[4] * shift(p, -1)
            + a[1] * shift(p, 2) + a[5] * shift(p, -2))


class MCRAParams(NamedTuple):
    """The JAX package's defaults (the fork's usage)."""
    alpha_d: float = 0.95
    alpha_s: float = 0.8
    alpha_p: float = 0.2
    frame_L: int = 100
    delta: float = 5.0
    g_min: float = 0.09
    # MCRA-2
    gamma: float = 0.998
    beta: float = 0.96
    # IMCRA
    b_min: float = 1.66
    gamma0: float = 4.6
    gamma1: float = 3.0
    zeta0: float = 1.67


def _init_common(pwr0: torch.Tensor) -> Dict[str, torch.Tensor]:
    # floor the seed: a silent first frame would make lambda_d = 0 and the
    # decision-directed division inf/NaN for the whole run
    pwr0 = torch.clamp(pwr0, min=1e-12)
    S0 = _freq_smooth(pwr0)
    return dict(lambda_d=pwr0, S=S0, S_tmp=S0, S_min=S0,
                speech_present=torch.zeros_like(pwr0),
                snr_gamma=torch.full_like(pwr0, 0.1),
                snr_xi=torch.full_like(pwr0, 0.1))


def _dd_snr(state, pwr):
    """Decision-directed a posteriori and a priori SNR of this frame."""
    G_h = mmse_lsa(state["snr_xi"], state["snr_gamma"])
    snr_gamma = pwr / torch.clamp(state["lambda_d"], min=1e-12)
    snr_xi = (_ALPHA_SNR * torch.square(G_h) * state["snr_gamma"]
              + (1.0 - _ALPHA_SNR) * torch.clamp(snr_gamma - 1.0, min=0.0))
    return snr_gamma, snr_xi


def _finish(state, pwr, p, params):
    """Shared tail: smoothed presence, adaptive alpha, noise update, gain."""
    sp = params.alpha_p * state["speech_present"] + (1.0 - params.alpha_p) * p
    alpha_D = params.alpha_d + (1.0 - params.alpha_d) * sp
    lambda_d = alpha_D * state["lambda_d"] + (1.0 - alpha_D) * pwr
    return sp, lambda_d, mmse_lsa(state["snr_xi"], state["snr_gamma"])


def _windowed_min(reset: bool, S, S_min, S_tmp):
    """(S_min, S_tmp) of the windowed minimum: a reset (a host decision on
    the frame index) restarts the window."""
    if reset:
        return torch.minimum(S, S_tmp), S
    return torch.minimum(S, S_min), torch.minimum(S, S_tmp)


def _mcra_update(state, pw, t: int, params):
    """One MCRA frame of `state`: the new state's fields."""
    snr_gamma, snr_xi = _dd_snr(state, pw)
    S = params.alpha_s * state["S"] + (1 - params.alpha_s) * _freq_smooth(pw)
    S_min, S_tmp = _windowed_min(t % params.frame_L == 0, S, state["S_min"],
                                 state["S_tmp"])
    p = (S / S_min > params.delta).to(pw.dtype)
    sp, lambda_d, G_h = _finish(dict(state, snr_gamma=snr_gamma, snr_xi=snr_xi),
                                pw, p, params)
    return dict(lambda_d=lambda_d, S=S, S_tmp=S_tmp, S_min=S_min,
                speech_present=sp, snr_gamma=snr_gamma, snr_xi=snr_xi), G_h


def _stack(outs) -> Tracked:
    return tuple(torch.stack(o) for o in zip(*outs))


def mcra_track(pwr: torch.Tensor, params: MCRAParams = MCRAParams()) -> Tracked:
    """MCRA noise tracking over a [T, F] periodogram: (lambda_d, G, p), each
    [T, F]: the noise PSD estimate, the MMSE-LSA gain and the smoothed
    speech presence of every frame."""
    state, outs = _init_common(pwr[0]), []
    for t in range(pwr.shape[0]):
        state, G_h = _mcra_update(state, pwr[t], t, params)
        outs.append((state["lambda_d"], G_h, state["speech_present"]))
    return _stack(outs)


def mcra2_track(pwr: torch.Tensor, params: MCRAParams = MCRAParams()) -> Tracked:
    """MCRA-2: continuous minimum tracking in place of the windowed
    minimum."""
    state, outs = _init_common(pwr[0]), []
    for t in range(pwr.shape[0]):
        pw = pwr[t]
        snr_gamma, snr_xi = _dd_snr(state, pw)
        S_prev = state["S"]
        S = params.alpha_s * S_prev + (1 - params.alpha_s) * _freq_smooth(pw)
        cont = (params.gamma * state["S_min"]
                + (1 - params.gamma) * (S - params.beta * S_prev) / (1 - params.beta))
        S_min = torch.where(state["S_min"] < S, cont, S)
        p = (S / S_min > params.delta).to(pw.dtype)
        sp, lambda_d, G_h = _finish(dict(state, snr_gamma=snr_gamma, snr_xi=snr_xi),
                                    pw, p, params)
        state = dict(state, lambda_d=lambda_d, S=S, S_min=S_min, speech_present=sp,
                     snr_gamma=snr_gamma, snr_xi=snr_xi)
        outs.append((lambda_d, G_h, sp))
    return _stack(outs)


def _soft_presence(q, snr_xi, snr_gamma):
    """Speech presence from the a priori absence q and the SNRs."""
    v = snr_xi * snr_gamma / torch.clamp(1.0 + snr_xi, min=1e-16)
    one_minus_q = torch.clamp(1.0 - q, min=1e-16)
    return 1.0 / torch.clamp(1.0 + q * (1.0 + snr_xi) * torch.exp(-v) / one_minus_q,
                             min=1e-16)


def imcra_track(pwr: torch.Tensor, params: MCRAParams = MCRAParams(
        alpha_d=0.89, frame_L=100)) -> Tracked:
    """IMCRA: a second smoothing over noise-dominated bins and a soft speech
    presence from the a priori SNR (Cohen 2003, as in the JAX package,
    whose reference copy cannot run)."""
    state = _init_common(pwr[0])
    state.update(S_hat=state["S"], S_min_hat=state["S_min"], S_tmp_hat=state["S_tmp"])
    alpha_s_hat = params.alpha_s * 1.2
    frame_L_hat = max(int(params.frame_L * 0.5), 1)
    outs = []
    for t in range(pwr.shape[0]):
        pw = pwr[t]
        snr_gamma, snr_xi = _dd_snr(state, pw)
        # first iteration: the smoothed windowed minimum
        S = params.alpha_s * state["S"] + (1 - params.alpha_s) * _freq_smooth(pw)
        S_min, S_tmp = _windowed_min(t % params.frame_L == 0, S, state["S_min"],
                                     state["S_tmp"])
        # second iteration: smoothing over noise-dominated bins only; a bin
        # with no vote keeps its previous second-iteration value
        gamma_min = pw / (params.b_min * S_min)
        zeta = S / (params.b_min * S_min)
        I = ((gamma_min < params.gamma0) & (zeta < params.zeta0)).to(pw.dtype)
        win_I = _freq_smooth(I)
        no_vote = (win_I == 0).to(pw.dtype)
        S_f = (_freq_smooth(I * pw) / torch.where(win_I == 0, 1.0, win_I)
               ) * (1 - no_vote) + state["S_hat"] * no_vote
        S_hat = alpha_s_hat * state["S_hat"] + (1 - alpha_s_hat) * S_f
        S_min_hat, S_tmp_hat = _windowed_min(t % frame_L_hat == 0, S_hat,
                                             state["S_min_hat"], state["S_tmp_hat"])
        # soft speech presence
        gamma_min_hat = pw / (params.b_min * S_min_hat)
        zeta_hat = S_hat / (params.b_min * S_min_hat)
        a = ((gamma_min_hat < 1.0) & (zeta_hat < params.zeta0)).to(pw.dtype)
        b = ((zeta_hat < params.zeta0) & (gamma_min_hat < params.gamma1)
             & (gamma_min_hat > 1.0)).to(pw.dtype)
        q = a + b * (params.gamma1 - gamma_min_hat) / (params.gamma1 - 1.0)
        p = _soft_presence(q, snr_xi, snr_gamma)
        # noise update with the soft presence (no alpha_p smoothing)
        alpha_D = params.alpha_d + (1.0 - params.alpha_d) * p
        lambda_d = alpha_D * state["lambda_d"] + (1.0 - alpha_D) * pw
        G_h = mmse_lsa(snr_xi, snr_gamma)
        state = dict(lambda_d=lambda_d, S=S, S_tmp=S_tmp, S_min=S_min, S_hat=S_hat,
                     S_min_hat=S_min_hat, S_tmp_hat=S_tmp_hat, speech_present=p,
                     snr_gamma=snr_gamma, snr_xi=snr_xi)
        outs.append((lambda_d, G_h, p))
    return _stack(outs)


def mcra_tbrr_track(pwr: torch.Tensor, pwr_b: torch.Tensor, pwr_bm: torch.Tensor,
                    params: MCRAParams = MCRAParams()) -> Tracked:
    """Dual-channel MCRA with transient beam-to-reference ratio priors: two
    auxiliary MCRA trackers follow the beamformer output `pwr_b` and the
    blocking-matrix reference `pwr_bm` (each [T, F]); their smoothed power
    over noise drives a soft a priori absence q that gates the main
    channel's (`pwr`) noise update. Returns (lambda_d, G, p) of the main
    channel."""
    LAMBDA_0, LAMBDA_1 = 1.67, 1.81
    GAMMA_0 = 4.6
    OMEGA_LO, OMEGA_HI = 1.0, 3.0
    state = _init_common(pwr[0])
    zb, zr = _init_common(pwr_b[0]), _init_common(pwr_bm[0])
    eps = torch.finfo(pwr.dtype).eps
    outs = []
    for t in range(pwr.shape[0]):
        pw = pwr[t]
        snr_gamma, snr_xi = _dd_snr(state, pw)
        zb = _mcra_update(zb, pwr_b[t], t, params)[0]
        zr = _mcra_update(zr, pwr_bm[t], t, params)[0]
        Lam_y = zb["S"] / torch.clamp(zb["lambda_d"], min=1e-16)
        Lam_bm = zr["S"] / torch.clamp(zr["lambda_d"], min=1e-16)
        # sign-preserving zero guard of the reference excess
        d = zr["S"] - zr["lambda_d"]
        Omega = (zb["S"] - zb["lambda_d"]) / torch.where(d == 0, eps, d)
        H0 = (Lam_y <= LAMBDA_0).to(pw.dtype)
        H1 = (1 - H0) * (Lam_bm <= LAMBDA_1).to(pw.dtype)
        Hr = (1 - H0) * (1 - H1)
        H0t = ((Omega < OMEGA_LO) | (snr_gamma < 1.0)).to(pw.dtype) * Hr
        Hmask = Hr * (1 - H0t)
        H1t = ((Omega > OMEGA_HI) | (snr_gamma > GAMMA_0)).to(pw.dtype) * Hmask
        Hr_mask = Hmask * (1 - H1t)
        r = torch.maximum((GAMMA_0 - snr_gamma) / (GAMMA_0 - 1.0),
                          (OMEGA_HI - Omega) / (OMEGA_HI - OMEGA_LO))
        q = torch.clamp(H0 + H0t + r * Hr_mask, 0.0, 1.0)
        p = _soft_presence(q, snr_xi, snr_gamma)
        alpha_D = params.alpha_d + (1.0 - params.alpha_d) * p
        lambda_d = alpha_D * state["lambda_d"] + (1.0 - alpha_D) * pw
        G_h = mmse_lsa(snr_xi, snr_gamma)
        state = dict(state, lambda_d=lambda_d, speech_present=p, snr_gamma=snr_gamma,
                     snr_xi=snr_xi)
        outs.append((lambda_d, G_h, p))
    return _stack(outs)


_TRACKERS = {"mcra": mcra_track, "mcra2": mcra2_track, "imcra": imcra_track}


def omlsa_enhance(mag: torch.Tensor, params: MCRAParams = MCRAParams(),
                  tracker: str = "mcra") -> torch.Tensor:
    """OM-LSA enhanced magnitude G^p * G_min^(1-p) * |X| of a [T, F] noisy
    magnitude spectrum, with the gain and presence of an MCRA-family
    tracker ("mcra", "mcra2" or "imcra")."""
    try:
        track = _TRACKERS[tracker]
    except KeyError:
        raise ValueError(f"Unknown tracker {tracker!r} (have {sorted(_TRACKERS)})") from None
    _, G, p = track(torch.square(mag), params)
    return torch.pow(G, p) * torch.pow(params.g_min, 1.0 - p) * mag
