"""Speech-quality measures: segmental SNR, LLR, WSS, and the composite
CSIG/CBAK/COVL regressions.

These rebuild the reference's offline MATLAB scoring suite
(ref: demand_voice_bank_objective_scoring/objective_scoring.m:1-83 with its
composite.m / comp_snr.m helpers), i.e. the Hu & Loizou measures
("Evaluation of objective quality measures for speech enhancement", IEEE
TASLP 2008; LLR/SegSNR/WSS after Pellom & Hansen's implementations, WSS
after Klatt 1982). The BASELINE.md parity targets are defined in terms of
this scorer, so every convention of the MATLAB code is matched exactly:

  * 30 ms windows (round(30*fs/1000)), hop = floor(win/4);
  * frame count floor(n/hop - win/hop) -- one frame SHORT of the last
    fitting window, as the MATLAB 1:num_frames loop produces;
  * the MATLAB Hann variant w[k] = 0.5*(1 - cos(2*pi*k/(N+1))), k=1..N
    (never exactly zero at the ends);
  * LLR: autocorrelation LPC via Levinson-Durbin on the *windowed* frame
    (no second analysis window), quadratic forms against toeplitz(R_clean),
    un-clamped log ratio, mean over the lowest 95% of sorted frames;
  * WSS: 25 Gaussian critical-band filters constructed in FFT-bin space
    with the log(bw_min/bw) normalisation and -30 dB floor, spectral-slope
    peak search transcribed exactly, frame distortions normalised by the
    weight sum, mean over the lowest 95%;
  * SegSNR: energies of *windowed* frames, eps regularisation inside the
    log, clamped to [-10, 35] dB;
  * composite(): both signals get +eps, CSIG/CBAK/COVL regressions with
    the published coefficients, clipped to [1, 5].
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

_EPS = np.finfo(np.float64).eps  # MATLAB eps
_ALPHA = 0.95  # lowest-95%-of-frames aggregation (composite.m:36)


def _win_hop(fs: int) -> Tuple[int, int]:
    # MATLAB round() is half-away-from-zero; Python round() is banker's.
    # They differ only when 30*fs/1000 lands on an even .5 (no common fs
    # does), but use the MATLAB convention the scorer transcribes.
    win = int(np.floor(30 * fs / 1000.0 + 0.5))
    return win, win // 4


def _matlab_hann(n: int) -> np.ndarray:
    """0.5*(1 - cos(2*pi*(1:n)/(n+1))) (composite.m:175,348,459)."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(1, n + 1) / (n + 1)))


def _framed(x: np.ndarray, fs: int, windowed: bool = True) -> np.ndarray:
    """[num_frames, win] windowed frames with the MATLAB frame count
    floor(n/hop - win/hop) (composite.m:173)."""
    win, hop = _win_hop(fs)
    nf = int(len(x) / hop - win / hop)
    if nf <= 0:
        return np.zeros((0, win))
    idx = (np.arange(nf) * hop)[:, None] + np.arange(win)[None, :]
    fr = x[idx]
    return fr * _matlab_hann(win)[None, :] if windowed else fr


def _trimmed_mean(vals: np.ndarray, alpha: float = _ALPHA) -> float:
    """Mean of the lowest round(alpha*N) sorted values (composite.m:49-58).

    MATLAB round() is half-AWAY-FROM-ZERO; Python's round is banker's, so
    `int(round(...))` kept one frame too few whenever N*alpha landed on
    .5 (e.g. 150 frames -> 142 instead of MATLAB's 143). Caught by the
    composite.m differential oracle (tests/test_composite_oracle.py)."""
    if len(vals) == 0:
        return 0.0
    v = np.sort(vals)
    return float(np.mean(v[: int(np.floor(len(v) * alpha + 0.5))]))


# ---------------------------------------------------------------------------
# SNR measures (composite.m `snr`, comp_snr.m)
# ---------------------------------------------------------------------------

def snr_overall(clean: np.ndarray, enhanced: np.ndarray) -> float:
    """Overall SNR: 10*log10(sum(c^2)/sum((c-e)^2)) (composite.m:446)."""
    n = min(len(clean), len(enhanced))
    c = clean[:n].astype(np.float64)
    e = enhanced[:n].astype(np.float64)
    return float(10.0 * np.log10(np.sum(c ** 2)
                                 / max(np.sum((c - e) ** 2), _EPS)))


def seg_snr_frames(clean: np.ndarray, enhanced: np.ndarray, fs: int
                   ) -> np.ndarray:
    """Per-frame segmental SNR of *windowed* frames, clamped to [-10, 35]
    dB (composite.m:448-483; identical in comp_snr.m)."""
    n = min(len(clean), len(enhanced))
    cf = _framed(clean[:n].astype(np.float64), fs)
    ef = _framed(enhanced[:n].astype(np.float64), fs)
    sig = np.sum(cf ** 2, axis=1)
    noi = np.sum((cf - ef) ** 2, axis=1)
    s = 10.0 * np.log10(sig / (noi + _EPS) + _EPS)
    return np.clip(s, -10.0, 35.0)


def seg_snr(clean: np.ndarray, enhanced: np.ndarray, fs: int) -> float:
    """Mean segmental SNR (composite.m:62-64)."""
    v = seg_snr_frames(clean, enhanced, fs)
    return float(np.mean(v)) if len(v) else 0.0


# ---------------------------------------------------------------------------
# LLR (composite.m `llr` + `lpcoeff`)
# ---------------------------------------------------------------------------

def _levinson_batch(R: np.ndarray, order: int) -> np.ndarray:
    """Levinson-Durbin over a batch of autocorrelations R [F, order+1]
    -> prediction polynomials A = [1, -a] [F, order+1]
    (composite.m lpcoeff:383-412)."""
    F = R.shape[0]
    a = np.zeros((F, order))
    E = R[:, 0].copy()
    for i in range(order):
        # sum_term = sum(a_past(1:i-1) .* R(i:-1:2)) in MATLAB 1-based,
        # i.e. dot of a[:, :i] with R[:, i:0:-1] here
        if i > 0:
            sum_term = np.sum(a[:, :i] * R[:, i:0:-1], axis=1)
        else:
            sum_term = np.zeros(F)
        rc = (R[:, i + 1] - sum_term) / E
        a_past = a[:, :i].copy()
        a[:, i] = rc
        if i > 0:
            a[:, :i] = a_past - rc[:, None] * a_past[:, ::-1]
        E = (1.0 - rc * rc) * E
    return np.concatenate([np.ones((F, 1)), -a], axis=1)


def _autocorr(frames: np.ndarray, order: int) -> np.ndarray:
    """R[k] = sum(x[:n-k] * x[k:]) for k = 0..order (lpcoeff:390-394)."""
    return np.stack([np.sum(frames[:, : frames.shape[1] - k] * frames[:, k:],
                            axis=1) for k in range(order + 1)], axis=1)


def _quad_toeplitz(A: np.ndarray, R: np.ndarray) -> np.ndarray:
    """A @ toeplitz(R) @ A' per row without building the matrix:
    R[0]*c0 + 2*sum_k R[k]*ck with ck = sum_i A[i]*A[i+k]."""
    P1 = A.shape[1]
    c = np.stack([np.sum(A[:, : P1 - k] * A[:, k:], axis=1)
                  for k in range(P1)], axis=1)
    return c[:, 0] * R[:, 0] + 2.0 * np.sum(c[:, 1:] * R[:, 1:], axis=1)


def llr_frames(clean: np.ndarray, enhanced: np.ndarray, fs: int) -> np.ndarray:
    """Per-frame log-likelihood ratio log(A_e R_c A_e' / A_c R_c A_c'),
    un-clamped (composite.m:334-381)."""
    n = min(len(clean), len(enhanced))
    order = 10 if fs < 10000 else 16
    cf = _framed(clean[:n].astype(np.float64), fs)
    ef = _framed(enhanced[:n].astype(np.float64), fs)
    if len(cf) == 0:
        return np.zeros(0)
    R_c = _autocorr(cf, order)
    R_e = _autocorr(ef, order)
    A_c = _levinson_batch(R_c, order)
    A_e = _levinson_batch(R_e, order)
    num = _quad_toeplitz(A_e, R_c)
    den = _quad_toeplitz(A_c, R_c)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(num / den)


def llr(clean: np.ndarray, enhanced: np.ndarray, fs: int) -> float:
    """Mean over the lowest 95% of sorted frame LLRs (composite.m:55-58)."""
    vals = llr_frames(clean, enhanced, fs)
    vals = vals[np.isfinite(vals)]
    return _trimmed_mean(vals)


# ---------------------------------------------------------------------------
# WSS (composite.m `wss`, after Klatt 1982)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _wss_filters(fs: int, n_fft: int) -> Tuple:
    """25 Gaussian critical-band filters over FFT bins 0..n_fft/2-1 with
    the log(bw_min/bw) normalisation and -30 dB floor
    (composite.m:120-166)."""
    cent = np.array([50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0,
                     617.372, 703.378, 798.717, 904.128, 1020.38, 1148.30,
                     1288.72, 1442.54, 1610.70, 1794.16, 1993.93, 2211.08,
                     2446.71, 2701.97, 2978.04, 3276.17, 3597.63])
    bw = np.array([70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724,
                   86.0056, 95.3398, 105.411, 116.256, 127.914, 140.423,
                   153.823, 168.154, 183.457, 199.776, 217.153, 235.631,
                   255.255, 276.072, 298.126, 321.465, 346.136])
    max_freq = fs / 2.0
    nby2 = n_fft // 2
    min_factor = np.exp(-30.0 / (2.0 * 2.303))
    j = np.arange(nby2)
    filt = np.zeros((25, nby2))
    for i in range(25):
        f0 = np.floor((cent[i] / max_freq) * nby2)
        b = (bw[i] / max_freq) * nby2
        norm = np.log(bw[0]) - np.log(bw[i])
        g = np.exp(-11.0 * (((j - f0) / b) ** 2) + norm)
        filt[i] = g * (g > min_factor)
    return tuple(map(tuple, filt))


def wss_frames(clean: np.ndarray, enhanced: np.ndarray, fs: int) -> np.ndarray:
    """Per-frame weighted-spectral-slope distortion (composite.m:89-331)."""
    n = min(len(clean), len(enhanced))
    win, _ = _win_hop(fs)
    cf = _framed(clean[:n].astype(np.float64), fs)
    ef = _framed(enhanced[:n].astype(np.float64), fs)
    F = len(cf)
    if F == 0:
        return np.zeros(0)
    n_fft = int(2 ** np.ceil(np.log2(2 * win)))
    nby2 = n_fft // 2
    filt = np.asarray(_wss_filters(fs, n_fft))  # [25, nby2]
    spec_c = np.abs(np.fft.fft(cf, n_fft, axis=1)[:, :nby2]) ** 2
    spec_e = np.abs(np.fft.fft(ef, n_fft, axis=1)[:, :nby2]) ** 2
    eng_c = 10.0 * np.log10(np.maximum(spec_c @ filt.T, 1e-10))  # [F, 25]
    eng_e = 10.0 * np.log10(np.maximum(spec_e @ filt.T, 1e-10))
    sl_c = np.diff(eng_c, axis=1)  # [F, 24]
    sl_e = np.diff(eng_e, axis=1)

    def loc_peaks(eng: np.ndarray, sl: np.ndarray) -> np.ndarray:
        """Nearest-peak energies, transcribing the MATLAB while-loop walk
        (composite.m:236-275): positive slope -> walk right while the slope
        stays positive, take energy one short of the stop; non-positive ->
        walk left while non-positive, take energy one past the stop."""
        nb = eng.shape[1]  # 25
        peaks = np.empty_like(sl)
        for f in range(eng.shape[0]):
            e, s = eng[f], sl[f]
            for i in range(nb - 1):
                if s[i] > 0:
                    m = i
                    while m < nb - 1 and s[m] > 0:
                        m += 1
                    peaks[f, i] = e[m - 1]
                else:
                    m = i
                    while m >= 0 and s[m] <= 0:
                        m -= 1
                    peaks[f, i] = e[m + 1]
        return peaks

    pk_c = loc_peaks(eng_c, sl_c)
    pk_e = loc_peaks(eng_e, sl_e)
    Kmax, Klocmax = 20.0, 1.0
    w_c = (Kmax / (Kmax + eng_c.max(axis=1, keepdims=True) - eng_c[:, :24])
           * Klocmax / (Klocmax + pk_c - eng_c[:, :24]))
    w_e = (Kmax / (Kmax + eng_e.max(axis=1, keepdims=True) - eng_e[:, :24])
           * Klocmax / (Klocmax + pk_e - eng_e[:, :24]))
    w = 0.5 * (w_c + w_e)
    return np.sum(w * (sl_c - sl_e) ** 2, axis=1) / np.sum(w, axis=1)


def wss(clean: np.ndarray, enhanced: np.ndarray, fs: int) -> float:
    """Mean over the lowest 95% of sorted frame WSS (composite.m:49-51)."""
    return _trimmed_mean(wss_frames(clean, enhanced, fs))


# ---------------------------------------------------------------------------
# Composite regressions (composite.m:72-79)
# ---------------------------------------------------------------------------

def composite(clean: np.ndarray, enhanced: np.ndarray, fs: int,
              pesq_mos: Optional[float] = None) -> dict:
    """CSIG/CBAK/COVL composite measures plus their LLR/WSS/SegSNR/SNR
    inputs -- the DEMAND-VB MATLAB scorer's per-utterance scores
    (ref: objective_scoring.m:45-48, composite.m:72-79).

    `pesq_mos` is the raw P.862 PESQ MOS; when omitted it is computed with
    deepxi_tpu_torch.metrics.pesq (documented deviation there: crude whole-signal
    alignment instead of P.862 utterance splitting).
    """
    n = min(len(clean), len(enhanced))
    c = clean[:n].astype(np.float64) + _EPS  # composite.m:44-45
    e = enhanced[:n].astype(np.float64) + _EPS
    if pesq_mos is None:
        from deepxi_tpu_torch.metrics.pesq import pesq as _pesq
        pesq_mos = _pesq(clean, enhanced, fs, mode="nb")
    out = {
        "SegSNR": seg_snr(c, e, fs),
        "LLR": llr(c, e, fs),
        "WSS": wss(c, e, fs),
        "SNR": snr_overall(c, e),
        "PESQ": float(pesq_mos),
    }
    out["CSIG"] = float(np.clip(3.093 - 1.029 * out["LLR"] + 0.603 * pesq_mos
                                - 0.009 * out["WSS"], 1.0, 5.0))
    out["CBAK"] = float(np.clip(1.634 + 0.478 * pesq_mos - 0.007 * out["WSS"]
                                + 0.063 * out["SegSNR"], 1.0, 5.0))
    out["COVL"] = float(np.clip(1.594 + 0.805 * pesq_mos - 0.512 * out["LLR"]
                                - 0.007 * out["WSS"], 1.0, 5.0))
    return out
