"""PESQ (ITU-T P.862) perceptual speech quality, native numpy implementation.

The reference evaluates PESQ via the `pesq` pip package in DeepXi.test
(ref: deepxi/model.py:1858-1861) and via MATLAB offline scoring
(ref: demand_voice_bank_objective_scoring/pesq.m); neither is available in
this environment, so the measure is implemented from the ITU-T P.862
algorithm: level alignment to the 325-3250 Hz band, IRS receive filtering
(narrowband) / P.862.2 input filter (wideband), Bark-domain pitch power
densities, partial frequency/gain compensation, Zwicker loudness, disturbance
with deadzone masking and asymmetry weighting, L2/L6 syllable-time
aggregation, and bad-interval realignment. Constants come from the published
standard tables (deepxi_tpu_torch/metrics/_pesq_tables.py).

Time alignment implements the full P.862 pipeline (deepxi_tpu_torch/metrics/
_pesq_align.py): energy VAD, whole-signal crude alignment on logVAD
envelopes, per-utterance crude + histogram fine alignment, utterance
boundary identification, and recursive utterance SPLITTING so delays that
change mid-signal are tracked piecewise (ref: pesq.m utterance_locate /
split_align); the psychoacoustic model reads the degraded signal through
the per-utterance delay map and keeps the bad-interval realignment.

Modes:
  * ``nb``      -> raw P.862 PESQ MOS (what the reference's PESQ column is)
  * ``nb-lqo``  -> P.862.1 MOS-LQO mapping of the nb score
  * ``wb``      -> P.862.2 wideband MOS-LQO (the reference's MOS-LQO column)
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy.signal import resample_poly, sosfilt

from deepxi_tpu_torch.metrics import _pesq_align as A
from deepxi_tpu_torch.metrics import _pesq_tables as T

DATAPADDING_MSECS = 320
SEARCHBUFFER = 75

# Level-alignment bandpass (325-3250 Hz) and narrowband IRS receive
# characteristic, as (Hz, dB) breakpoints -- standard P.862 tables.
_ALIGN_FILTER_DB = np.array([
    [0, -500], [50, -500], [100, -500], [125, -500], [160, -500], [200, -500],
    [250, -500], [300, -500], [350, 0], [400, 0], [500, 0], [600, 0],
    [630, 0], [800, 0], [1000, 0], [1250, 0], [1600, 0], [2000, 0],
    [2500, 0], [3000, 0], [3250, 0], [3500, -500], [4000, -500],
    [5000, -500], [6300, -500], [8000, -500]], dtype=np.float64)

_IRS_FILTER_DB = np.array([
    [0, -200], [50, -40], [100, -20], [125, -12], [160, -6], [200, 0],
    [250, 4], [300, 6], [350, 8], [400, 10], [500, 11], [600, 12], [700, 12],
    [800, 12], [1000, 12], [1300, 12], [1600, 12], [2000, 12], [2500, 12],
    [3000, 12], [3250, 12], [3500, 4], [4000, -200], [5000, -200],
    [6300, -200], [8000, -200]], dtype=np.float64)


class _Cfg:
    def __init__(self, fs: int):
        sfx = "8k" if fs == 8000 else "16k"
        self.fs = fs
        self.Nb = int(getattr(T, f"Nb_{sfx}"))
        self.Sp = float(getattr(T, f"Sp_{sfx}"))
        self.Sl = float(getattr(T, f"Sl_{sfx}"))
        self.downsample = int(getattr(T, f"Downsample_{sfx}"))
        self.nr_per_band = np.asarray(
            getattr(T, f"nr_of_hz_bands_per_bark_band_{sfx}"), np.int64)
        self.centre_bark = np.asarray(getattr(T, f"centre_of_band_bark_{sfx}"))
        self.width_bark = np.asarray(getattr(T, f"width_of_band_bark_{sfx}"))
        self.pow_corr = np.asarray(getattr(T, f"pow_dens_correction_factor_{sfx}"))
        self.abs_thresh = np.asarray(getattr(T, f"abs_thresh_power_{sfx}"))
        self.align_nfft = int(getattr(T, f"Align_Nfft_{sfx}"))
        # the standard's input_filter (DC block + InIIR_Hsos IIR) feeds the
        # VAD/alignment stage; the psychoacoustic model consumes the
        # IRS/WB-filtered signals (pesq.m restores model_ref/model_deg)
        iir = np.asarray(getattr(T, f"InIIR_Hsos_{sfx}")).reshape(-1, 5)
        self.in_sos = np.concatenate(
            [iir[:, :3], np.ones((len(iir), 1)), iir[:, 3:]], axis=1)
        if fs == 16000:
            wb = np.asarray(T.WB_InIIR_Hsos_16k).reshape(-1, 5)
            self.wb_sos = np.concatenate(
                [wb[:, :3], np.ones((len(wb), 1)), wb[:, 3:]], axis=1)
        self.Nf = self.downsample * 8
        self.sb = SEARCHBUFFER * self.downsample
        self.pad = DATAPADDING_MSECS * (fs // 1000)
        # frequency-warping band boundaries for np.add.reduceat
        self.band_starts = np.concatenate([[0], np.cumsum(self.nr_per_band)])[:-1]


def _apply_filter_fft(data: np.ndarray, n: int, table: np.ndarray,
                      cfg: _Cfg) -> np.ndarray:
    """Piecewise-linear dB magnitude filter applied in the FFT domain over
    the active region, gain-normalised at 1 kHz (P.862 apply_filter)."""
    out = data.copy()
    pow2 = 2 ** math.ceil(math.log2(n))
    gain_1k = np.interp(1000.0, table[:, 0], table[:, 1])
    x = np.zeros(pow2)
    x[:n] = data[cfg.sb:cfg.sb + n]
    X = np.fft.fft(x)
    freqs = np.arange(pow2 // 2 + 1) * (cfg.fs / pow2)
    fac_db = np.interp(freqs, table[:, 0], table[:, 1]) - gain_1k
    fac = 10.0 ** (fac_db / 20.0)
    fac = np.concatenate([fac, fac[1:-1][::-1]])
    y = np.real(np.fft.ifft(X * fac))
    out[cfg.sb:cfg.sb + n] = y[:n]
    return out


def _pow_of(x: np.ndarray, lo: int, hi: int, divisor: float) -> float:
    return float(np.sum(np.square(x[lo:hi], dtype=np.float64)) / divisor)


def _fix_power_level(data: np.ndarray, n: int, max_n: int, cfg: _Cfg) -> np.ndarray:
    filtered = _apply_filter_fft(data, n - 2 * cfg.sb + cfg.pad, _ALIGN_FILTER_DB, cfg)
    p = _pow_of(filtered, cfg.sb, max_n - cfg.sb + cfg.pad,
                max_n - 2 * cfg.sb + cfg.pad)
    if p <= 0.0:
        # P.862 is undefined on a silent signal; raise the same error
        # class the scorer already skips per-metric (an all-zero enhanced
        # output must not kill a whole campaign scoring pass)
        raise ValueError("PESQ: zero band power (silent signal)")
    return data * math.sqrt(1e7 / p)


def _freq_warp(hz_spectrum: np.ndarray, cfg: _Cfg) -> np.ndarray:
    """Hz power spectra [..., Nf/2] -> Bark pitch power densities [..., Nb]."""
    sums = np.add.reduceat(hz_spectrum, cfg.band_starts, axis=-1)
    return sums * cfg.pow_corr * cfg.Sp


def _total_audible(ppd: np.ndarray, cfg: _Cfg, factor: float) -> np.ndarray:
    """Audible power per frame, bands 2..Nb (ppd [T, Nb] -> [T])."""
    h = ppd[:, 1:]
    thr = factor * cfg.abs_thresh[1:]
    return np.sum(np.where(h > thr, h, 0.0), axis=1)


def _loudness(ppd: np.ndarray, cfg: _Cfg) -> np.ndarray:
    """Zwicker intensity->loudness warping (ppd [T, Nb] -> [T, Nb])."""
    h = np.where(cfg.centre_bark < 4.0, 6.0 / (cfg.centre_bark + 2.0), 1.0)
    h = np.minimum(h, 2.0) ** 0.15
    zp = 0.23 * h
    thr = cfg.abs_thresh
    loud = ((thr / 0.5) ** zp) * ((0.5 + 0.5 * ppd / thr) ** zp - 1.0)
    return np.where(ppd > thr, loud, 0.0) * cfg.Sl


def _pseudo_lp(dens: np.ndarray, p: float, cfg: _Cfg) -> np.ndarray:
    """Width-weighted Lp over bands 2..Nb (dens [T, Nb] -> [T])."""
    w = cfg.width_bark[1:]
    tot_w = np.sum(w)
    r = np.sum((np.abs(dens[:, 1:]) * w) ** p, axis=1) / tot_w
    return (r ** (1.0 / p)) * tot_w


def _asymmetry(dens: np.ndarray, ppd_ref: np.ndarray, ppd_deg: np.ndarray
               ) -> np.ndarray:
    ratio = (ppd_deg + 50.0) / (ppd_ref + 50.0)
    h = ratio ** 1.2
    h = np.where(h > 12.0, 12.0, h)
    h = np.where(h < 3.0, 0.0, h)
    return dens * h


def _deadzone_clip(dist: np.ndarray, loud_ref: np.ndarray,
                   loud_deg: np.ndarray) -> np.ndarray:
    m = 0.25 * np.minimum(loud_ref, loud_deg)
    return np.where(dist > m, dist - m, np.where(dist < -m, dist + m, 0.0))


def _lpq_weight(start: int, stop: int, p_syl: float, p_t: float,
                frame_dist: np.ndarray, time_weight: np.ndarray) -> float:
    """L_{p_syl} over 20-frame syllables (hop 10), L_{p_t} over time."""
    NSYL = 20
    num, den = 0.0, 0.0
    for s0 in range(start, stop + 1, NSYL // 2):
        frames = np.arange(s0, s0 + NSYL)
        valid = frames <= stop
        h = frame_dist[frames[valid]]
        r = (np.sum(h ** p_syl) / NSYL) ** (1.0 / p_syl)
        tw = time_weight[s0 - start]
        num += (tw * r) ** p_t
        den += tw ** p_t
    return (num / den) ** (1.0 / p_t)


def _frame_disturbances(ppd_ref, ppd_deg, cfg, blend_first: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scale-tracked disturbance computation (frames already warped).

    blend_first: the bad-interval recompute restarts the scale chain at
    oldScale=1 but still blends the first frame when its global frame
    number is > 0 (ref: pesq.m:1352-1360).

    Returns (frame_disturbance, frame_disturbance_asym, total_power_ref)."""
    Tn = ppd_ref.shape[0]
    tap_ref = _total_audible(ppd_ref, cfg, 1.0)
    tap_deg = _total_audible(ppd_deg, cfg, 1.0)
    # sequential first-order clipped gain tracking (P.862 local scaling)
    scales = np.empty(Tn)
    old = 1.0
    for t in range(Tn):
        s = (tap_ref[t] + 5e3) / (tap_deg[t] + 5e3)
        if t > 0 or blend_first:
            s = 0.2 * old + 0.8 * s
        old = s
        scales[t] = min(max(s, 3e-4), 5.0)
    ppd_deg = ppd_deg * scales[:, None]

    loud_ref = _loudness(ppd_ref, cfg)
    loud_deg = _loudness(ppd_deg, cfg)
    dist = _deadzone_clip(loud_deg - loud_ref, loud_ref, loud_deg)
    fd = _pseudo_lp(dist, 2.0, cfg)
    dist_a = _asymmetry(dist, ppd_ref, ppd_deg)
    fda = _pseudo_lp(dist_a, 1.0, cfg)
    return fd, fda, tap_ref


def _psychoacoustic_model(ref: np.ndarray, deg: np.ndarray, ref_ns: int,
                          deg_ns: int, st, cfg: _Cfg) -> float:
    """P.862 psychoacoustic model reading the degraded signal through the
    per-utterance delay map `st` (ref: pesq.m:785-1478). `ref`/`deg` are
    the IRS/WB-filtered signals zero-extended to max_n + pad samples."""
    max_n = max(ref_ns, deg_ns)
    Nf, sb, pad = cfg.Nf, cfg.sb, cfg.pad
    Nf2 = Nf // 2
    D = cfg.downsample

    # skip leading/trailing silence (5-sample |sum| < 500)
    abs_ref = np.abs(ref)
    c5 = np.convolve(abs_ref[sb:], np.ones(5), mode="valid")
    active = np.nonzero(c5 >= 500)[0]
    skip_start = int(active[0]) if len(active) else 0
    tail_region = np.abs(ref[:max_n - sb + pad])
    c5e = np.convolve(tail_region, np.ones(5), mode="valid")
    nz = np.nonzero(c5e >= 500)[0]
    skip_end = int(len(c5e) - 1 - nz[-1]) if len(nz) else 0

    start_frame = skip_start // Nf2
    stop_frame = (max_n - 2 * sb + pad - skip_end) // Nf2 - 1
    Tn = stop_frame + 1

    win = 0.5 * (1.0 - np.cos(2 * np.pi * np.arange(Nf) / Nf))

    # reference frames, all at once
    starts = sb + np.arange(Tn) * Nf2
    idx = starts[:, None] + np.arange(Nf)[None, :]
    hz_ref = np.abs(np.fft.fft(ref[idx] * win, axis=1)[:, :Nf2]) ** 2
    hz_ref[:, 0] = 0.0

    # degraded frames through the per-utterance delay map
    # (ref: pesq.m:908-930): frame -> last utterance whose start sample
    # precedes it -> that utterance's delay
    nutt = max(1, st.nutt)
    utt_start_smp = (st.utt_start[1:nutt + 1] - 1) * D + 1  # 1-based
    delays = st.utt_delay[1:nutt + 1]
    ssr1 = 1 + sb + np.arange(Tn) * Nf2                     # 1-based
    u = np.searchsorted(utt_start_smp, ssr1, side="right") - 1
    frame_delay = delays[np.clip(u, 0, nutt - 1)]
    ssd1 = ssr1 + frame_delay
    valid = (ssd1 > 0) & (ssd1 + Nf - 1 < max_n + pad)
    deg_idx = (np.clip(ssd1, 1, max_n + pad - Nf + 1) - 1)[:, None] \
        + np.arange(Nf)[None, :]
    hz_deg = np.abs(np.fft.fft(deg[deg_idx] * win, axis=1)[:, :Nf2]) ** 2
    hz_deg[:, 0] = 0.0
    hz_deg[~valid] = 0.0

    ppd_ref = _freq_warp(hz_ref, cfg)
    ppd_deg = _freq_warp(hz_deg, cfg)

    silent = _total_audible(ppd_ref, cfg, 1e2) < 1e7

    # time-averaged audible densities -> partial frequency compensation of ref
    total_frames = (max_n - 2 * sb + pad) // Nf2 - 1
    mask = (~silent)[:, None] & (ppd_ref > 100.0 * cfg.abs_thresh)
    avg_ref = np.sum(np.where(mask, ppd_ref, 0.0), axis=0) / total_frames
    mask_d = (~silent)[:, None] & (ppd_deg > 100.0 * cfg.abs_thresh)
    avg_deg = np.sum(np.where(mask_d, ppd_deg, 0.0), axis=0) / total_frames
    comp = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0)
    ppd_ref = ppd_ref * comp[None, :]

    fd, fda, tp_ref = _frame_disturbances(ppd_ref, ppd_deg, cfg)

    THRESH = 30.0
    there_is_a_bad_frame = bool(np.any(fd > THRESH))

    # frames straddling a large negative delay jump are skipped entirely
    # (ref: pesq.m:1112-1140)
    for utt in range(2, st.nutt + 1):
        frame1 = int((st.utt_start[utt] - 1 - SEARCHBUFFER) * D + 1
                     + st.utt_delay[utt]) // Nf2
        j = int((st.utt_end[utt - 1] - 1 - SEARCHBUFFER) * D + 1
                + st.utt_delay[utt - 1]) // Nf2
        delay_jump = int(st.utt_delay[utt] - st.utt_delay[utt - 1])
        frame1 = max(min(frame1, j), 0)
        if delay_jump < -Nf2:
            frame2 = int((st.utt_start[utt] - 1 - SEARCHBUFFER) * D + 1
                         + max(0, abs(delay_jump))) // Nf2 + 1
            for fr in range(frame1, frame2 + 1):
                if fr < stop_frame:
                    fd[fr] = 0.0
                    fda[fr] = 0.0

    # degraded signal re-read through the delay map, per sample
    # (ref: pesq.m:1142-1167)
    nn = max_n + pad
    tweaked = np.zeros(nn)
    i1 = np.arange(sb + 1, nn - sb + 1)
    starts0 = (st.utt_start[1:nutt + 1] - 1) * D
    ut = np.searchsorted(starts0, i1, side="right") - 1
    dly = delays[np.clip(ut, 0, nutt - 1)]
    j1 = np.clip(i1 + dly, sb + 1, nn - sb)
    tweaked[i1 - 1] = deg[j1 - 1]

    # bad-interval local realignment (ref: pesq.m:1169-1407)
    if there_is_a_bad_frame:
        bad = fd > THRESH
        bad[0] = False
        smear = np.zeros_like(bad)
        for t in range(2, Tn - 3):
            smear[t] = min(bad[max(t - 2, 0):t + 1].max(),
                           bad[t:t + 3].max())
        # contiguous bad intervals of >= 5 frames, fully inside the range
        t = 0
        intervals = []
        while t <= stop_frame:
            while t <= stop_frame and not smear[t]:
                t += 1
            if t <= stop_frame:
                f0 = t
                while t <= stop_frame and smear[t]:
                    t += 1
                if t <= stop_frame and t - f0 >= 5:
                    intervals.append((f0, t))

        sr = 4 * Nf  # SEARCH_RANGE_IN_TRANSFORM_LENGTH * Nf
        interval_delays = []
        for f0, f1 in intervals:
            ss1 = f0 * Nf2 + sb + 1          # 1-based sample bounds
            es1 = f1 * Nf2 + Nf + sb
            nsamp = es1 - ss1 + 1
            ref_seg = np.zeros(2 * sr + nsamp)
            ref_seg[sr:sr + nsamp] = ref[ss1:ss1 + nsamp]
            j_idx = ss1 - sr + np.arange(2 * sr + nsamp)
            j_idx = np.clip(j_idx, sb + 1, max_n - sb + pad)
            deg_seg = tweaked[j_idx - 1]
            delay, best_corr = A.compute_delay(1, 2 * sr + nsamp, sr,
                                               ref_seg, deg_seg)
            if best_corr < 0.5:
                delay = 0
            interval_delays.append(delay)

        if intervals:
            doubly = tweaked.copy()
            for (f0, f1), dl in zip(intervals, interval_delays):
                ss1 = f0 * Nf2 + sb + 1
                es1 = f1 * Nf2 + Nf + sb
                i_idx = np.arange(ss1, es1 + 1)
                j_idx = np.clip(i_idx + dl, 1, max_n)
                doubly[i_idx - 1] = tweaked[j_idx - 1]

            for f0, f1 in intervals:
                frames_i = np.arange(f0, f1)
                starts_i = sb + frames_i * Nf2
                idx_i = starts_i[:, None] + np.arange(Nf)[None, :]
                hz_d = np.abs(np.fft.fft(doubly[idx_i] * win,
                                         axis=1)[:, :Nf2]) ** 2
                hz_d[:, 0] = 0.0
                ppd_d = _freq_warp(hz_d, cfg)
                ppd_deg[frames_i] = ppd_d
                fd_i, fda_i, _ = _frame_disturbances(
                    ppd_ref[f0:f1], ppd_d, cfg, blend_first=f0 > 0)
                fd[f0:f1] = np.minimum(fd[f0:f1], fd_i)
                fda[f0:f1] = np.minimum(fda[f0:f1], fda_i)

    # time weighting for very long signals
    time_weight = np.ones(Tn)
    if Tn > 1000:
        nfr = (max_n - 2 * sb) // Nf2 - 1
        twf = min((nfr - 1000) / 5500.0, 0.5)
        time_weight = (1.0 - twf) + twf * np.arange(Tn) / nfr

    h = ((tp_ref + 1e5) / 1e7) ** 0.04
    fd = np.minimum(fd / h, 45.0)
    fda = np.minimum(fda / h, 45.0)

    d_ind = _lpq_weight(start_frame, stop_frame, 6.0, 2.0, fd,
                        time_weight[start_frame:])
    a_ind = _lpq_weight(start_frame, stop_frame, 6.0, 2.0, fda,
                        time_weight[start_frame:])
    return 4.5 - 0.1 * d_ind - 0.0309 * a_ind


def pesq(ref: np.ndarray, deg: np.ndarray, fs: int, mode: str = "nb") -> float:
    """PESQ score of `deg` against clean `ref`.

    Args:
      ref, deg: waveforms (float in [-1, 1] or int16); need not be
          sample-aligned -- the P.862 utterance alignment recovers
          constant and piecewise-varying delays.
      fs: input sampling rate (resampled to 8 kHz for nb, 16 kHz for wb
          when different).
      mode: "nb" (raw P.862 MOS), "nb-lqo" (P.862.1), "wb" (P.862.2 MOS-LQO).
    """
    if mode not in ("nb", "nb-lqo", "wb"):
        raise ValueError(f"invalid PESQ mode: {mode!r}")
    target_fs = 16000 if mode == "wb" else (fs if fs in (8000, 16000) else 8000)

    def prep(x):
        x = np.asarray(x, np.float64)
        if x.dtype.kind != "f" or np.max(np.abs(x)) > 4.0:
            x = x / 32768.0
        if fs != target_fs:
            g = math.gcd(fs, target_fs)
            x = resample_poly(x, target_fs // g, fs // g)
        return x * 32768.0

    r, d = prep(ref), prep(deg)
    cfg = _Cfg(target_fs)
    # SEARCHBUFFER front padding, DATAPADDING + SEARCHBUFFER back padding
    # (ref: pesq.m:71-81); ref/deg keep their own lengths
    ref_ns = len(r) + 2 * cfg.sb
    deg_ns = len(d) + 2 * cfg.sb
    zpre = np.zeros(cfg.sb)
    zpost = np.zeros(cfg.pad + cfg.sb)
    r = np.concatenate([zpre, r, zpost])
    d = np.concatenate([zpre, d, zpost])
    max_ns = max(ref_ns, deg_ns)

    r = _fix_power_level(r, ref_ns, max_ns, cfg)
    d = _fix_power_level(d, deg_ns, max_ns, cfg)

    if mode == "wb":
        r = sosfilt(cfg.wb_sos, r)
        d = sosfilt(cfg.wb_sos, d)
    else:
        r = _apply_filter_fft(r, ref_ns - 2 * cfg.sb + cfg.pad, _IRS_FILTER_DB, cfg)
        d = _apply_filter_fft(d, deg_ns - 2 * cfg.sb + cfg.pad, _IRS_FILTER_DB, cfg)

    # P.862 time alignment on the DC-blocked + InIIR-filtered signals
    # (ref: pesq.m:140-186): whole-signal crude alignment, then utterance
    # location / fine alignment / recursive splitting
    align_r = A.input_filter_iir(A.dc_block(r, ref_ns, cfg), cfg)
    align_d = A.input_filter_iir(A.dc_block(d, deg_ns, cfg), cfg)
    vad_r, logvad_r = A.apply_vad(align_r, ref_ns, cfg)
    vad_d, logvad_d = A.apply_vad(align_d, deg_ns, cfg)
    st = A.AlignState()
    A.crude_align(st, logvad_r, ref_ns, logvad_d, deg_ns, A.WHOLE_SIGNAL, cfg)
    A.utterance_locate(st, align_r, ref_ns, vad_r, logvad_r,
                       align_d, deg_ns, vad_d, logvad_d, cfg)

    # zero-extend both model signals to max_ns + pad (ref: pesq.m:188-197)
    newlen = max_ns + cfg.pad
    if len(r) < newlen:
        r = np.concatenate([r, np.zeros(newlen - len(r))])
    if len(d) < newlen:
        d = np.concatenate([d, np.zeros(newlen - len(d))])

    raw = _psychoacoustic_model(r[:newlen], d[:newlen], ref_ns, deg_ns,
                                st, cfg)

    if mode == "nb":
        return float(raw)
    if mode == "nb-lqo":
        return float(0.999 + (4.999 - 0.999) / (1.0 + math.exp(-1.4945 * raw + 4.6607)))
    return float(0.999 + (4.999 - 0.999) / (1.0 + math.exp(-1.3669 * raw + 3.8224)))
