"""ITU-T P.862 time-alignment pipeline: VAD, crude/fine alignment,
utterance identification and utterance SPLITTING (piecewise delays).

Faithful NumPy port of the alignment stages of the reference's MATLAB
PESQ (ref: demand_voice_bank_objective_scoring/pesq.m -- apply_VAD
:308-466, crude_align :468-548, DC_block :550-568, FFTNXCorr :570-607,
id_searchwindows :632-688, id_utterances :690-772, compute_delay
:1527-1580, split_align :2109-2477, time_align :2479-2550,
utterance_locate :2552-2583, utterance_split :2585-2707).

Port conventions: signal arrays are 0-based numpy float64; the utterance
bookkeeping (window indices, sample indices) keeps the MATLAB 1-based
values, converted with an explicit -1 exactly where a signal array is
indexed.  Delays are in samples throughout.

Validation status (round-3 advisor asked for a golden cross-check
against a known-good P.862 implementation): environment-blocked. No
PESQ package is installed (and installs are disallowed), the
reference's pesq.m needs MATLAB plus the ITU MEX binary, the ITU
conformance vectors are not on disk, and the reference ships no
per-file PESQ score for its one (ref, deg) wav pair. Until a golden
source exists, the port is pinned by behavioral self-tests
(tests/test_pesq.py: planted constant delays recovered within 16
samples, a +40 ms mid-signal jump tracked by utterance splitting,
alignment invariance of the final MOS) and by the composite scorer
reproducing the published per-condition range on the shipped enhanced
wav (README "Parity & performance").
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import sosfilt

MINSPEECHLGTH = 4
JOINSPEECHLGTH = 50
MINUTTLENGTH = 50
MAXNUTTERANCES = 50
WHOLE_SIGNAL = -1


class AlignState:
    """Mutable alignment state (the MATLAB globals), slots 1-based;
    slot MAXNUTTERANCES doubles as split_align's scratch slot."""

    def __init__(self):
        m = MAXNUTTERANCES + 12  # headroom for insertions near the cap
        self.nutt = 0
        self.crude_delay = 0
        self.utt_search_start = np.zeros(m, np.int64)
        self.utt_search_end = np.zeros(m, np.int64)
        self.utt_delay_est = np.zeros(m, np.int64)
        self.utt_delay = np.zeros(m, np.int64)
        self.utt_delay_conf = np.zeros(m, np.float64)
        self.utt_start = np.zeros(m, np.int64)
        self.utt_end = np.zeros(m, np.int64)


def _seg(x: np.ndarray, start1: int, n: int) -> np.ndarray:
    """x[start1 : start1+n-1] in 1-based MATLAB terms, zero-padded if the
    slice runs past either end (MATLAB would error; callers keep in
    range, this is a robustness guard only)."""
    lo = max(start1 - 1, 0)
    seg = x[lo:lo + n]
    if len(seg) < n:
        seg = np.concatenate([seg, np.zeros(n - len(seg))])
    return seg


def dc_block(data: np.ndarray, nsamples: int, cfg) -> np.ndarray:
    """P.862 DC removal with Downsample-long end tapers
    (ref: pesq.m:550-568)."""
    d = cfg.downsample
    ofs = cfg.sb
    mod = data.copy()
    facc = np.sum(data[ofs:nsamples - ofs]) / nsamples
    mod[ofs:nsamples - ofs] -= facc
    ramp = (0.5 + np.arange(d)) / d
    mod[ofs:ofs + d] *= ramp
    mod[nsamples - ofs - d:nsamples - ofs] *= ramp[::-1]
    return mod


def input_filter_iir(data: np.ndarray, cfg) -> np.ndarray:
    """The standard's InIIR_Hsos cascade for the VAD/alignment path
    (ref: pesq.m:265-283)."""
    return sosfilt(cfg.in_sos, data)


def apply_vad(data: np.ndarray, nsamples: int, cfg):
    """Energy VAD over 4 ms windows with iterative noise-threshold
    estimation, min-length/joining rules and edge ramps
    (ref: pesq.m:308-466). Returns (VAD, logVAD), length Nwindows."""
    d = cfg.downsample
    nwin = nsamples // d
    vad = np.sum(data[:nwin * d].reshape(nwin, d) ** 2, axis=1) / d

    level_thresh = np.sum(vad) / nwin
    level_min = vad.max()
    level_min = level_min * 1.0e-4 if level_min > 0 else 1.0
    vad[vad < level_min] = level_min

    for _ in range(12):
        less = vad[vad <= level_thresh]
        if len(less) > 0:
            level_noise = less.mean()
            std_noise = math.sqrt(np.mean((less - level_noise) ** 2))
        else:
            level_noise = 0.0
            std_noise = 0.0
        level_thresh = 1.001 * (level_noise + 2.0 * std_noise)

    greater = vad[vad > level_thresh]
    n_g = len(greater)
    level_sig = greater.sum()
    level_noise = vad[vad <= level_thresh].sum()
    if n_g > 0:
        level_sig /= n_g
    else:
        level_thresh = -1.0
    if n_g < nwin:
        level_noise /= (nwin - n_g)
    else:
        level_noise = 1.0

    vad[vad <= level_thresh] *= -1.0
    vad[0] = -level_min
    vad[nwin - 1] = -level_min

    # drop speech bursts shorter than MINSPEECHLGTH windows
    start = finish = 0
    for c in range(1, nwin):
        if vad[c] > 0.0 and vad[c - 1] <= 0.0:
            start = c
        if vad[c] <= 0.0 and vad[c - 1] > 0.0:
            finish = c
            if finish - start <= MINSPEECHLGTH:
                vad[start:finish] = -vad[start:finish]

    # drop low-power bursts when the SNR is very high
    if level_sig >= level_noise * 1000.0:
        for c in range(1, nwin):
            if vad[c] > 0.0 and vad[c - 1] <= 0.0:
                start = c
            if vad[c] <= 0.0 and vad[c - 1] > 0.0:
                finish = c
                g = np.sum(vad[start:finish])
                if g < 3.0 * level_thresh * (finish - start):
                    vad[start:finish] = -vad[start:finish]

    # join bursts separated by < JOINSPEECHLGTH windows
    start = finish = 0
    for c in range(1, nwin):
        if vad[c] > 0.0 and vad[c - 1] <= 0.0:
            start = c
            if finish > 0 and (start - finish) <= JOINSPEECHLGTH:
                vad[finish:start] = level_min
        if vad[c] <= 0.0 and vad[c - 1] > 0.0:
            finish = c

    # no speech found at all -> treat everything as speech
    start = 0
    for c in range(1, nwin):
        if vad[c] > 0.0 and vad[c - 1] <= 0.0:
            start = c
    if start == 0:
        vad = np.abs(vad)
        vad[0] = -level_min
        vad[nwin - 1] = -level_min

    # onset/offset ramps
    c = 3
    while c < nwin - 2:
        if vad[c] > 0.0 and vad[c - 2] <= 0.0:
            vad[c - 2] = vad[c] * 0.1
            vad[c - 1] = vad[c] * 0.3
            c += 1
        if vad[c] <= 0.0 and vad[c - 1] > 0.0:
            vad[c] = vad[c - 1] * 0.3
            vad[c + 1] = vad[c - 1] * 0.1
            c += 3
        c += 1

    vad[vad < 0.0] = 0.0
    if level_thresh <= 0.0:
        level_thresh = level_min
    logvad = np.where(vad <= level_thresh, 0.0,
                      np.log(np.maximum(vad, 1e-300) / level_thresh))
    return vad, logvad


def fftnxcorr(ref: np.ndarray, startr: int, nr: int,
              deg: np.ndarray, startd: int, nd: int) -> np.ndarray:
    """Full cross-correlation of two 1-based segments via FFT
    (ref: pesq.m:570-607). Returns length nr+nd-1."""
    startr = max(1, startr)
    startd = max(1, startd)
    x1 = _seg(ref, startr, nr)[::-1]
    x2 = _seg(deg, startd, nd)
    nx = 1 << int(math.ceil(math.log2(max(nr, nd))))
    f1 = np.fft.fft(x1, 2 * nx)
    f2 = np.fft.fft(x2, 2 * nx)
    y = np.real(np.fft.ifft(f1 * f2))
    return y[:nr + nd - 1]


def crude_align(st: AlignState, ref_logvad, ref_ns, deg_logvad, deg_ns,
                utt_id: int, cfg) -> None:
    """Crude delay from logVAD envelope correlation, whole-signal /
    per-utterance / split-scratch variants (ref: pesq.m:468-548)."""
    d = cfg.downsample
    if utt_id == WHOLE_SIGNAL:
        nr = ref_ns // d
        nd = deg_ns // d
        startr = startd = 1
    elif utt_id == MAXNUTTERANCES:
        startr = int(st.utt_search_start[MAXNUTTERANCES])
        startd = startr + int(st.utt_delay_est[MAXNUTTERANCES]) // d
        if startd < 0:
            startr = 1 - int(st.utt_delay_est[MAXNUTTERANCES]) // d
            startd = 1
        nr = int(st.utt_search_end[MAXNUTTERANCES]) - startr
        nd = nr
        if startd + nd > deg_ns // d:
            nd = deg_ns // d - startd
    else:
        startr = int(st.utt_search_start[utt_id])
        startd = startr + st.crude_delay // d
        if startd < 0:
            startr = 1 - st.crude_delay // d
            startd = 1
        nr = int(st.utt_search_end[utt_id]) - startr
        nd = nr
        if startd + nd > deg_ns // d + 1:
            nd = deg_ns // d - startd + 1

    startr = max(1, startr)
    startd = max(1, startd)

    i_max_y = nr
    if nr > 1 and nd > 1:
        y = fftnxcorr(ref_logvad, startr, nr, deg_logvad, startd, nd)
        k = int(np.argmax(y))
        if y[k] > 0:
            i_max_y = k + 1

    if utt_id == WHOLE_SIGNAL:
        st.crude_delay = (i_max_y - nr) * d
    elif utt_id == MAXNUTTERANCES:
        st.utt_delay[MAXNUTTERANCES] = ((i_max_y - nr) * d
                                        + st.utt_delay_est[MAXNUTTERANCES])
    else:
        st.utt_delay_est[utt_id] = (i_max_y - nr) * d + st.crude_delay


def _hann_periodic(n: int) -> np.ndarray:
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def time_align(st: AlignState, ref, ref_ns, deg, deg_ns, utt_id, cfg) -> None:
    """Fine per-utterance delay: histogram of windowed cross-correlation
    peaks, triangular smoothing, peak -> (delay, confidence)
    (ref: pesq.m:2479-2550)."""
    nfft = cfg.align_nfft
    d = cfg.downsample
    win = _hann_periodic(nfft)
    estdelay = int(st.utt_delay_est[utt_id])
    h = np.zeros(nfft)

    startr = (int(st.utt_search_start[utt_id]) - 1) * d + 1
    startd = startr + estdelay
    if startd < 0:
        startr = 1 - estdelay
        startd = 1

    while (startd + nfft <= deg_ns and
           startr + nfft <= (int(st.utt_search_end[utt_id]) - 1) * d):
        x1 = _seg(ref, startr, nfft) * win
        x2 = _seg(deg, startd, nfft) * win
        xc = np.abs(np.fft.ifft(np.conj(np.fft.fft(x1)) * np.fft.fft(x2)))
        v_max = xc.max() * 0.99
        h[xc > v_max] += v_max ** 0.125
        startr += nfft // 4
        startd += nfft // 4

    hsum = float(np.sum(h))
    kernel = nfft // 64
    tri = np.zeros(nfft)
    tri[0] = 1.0
    c = np.arange(1, kernel)
    tri[c] = 1.0 - c / kernel
    tri[nfft - c] = 1.0 - c / kernel
    hs = np.abs(np.fft.ifft(np.fft.fft(h) * np.fft.fft(tri)))
    hs = hs / hsum if hsum > 0 else np.zeros(nfft)

    i_max = int(np.argmax(hs))
    v_max = float(hs[i_max])
    if i_max >= nfft // 2:
        i_max -= nfft
    st.utt_delay[utt_id] = estdelay + i_max
    st.utt_delay_conf[utt_id] = v_max


def id_searchwindows(st: AlignState, ref_vad, ref_ns, deg_vad, deg_ns,
                     cfg) -> None:
    """Utterance search windows from the reference VAD
    (ref: pesq.m:632-688)."""
    d = cfg.downsample
    sb_w = cfg.sb // d  # SEARCHBUFFER in windows
    utt_num = 1
    speech_flag = 0
    vad_len = ref_ns // d
    del_deg_start = MINUTTLENGTH - st.crude_delay // d
    del_deg_end = (deg_ns - st.crude_delay) // d - MINUTTLENGTH

    this_start = 0
    for count in range(1, vad_len + 1):
        v = ref_vad[count - 1]
        if v > 0.0 and speech_flag == 0:
            speech_flag = 1
            this_start = count
            st.utt_search_start[utt_num] = max(count - sb_w, 1)
        if (v == 0.0 or count == vad_len - 1) and speech_flag == 1:
            speech_flag = 0
            st.utt_search_end[utt_num] = min(count + sb_w, vad_len)
            if (count - this_start >= MINUTTLENGTH and
                    this_start < del_deg_end and count > del_deg_start):
                utt_num += 1
                if utt_num >= MAXNUTTERANCES:
                    break
    st.nutt = utt_num - 1


def id_utterances(st: AlignState, ref_ns, ref_vad, deg_ns, cfg) -> None:
    """Final utterance boundaries: speech bursts, midpoint splits between
    neighbours, delay-aware edge clamps (ref: pesq.m:690-772)."""
    d = cfg.downsample
    sb_w = cfg.sb // d
    utt_num = 1
    speech_flag = 0
    vad_len = ref_ns // d
    del_deg_start = MINUTTLENGTH - st.crude_delay // d
    del_deg_end = (deg_ns - st.crude_delay) // d - MINUTTLENGTH

    this_start = 0
    for count in range(1, vad_len + 1):
        v = ref_vad[count - 1]
        if v > 0.0 and speech_flag == 0:
            speech_flag = 1
            this_start = count
            if utt_num < len(st.utt_start):
                st.utt_start[utt_num] = count
        if (v == 0.0 or count == vad_len) and speech_flag == 1:
            speech_flag = 0
            if utt_num < len(st.utt_end):
                st.utt_end[utt_num] = count
            if (count - this_start >= MINUTTLENGTH and
                    this_start < del_deg_end and count > del_deg_start):
                utt_num += 1

    st.utt_start[1] = sb_w + 1
    st.nutt = max(1, st.nutt)
    st.utt_end[st.nutt] = vad_len - sb_w + 1

    for utt in range(2, st.nutt + 1):
        mid = (int(st.utt_start[utt]) - 1 + int(st.utt_end[utt - 1]) - 1) // 2
        st.utt_start[utt] = mid + 1
        st.utt_end[utt - 1] = mid + 1

    this_start = (int(st.utt_start[1]) - 1) * d + int(st.utt_delay[1])
    if this_start < sb_w * d:
        count = sb_w + (d - 1 - int(st.utt_delay[1])) // d
        st.utt_start[1] = count + 1

    last_end = (int(st.utt_end[st.nutt]) - 1) * d + 1 + int(st.utt_delay[st.nutt])
    if last_end > deg_ns - sb_w * d + 1:
        count = (deg_ns - int(st.utt_delay[st.nutt])) // d - sb_w
        st.utt_end[st.nutt] = count + 1

    for utt in range(2, st.nutt + 1):
        this_start = (int(st.utt_start[utt]) - 1) * d + int(st.utt_delay[utt])
        last_end = (int(st.utt_end[utt - 1]) - 1) * d + int(st.utt_delay[utt - 1])
        if this_start < last_end:
            mid = (this_start + last_end) // 2
            st.utt_start[utt] = (d - 1 + mid - int(st.utt_delay[utt])) // d + 1
            st.utt_end[utt - 1] = (mid - int(st.utt_delay[utt - 1])) // d + 1


def _acc_histogram(ref_win, deg_win, h: np.ndarray, kernel: int) -> float:
    """One windowed cross-correlation's triangularly-smeared peak-position
    histogram contribution (the split_align inner accumulation,
    ref: pesq.m:2213-2235). Returns the Hsum increment."""
    nfft = len(h)
    xc = np.abs(np.fft.ifft(np.conj(np.fft.fft(ref_win)) * np.fft.fft(deg_win)))
    v_max = xc.max() * 0.99
    n_max = (v_max ** 0.125) / kernel
    idxs = np.nonzero(xc > v_max)[0]
    if len(idxs) == 0:
        return 0.0
    offs = np.arange(1 - kernel, kernel)
    weights = n_max * (kernel - np.abs(offs))
    np.add.at(h, (idxs[:, None] + offs[None, :]) % nfft,
              np.broadcast_to(weights, (len(idxs), len(offs))))
    return float(len(idxs)) * n_max * kernel


def _hist_peak(h: np.ndarray, hsum: float, nfft: int):
    i_max = int(np.argmax(h))
    v_max = float(h[i_max])
    if i_max >= nfft // 2:
        i_max -= nfft
    conf = v_max / hsum if hsum > 0.0 else 0.0
    return i_max, conf


class SplitResult:
    def __init__(self):
        self.ed1 = self.d1 = self.ed2 = self.d2 = 0
        self.dc1 = self.dc2 = 0.0
        self.bp = 0


def split_align(st: AlignState, ref, ref_ns, ref_vad, ref_logvad,
                deg, deg_ns, deg_vad, deg_logvad,
                utt_start_l, utt_speech_start, utt_speech_end, utt_end_l,
                utt_delay_est_l, utt_delay_conf_l, cfg) -> SplitResult:
    """Search for the best 2-piece split of one utterance: candidate
    breakpoints on a Delta grid; for each, crude-align then
    histogram-fine-align the left part (forward scan) and the right part
    (backward scan); keep the best confident pair of differing delays
    (ref: pesq.m:2109-2477)."""
    nfft = cfg.align_nfft
    d = cfg.downsample
    win = _hann_periodic(nfft)
    best = SplitResult()

    utt_len = utt_speech_end - utt_speech_start
    kernel = nfft // 64
    delta = nfft // (4 * d)
    step = math.floor((0.801 * utt_len + 40 * delta - 1) / (40 * delta)) * delta

    pad = max(utt_len // 10, 75)

    utt_bps = np.zeros(44, np.int64)
    utt_ed1 = np.zeros(44, np.int64)
    utt_ed2 = np.zeros(44, np.int64)
    utt_d1 = np.zeros(44, np.int64)
    utt_d2 = np.zeros(44, np.int64)
    utt_dc1 = np.zeros(44, np.float64)
    utt_dc2 = np.zeros(44, np.float64)

    utt_bps[1] = utt_speech_start + pad
    n_bps = 1
    while True:
        n_bps += 1
        utt_bps[n_bps] = utt_bps[n_bps - 1] + step
        if not (utt_bps[n_bps] <= utt_speech_end - pad and n_bps <= 40):
            break
    if n_bps <= 1:
        return best

    # crude alignment of both halves at every breakpoint (scratch slot)
    for bp in range(1, n_bps):
        st.utt_delay_est[MAXNUTTERANCES] = utt_delay_est_l
        st.utt_search_start[MAXNUTTERANCES] = utt_start_l
        st.utt_search_end[MAXNUTTERANCES] = utt_bps[bp]
        crude_align(st, ref_logvad, ref_ns, deg_logvad, deg_ns,
                    MAXNUTTERANCES, cfg)
        utt_ed1[bp] = st.utt_delay[MAXNUTTERANCES]

        st.utt_delay_est[MAXNUTTERANCES] = utt_delay_est_l
        st.utt_search_start[MAXNUTTERANCES] = utt_bps[bp]
        st.utt_search_end[MAXNUTTERANCES] = utt_end_l
        crude_align(st, ref_logvad, ref_ns, deg_logvad, deg_ns,
                    MAXNUTTERANCES, cfg)
        utt_ed2[bp] = st.utt_delay[MAXNUTTERANCES]

    # fine alignment of the LEFT half, scanning forward; breakpoints with
    # the same crude delay share the accumulation incrementally
    utt_dc1[1:n_bps] = -2.0
    while True:
        bp = 1
        while bp <= n_bps - 1 and utt_dc1[bp] > -2.0:
            bp += 1
        if bp >= n_bps:
            break

        estdelay = int(utt_ed1[bp])
        h = np.zeros(nfft)
        hsum = 0.0

        startr = (utt_start_l - 1) * d + 1
        startd = startr + estdelay
        if startd < 0:
            startr = -estdelay + 1
            startd = 1
        startr = max(1, startr)
        startd = max(1, startd)

        while (startd + nfft <= 1 + deg_ns and
               startr + nfft <= 1 + (int(utt_bps[bp]) - 1) * d):
            hsum += _acc_histogram(_seg(ref, startr, nfft) * win,
                                   _seg(deg, startd, nfft) * win, h, kernel)
            startr += nfft // 4
            startd += nfft // 4

        i_max, conf = _hist_peak(h, hsum, nfft)
        utt_d1[bp] = estdelay + i_max
        utt_dc1[bp] = conf

        while bp < n_bps - 1:
            bp += 1
            if utt_ed1[bp] == estdelay and utt_dc1[bp] <= -2.0:
                while (startd + nfft <= 1 + deg_ns and
                       startr + nfft <= 1 + (int(utt_bps[bp]) - 1) * d):
                    hsum += _acc_histogram(
                        _seg(ref, startr, nfft) * win,
                        _seg(deg, startd, nfft) * win, h, kernel)
                    startr += nfft // 4
                    startd += nfft // 4
                i_max, conf = _hist_peak(h, hsum, nfft)
                utt_d1[bp] = estdelay + i_max
                utt_dc1[bp] = conf

    # fine alignment of the RIGHT half, scanning backward from the end
    for bp in range(1, n_bps):
        utt_dc2[bp] = -2.0 if utt_dc1[bp] > utt_delay_conf_l else 0.0

    while True:
        bp = n_bps - 1
        while bp >= 1 and utt_dc2[bp] > -2.0:
            bp -= 1
        if bp < 1:
            break

        estdelay = int(utt_ed2[bp])
        h = np.zeros(nfft)
        hsum = 0.0

        startr = (utt_end_l - 1) * d + 1 - nfft
        startd = startr + estdelay
        if startd + nfft > deg_ns + 1:
            startd = deg_ns - nfft + 1
            startr = startd - estdelay

        while startd >= 1 and startr >= (int(utt_bps[bp]) - 1) * d + 1:
            hsum += _acc_histogram(_seg(ref, startr, nfft) * win,
                                   _seg(deg, startd, nfft) * win, h, kernel)
            startr -= nfft // 4
            startd -= nfft // 4

        i_max, conf = _hist_peak(h, hsum, nfft)
        utt_d2[bp] = estdelay + i_max
        utt_dc2[bp] = conf

        while bp > 1:
            bp -= 1
            if utt_ed2[bp] == estdelay and utt_dc2[bp] <= -2.0:
                while (startd >= 1 and
                       startr >= (int(utt_bps[bp]) - 1) * d + 1):
                    hsum += _acc_histogram(
                        _seg(ref, startr, nfft) * win,
                        _seg(deg, startd, nfft) * win, h, kernel)
                    startr -= nfft // 4
                    startd -= nfft // 4
                i_max, conf = _hist_peak(h, hsum, nfft)
                utt_d2[bp] = estdelay + i_max
                utt_dc2[bp] = conf

    for bp in range(1, n_bps):
        if (abs(utt_d2[bp] - utt_d1[bp]) >= d and
                utt_dc1[bp] + utt_dc2[bp] > best.dc1 + best.dc2 and
                utt_dc1[bp] > utt_delay_conf_l and
                utt_dc2[bp] > utt_delay_conf_l):
            best.ed1 = int(utt_ed1[bp])
            best.d1 = int(utt_d1[bp])
            best.dc1 = float(utt_dc1[bp])
            best.ed2 = int(utt_ed2[bp])
            best.d2 = int(utt_d2[bp])
            best.dc2 = float(utt_dc2[bp])
            best.bp = int(utt_bps[bp])
    return best


def utterance_split(st: AlignState, ref, ref_ns, ref_vad, ref_logvad,
                    deg, deg_ns, deg_vad, deg_logvad, cfg) -> None:
    """Recursively split utterances whose two halves align with higher
    confidence at different delays (ref: pesq.m:2585-2707)."""
    d = cfg.downsample
    sb_w = cfg.sb // d
    utt_id = 1
    while utt_id <= st.nutt and st.nutt <= MAXNUTTERANCES:
        utt_delay_est_l = int(st.utt_delay_est[utt_id])
        utt_delay_conf_l = float(st.utt_delay_conf[utt_id])
        utt_start_l = int(st.utt_start[utt_id])
        utt_end_l = int(st.utt_end[utt_id])

        speech_start = max(1, utt_start_l)
        while speech_start < utt_end_l and ref_vad[speech_start - 1] <= 0.0:
            speech_start += 1
        speech_end = utt_end_l
        while speech_end > utt_start_l and ref_vad[speech_end - 1] <= 0.0:
            speech_end -= 1
        speech_end += 1
        utt_len = speech_end - speech_start

        if utt_len >= 200:
            res = split_align(st, ref, ref_ns, ref_vad, ref_logvad,
                              deg, deg_ns, deg_vad, deg_logvad,
                              utt_start_l, speech_start, speech_end,
                              utt_end_l, utt_delay_est_l,
                              utt_delay_conf_l, cfg)
            if res.dc1 > utt_delay_conf_l and res.dc2 > utt_delay_conf_l:
                for step in range(st.nutt, utt_id, -1):
                    st.utt_delay_est[step + 1] = st.utt_delay_est[step]
                    st.utt_delay[step + 1] = st.utt_delay[step]
                    st.utt_delay_conf[step + 1] = st.utt_delay_conf[step]
                    st.utt_start[step + 1] = st.utt_start[step]
                    st.utt_end[step + 1] = st.utt_end[step]
                    st.utt_search_start[step + 1] = st.utt_start[step]
                    st.utt_search_end[step + 1] = st.utt_end[step]
                st.nutt += 1

                st.utt_delay_est[utt_id] = res.ed1
                st.utt_delay[utt_id] = res.d1
                st.utt_delay_conf[utt_id] = res.dc1
                st.utt_delay_est[utt_id + 1] = res.ed2
                st.utt_delay[utt_id + 1] = res.d2
                st.utt_delay_conf[utt_id + 1] = res.dc2
                st.utt_search_start[utt_id + 1] = st.utt_search_start[utt_id]
                st.utt_search_end[utt_id + 1] = st.utt_search_end[utt_id]

                if res.d2 < res.d1:
                    st.utt_start[utt_id] = utt_start_l
                    st.utt_end[utt_id] = res.bp
                    st.utt_start[utt_id + 1] = res.bp
                    st.utt_end[utt_id + 1] = utt_end_l
                else:
                    shift = (res.d2 - res.d1) // (2 * d)
                    st.utt_start[utt_id] = utt_start_l
                    st.utt_end[utt_id] = res.bp + shift
                    st.utt_start[utt_id + 1] = res.bp - shift
                    st.utt_end[utt_id + 1] = utt_end_l

                if ((int(st.utt_start[utt_id]) - sb_w - 1) * d + 1
                        + res.d1 < 0):
                    st.utt_start[utt_id] = sb_w + 1 + (d - 1 - res.d1) // d
                if ((int(st.utt_end[utt_id + 1]) - 1) * d + 1 + res.d2
                        > deg_ns - sb_w * d):
                    st.utt_end[utt_id + 1] = ((deg_ns - res.d2) // d
                                              - sb_w + 1)
            else:
                utt_id += 1
        else:
            utt_id += 1


def utterance_locate(st: AlignState, ref, ref_ns, ref_vad, ref_logvad,
                     deg, deg_ns, deg_vad, deg_logvad, cfg) -> None:
    """Full utterance pipeline: search windows, per-utterance crude+fine
    alignment, boundary identification, recursive splitting
    (ref: pesq.m:2552-2583)."""
    id_searchwindows(st, ref_vad, ref_ns, deg_vad, deg_ns, cfg)
    for utt_id in range(1, st.nutt + 1):
        crude_align(st, ref_logvad, ref_ns, deg_logvad, deg_ns, utt_id, cfg)
        time_align(st, ref, ref_ns, deg, deg_ns, utt_id, cfg)
    id_utterances(st, ref_ns, ref_vad, deg_ns, cfg)
    utterance_split(st, ref, ref_ns, ref_vad, ref_logvad,
                    deg, deg_ns, deg_vad, deg_logvad, cfg)


def compute_delay(start1: int, stop1: int, search_range: int,
                  ts1: np.ndarray, ts2: np.ndarray):
    """Envelope cross-correlation delay within +/-search_range samples
    (the bad-interval realignment search, ref: pesq.m:1527-1580).
    start1/stop1 are 1-based inclusive."""
    n = stop1 - start1 + 1
    pw2 = 1 << int(math.ceil(math.log2(2 * n)))
    power1 = np.sum(np.square(ts1[start1:stop1], dtype=np.float64)) / n \
        * n / pw2
    power2 = np.sum(np.square(ts2[start1:stop1], dtype=np.float64)) / n \
        * n / pw2
    normalization = math.sqrt(power1 * power2)
    if power1 <= 1e-6 or power2 <= 1e-6:
        return 0, 0.0

    x1 = np.zeros(pw2)
    x2 = np.zeros(pw2)
    x1[:n] = np.abs(ts1[start1 - 1:stop1])
    x2[:n] = np.abs(ts2[start1 - 1:stop1])
    y = np.real(np.fft.ifft(np.conj(np.fft.fft(x1) / pw2) * np.fft.fft(x2)))

    best_delay = 0
    max_corr = 0.0
    for i in range(-search_range, 0):
        h = abs(y[i + pw2]) / normalization
        if h > max_corr:
            max_corr = h
            best_delay = i
    for i in range(0, search_range):
        h = abs(y[i]) / normalization
        if h > max_corr:
            max_corr = h
            best_delay = i
    return best_delay - 1, max_corr
