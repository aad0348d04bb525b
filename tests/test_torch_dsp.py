"""The port's classical DSP (`deepxi_tpu_torch.dsp`) against the JAX
package's (`deepxi_tpu.dsp`) on the CPU: the MCRA-family trackers and
OM-LSA, the histogram tracker, MixMax (`enhance` in every variant and
`estimate_frame`), VTS (`make_model`, `compensate`, `posteriors`, `em_step`,
`vts_enhance`, `rt_vts_track`), and the alignment and lexicon parsers.

Every recursion is compared in float64 (JAX with `jax_enable_x64`, restored
afterwards). In float32 each package is first held to its own float64
result, which shows that no decision of these inputs lies within float32
rounding of its threshold (a flip would move every later frame far past the
gate), and then the two float32 results to each other. Limits are relative
to each output's largest magnitude:

  * 1e-12 in float64 where the arithmetic is the same;
  * 1e-6 in float64 for the MCRA-family gains and whatever the
    decision-directed SNR feeds (IMCRA's and MCRA-TBRR's presence and noise):
    both packages evaluate exp1 in float32 inside the MMSE-LSA gain, whose
    last bits differ between the two libraries (measured up to 9.3e-8);
  * 1e-5 in float32 (measured up to 1.5e-6, the histogram tracker 2.2e-7,
    MixMax 2.0e-6); 5e-5 for VTS's EM, whose noise variance E[x^2] -
    E[x]^2 cancels (measured 8.1e-6).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu.dsp import histnoise as hist_j
from deepxi_tpu.dsp import labels as labels_j
from deepxi_tpu.dsp import mixmax as mixmax_j
from deepxi_tpu.dsp import phoneme as phoneme_j
from deepxi_tpu.dsp import trackers as trackers_j
from deepxi_tpu.dsp import vts as vts_j
from deepxi_tpu_torch.dsp import histnoise, labels, mixmax, phoneme, trackers, vts

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools"))
from torch_hybrid import write_alignment, write_lexicon  # noqa: E402

TOL64, TOL64_EXP1, TOL32, TOL32_EM = 1e-12, 1e-6, 1e-5, 5e-5
DTYPES = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}


@pytest.fixture(params=list(DTYPES))
def prec(request):
    """The precision of a test: JAX's x64 flag set for float64 and restored
    afterwards."""
    jax.config.update("jax_enable_x64", request.param == "float64")
    try:
        yield request.param
    finally:
        jax.config.update("jax_enable_x64", False)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _run(fn_j, fn_p, args, prec):
    """(JAX outputs, port outputs) as float64 numpy lists at `prec`, with the
    port's also at float64 (and JAX's, under the x64 flag) when `prec` is
    float32: (j, p, j64, p64)."""
    nd, td = DTYPES[prec]

    def flat(o):
        return [np.asarray(x, np.float64) for x in (o if isinstance(o, (tuple, list)) else [o])]

    j = flat(fn_j(*(jnp.asarray(a.astype(nd)) for a in args)))
    p = flat(fn_p(*(torch.tensor(a.astype(nd)) for a in args)))
    if prec == "float64":
        return j, p, None, None
    p64 = flat(fn_p(*(torch.tensor(a) for a in args)))
    jax.config.update("jax_enable_x64", True)
    try:
        j64 = flat(fn_j(*(jnp.asarray(a) for a in args)))
    finally:
        jax.config.update("jax_enable_x64", False)
    return j, p, j64, p64


def _hold(j, p, j64, p64, tols64, tol32):
    """Each port output within its limit of JAX's; in float32 each package
    first within `tol32` of its own float64 result."""
    for i, (a, b) in enumerate(zip(p, j)):
        assert a.shape == b.shape
        if j64 is None:
            assert _rel(a, b) <= tols64[i], (i, _rel(a, b))
        else:
            assert _rel(j[i], j64[i]) <= tol32, (i, "JAX f32 from f64", _rel(j[i], j64[i]))
            assert _rel(p[i], p64[i]) <= tol32, (i, "port f32 from f64", _rel(p[i], p64[i]))
            assert _rel(a, b) <= tol32, (i, _rel(a, b))


def periodogram(T, F, seed):
    """[T, F] float64 noise periodogram with speech-like bursts of 1-21x
    the noise in half the frames."""
    rng = np.random.RandomState(seed)
    noise = np.abs(rng.randn(T, F)) ** 2 * 0.5 + 0.05
    env = (np.sin(np.arange(T) / 9.0) > 0.3)[:, None] * (1 + 20 * rng.rand(1, F))
    return noise * (1 + env * np.abs(rng.randn(T, F)) ** 2)


PWR = periodogram(230, 33, 0)   # past MCRA's window of 100 frames twice


# (lambda_d, G, p) limits in float64: G carries the float32 exp1; IMCRA's
# and MCRA-TBRR's presence and noise follow the decision-directed SNR
TRACKER_TOLS = {"mcra_track": (TOL64, TOL64_EXP1, TOL64),
                "mcra2_track": (TOL64, TOL64_EXP1, TOL64),
                "imcra_track": (TOL64_EXP1,) * 3}


@pytest.mark.parametrize("name", list(TRACKER_TOLS))
def test_trackers_match_jax(name, prec):
    _hold(*_run(getattr(trackers_j, name), getattr(trackers, name), [PWR], prec),
          TRACKER_TOLS[name], TOL32)


def test_mcra_tbrr_matches_jax(prec):
    pw = [periodogram(230, 33, s) for s in (0, 1, 2)]
    _hold(*_run(trackers_j.mcra_tbrr_track, trackers.mcra_tbrr_track, pw, prec),
          (TOL64_EXP1,) * 3, TOL32)


@pytest.mark.parametrize("tracker", ["mcra", "mcra2", "imcra"])
def test_omlsa_enhance_matches_jax(tracker, prec):
    _hold(*_run(lambda m: trackers_j.omlsa_enhance(m, tracker=tracker),
                lambda m: trackers.omlsa_enhance(m, tracker=tracker), [np.sqrt(PWR)], prec),
          (TOL64_EXP1,), TOL32)
    with pytest.raises(ValueError, match="Unknown tracker"):
        trackers.omlsa_enhance(torch.ones(3, 5), tracker="mcra3")


def test_freq_smooth_is_the_banded_hanning():
    x = np.random.RandomState(1).rand(4, 17)
    a = np.hanning(7)
    band = sum(a[3 + k] * np.eye(17, k=k) for k in range(-3, 4))
    np.testing.assert_allclose(trackers._freq_smooth(torch.tensor(x)).numpy(), x @ band,
                               rtol=1e-14, atol=0)
    assert _rel(trackers._freq_smooth(torch.tensor(x)),
                trackers_j._freq_smooth(jnp.asarray(x.astype(np.float32)))) <= 1e-6


def test_histogram_track_matches_jax(prec):
    _hold(*_run(hist_j.histogram_track, histnoise.histogram_track, [PWR], prec),
          (TOL64,) * 9, TOL32)


def test_histogram_track_with_a_seed_and_other_params(prec):
    params = (hist_j.HistParams(frame_L=12, n_buckets=7, delta=0.5),
              histnoise.HistParams(frame_L=12, n_buckets=7, delta=0.5))
    S0 = PWR[:5].mean(0)
    _hold(*_run(lambda p, s: hist_j.histogram_track(p, params[0], S0=s),
                lambda p, s: histnoise.histogram_track(p, params[1], S0=s),
                [PWR[:60], S0], prec), (TOL64,) * 9, TOL32)


def test_masked_mode_matches_numpy_histogram():
    """The mode bucket's left edge, mean and std of a bin against
    np.histogram over its masked pool (min(count, n_buckets) buckets)."""
    rng = np.random.RandomState(2)
    pool = rng.rand(40, 6) ** 3
    mask = (rng.rand(40, 6) < 0.6).astype(np.float64)
    mode, mean, std, cnt = (t.numpy() for t in histnoise._masked_mode(
        torch.tensor(pool), torch.tensor(mask), 40))
    for f in range(6):
        v = pool[mask[:, f] > 0, f]
        h, edges = np.histogram(v, min(len(v), 40))
        assert cnt[f] == len(v)
        np.testing.assert_allclose(mode[f], edges[np.argmax(h)], rtol=1e-12)
        np.testing.assert_allclose((mean[f], std[f]), (v.mean(), v.std()), rtol=1e-12)


# MixMax: P classes of log-STMS Gaussians over F bins, posteriors of T frames
_rng = np.random.RandomState(0)
MM_P, MM_F, MM_T = 7, 33, 60
LOG_MAG = _rng.randn(MM_T, MM_F) * 1.5 - 3.0
MEANS = _rng.randn(MM_P, MM_F) - 2.5
STDS = 0.5 + _rng.rand(MM_P, MM_F)
PROBS = _rng.rand(MM_P)
PROBS /= PROBS.sum()
POST = _rng.rand(MM_T, MM_P)
POST /= POST.sum(1, keepdims=True)


@pytest.mark.parametrize("track_noise", [False, True])
@pytest.mark.parametrize("nn_weighted", [False, True])
@pytest.mark.parametrize("with_post", [False, True])
def test_mixmax_enhance_matches_jax(track_noise, nn_weighted, with_post, prec):
    def fn_j(z, post):
        m = mixmax_j.MixMaxModel(*(jnp.asarray(np.asarray(a, z.dtype)) for a in
                                   (MEANS, STDS, MEANS[0], STDS[0], PROBS)))
        return mixmax_j.enhance(m, z, post if with_post else None, track_noise, nn_weighted)

    def fn_p(z, post):
        m = mixmax.MixMaxModel(*(torch.tensor(a).to(z.dtype) for a in
                                 (MEANS, STDS, MEANS[0], STDS[0], PROBS)))
        return mixmax.enhance(m, z, post if with_post else None, track_noise, nn_weighted)

    _hold(*_run(fn_j, fn_p, [LOG_MAG, POST], prec), (TOL64,), TOL32)


@pytest.mark.parametrize("nn_weighted", [False, True])
def test_mixmax_estimate_frame_matches_jax(nn_weighted, prec):
    def fn_j(z, post):
        m = mixmax_j.MixMaxModel(*(jnp.asarray(np.asarray(a, z.dtype)) for a in
                                   (MEANS, STDS, MEANS[0] - 1.0, STDS[0], PROBS)))
        return mixmax_j.estimate_frame(m, post, z, mixmax_j.default_delta(MM_F), nn_weighted)

    def fn_p(z, post):
        m = mixmax.MixMaxModel(*(torch.tensor(a).to(z.dtype) for a in
                                 (MEANS, STDS, MEANS[0] - 1.0, STDS[0], PROBS)))
        return mixmax.estimate_frame(m, post, z, mixmax.default_delta(MM_F), nn_weighted)

    _hold(*_run(fn_j, fn_p, [LOG_MAG[7], POST[7]], prec), (TOL64, TOL64), TOL32)


def test_mixmax_model_helpers_match_jax():
    m_j = mixmax_j.gaussians_from_stats(MEANS, STDS * 0 + 1e-9, PROBS)
    m_p = mixmax.gaussians_from_stats(MEANS, STDS * 0 + 1e-9, PROBS)
    for k in ("x_mu", "x_sigma", "g_mu", "g_sigma", "prio_p"):
        np.testing.assert_array_equal(getattr(m_p, k).numpy(), np.asarray(getattr(m_j, k)))
        assert getattr(m_p, k).dtype == torch.float32
    for n in (100, 257, 513):
        np.testing.assert_array_equal(mixmax.default_delta(n).numpy(),
                                      np.asarray(mixmax_j.default_delta(n)))


def test_ndtr_keeps_the_left_tail():
    """The port's Normal cdf against scipy's: torch.special.ndtr cancels to
    0 below -8.3 in float64; this one holds the tail (float32 to 2e-5 down
    to its smallest normal number: 1.08e-5 measured at 1.3e-38; JAX's own
    float32 ndtr is 5.9e-6 from scipy's at -10)."""
    from scipy.special import ndtr as ndtr_ref
    x = np.linspace(-35.0, 6.0, 2001)
    got = mixmax.ndtr(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ndtr_ref(x), rtol=1e-13, atol=0)
    got32 = mixmax.ndtr(torch.tensor(x.astype(np.float32))).double().numpy()
    keep = ndtr_ref(x.astype(np.float32)) > np.finfo(np.float32).tiny
    np.testing.assert_allclose(got32[keep], ndtr_ref(x.astype(np.float32))[keep], rtol=2e-5)


# VTS: K = MM_P speech components, L = 2 noise components
def _vts_models(dt):
    mj = vts_j.make_model(MEANS, STDS, PROBS, MEANS[0] - 1.0, STDS[0], n_noise_comp=2, seed=3)
    mp = vts.make_model(MEANS, STDS, PROBS, MEANS[0] - 1.0, STDS[0], n_noise_comp=2, seed=3)
    if dt == "float64":
        mj = vts_j.VTSModel(*(jnp.asarray(np.asarray(a), jnp.float64) for a in mj))
        mp = mp.to(torch.float64)
    return mj, mp


def test_vts_make_model_matches_jax_exactly():
    mj = vts_j.make_model(MEANS, STDS, PROBS, MEANS[0], STDS[0] * 1e-4, n_noise_comp=3,
                          jitter=0.2, seed=7)
    mp = vts.make_model(MEANS, STDS, PROBS, MEANS[0], STDS[0] * 1e-4, n_noise_comp=3,
                        jitter=0.2, seed=7)
    for k in vts_j.VTSModel._fields:
        np.testing.assert_array_equal(getattr(mp, k).numpy(), np.asarray(getattr(mj, k)), k)
        assert getattr(mp, k).dtype == torch.float32


def test_vts_compensate_and_posteriors_match_jax(prec):
    mj, mp = _vts_models(prec)
    nd = DTYPES[prec][0]
    cj, cp = vts_j.compensate(mj), vts.compensate(mp)
    tol = TOL64 if prec == "float64" else TOL32
    for a, b in zip(cp, cj):
        assert _rel(a, b) <= tol
    assert _rel(vts.posteriors(cp, torch.tensor(LOG_MAG.astype(nd))),
                vts_j.posteriors(cj, jnp.asarray(LOG_MAG.astype(nd)))) <= tol


@pytest.mark.parametrize("kw", ["plain", "spp", "phoneme_post", "fixed_bias"])
def test_vts_em_step_matches_jax(kw, prec):
    rng = np.random.RandomState(4)
    extra = {"plain": {}, "spp": {"spp": rng.rand(MM_T, MM_F)},
             "phoneme_post": {"phoneme_post": POST}, "fixed_bias": {"update_bias": False}}[kw]
    names = [k for k, v in extra.items() if isinstance(v, np.ndarray)]
    flag = {k: v for k, v in extra.items() if not isinstance(v, np.ndarray)}

    def fn_j(O, *arrs):
        m, s, n = vts_j.em_step(_vts_models("float64" if O.dtype == jnp.float64 else "f32")[0],
                                O, **dict(zip(names, arrs)), **flag)
        return [s, n, m.g_mu, m.g_var, m.w_l, m.bias]

    def fn_p(O, *arrs):
        m0 = _vts_models("float64" if O.dtype == torch.float64 else "f32")[1]
        m, s, n = vts.em_step(m0, O, **dict(zip(names, arrs)), **flag)
        return [s, n, m.g_mu, m.g_var, m.w_l, m.bias]

    _hold(*_run(fn_j, fn_p, [LOG_MAG] + [extra[k] for k in names], prec), (TOL64,) * 6,
          TOL32_EM)


def test_vts_enhance_and_rt_vts_track_match_jax(prec):
    def fn_j(O):
        m = _vts_models("float64" if O.dtype == jnp.float64 else "f32")[0]
        return [vts_j.vts_enhance(m, O)[0], *vts_j.rt_vts_track(m, O)]

    def fn_p(O):
        m = _vts_models("float64" if O.dtype == torch.float64 else "f32")[1]
        return [vts.vts_enhance(m, O)[0], *vts.rt_vts_track(m, O)]

    _hold(*_run(fn_j, fn_p, [LOG_MAG], prec), (TOL64,) * 3, TOL32_EM)


def test_alignment_and_labels_match_jax(tmp_path):
    lex, ali = str(tmp_path / "lexicon.txt"), str(tmp_path / "a.ali")
    write_lexicon(lex)
    write_alignment(ali, [("u0", 16000), ("u1", 40000)], seed=2)
    a_p, a_j = labels.read_alignment(ali), labels_j.read_alignment(ali)
    assert a_p == a_j and set(a_p) == {"u0", "u1"}
    assert all(pho != "$0" for segs in a_p.values() for _, _, pho in segs)
    e2i = phoneme.Phoneme(lex).tkn_dict.entry2Index
    for frame_ms in (10.0, 16.0):
        for key, segs in a_p.items():
            lab = labels.frame_labels(segs, 160, e2i, frame_ms=frame_ms, fill="|")
            np.testing.assert_array_equal(lab, labels_j.frame_labels(
                segs, 160, e2i, frame_ms=frame_ms, fill="|"))
            assert lab.dtype == np.int32 and lab.max() < 98
            oh = labels.one_hot_targets(lab, 98)
            np.testing.assert_array_equal(oh, labels_j.one_hot_targets(lab, 98))


def test_lexicon_parser_matches_jax(tmp_path):
    lex = str(tmp_path / "lexicon.txt")
    write_lexicon(lex)
    with open(lex, "a") as f:   # a skipped entry, a multi-token one, a repeat
        f.write("aa | a\nzhuang | zh uang\nb | p\nno separator line\n")
    m_p, d_p = phoneme.parse_lexicon(lex)
    m_j, d_j = phoneme_j.parse_lexicon(lex)
    assert m_p == m_j and d_p.entry2Index == d_j.entry2Index
    assert d_p.index2Entry == d_j.index2Entry and len(d_p) == len(d_j) == 98 + 10  # zh1-5 and uang1-5
    ph, ph_j = phoneme.Phoneme(lex), phoneme_j.Phoneme(lex)
    for entry in ("zhuang", "ang", "b"):
        assert ph.tokens(entry, "3") == ph_j.tokens(entry, "3")
    assert ph.ids(["a1 ", "b", "*"]) == ph_j.ids(["a1 ", "b", "*"])


def test_mixmax_presence_past_one_diverges_as_in_jax():
    """Posteriors that sum past 1 a frame (a classifier's sigmoid outputs, as
    the JAX package's `_infer_hybrid` passes them) make the presence exceed
    1, and the noise recursion g <- rho g + (1 - rho)(...) grows without
    bound: both packages' float32 estimates turn non-finite within two
    frames of each other (where it overflows hangs on the last bits: 183
    and 184 of 480 measured), and agree within TOL32 over the first 5
    frames: the growth amplifies rounding (measured 1.2e-6 of the scale
    over 5 frames, 2.1e-3 over 10, 0.13 by the overflow). ROADMAP queue C:
    found in the JAX package, reproduced by the port."""
    z = np.tile(LOG_MAG, (8, 1)).astype(np.float32)   # 480 frames
    post = np.full((len(z), MM_P), 60.0 / MM_P, np.float32)
    arrays = [x.astype(np.float32) for x in (MEANS, STDS, MEANS[0], STDS[0], PROBS)]
    a = np.asarray(mixmax_j.enhance(mixmax_j.MixMaxModel(*map(jnp.asarray, arrays)),
                                    jnp.asarray(z), jnp.asarray(post)))
    b = mixmax.enhance(mixmax.MixMaxModel(*map(torch.tensor, arrays)), torch.tensor(z),
                       torch.tensor(post)).numpy()
    bad_a, bad_b = ((~np.isfinite(v)).any(1) for v in (a, b))
    assert bad_a.any() and bad_b.any() and abs(np.argmax(bad_a) - np.argmax(bad_b)) <= 2
    assert 100 < min(np.argmax(bad_a), np.argmax(bad_b)) < len(z) - 10
    assert _rel(b[:5], a[:5]) <= TOL32
