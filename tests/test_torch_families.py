"""Every input/target family but MagPhonemes (`deepxi_tpu_torch.inp_tgt`;
MagPhonemes is held in tests/test_torch_hybrid.py)
against the JAX package's (`deepxi_tpu.inp_tgt`) on the CPU, each with its
maps: the statistics `with_stats` fits on one seeded sample; `observation`
and `example` of the same int16 waves (the noise offsets the JAX key draws
handed to the port, as the ROADMAP trap on `jax.random` says), with the JAX
statistics in both; `enhanced_speech` and the readers (`xi_hat`,
`gamma_hat`, `mag_hat`, `cd_hat`, `s_stps_hat`) of the same network output;
`make_enhancer` of each gain-form family on a small ResNetV2 (JAX at
precision "highest"); MagMag at bins where |X| = 0; and what the port
refuses. Tolerances: 1e-4 of a map's or gain's [0, 1] scale and 1e-5 of a
spectrum's or waveform's scale (float32 sums in another order), stated at
each check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from deepxi_tpu.enhance import make_enhancer as make_enhancer_j
from deepxi_tpu.inp_tgt import inp_tgt_selector as inp_tgt_selector_j
from deepxi_tpu.models import network_selector
from deepxi_tpu_torch.compat.artifact import from_flax_params, restore_stats
from deepxi_tpu_torch.enhance import make_enhancer
from deepxi_tpu_torch.inp_tgt import MAP_ATTRS, inp_tgt_selector
from deepxi_tpu_torch.models.tcn import ResNetV2
from deepxi_tpu_torch.ops.kernels.spectral import stft_mag
from deepxi_tpu_torch.ops.maps import STATS_FIELDS

DIMS = dict(N_d=512, N_s=256, K=512, f_s=16000)
# family label: (inp_tgt_type, selector arguments)
FAMILIES = {
    "MagXi-LaplaceCDF": ("MagXi", dict(map_type="DBLaplaceCDF", map_params=[0.0])),
    "MagGamma": ("MagGamma", dict(map_type="DBNormalCDF")),
    "MagXiGamma": ("MagXiGamma", dict(map_type=["DBNormalCDF", "DBNormalCDF"])),
    "MagGain": ("MagGain", dict(gain="mmse-lsa")),
    "MagGain-ibm": ("MagGain", dict(gain="ibm")),
    "MagMag": ("MagMag", dict(map_type="DBNormalCDF")),
    "MagSMM": ("MagSMM", {}),
    "MagPhaXiPha": ("MagPhaXiPha", dict(map_type=[["DB", "NormalCDF"], ["UniformCDF"]])),
    "STDCTXiCD": ("STDCTXiCD", dict(map_type=["DBNormalCDF", "NormalCDF"])),
}
NAMES = sorted(FAMILIES)
GAIN_FORM = [n for n in NAMES if FAMILIES[n][0] in
             ("MagXi", "MagXiGamma", "MagGain", "MagSMM", "MagMag")]
READERS = ("xi_hat", "gamma_hat", "mag_hat", "cd_hat", "s_stps_hat")
SMALL = dict(d_model=32, n_blocks=3, d_f=16, k=3, max_d_rate=2)


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _sample():
    rng = np.random.RandomState(4)
    s, d = (rng.randn(3, 6000) * a for a in (0.3, 0.1))
    x = s + d
    return (s.astype(np.float32), d.astype(np.float32), x.astype(np.float32),
            np.array([6000, 4500, 3000], np.int32))


def _pair(name, fit=True):
    """The family in both packages; with `fit`, the JAX one fitted on
    `_sample` and the port's given the same statistics."""
    typ, kw = FAMILIES[name]
    kw = dict(kw, gain=kw.get("gain", "mmse-lsa"))
    it, it_j = inp_tgt_selector(typ, **DIMS, **kw), inp_tgt_selector_j(typ, **DIMS, **kw)
    if fit:
        it_j = it_j.with_stats(*_sample())
        stats = {f"{m}.{f}": np.asarray(getattr(getattr(it_j, m), f))
                 for m in MAP_ATTRS if getattr(it_j, m, None) is not None
                 for f in STATS_FIELDS if getattr(getattr(it_j, m), f, None) is not None}
        it = restore_stats(it, stats)
    return it, it_j


@pytest.mark.parametrize("name", NAMES)
def test_with_stats_matches_jax(name):
    """Each map's fitted fields (1e-4 relative: dB statistics of float32
    spectra summed in another order)."""
    it, it_j = _pair(name, fit=False)
    it, it_j = it.with_stats(*_sample()), it_j.with_stats(*_sample())
    assert (it.n_feat, it.n_outp) == (it_j.n_feat, it_j.n_outp)
    for m in MAP_ATTRS:
        assert (getattr(it, m, None) is None) == (getattr(it_j, m, None) is None)
        if getattr(it, m, None) is None:
            continue
        for f in STATS_FIELDS:
            v = getattr(getattr(it, m), f, None)
            if torch.is_tensor(v):
                assert _scaled_err(v, getattr(getattr(it_j, m), f)) <= 1e-4, (m, f)


def _waves():
    rng = np.random.RandomState(0)
    s = (rng.randn(2, 6144) * 3000).astype(np.int16)
    d = (rng.randn(2, 9000) * 2000).astype(np.int16)
    return s, d, np.array([6144, 5000], np.int32), np.array([9000, 7000], np.int32), \
        np.array([0.0, 5.0], np.float32)


def _phase_err(a, b):
    """Largest distance of two mapped phases on the circle of the [0, 1]
    UniformCDF image of [-pi, pi] (an angle at pi may come out as -pi)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, np.abs(d - 1.0)).max()


def _input_close(name, inp, sup, inp_j, sup_j):
    """A network input (and the noisy phase `sup` where given) to 1e-5 of
    its scale; a phase as the spectrum |X| e^{j angle X}, since it is free
    where |X| is within rounding of 0."""
    nb = 257
    if name == "STDCTXiCD":
        assert _scaled_err(inp, inp_j) <= 1e-5
        return
    inp_j = np.asarray(inp_j)
    if name == "MagPhaXiPha":
        inp, sup, inp_j, sup_j = inp[..., :nb], inp[..., nb:], inp_j[..., :nb], inp_j[..., nb:]
    assert _scaled_err(inp, inp_j) <= 1e-5
    if sup is not None:
        assert _scaled_err(torch.polar(inp, sup).numpy(),
                           inp_j * np.exp(1j * np.asarray(sup_j))) <= 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_observation_and_example_match_jax(name):
    """Network input to 1e-5 of its scale; targets to 1e-4 (the phase half
    of MagPhaXiPha on the circle); frame counts exactly."""
    it, it_j = _pair(name)
    s, d, s_len, d_len, snr = _waves()
    inp, sup = it.observation(torch.as_tensor(s))
    inp_j, sup_j = it_j.observation(jnp.asarray(s))
    _input_close(name, inp, sup, inp_j, sup_j)
    key = jax.random.PRNGKey(3)
    offs = [int(jax.random.randint(k, (), 0, max(1 + int(dl) - int(sl), 1)))
            for k, sl, dl in zip(jax.random.split(key, 2), s_len, d_len)]
    assert max(offs) > 0
    x, tgt, nf = it.example(*(torch.as_tensor(a) for a in (s, d, s_len, d_len, snr)),
                            offsets=torch.as_tensor(offs))
    x_j, tgt_j, nf_j = it_j.example(key, *(jnp.asarray(a) for a in (s, d, s_len, d_len, snr)))
    _input_close(name, x, None, x_j, None)
    np.testing.assert_array_equal(nf.numpy(), np.asarray(nf_j))
    tgt, tgt_j = tgt.numpy(), np.asarray(tgt_j)
    assert tgt.shape == tgt_j.shape == x.shape[:2] + (it.n_outp,)
    if name == "MagPhaXiPha":
        nb = it.K // 2 + 1
        assert np.abs(tgt[..., :nb] - tgt_j[..., :nb]).max() <= 1e-4
        # the clean phase where the clean spectrum is not within rounding of 0
        s_f = it.mix(*(torch.as_tensor(a) for a in (s, d, s_len, d_len, snr)),
                     offsets=torch.as_tensor(offs))[0]
        S = it.polar_analysis(s_f)[0].numpy()
        held = S > 1e-5 * S.max()
        assert _phase_err(tgt[..., nb:][held], tgt_j[..., nb:][held]) <= 1e-4
    else:
        assert np.abs(tgt - tgt_j).max() <= 1e-4 * max(np.abs(tgt_j).max(), 1.0)


def _network_output(it, T, seed=5):
    """A network output in each family's range: (0, 1), and [0, 5] for MagSMM."""
    tgt = np.random.RandomState(seed).uniform(0.02, 0.98, (T, it.n_outp)).astype(np.float32)
    return tgt * 5.0 if type(it).__name__ == "MagSMM" else tgt


@pytest.mark.parametrize("name", NAMES)
def test_enhanced_speech_and_readers_match_jax(name):
    """The waveform of the same observation and network output (1e-5 of
    its scale; STDCTXiCD through dgwf and its cd > 0 mask), and every
    reader the family has (1e-4 of its scale)."""
    it, it_j = _pair(name)
    w = (np.random.RandomState(1).randn(5000) * 3000).astype(np.int16)
    inp_j, sup_j = it_j.observation(jnp.asarray(w))
    tgt = _network_output(it, inp_j.shape[0])
    gtype = "dgwf" if name == "STDCTXiCD" else "mmse-lsa"
    y = it.enhanced_speech(torch.as_tensor(np.asarray(inp_j)),
                           torch.as_tensor(np.asarray(sup_j)), torch.as_tensor(tgt), gtype)
    y_j = it_j.enhanced_speech(inp_j, sup_j, jnp.asarray(tgt), gtype)
    assert _scaled_err(y, y_j) <= 1e-5
    read = [r for r in READERS if hasattr(it_j, r)]
    assert read == [r for r in READERS if hasattr(it, r)]
    for r in read:
        assert _scaled_err(getattr(it, r)(torch.as_tensor(tgt)),
                           getattr(it_j, r)(jnp.asarray(tgt))) <= 1e-4, r


def _nets(it, outp_act="Sigmoid", seed=0):
    net_j = network_selector("ResNetV2", it.n_outp, causal=True, unit_type="ReLU->LN->W+b",
                             outp_act=outp_act, **SMALL)
    params = net_j.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, it.n_feat)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
                                    params)
    return net_j, params, ResNetV2(it.n_feat, it.n_outp, outp_act=outp_act, **SMALL), \
        from_flax_params(params)


@pytest.mark.parametrize("name", GAIN_FORM)
def test_make_enhancer_matches_jax(name):
    """The batched enhancer of each gain-form family on the same weights
    and int16 batch: waveforms to 1e-5 of their scale. MagGain-ibm's
    threshold: no network output lies within 1e-5 of 0.5 (a tie would
    flip a bin in one package only)."""
    it, it_j = _pair(name)
    net_j, params_j, net, params = _nets(it)
    x = (np.random.RandomState(2).randn(2, 6000) * 3000).astype(np.int16)
    y = make_enhancer(it, net, "mmse-lsa", device="cpu")(params, x).numpy()
    y_j = np.asarray(make_enhancer_j(it_j, net_j, "mmse-lsa", precision="highest")(
        params_j, jnp.asarray(x)))
    if name == "MagGain-ibm":
        with torch.no_grad():
            out = functional_call(net, params, (stft_mag(
                torch.as_tensor(x / 32768.0, dtype=torch.float32), 512, 256, 512),))
        assert (out - 0.5).abs().min() > 1e-5
    assert y.shape == y_j.shape
    assert _scaled_err(y, y_j) <= 1e-5


def test_magmag_keeps_the_unit_vector_at_zero_bins():
    """Frames of exact zeros have |X| = 0 in every bin: the enhancer writes
    the mapped magnitude there with the unit vector (1, 0), as the JAX
    enhancer does (both fed the same network output, since the map's
    inverse near 0 and 1 magnifies the networks' float32 differences). The
    polar route (`MagMag.enhanced_speech`) takes the phase angle(X), which
    is pi where the FFT gives X = -0 + 0j: the two routes agree once those
    phases are 0 (a limit of the JAX package, ROADMAP queue C)."""
    it, it_j = _pair("MagMag")
    _, _, net, params = _nets(it)
    x = (np.random.RandomState(3).randn(1, 8192) * 3000).astype(np.int16)
    x[:, 2048:5120] = 0
    mag, pha = it.observation(torch.as_tensor(x))
    with torch.no_grad():
        tgt = functional_call(net, params, (mag,))
    y = make_enhancer(it, None, apply_fn=lambda p, m: tgt, device="cpu")(None, x)
    y_j = make_enhancer_j(it_j, None, precision="highest",
                          apply_fn=lambda p, m: jnp.asarray(tgt.numpy()))(None, jnp.asarray(x))
    assert _scaled_err(y, y_j) <= 1e-5
    zero = mag[0, 9:19] == 0
    assert zero.all() and (pha[0, 9:19][zero] != 0).any()
    with torch.no_grad():
        y_polar = it.enhanced_speech(mag, torch.where(mag == 0, 0.0, pha), tgt)
        y_pi = it.enhanced_speech(mag, pha, tgt)
    assert _scaled_err(y, y_polar) <= 1e-5
    assert _scaled_err(y, y_pi) > 1e-3
    assert np.abs(y.numpy()[0, 2560:4608]).max() > 0   # the zero frames are filled


@pytest.mark.parametrize("name", ["MagGamma", "MagPhaXiPha", "STDCTXiCD"])
def test_families_without_a_gain_form_refuse_make_enhancer(name):
    it, _ = _pair(name, fit=False)
    with pytest.raises(ValueError, match="enhanced_speech"):
        make_enhancer(it, None, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_family_routes_follow_the_jax_package(name):
    """The route attributes `infer` and `make_enhancer` read give the JAX
    package's choices by family name: its batched families
    (`DeepXiTPU._FAST_FAMILIES`), the gain families among them (all but
    MagMag), `y/` without a gain directory for MagGain and MagMag, and the
    saved a priori SNR estimate of MagGamma's `y`."""
    from deepxi_tpu.framework import DeepXiTPU
    it, _ = _pair(name, fit=False)
    typ = FAMILIES[name][0]
    assert it.gain_form == (typ in DeepXiTPU._FAST_FAMILIES)
    assert it.gain_synthesis == (it.gain_form and typ != "MagMag")
    assert it.y_per_gain == (typ not in ("MagGain", "MagMag"))
    assert it.saved_xi_hat == (typ == "MagGamma")


@pytest.mark.parametrize("typ", ["MagPhonemes", "MagPhonme"])
def test_magphonemes_names_its_roadmap_item(typ):
    """MagPhonemes (ROADMAP item A11, now in the port; the fork's typo too)
    builds as the JAX selector builds it: 98 classes unless `Noutp`, |X|
    input, out_types y and pho, no gain-form route."""
    from deepxi_tpu.inp_tgt import inp_tgt_selector as inp_tgt_selector_j
    for noutp in (None, 40):
        it = inp_tgt_selector(typ, **DIMS, Noutp=noutp)
        it_j = inp_tgt_selector_j(typ, **DIMS, Noutp=noutp)
        assert type(it).__name__ == type(it_j).__name__ == "MagPhonemes"
        assert it.n_outp == it_j.n_outp == (noutp or 98) and it.n_feat == it_j.n_feat
    assert it.out_types == ("y", "pho") and it.mag_input and not it.gain_form
