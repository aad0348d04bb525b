"""Input/target families (follows deepxi_tpu/inp_tgt.py).

Each family frames the signal, builds the training pair (`example`: the
network input and the mapped target from int16 speech and noise mixed on the
device), fits its maps' statistics on a training sample (`with_stats`),
reads the network output back (`xi_hat`, `gamma_hat`, `mag_hat`, `cd_hat`,
`s_stps_hat`) and turns it into a waveform (`enhanced_speech`):

  MagXi        STMS -> mapped a priori SNR (the published Deep Xi target)
  MagGamma     STMS -> mapped a posteriori SNR
  MagXiGamma   STMS -> [xi_bar || gamma_bar]
  MagGain      STMS -> the gain `gain` of the instantaneous SNRs
  MagMag       STMS -> mapped clean STMS
  MagSMM       STMS -> spectral magnitude mask, clipped to [0, 5]
  MagPhaXiPha  [STMS || STPS] -> [xi_bar || mapped clean STPS]
  STDCTXiCD    STDCT -> [xi_bar || mapped constructive/destructive term]
  MagPhonemes  STMS -> one-hot per-frame phoneme labels (a classifier);
               its `y` is OM-LSA or MixMax (`dsp/`)

The families whose synthesis is a real gain on the noisy spectrum give it
as `synthesis_gain` (`gain_synthesis`); they and MagMag, which replaces the
magnitude instead, are the `gain_form` families `enhance.make_enhancer`
takes through `spectrum_hat`. Map statistics are tensors on the
device the family is used on.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import numpy as np
import torch

from deepxi_tpu_torch.ops.gains import gfunc
from deepxi_tpu_torch.ops.kernels.spectral import apply_gain_reim
from deepxi_tpu_torch.ops.maps import map_selector
from deepxi_tpu_torch.sig import mix as mixing
from deepxi_tpu_torch.sig import stdct as stdct_mod
from deepxi_tpu_torch.sig import stft

# every map attribute a family may carry, in the stats file's order
MAP_ATTRS = ("xi_map", "gamma_map", "mag_map", "cd_map", "s_stps_map")
# the out_types of the families with an a priori SNR estimate and |X| input
_XI_OUT_TYPES = ("y", "xi_hat", "gamma_hat", "deepmmse", "ibm_hat",
                 "subband_ibm_hat", "d_hat")


def _stack_valid_frames(transform: Callable, sample_wavs: np.ndarray,
                        wav_len: np.ndarray, n_feat: int, N_s: int = 256,
                        chunk: int = 64, device=None) -> torch.Tensor:
    """Per-utterance spectra stacked over valid frames only: the transform
    runs over chunks of rows and each utterance keeps its first
    ceil(len / N_s) frames (zero padding does not change them)."""
    out = []
    for c0 in range(0, sample_wavs.shape[0], chunk):
        S = transform(torch.as_tensor(sample_wavs[c0:c0 + chunk], device=device))
        for i in range(S.shape[0]):
            n_frames = -(-int(wav_len[c0 + i]) // N_s)
            out.append(S[i, :n_frames].reshape(-1, n_feat))
    return torch.cat(out)


def _halves(t: torch.Tensor):
    """The two halves of the last axis."""
    return torch.chunk(t, 2, dim=-1)


@dataclass(frozen=True)
class InpTgtBase:
    """Analysis/synthesis framing shared by every family; `f_s` is the
    sampling rate the framing is for (wavs are read at it). `out_types` are
    the outputs `DeepXiTorch.infer` writes for the family; `mag_input` says
    whether the network reads the noisy STMS, which the spectral kernel
    `stft_mag_fused` can make. How `y` is made: a `gain_form` family's
    batched enhancer takes `spectrum_hat`; a `gain_synthesis` one's `y` is
    the real gain `synthesis_gain` on the noisy spectrum (per utterance, the
    gain synthesiser); the others' is `enhanced_speech`. `y_per_gain`: `y`
    depends on the gain function (written under `y/<gain>/`);
    `saved_xi_hat`: `y` can take a saved a priori SNR estimate."""
    N_d: int = 512
    N_s: int = 256
    K: int = 512
    f_s: int = 16000

    out_types = ("y",)
    mag_input = True
    gain_form = False
    gain_synthesis = False
    y_per_gain = True
    saved_xi_hat = False

    @property
    def n_feat(self) -> int:
        return self.K // 2 + 1

    @property
    def n_outp(self) -> int:
        return self.n_feat

    def polar_analysis(self, x: torch.Tensor):
        return stft.polar_analysis(x, self.N_d, self.N_s, self.K)

    def polar_synthesis(self, STMS: torch.Tensor, STPS: torch.Tensor) -> torch.Tensor:
        return stft.polar_synthesis(STMS, STPS, self.N_d, self.N_s, self.K)

    def n_frames(self, n: int) -> int:
        return stft.n_frames(n, self.N_s)

    def observation(self, x: torch.Tensor):
        """(network input, supplementary) of an int16 waveform: the noisy
        STMS and STPS."""
        return self.polar_analysis(mixing.normalise(x))

    def _stms(self, w: torch.Tensor) -> torch.Tensor:
        return self.polar_analysis(w)[0]

    def _stack(self, transform: Callable, sample: np.ndarray, wav_len: np.ndarray,
               n_feat: int, device) -> torch.Tensor:
        return _stack_valid_frames(transform, sample, wav_len, n_feat, self.N_s,
                                   device=device)

    def mix(self, s, d, s_len, d_len, snr,
            generator: Optional[torch.Generator] = None,
            offsets: Optional[torch.Tensor] = None):
        """(s, d, x, n_frames) of int16 [B, L] speech and noise mixed at
        `snr` dB; the noise offsets are `offsets`, or drawn on the host from
        `generator` (see `sig.mix.noise_offsets`)."""
        return mixing.mix(s, d, s_len, d_len, snr, self.N_s, generator, offsets)

    def with_stats(self, s_sample: np.ndarray, d_sample: np.ndarray,
                   x_sample: np.ndarray, wav_len: np.ndarray, device=None):
        """Fit the maps' statistics on the valid frames of a training sample
        ([N, L] float waveforms), computed on `device`. A family without
        maps is its own fit."""
        return self

    def spectrum_hat(self, Y: torch.Tensor, mag: torch.Tensor, tgt_hat: torch.Tensor,
                     gtype: str) -> torch.Tensor:
        """[re || im] of the enhanced spectrum from the noisy [re || im] `Y`,
        its magnitude `mag` and the network output (a `gain_form` family):
        the real gain `synthesis_gain` times Y."""
        return apply_gain_reim(Y, self.synthesis_gain(tgt_hat, gtype), self.K)


@dataclass(frozen=True)
class MagXi(InpTgtBase):
    """STMS input, mapped instantaneous a priori SNR target."""
    xi_map: Any = None

    out_types = _XI_OUT_TYPES
    gain_form = gain_synthesis = True

    def with_stats(self, s_sample, d_sample, x_sample, wav_len, device=None) -> "MagXi":
        s = self._stack(self._stms, s_sample, wav_len, self.n_feat, device)
        d = self._stack(self._stms, d_sample, wav_len, self.n_feat, device)
        return replace(self, xi_map=self.xi_map.with_stats(mixing.xi(s, d)))

    def example(self, s, d, s_len, d_len, snr,
                generator: Optional[torch.Generator] = None,
                offsets: Optional[torch.Tensor] = None):
        """Training pair from int16 [B, L] speech and noise: (noisy STMS,
        mapped xi target, frame counts)."""
        s, d, x, n_frames = self.mix(s, d, s_len, d_len, snr, generator, offsets)
        xi_bar = self.xi_map.map(mixing.xi(self._stms(s), self._stms(d)))
        return self._stms(x), xi_bar, n_frames

    def synthesis_gain(self, tgt_hat: torch.Tensor, gtype: str) -> torch.Tensor:
        xi_hat = self.xi_hat(tgt_hat)
        return gfunc(xi_hat, xi_hat + 1.0, gtype)

    def enhanced_speech(self, x_STMS: torch.Tensor, x_STPS: torch.Tensor,
                        xi_bar_hat: torch.Tensor, gtype: str) -> torch.Tensor:
        """Waveform of the gain `gtype` applied to the noisy STMS, with the
        noisy phase."""
        return self.polar_synthesis(x_STMS * self.synthesis_gain(xi_bar_hat, gtype), x_STPS)

    def xi_hat(self, xi_bar_hat: torch.Tensor) -> torch.Tensor:
        """A priori SNR estimate from the network output."""
        return self.xi_map.inverse(xi_bar_hat)

    def gamma_hat(self, xi_bar_hat: torch.Tensor) -> torch.Tensor:
        """ML a posteriori SNR estimate xi_hat + 1."""
        return self.xi_map.inverse(xi_bar_hat) + 1.0


@dataclass(frozen=True)
class MagGamma(InpTgtBase):
    """STMS input, mapped a posteriori SNR target."""
    gamma_map: Any = None

    out_types = _XI_OUT_TYPES
    saved_xi_hat = True

    def with_stats(self, s_sample, d_sample, x_sample, wav_len, device=None) -> "MagGamma":
        x = self._stack(self._stms, x_sample, wav_len, self.n_feat, device)
        d = self._stack(self._stms, d_sample, wav_len, self.n_feat, device)
        return replace(self, gamma_map=self.gamma_map.with_stats(mixing.gamma(x, d)))

    def example(self, s, d, s_len, d_len, snr, generator=None, offsets=None):
        s, d, x, n_frames = self.mix(s, d, s_len, d_len, snr, generator, offsets)
        x_STMS = self._stms(x)
        return x_STMS, self.gamma_map.map(mixing.gamma(x_STMS, self._stms(d))), n_frames

    def enhanced_speech(self, x_STMS, x_STPS, gamma_bar_hat, gtype: str,
                        xi_hat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The gain at (xi_hat, gamma_hat): xi_hat is a saved a priori SNR
        estimate when given, else the ML estimate of `xi_hat`."""
        if xi_hat is None:
            xi_hat = self.xi_hat(gamma_bar_hat)
        G = gfunc(xi_hat, self.gamma_hat(gamma_bar_hat), gtype)
        return self.polar_synthesis(x_STMS * G, x_STPS)

    def gamma_hat(self, gamma_bar_hat: torch.Tensor) -> torch.Tensor:
        return self.gamma_map.inverse(gamma_bar_hat)

    def xi_hat(self, gamma_bar_hat: torch.Tensor) -> torch.Tensor:
        """ML a priori estimate max(gamma_hat - 1, 1e-12)."""
        return torch.clamp(self.gamma_map.inverse(gamma_bar_hat) - 1.0, min=1e-12)


@dataclass(frozen=True)
class MagXiGamma(InpTgtBase):
    """STMS input, [xi_bar || gamma_bar] target."""
    xi_map: Any = None
    gamma_map: Any = None

    out_types = _XI_OUT_TYPES
    gain_form = gain_synthesis = True

    @property
    def n_outp(self) -> int:
        return self.n_feat * 2

    def with_stats(self, s_sample, d_sample, x_sample, wav_len, device=None) -> "MagXiGamma":
        s = self._stack(self._stms, s_sample, wav_len, self.n_feat, device)
        d = self._stack(self._stms, d_sample, wav_len, self.n_feat, device)
        x = self._stack(self._stms, x_sample, wav_len, self.n_feat, device)
        return replace(self, xi_map=self.xi_map.with_stats(mixing.xi(s, d)),
                       gamma_map=self.gamma_map.with_stats(mixing.gamma(x, d)))

    def example(self, s, d, s_len, d_len, snr, generator=None, offsets=None):
        s, d, x, n_frames = self.mix(s, d, s_len, d_len, snr, generator, offsets)
        s_STMS, d_STMS, x_STMS = self._stms(s), self._stms(d), self._stms(x)
        xi_bar = self.xi_map.map(mixing.xi(s_STMS, d_STMS))
        gamma_bar = self.gamma_map.map(mixing.gamma(x_STMS, d_STMS))
        return x_STMS, torch.cat([xi_bar, gamma_bar], dim=-1), n_frames

    def synthesis_gain(self, tgt_hat: torch.Tensor, gtype: str) -> torch.Tensor:
        return gfunc(self.xi_hat(tgt_hat), self.gamma_hat(tgt_hat), gtype)

    def enhanced_speech(self, x_STMS, x_STPS, tgt_hat, gtype: str) -> torch.Tensor:
        return self.polar_synthesis(x_STMS * self.synthesis_gain(tgt_hat, gtype), x_STPS)

    def xi_hat(self, tgt_hat: torch.Tensor) -> torch.Tensor:
        return self.xi_map.inverse(_halves(tgt_hat)[0])

    def gamma_hat(self, tgt_hat: torch.Tensor) -> torch.Tensor:
        return self.gamma_map.inverse(_halves(tgt_hat)[1])


@dataclass(frozen=True)
class MagGain(InpTgtBase):
    """STMS input, the gain `gain` of the instantaneous SNRs as target; an
    `ibm` estimate is thresholded at 0.5."""
    gain: str = "mmse-lsa"

    gain_form = gain_synthesis = True
    y_per_gain = False

    def example(self, s, d, s_len, d_len, snr, generator=None, offsets=None):
        s, d, x, n_frames = self.mix(s, d, s_len, d_len, snr, generator, offsets)
        s_STMS, d_STMS, x_STMS = self._stms(s), self._stms(d), self._stms(x)
        G = gfunc(mixing.xi(s_STMS, d_STMS), mixing.gamma(x_STMS, d_STMS), self.gain)
        return x_STMS, G, n_frames

    def synthesis_gain(self, G_hat: torch.Tensor, gtype: Optional[str] = None) -> torch.Tensor:
        if self.gain == "ibm":
            return (G_hat > 0.5).to(torch.float32)
        return G_hat

    def enhanced_speech(self, x_STMS, x_STPS, G_hat, gtype: Optional[str] = None):
        return self.polar_synthesis(x_STMS * self.synthesis_gain(G_hat), x_STPS)


@dataclass(frozen=True)
class MagMag(InpTgtBase):
    """STMS input, mapped clean-speech STMS target; synthesis replaces the
    noisy magnitude and keeps its phase."""
    mag_map: Any = None

    out_types = ("y", "mag_hat")
    gain_form = True
    y_per_gain = False

    def with_stats(self, s_sample, d_sample, x_sample, wav_len, device=None) -> "MagMag":
        s = self._stack(self._stms, s_sample, wav_len, self.n_feat, device)
        return replace(self, mag_map=self.mag_map.with_stats(s))

    def example(self, s, d, s_len, d_len, snr, generator=None, offsets=None):
        s, d, x, n_frames = self.mix(s, d, s_len, d_len, snr, generator, offsets)
        return self._stms(x), self.mag_map.map(self._stms(s)), n_frames

    def enhanced_speech(self, x_STMS, x_STPS, tgt_hat, gtype: Optional[str] = None):
        return self.polar_synthesis(self.mag_hat(tgt_hat), x_STPS)

    def spectrum_hat(self, Y, mag, tgt_hat, gtype: Optional[str] = None) -> torch.Tensor:
        """[re || im] with magnitude `mag_hat` and the noisy phase's unit
        vector; where |X| = 0 that vector is (1, 0), as in the JAX package's
        enhancer (the polar route of `enhanced_speech` takes angle(X), which
        is pi where X = -0 + 0j)."""
        nb = self.K // 2 + 1
        re, im = Y[..., :nb], Y[..., nb:]
        safe = mag > 0.0
        inv = torch.where(safe, 1.0 / torch.where(safe, mag, torch.ones_like(mag)),
                          torch.zeros_like(mag))
        u_re = torch.where(safe, re * inv, torch.ones_like(re))
        s_hat = self.mag_hat(tgt_hat)
        return torch.cat([s_hat * u_re, s_hat * (im * inv)], dim=-1)

    def mag_hat(self, tgt_hat: torch.Tensor) -> torch.Tensor:
        return self.mag_map.inverse(tgt_hat)


@dataclass(frozen=True)
class MagSMM(InpTgtBase):
    """STMS input, spectral magnitude mask target |S| / |X| clipped to
    [0, 5] (the denominator floored at 1e-12, so padded frames give 0)."""

    gain_form = gain_synthesis = True

    def example(self, s, d, s_len, d_len, snr, generator=None, offsets=None):
        s, d, x, n_frames = self.mix(s, d, s_len, d_len, snr, generator, offsets)
        s_STMS, x_STMS = self._stms(s), self._stms(x)
        smm = torch.clamp(s_STMS / torch.clamp(x_STMS, min=1e-12), 0.0, 5.0)
        return x_STMS, smm, n_frames

    def synthesis_gain(self, smm_hat: torch.Tensor, gtype: Optional[str] = None):
        return smm_hat

    def enhanced_speech(self, x_STMS, x_STPS, smm_hat, gtype: Optional[str] = None):
        return self.polar_synthesis(smm_hat * x_STMS, x_STPS)


@dataclass(frozen=True)
class MagPhaXiPha(InpTgtBase):
    """[STMS || STPS] input, [xi_bar || mapped clean STPS] target; synthesis
    takes the estimated phase."""
    xi_map: Any = None
    s_stps_map: Any = None

    out_types = ("y", "xi_hat", "ibm_hat", "subband_ibm_hat")
    mag_input = False

    @property
    def n_feat(self) -> int:
        return (self.K // 2 + 1) * 2

    def observation(self, x: torch.Tensor):
        x_STMS, x_STPS = self.polar_analysis(mixing.normalise(x))
        obs = torch.cat([x_STMS, x_STPS], dim=-1)
        return obs, obs

    def with_stats(self, s_sample, d_sample, x_sample, wav_len, device=None) -> "MagPhaXiPha":
        nb = self.K // 2 + 1
        s = self._stack(self._stms, s_sample, wav_len, nb, device)
        d = self._stack(self._stms, d_sample, wav_len, nb, device)
        return replace(self, xi_map=self.xi_map.with_stats(mixing.xi(s, d)))

    def example(self, s, d, s_len, d_len, snr, generator=None, offsets=None):
        s, d, x, n_frames = self.mix(s, d, s_len, d_len, snr, generator, offsets)
        s_STMS, s_STPS = self.polar_analysis(s)
        x_STMS, x_STPS = self.polar_analysis(x)
        xi_bar = self.xi_map.map(mixing.xi(s_STMS, self._stms(d)))
        tgt = torch.cat([xi_bar, self.s_stps_map.map(s_STPS)], dim=-1)
        return torch.cat([x_STMS, x_STPS], dim=-1), tgt, n_frames

    def enhanced_speech(self, x_STMS_STPS, dummy, tgt_hat, gtype: str) -> torch.Tensor:
        x_STMS = _halves(x_STMS_STPS)[0]
        xi_hat = self.xi_hat(tgt_hat)
        y_STMS = x_STMS * gfunc(xi_hat, xi_hat + 1.0, gtype)
        return self.polar_synthesis(y_STMS, self.s_stps_hat(tgt_hat))

    def xi_hat(self, tgt_hat: torch.Tensor) -> torch.Tensor:
        return self.xi_map.inverse(_halves(tgt_hat)[0])

    def s_stps_hat(self, tgt_hat: torch.Tensor) -> torch.Tensor:
        return self.s_stps_map.inverse(_halves(tgt_hat)[1])


@dataclass(frozen=True)
class STDCTXiCD(InpTgtBase):
    """STDCT input, [xi_bar || mapped constructive/destructive term] target;
    synthesis takes the gain dgwf with the estimated cd > 0 mask. The
    inverse STDCT carries tf.signal's 2K scale, which `enhanced_speech`
    divides out (as the JAX package does), so the waveform is at signal
    scale."""
    xi_map: Any = None
    cd_map: Any = None

    out_types = ("y", "xi_hat", "deepmmse", "ibm_hat", "cd_hat")
    mag_input = False

    @property
    def n_feat(self) -> int:
        return self.K

    @property
    def n_outp(self) -> int:
        return self.K * 2

    def _stdct(self, x: torch.Tensor) -> torch.Tensor:
        return stdct_mod.stdct(x, self.N_d, self.N_s, self.K)

    def observation(self, x: torch.Tensor):
        X = self._stdct(mixing.normalise(x))
        return X, X

    def with_stats(self, s_sample, d_sample, x_sample, wav_len, device=None) -> "STDCTXiCD":
        s = self._stack(self._stdct, s_sample, wav_len, self.K, device)
        d = self._stack(self._stdct, d_sample, wav_len, self.K, device)
        return replace(self, xi_map=self.xi_map.with_stats(mixing.xi(s, d)),
                       cd_map=self.cd_map.with_stats(mixing.cd(s, d)))

    def example(self, s, d, s_len, d_len, snr, generator=None, offsets=None):
        s, d, x, n_frames = self.mix(s, d, s_len, d_len, snr, generator, offsets)
        s_X, d_X, x_X = self._stdct(s), self._stdct(d), self._stdct(x)
        tgt = torch.cat([self.xi_map.map(mixing.xi(s_X, d_X)),
                         self.cd_map.map(mixing.cd(s_X, d_X))], dim=-1)
        return x_X, tgt, n_frames

    def enhanced_speech(self, x_STDCT, dummy, tgt_hat, gtype: str) -> torch.Tensor:
        xi_hat = self.xi_hat(tgt_hat)
        cdm_hat = self.cd_hat(tgt_hat) > 0.0
        y = x_STDCT * gfunc(xi_hat, xi_hat + 1.0, gtype, cdm_hat)
        return stdct_mod.inverse_stdct(y, self.N_d, self.N_s, self.K) / (2.0 * self.K)

    def xi_hat(self, tgt_hat: torch.Tensor) -> torch.Tensor:
        return self.xi_map.inverse(_halves(tgt_hat)[0])

    def cd_hat(self, tgt_hat: torch.Tensor) -> torch.Tensor:
        return self.cd_map.inverse(_halves(tgt_hat)[1])


@dataclass(frozen=True)
class MagPhonemes(InpTgtBase):
    """STMS input, per-frame phoneme targets: the one-hot of integer labels
    at the STFT frame rate (`dsp.labels`, through a labelled list and
    loader); a label outside [0, n_phonemes) is an all-zero row. `y` runs
    the classical stack: OM-LSA (gain "omlsa", which reads no network
    output) or MixMax with the network's posteriors (gain "mixmax", given
    a `dsp.mixmax.MixMaxModel`). `pho` writes the posteriors."""
    n_phonemes: int = 98

    out_types = ("y", "pho")

    @property
    def n_outp(self) -> int:
        return self.n_phonemes

    def example(self, s, d, s_len, d_len, snr, generator=None, offsets=None,
                labels: Optional[torch.Tensor] = None):
        """(noisy STMS, one-hot targets [B, T, n_phonemes], frame counts);
        `labels` [B, >= T] int, cut to T frames (all class 0 without)."""
        s, d, x, n_frames = self.mix(s, d, s_len, d_len, snr, generator, offsets)
        x_STMS = self._stms(x)
        T = x_STMS.shape[1]
        if labels is None:
            labels = torch.zeros(x_STMS.shape[:2], dtype=torch.int64, device=x.device)
        classes = torch.arange(self.n_phonemes, device=x.device)
        tgt = (labels[:, :T, None].to(x.device) == classes).to(torch.float32)
        return x_STMS, tgt, n_frames

    def enhanced_speech(self, x_STMS, x_STPS, posteriors, gtype: str = "omlsa",
                        mixmax_model=None):
        """The waveform of OM-LSA on the noisy STMS ("omlsa"), or of MixMax
        of `mixmax_model` with the network's posteriors ("mixmax"), with the
        noisy phase."""
        if gtype == "omlsa":
            from deepxi_tpu_torch.dsp.trackers import omlsa_enhance
            return self.polar_synthesis(omlsa_enhance(x_STMS), x_STPS)
        if gtype == "mixmax":
            if mixmax_model is None:
                raise ValueError("MagPhonemes mixmax synthesis needs a mixmax_model "
                                 "(dsp.mixmax.MixMaxModel)")
            from deepxi_tpu_torch.dsp.mixmax import enhance as mixmax_enhance
            log_mag = torch.log(torch.clamp(x_STMS, min=float(np.finfo(np.float32).eps)))
            x_hat = mixmax_enhance(mixmax_model, log_mag, posteriors=posteriors)
            return self.polar_synthesis(torch.exp(x_hat), x_STPS)
        raise ValueError(f"MagPhonemes gtype must be omlsa|mixmax, got {gtype!r}")


def inp_tgt_selector(inp_tgt_type: str, N_d: int, N_s: int, K: int, f_s: int,
                     **kwargs: Any):
    """A family by name, with its maps from `map_type`/`map_params`: a
    scalar each for the one-map families, two-element lists for the two-map
    ones (MagXiGamma, MagPhaXiPha, STDCTXiCD); MagPhaXiPha's phase map takes
    [-pi, pi] when its params are not given; MagGain takes `gain`,
    MagPhonemes (or "MagPhonme") `Noutp` classes (default 98)."""
    dims = dict(N_d=N_d, N_s=N_s, K=K, f_s=f_s)
    mt, mp = kwargs.get("map_type"), kwargs.get("map_params")
    if isinstance(mt, (list, tuple)) and mp is None:
        mp = [None] * len(mt)
    if inp_tgt_type == "MagXi":
        return MagXi(**dims, xi_map=map_selector(mt, mp))
    if inp_tgt_type == "MagGamma":
        return MagGamma(**dims, gamma_map=map_selector(mt, mp))
    if inp_tgt_type == "MagXiGamma":
        return MagXiGamma(**dims, xi_map=map_selector(mt[0], mp[0]),
                          gamma_map=map_selector(mt[1], mp[1]))
    if inp_tgt_type == "MagGain":
        return MagGain(**dims, gain=kwargs["gain"])
    if inp_tgt_type == "MagMag":
        return MagMag(**dims, mag_map=map_selector(mt, mp))
    if inp_tgt_type == "MagSMM":
        return MagSMM(**dims)
    if inp_tgt_type == "MagPhaXiPha":
        stps_mp = mp[1] if mp[1] is not None else [-np.pi, np.pi]
        return MagPhaXiPha(**dims, xi_map=map_selector(mt[0], mp[0]),
                           s_stps_map=map_selector(mt[1], stps_mp))
    if inp_tgt_type == "STDCTXiCD":
        return STDCTXiCD(**dims, xi_map=map_selector(mt[0], mp[0]),
                         cd_map=map_selector(mt[1], mp[1]))
    if inp_tgt_type in ("MagPhonemes", "MagPhonme"):  # the fork's typo accepted
        return MagPhonemes(**dims, n_phonemes=kwargs.get("Noutp") or 98)
    raise ValueError(f"Invalid inp_tgt type: {inp_tgt_type!r}")
