"""Input/target families (follows deepxi_tpu/inp_tgt.py; so far `MagXi`,
the published Deep Xi target: STMS input, mapped a priori SNR target)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from deepxi_tpu_torch.ops.gains import gfunc
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.sig import mix as mixing
from deepxi_tpu_torch.sig import stft


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


@dataclass(frozen=True)
class MagXi:
    """Analysis/synthesis framing plus the xi map; the map's statistics are
    tensors on the device the family is used on. `f_s` is the sampling rate
    the framing is for (wavs are read at it)."""
    N_d: int = 512
    N_s: int = 256
    K: int = 512
    xi_map: NormalCDF = None
    f_s: int = 16000

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
        """Noisy-speech STMS and STPS of an int16 waveform."""
        return self.polar_analysis(mixing.normalise(x))

    def _stms(self, w: torch.Tensor) -> torch.Tensor:
        return self.polar_analysis(w)[0]

    def mix(self, s, d, s_len, d_len, snr,
            generator: Optional[torch.Generator] = None,
            offsets: Optional[torch.Tensor] = None):
        """(s, d, x, n_frames) of int16 [B, L] speech and noise mixed at
        `snr` dB; the noise offsets are `offsets`, or drawn on the host from
        `generator` (see `sig.mix.noise_offsets`)."""
        return mixing.mix(s, d, s_len, d_len, snr, self.N_s, generator, offsets)

    def with_stats(self, s_sample: np.ndarray, d_sample: np.ndarray,
                   x_sample: np.ndarray, wav_len: np.ndarray,
                   device=None) -> "MagXi":
        """Fit the xi map's statistics on the valid frames of a training
        sample ([N, L] float waveforms), computed on `device`."""
        s = _stack_valid_frames(self._stms, s_sample, wav_len, self.n_feat,
                                self.N_s, device=device)
        d = _stack_valid_frames(self._stms, d_sample, wav_len, self.n_feat,
                                self.N_s, device=device)
        return replace(self, xi_map=self.xi_map.with_stats(mixing.xi(s, d)))

    def example(self, s, d, s_len, d_len, snr,
                generator: Optional[torch.Generator] = None,
                offsets: Optional[torch.Tensor] = None):
        """Training pair from int16 [B, L] speech and noise: (noisy STMS,
        mapped xi target, frame counts)."""
        s, d, x, n_frames = self.mix(s, d, s_len, d_len, snr, generator, offsets)
        xi_bar = self.xi_map.map(mixing.xi(self._stms(s), self._stms(d)))
        return self._stms(x), xi_bar, n_frames

    def enhanced_speech(self, x_STMS: torch.Tensor, x_STPS: torch.Tensor,
                        xi_bar_hat: torch.Tensor, gtype: str) -> torch.Tensor:
        """Waveform of the gain `gtype` applied to the noisy STMS, with the
        noisy phase."""
        xi_hat = self.xi_hat(xi_bar_hat)
        return self.polar_synthesis(x_STMS * gfunc(xi_hat, xi_hat + 1.0, gtype), x_STPS)

    def xi_hat(self, xi_bar_hat: torch.Tensor) -> torch.Tensor:
        """A priori SNR estimate from the network output."""
        return self.xi_map.inverse(xi_bar_hat)

    def gamma_hat(self, xi_bar_hat: torch.Tensor) -> torch.Tensor:
        """ML a posteriori SNR estimate xi_hat + 1."""
        return self.xi_map.inverse(xi_bar_hat) + 1.0
