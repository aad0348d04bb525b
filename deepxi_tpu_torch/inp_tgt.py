"""Input/target families (follows deepxi_tpu/inp_tgt.py; so far `MagXi`,
the published Deep Xi target: STMS input, mapped a priori SNR target)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.sig import mix as mixing
from deepxi_tpu_torch.sig.stft import polar_analysis


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
    tensors on the device the family is used on."""
    N_d: int = 512
    N_s: int = 256
    K: int = 512
    xi_map: NormalCDF = None

    @property
    def n_feat(self) -> int:
        return self.K // 2 + 1

    @property
    def n_outp(self) -> int:
        return self.n_feat

    def _stms(self, w: torch.Tensor) -> torch.Tensor:
        return polar_analysis(w, self.N_d, self.N_s, self.K)[0]

    def mix(self, s, d, s_len, d_len, snr,
            generator: Optional[torch.Generator] = None,
            offsets: Optional[torch.Tensor] = None):
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

    def xi_hat(self, xi_bar_hat: torch.Tensor) -> torch.Tensor:
        """A priori SNR estimate from the network output."""
        return self.xi_map.inverse(xi_bar_hat)
