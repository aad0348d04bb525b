"""Spectral transforms as matrix products (follows
deepxi_tpu/ops/kernels/spectral.py).

At K=512 the windowed real DFT is a [*, 512] x [512, 514] product and the
inverse DFT, with the COLA synthesis window folded in, a [*, 514] x [514, 512]
product. `stft_reim`, `stft_mag` and `synthesis_from_reim` leave them to
`torch.matmul`, as the JAX package leaves them to XLA.

Two CUDA kernels for Hopper (`csrc/spectral.cu`) replace the module's two
Pallas kernels. Each computes its plain version's function with an FFT a
frame in shared memory, reading the window and a twiddle table instead of
the DFT matrices:

  * `stft_mag_fused` (`stft_mag_pallas`): hop rows [B, T+1, N_s] to |X|
    [B, T, K/2+1]; frames are built from two hop rows in shared memory and
    only the magnitudes reach device memory. The port's ξ̂ estimator
    (`enhance.make_xi_estimator`) takes its |X| from it.
  * `enhance_frames_fused` (`enhance_frames_pallas`): the gain times
    [re || im], then the inverse DFT: synthesis frames [B, T, N_d],
    overlap-added outside (`sig.stft.overlap_and_add`).

Each wrapper launches its kernel for a CUDA tensor and takes its plain
version (`*_ref`, the matrix products: the definition) for a CPU tensor;
each has a plain-integer `launches` counter and, like `pallas_call`, no
backward. Both take N_d = 2 N_s (they read the hop-row layout) and K a
power of two with N_d <= K and 64 <= K <= 4096 (every K `Config.K` gives),
on every device: `kernel_takes`. A framing outside it takes the matrix
products, chosen by the callers (`enhance`) from (N_d, N_s, K) before any
launch, as the JAX package's `stft_mag` is always the product.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from deepxi_tpu_torch.ops.kernels import _build, refuse_autograd
from deepxi_tpu_torch.sig.stft import (_hamming_np, _synthesis_window_np,
                                       frame, overlap_and_add)


@functools.lru_cache(maxsize=None)
def _analysis_matrix(N_d: int, K: int) -> np.ndarray:
    """[N_d, 2*(K//2+1)] windowed real-DFT matrix: frames @ M = [re || im]
    of the Hamming-windowed rFFT."""
    w = _hamming_np(N_d).astype(np.float64)
    n = np.arange(N_d)[:, None]
    k = np.arange(K // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / K
    return np.concatenate([np.cos(ang) * w[:, None], np.sin(ang) * w[:, None]],
                          axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _synthesis_matrix(N_d: int, N_s: int, K: int) -> np.ndarray:
    """[2*(K//2+1), N_d] inverse real-DFT matrix with the COLA synthesis
    window folded in: frames = [re || im] @ M."""
    nb = K // 2 + 1
    k = np.arange(nb)[:, None]
    n = np.arange(K)[None, :]
    ang = 2.0 * np.pi * k * n / K
    # irfft: x[n] = (1/K)[X0 + 2 sum_{k=1}^{K/2-1}(re_k cos - im_k sin) + re_{K/2} cos(pi n)]
    scale = np.full((nb, 1), 2.0)
    scale[0, 0] = 1.0
    scale[-1, 0] = 1.0
    M = np.concatenate([np.cos(ang) * scale / K, -np.sin(ang) * scale / K],
                       axis=0)[:, :N_d]
    w_syn = _synthesis_window_np(N_d, N_s).astype(np.float64)
    return (M * w_syn[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddles(K: int) -> np.ndarray:
    """[K/2+1, 2] (cos, sin) of e^{-2 pi i j / K}, j = 0 .. K/2: the FFT
    kernels' twiddle table (float64, then cast)."""
    ang = -2.0 * np.pi * np.arange(K // 2 + 1) / K
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


_TABLES = {"analysis": _analysis_matrix, "synthesis": _synthesis_matrix,
           "hamming": _hamming_np, "synthesis_window": _synthesis_window_np,
           "twiddles": _twiddles}


_DEVICE_TABLES: Dict[Tuple[str, tuple, torch.device], torch.Tensor] = {}


def _on_device(name: str, args: tuple, device: torch.device) -> torch.Tensor:
    """One device copy of a host table per (table, arguments, device). A
    table first made under a trace (a fake tensor) is not kept."""
    key = (name, args, device)
    if key not in _DEVICE_TABLES:
        table = torch.as_tensor(_TABLES[name](*args), device=device)
        if type(table) is not torch.Tensor:
            return table
        _DEVICE_TABLES[key] = table
    return _DEVICE_TABLES[key]


def dft_tables(N_d: int, N_s: int, K: int, device) -> None:
    """Make the analysis and synthesis products' matrices on `device` now,
    outside any trace, under the key a tensor's own device gives (with its
    index): a trace (`torch.export`) then takes them as constants."""
    device = torch.empty(0, device=device).device
    _on_device("analysis", (N_d, K), device)
    _on_device("synthesis", (N_d, N_s, K), device)


def stft_reim(x: torch.Tensor, N_d: int, N_s: int, K: int) -> torch.Tensor:
    """[..., T, 2*(K//2+1)] = [re || im] of the windowed STFT."""
    fr = frame(x, N_d, N_s)
    return torch.matmul(fr, _on_device("analysis", (N_d, K), x.device))


def _magnitude(Y: torch.Tensor, K: int) -> torch.Tensor:
    """|X| of a [re || im] spectrum."""
    nb = K // 2 + 1
    re, im = Y[..., :nb], Y[..., nb:]
    return torch.sqrt(re * re + im * im)


def stft_mag(x: torch.Tensor, N_d: int, N_s: int, K: int) -> torch.Tensor:
    """Short-time magnitude spectrum via the matmul DFT."""
    return _magnitude(stft_reim(x, N_d, N_s, K), K)


def _synthesis_frames(Y: torch.Tensor, N_d: int, N_s: int,
                      K: int) -> torch.Tensor:
    """Synthesis frames [..., T, N_d] of [re || im] spectra: the inverse-DFT
    product with the COLA window folded in."""
    return torch.matmul(Y, _on_device("synthesis", (N_d, N_s, K), Y.device))


def synthesis_from_reim(Y: torch.Tensor, N_d: int, N_s: int,
                        K: int) -> torch.Tensor:
    """Waveform from [re || im] spectra: inverse-DFT product + overlap-add."""
    return overlap_and_add(_synthesis_frames(Y, N_d, N_s, K), N_s)


def apply_gain_reim(Y: torch.Tensor, G: torch.Tensor, K: int) -> torch.Tensor:
    """Multiply a real gain into a [re || im] spectrum (commutes with the
    polar decomposition, so equals |X| G exp(j angle X))."""
    nb = K // 2 + 1
    return torch.cat([Y[..., :nb] * G, Y[..., nb:] * G], dim=-1)


def stft_mag_fused_ref(x2d: torch.Tensor, N_d: int, K: int) -> torch.Tensor:
    """Plain version of `stft_mag_fused`: frames from consecutive hop rows,
    the windowed-DFT product, the magnitude."""
    fr = torch.cat([x2d[..., :-1, :], x2d[..., 1:, :]], dim=-1)
    return _magnitude(torch.matmul(fr, _on_device("analysis", (N_d, K), x2d.device)), K)


def gained_frames(Y: torch.Tensor, G: torch.Tensor, N_d: int, N_s: int,
                  K: int) -> torch.Tensor:
    """Synthesis frames [..., T, N_d] of a real gain G on [re || im] spectra
    Y at any framing: the gain into both halves, then the inverse-DFT
    product."""
    return _synthesis_frames(apply_gain_reim(Y, G, K), N_d, N_s, K)


def enhance_frames_fused_ref(Y: torch.Tensor, G: torch.Tensor, N_d: int,
                             N_s: int, K: int) -> torch.Tensor:
    """Plain version of `enhance_frames_fused`: `gained_frames`."""
    return gained_frames(Y, G, N_d, N_s, K)


def _check(x: torch.Tensor, shape: tuple, what: str) -> None:
    """Raise unless x is a float32 tensor of `shape` (None: any size)."""
    if (x.dtype != torch.float32 or x.dim() != len(shape)
            or any(n is not None and n != m for n, m in zip(shape, x.shape))):
        want = "[" + ", ".join("*" if n is None else str(n) for n in shape) + "]"
        raise ValueError(f"{what} must be a float32 {want} tensor, not "
                         f"{tuple(x.shape)} {x.dtype}")


def kernel_takes(N_d: int, N_s: int, K: int) -> bool:
    """Whether the spectral kernels take a framing: N_d = 2 N_s, and K a
    power of two with N_d <= K and 64 <= K <= 4096."""
    return N_d == 2 * N_s and 64 <= K <= 4096 and K & (K - 1) == 0 and N_d <= K


def _check_domain(N_d: int, N_s: int, K: int) -> None:
    """`kernel_takes`, held on every device."""
    if not kernel_takes(N_d, N_s, K):
        raise ValueError(f"the spectral kernels take N_d = 2 N_s and K a power of two "
                         f"in [64, 4096] with N_d <= K, not N_d {N_d}, N_s {N_s}, K {K}")


def _check_card(tensors) -> None:
    """What the kernels need beyond the function's shapes: contiguous
    tensors on one device."""
    for t in tensors:
        if not t.is_contiguous() or t.device != tensors[0].device:
            raise ValueError("the spectral kernels take contiguous tensors on one device")


# Complex points a CTA of the spectral kernels takes where the frames allow
# (4 frames at K = 512; its buffers hold 2048): on the H100, faster than
# twice as many at B=96 T=625 (chip_smoke.py times both; PERF.md).
CTA_POINTS = 1024


def _frames_per_cta(ctas, K: int, device: torch.device) -> int:
    """Frames a CTA takes: CTA_POINTS worth (one at K >= 2048), halved
    while `ctas(F)` would leave an SM without a CTA, so that short batches
    spread over the card."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    F = max(1, CTA_POINTS // (K // 2))
    while F > 1 and ctas(F) < n_sm:
        F //= 2
    return F


def stft_mag_fused(x2d: torch.Tensor, N_d: int, K: int) -> torch.Tensor:
    """Magnitude spectrum [B, T, K/2+1] of hop rows x2d [B, T+1, N_s] with
    N_d = 2 N_s (`sig.stft.hop_rows` of a waveform): frame, window, real FFT
    of length K and |X| in one kernel (replaces `stft_mag_pallas`)."""
    refuse_autograd([x2d], "stft_mag_fused")
    _check(x2d, (None, None, N_d // 2), "x2d")
    _check_domain(N_d, x2d.shape[2], K)
    if x2d.shape[1] < 2:
        raise ValueError("x2d needs T+1 >= 2 hop rows")
    if x2d.device.type == "cpu":
        return stft_mag_fused_ref(x2d, N_d, K)
    B, T, N_s = x2d.shape[0], x2d.shape[1] - 1, x2d.shape[2]
    win = _on_device("hamming", (N_d,), x2d.device)
    tw = _on_device("twiddles", (K,), x2d.device)
    _check_card([x2d, win, tw])
    out = torch.empty(B, T, K // 2 + 1, device=x2d.device)
    lib = _build.load("spectral")
    F = _frames_per_cta(lambda F: B * -(-T // F), K, x2d.device)
    with torch.cuda.device(x2d.device):
        _build.check(lib, lib.stft_mag_forward(
            x2d.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(), B, T, N_s,
            K, F, torch.cuda.current_stream().cuda_stream), "stft_mag_forward")
    stft_mag_fused.launches += 1
    return out


stft_mag_fused.launches = 0


def enhance_frames_fused(Y: torch.Tensor, G: torch.Tensor, N_d: int, N_s: int,
                         K: int) -> torch.Tensor:
    """Synthesis frames [B, T, N_d] of the gain G [B, T, K/2+1] times the
    spectrum Y = [re || im] [B, T, 2(K/2+1)]: the gain product, the inverse
    real FFT of length K and the synthesis window in one kernel (replaces
    `enhance_frames_pallas`); overlap-add them with
    `sig.stft.overlap_and_add`."""
    refuse_autograd([Y, G], "enhance_frames_fused")
    _check_domain(N_d, N_s, K)
    nb = K // 2 + 1
    _check(Y, (None, None, 2 * nb), "Y")
    _check(G, (Y.shape[0], Y.shape[1], nb), "G")
    if Y.device.type == "cpu":
        return enhance_frames_fused_ref(Y, G, N_d, N_s, K)
    B, T = Y.shape[:2]
    wsyn = _on_device("synthesis_window", (N_d, N_s), Y.device)
    tw = _on_device("twiddles", (K,), Y.device)
    _check_card([Y, G, wsyn, tw])
    out = torch.empty(B, T, N_d, device=Y.device)
    lib = _build.load("spectral")
    F = _frames_per_cta(lambda F: -(-B * T // F), K, Y.device)
    with torch.cuda.device(Y.device):
        _build.check(lib, lib.enhance_frames_forward(
            Y.data_ptr(), G.data_ptr(), wsyn.data_ptr(), tw.data_ptr(), out.data_ptr(),
            B * T, N_d, K, F, torch.cuda.current_stream().cuda_stream),
            "enhance_frames_forward")
    enhance_frames_fused.launches += 1
    return out


enhance_frames_fused.launches = 0
