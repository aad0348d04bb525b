"""Where a frame of the LSTM kernels' time goes, on one card.

    python3 tools/torch_lstm_phases.py      # needs an NVIDIA card

Builds csrc/lstm.cu with -DLSTM_PHASES=1 (its own library beside the plain
build: thread 0 of CTA (0, 0) adds up the %globaltimer ns of each phase of
each frame) and runs the forward and the backward once each, after a warm-up,
at reslstm-1.0c's H = 512 and the shapes [3o] times (B=1 T=250, B=8 T=256,
B=32 T=1025) and B=96 T=626 (make_enhancer's B=96 x 10 s), all frames valid.
Prints ns a frame for each phase: the forward's staging of h_{t-1}, its
product, the warps' sums, the cell and the grid barrier; the backward's cell,
barrier, staging of dz_t, product and sums. The phases are CTA (0, 0)'s view,
its waits at the barrier included; the sum is the frame's time. Each launch's
CUDA-events time is printed beside it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from deepxi_tpu_torch.ops.kernels import _build, lstm  # noqa: E402

H = 512
SHAPES = ((1, 250), (8, 256), (32, 1025), (96, 626))
FORWARD = ("staging", "product", "sums", "cell", "barrier")
BACKWARD = ("cell", "barrier", "staging", "product", "sums")


def _ms(fn) -> float:
    """CUDA-events ms of one call after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    lib = lstm.bind(_build.load("lstm", {"LSTM_PHASES": 1}))
    lib.masked_lstm_phases.argtypes = [ctypes.c_void_p]
    lib.masked_lstm_phases.restype = ctypes.c_int
    lstm._lib = lambda: lib
    ns = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda")
    for B, T in SHAPES:
        gen = torch.Generator().manual_seed(B + T)
        xp = (torch.randn(T, B, 4 * H, generator=gen) * 0.5).to(dev)
        w_h = (torch.randn(H, 4 * H, generator=gen) * H ** -0.5).to(dev)
        dys = torch.randn(T, B, H, generator=gen).to(dev)
        mask = torch.ones(T, B, dtype=torch.bool, device=dev)
        with torch.no_grad():
            _, gates, cs = lstm.masked_lstm_train(xp, w_h, mask)
            ms = _ms(lambda: lstm.masked_lstm(xp, w_h, mask))  # noqa: B023
            lib.masked_lstm_phases(ns)
            fwd = [ns[i] / T for i in range(5)]
            ms_b = _ms(lambda: lstm.masked_lstm_backward(dys, gates, cs, w_h, mask))  # noqa: B023
            lib.masked_lstm_phases(ns)
            bwd = [ns[8 + i] / T for i in range(5)]
        plan, plan_b = lstm.kernel_plan(False, B, H), lstm.kernel_plan(True, B, H)
        print(f"B={B} T={T} forward {ms:.4f} ms ({plan}): ns a frame "
              + ", ".join(f"{k} {v:.0f}" for k, v in zip(FORWARD, fwd))
              + f"; sum {sum(fwd):.0f}; {card}")
        print(f"B={B} T={T} backward {ms_b:.4f} ms ({plan_b}): ns a frame "
              + ", ".join(f"{k} {v:.0f}" for k, v in zip(BACKWARD, bwd))
              + f"; sum {sum(bwd):.0f}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
