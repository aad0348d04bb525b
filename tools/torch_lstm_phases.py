"""Where a frame of the LSTM kernels' time goes, on one card, on each
route of their recurrent product.

    python3 tools/torch_lstm_phases.py      # needs an NVIDIA card

Builds csrc/lstm.cu with -DLSTM_PHASES=1 (its own library beside the plain
build: thread 0 of CTA (0, 0) adds up the %globaltimer ns of each phase of
each frame) and runs the forward and the backward 5 times each after a warm-up,
at reslstm-1.0c's H = 512 and the shapes [3o] times (B=1 T=250, B=8 T=256,
B=32 T=1025), B=16 and B=24 at T=256 (4 and 6 rows a CTA, where the
product routes meet) and B=96 T=626 (make_enhancer's B=96 x 10 s),
all frames valid.
Prints ns a frame for each phase: the forward's staging of h_{t-1}, its
product, the warps' sums (the tensor-core route has none: its cell adds the
K-parts), the cell and the grid barrier; the backward's cell,
CTA barrier after it, product (its partial dh written), the CTA barrier after
it, the row group's barrier (thread 0's arrival, the start of the next
cell's prefetch and thread 0's wait), the CTA barrier after that, the sums
of the group's partials and the wait for the cell's prefetched inputs. The
phases are CTA (0, 0)'s view, its waits at the barrier included; the sum is
the frame's time (the last launch's). The mean CUDA-events time of a launch
is printed beside it, and that of the build without timers.

Both kernels' products run on the tensor cores from a number of rows a CTA
(csrc/lstm.cu: the forward's LSTM_FWD_TC_ROWS, the backward's LSTM_TC_ROWS)
and on FMAs below; two more builds (with and without timers) force each
route (1: the tensor cores at every shape; a large value: FMAs), and each
kernel is timed on each, so that the thresholds rest on a measurement. Each
route's ys and dxp are printed as their distance from the default build's.
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
SHAPES = ((1, 250), (8, 256), (16, 256), (24, 256), (32, 1025), (96, 626))
FORWARD = ("staging", "product", "sums", "cell", "barrier")
BACKWARD = ("cell", "cell sync", "product", "product sync", "group barrier",
            "barrier sync", "sums", "prefetch wait")
# the product routes: the build's own thresholds, then each forced
ROUTES = (("default", {}),
          ("tensor cores", {"LSTM_TC_ROWS": 1, "LSTM_FWD_TC_ROWS": 1}),
          ("FMAs", {"LSTM_TC_ROWS": 1 << 30, "LSTM_FWD_TC_ROWS": 1 << 30}))


def _ms(fn, iters=5) -> float:
    """CUDA-events ms a call, the mean of `iters` after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _use(lib) -> None:
    lstm._lib = lambda: lib  # noqa: E731


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    _build.build([("lstm", {"LSTM_PHASES": 1, **d}) for _, d in ROUTES]
                 + [("lstm", d) if d else "lstm" for _, d in ROUTES])
    timed = {name: _build.load("lstm", {"LSTM_PHASES": 1, **d}) for name, d in ROUTES}
    plain = {name: _build.load("lstm", d) for name, d in ROUTES}
    ns = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda")
    for B, T in SHAPES:
        gen = torch.Generator().manual_seed(B + T)
        xp = (torch.randn(T, B, 4 * H, generator=gen) * 0.5).to(dev)
        w_h = (torch.randn(H, 4 * H, generator=gen) * H ** -0.5).to(dev)
        dys = torch.randn(T, B, H, generator=gen).to(dev)
        mask = torch.ones(T, B, dtype=torch.bool, device=dev)
        _use(plain["default"])
        with torch.no_grad():
            ys_ref, gates, cs = lstm.masked_lstm_train(xp, w_h, mask)
        dxp_ref = None
        for name, _ in ROUTES:
            _use(plain[name])
            plan, plan_b = lstm.kernel_plan(False, B, H), lstm.kernel_plan(True, B, H)
            with torch.no_grad():
                ms_f = _ms(lambda: lstm.masked_lstm(xp, w_h, mask))  # noqa: B023
                ms_b = _ms(lambda: lstm.masked_lstm_backward(dys, gates, cs, w_h, mask))  # noqa: B023,E501
                ys = lstm.masked_lstm(xp, w_h, mask)
                dxp = lstm.masked_lstm_backward(dys, gates, cs, w_h, mask)
            dxp_ref = dxp if dxp_ref is None else dxp_ref
            _use(timed[name])
            with torch.no_grad():
                ms_ft = _ms(lambda: lstm.masked_lstm(xp, w_h, mask))  # noqa: B023
                timed[name].masked_lstm_phases(ns)
                fwd = [ns[i] / T for i in range(len(FORWARD))]
                ms_bt = _ms(lambda: lstm.masked_lstm_backward(dys, gates, cs, w_h, mask))  # noqa: B023,E501
                timed[name].masked_lstm_phases(ns)
                bwd = [ns[8 + i] / T for i in range(len(BACKWARD))]
            rel_f = ((ys - ys_ref).abs().max() / ys_ref.abs().max()).item()
            rel_b = ((dxp - dxp_ref).abs().max() / dxp_ref.abs().max()).item()
            print(f"B={B} T={T} forward ({name}) {ms_f:.4f} ms, with timers {ms_ft:.4f} ms "
                  f"({plan}): ns a frame "
                  + ", ".join(f"{k} {v:.0f}" for k, v in zip(FORWARD, fwd))
                  + f"; sum {sum(fwd):.0f}; ys within {rel_f:.2e} of the default's; {card}")
            print(f"B={B} T={T} backward ({name}) {ms_b:.4f} ms, with timers {ms_bt:.4f} ms "
                  f"({plan_b}): ns a frame "
                  + ", ".join(f"{k} {v:.0f}" for k, v in zip(BACKWARD, bwd))
                  + f"; sum {sum(bwd):.0f}; dxp within {rel_b:.2e} of the default's; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
