"""Parallel per-utterance objective scoring (follows
deepxi_tpu/metrics/scoring.py).

The reference scores utterances serially on the host inside DeepXi.test
(ref: deepxi/model.py:1834-1861); with the full composite suite
(STOI/eSTOI/PESQ-nb/PESQ-wb/LLR/WSS/SegSNR) each utterance costs ~1-2 s of
pure NumPy, which would dominate any parity campaign's wall-clock. The
metrics are numpy/scipy only, so scoring fans out over a multiprocessing
pool of spawned workers: a forked worker would inherit the parent's CUDA
context, and a spawned one touches no card (importing the package imports
torch but initialises no CUDA).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def score_utterance(s: np.ndarray, y: np.ndarray, fs: int) -> Dict[str, float]:
    """All objective metrics of one enhanced utterance vs its clean
    reference: the reference's in-loop metrics (STOI/eSTOI/PESQ/MOS-LQO,
    ref: deepxi/model.py:1854-1861) plus the DEMAND-VB composite suite
    (ref: demand_voice_bank_objective_scoring/objective_scoring.m:45-48)."""
    from deepxi_tpu_torch.metrics import composite, stoi
    from deepxi_tpu_torch.metrics.pesq import pesq

    out: Dict[str, float] = {}
    for key, extended in (("STOI", False), ("eSTOI", True)):
        try:
            out[key] = 100.0 * stoi(s, y, fs, extended=extended)
        except ValueError as exc:  # utterance too short for STOI framing
            import warnings
            warnings.warn(f"{key} unavailable for a {len(s)}-sample "
                          f"utterance: {exc}")
    try:
        pesq_nb = pesq(s, y, fs, mode="nb")
        out["MOS-LQO"] = pesq(s, y, fs, mode="wb")
    except ValueError as exc:  # silent/degenerate signal: P.862 undefined
        import warnings
        warnings.warn(f"PESQ unavailable for an utterance: {exc}")
        pesq_nb = float("nan")  # NaN propagates through the PESQ-derived
        # composites (CSIG/CBAK/COVL); the pure signal metrics
        # (SegSNR/SNR/LLR/WSS) still score and NaNs are dropped below
    comp = composite(s, y, fs, pesq_mos=pesq_nb)
    for m in ("PESQ", "CSIG", "CBAK", "COVL", "SegSNR", "SNR"):
        if np.isfinite(comp[m]):
            out[m] = comp[m]
    return out


def _worker(args: Tuple[np.ndarray, np.ndarray, int]) -> Dict[str, float]:
    return score_utterance(*args)


def score_many(pairs: Sequence[Tuple[np.ndarray, np.ndarray]], fs: int,
               n_workers: int = 0) -> List[Dict[str, float]]:
    """Score (clean, enhanced) pairs, fanned out over processes.

    n_workers: 0 -> min(cpu_count, len(pairs)); 1 -> serial (in-process).
    """
    pairs = list(pairs)
    if n_workers == 0:
        n_workers = min(os.cpu_count() or 1, len(pairs))
    if n_workers <= 1 or len(pairs) <= 1:
        return [score_utterance(s, y, fs) for s, y in pairs]
    import multiprocessing as mp
    # spawn: workers re-import only numpy/scipy-backed modules and never
    # inherit the parent's CUDA context
    ctx = mp.get_context("spawn")
    with ctx.Pool(n_workers) as pool:
        return pool.map(_worker, [(s, y, fs) for s, y in pairs])
