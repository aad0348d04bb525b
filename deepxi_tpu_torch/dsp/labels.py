"""Forced-alignment label utilities (follows deepxi_tpu/dsp/labels.py; a
JAX-free copy).

Alignment format: blocks of

    <utterance-key>
    <start-sec> <stop-sec> <phoneme>
    ...
    .

Frames are 10 ms by default; `$0` segments are skipped.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Segment = Tuple[float, float, str]


def read_alignment(path: str) -> Dict[str, List[Segment]]:
    """Parse a speech-aligner alignment file into
    {utterance_key: [(start_s, stop_s, phoneme), ...]}."""
    out: Dict[str, List[Segment]] = {}
    cur: Optional[str] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line == ".":
                cur = None
                continue
            parts = line.split()
            if cur is None:
                cur = parts[0]
                out[cur] = []
                continue
            if len(parts) >= 3:
                start, stop, pho = float(parts[0]), float(parts[1]), parts[2]
                if pho == "$0":
                    continue
                out[cur].append((start, stop, pho))
    return out


def frame_labels(segments: Sequence[Segment], n_frames: int,
                 entry2index: Dict[str, int], frame_ms: float = 10.0,
                 fill: str = "sil") -> np.ndarray:
    """Per-frame phoneme token ids from alignment segments.

    A segment [a, b) covers frames ceil(a / frame) .. floor(b / frame),
    the stop frame included; labels not in `entry2index` are skipped and
    uncovered frames take `fill`.
    """
    fill_id = entry2index.get(fill, 0)
    out = np.full(n_frames, fill_id, np.int32)
    per_sec = 1000.0 / frame_ms
    for a, b, pho in segments:
        if pho not in entry2index:
            continue
        f0 = int(math.ceil(a * per_sec))
        f1 = int(math.floor(b * per_sec))
        out[max(f0, 0):min(f1 + 1, n_frames)] = entry2index[pho]
    return out


def one_hot_targets(labels: np.ndarray, n_classes: int) -> np.ndarray:
    """[T, n_classes] float32 one-hot targets (labels clipped to the
    classes)."""
    out = np.zeros((len(labels), n_classes), np.float32)
    idx = np.clip(labels, 0, n_classes - 1)
    out[np.arange(len(labels)), idx] = 1.0
    return out
