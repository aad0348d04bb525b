"""Host-side training batch loader: wav reads and bucketed padding
(follows deepxi_tpu/data/loader.py, on its Python decode path).

Shuffles and noise draws come from a seeded ``np.random.Generator`` in the
JAX package's order, so one seed and file list give the same batches in
both packages. Batches are read in the caller's thread (no prefetch).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from deepxi_tpu_torch.data.wavio import read_wav


# Buckets of padded lengths: multiples of 32 frames, at least 32.
_BUCKET_FRAMES = 32


def bucket_length(n: int, N_s: int = 256) -> int:
    """Pad length: the frame count rounded up to a multiple of 32 frames (at
    least 32), back in samples."""
    frames = -(-n // N_s)
    return max(_BUCKET_FRAMES, -(-frames // _BUCKET_FRAMES) * _BUCKET_FRAMES) * N_s


class MiniBatchLoader:
    """Yields (s, d, s_len, d_len, snr) int16/int32/float32 host batches.

    Per epoch the clean list is shuffled; for each utterance a noise file at
    least as long is drawn uniformly, then a random crop of it to the padded
    length, and an SNR from the training levels. The noise segment offset
    within the crop is drawn later, in `sig.mix.add_noise_batch`."""

    def __init__(self, train_s_list: List[Dict], train_d_list: List[Dict],
                 mbatch_size: int, snr_levels: List[int], seed: int = 0,
                 N_s: int = 256):
        self.s_list = list(train_s_list)
        self.d_list = list(train_d_list)
        self.mbatch_size = mbatch_size
        self.snr_levels = list(snr_levels)
        self.rng = np.random.default_rng(seed)
        self.N_s = N_s
        self.n_examples = len(self.s_list)
        self.n_iter = -(-self.n_examples // mbatch_size)

    def _load_batch(self, s_items: List[Dict]) -> Tuple[np.ndarray, ...]:
        B = len(s_items)
        L = bucket_length(max(it["wav_len"] for it in s_items), self.N_s)
        s = np.zeros((B, L), np.int16)
        d = np.zeros((B, L), np.int16)
        s_len = np.zeros(B, np.int32)
        d_len = np.zeros(B, np.int32)
        d_items = []
        for i, item in enumerate(s_items):
            n = min(item["wav_len"], L)
            s_len[i] = n
            eligible = [it for it in self.d_list if it["wav_len"] >= n]
            if not eligible:
                longest = max(it["wav_len"] for it in self.d_list)
                raise ValueError(
                    f"no noise file is >= {n} samples (longest available: "
                    f"{longest}); speech {item['file_path']!r} cannot be mixed")
            d_item = eligible[self.rng.integers(len(eligible))]
            dn = d_item["wav_len"]
            off = int(self.rng.integers(0, dn - L + 1)) if dn > L else 0
            d_items.append((d_item["file_path"], off))
            d_len[i] = min(dn, L)
        for i, item in enumerate(s_items):
            wav = read_wav(item["file_path"])[0][:L]
            s[i, :len(wav)] = wav
        for i, (path, off) in enumerate(d_items):
            wav = read_wav(path)[0][off:off + L]
            d[i, :len(wav)] = wav
        snr = self.rng.choice(self.snr_levels, B).astype(np.float32)
        return s, d, s_len, d_len, snr

    def epoch(self, epoch_idx: int) -> Iterator[Tuple[np.ndarray, ...]]:
        """One epoch of mini-batches. Items shuffle globally, then sort by
        length within chunks of 8 mini-batches whose order is shuffled."""
        order = self.rng.permutation(self.n_examples)
        items = [self.s_list[i] for i in order]
        chunk = self.mbatch_size * 8
        chunks = [sorted(items[i:i + chunk], key=lambda it: it["wav_len"])
                  for i in range(0, len(items), chunk)]
        self.rng.shuffle(chunks)
        items = [it for c in chunks for it in c]
        for i in range(self.n_iter):
            batch = items[i * self.mbatch_size:(i + 1) * self.mbatch_size]
            if not batch:
                break
            yield self._load_batch(batch)
