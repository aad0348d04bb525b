"""Host-side training batch loader: wav reads, bucketed padding and a
prefetch thread (follows deepxi_tpu/data/loader.py).

Shuffles and noise draws come from a seeded ``np.random.Generator`` in the
JAX package's order, so one seed and file list give the same batches in
both packages. A background thread reads up to `prefetch` batches ahead of
the train step: a batch's speech rows, then its noise rows at their
offsets, decoded straight into the batch buffers by the native decoder's
thread pool (`native.load_batch`), each row it does not take by
`read_wav`, so the batches are the same with native off. Where a read
raises, the worker hands the exception to the consumer, which raises it
(the JAX package's worker ends the epoch early without a word).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Tuple

import numpy as np

from deepxi_tpu_torch import native
from deepxi_tpu_torch.data.wavio import read_wav


def bucket_length(n: int, N_s: int = 256, frames_per_bucket: int = 32,
                  min_frames: int = 32) -> int:
    """Pad length: the frame count rounded up to a multiple of
    `frames_per_bucket` (at least `min_frames`), back in samples."""
    frames = -(-n // N_s)
    return max(min_frames, -(-frames // frames_per_bucket) * frames_per_bucket) * N_s


def _decode_rows(paths: List[str], offsets: List[int], out: np.ndarray) -> None:
    """Fill out[i] with paths[i] decoded from offsets[i], cut at out's
    length and zero-padded: natively, and each row the native decoder does
    not take through `read_wav` (which raises on a file it cannot read)."""
    L = out.shape[1]
    res = native.load_batch(paths, L, offsets=offsets, out=out)
    rows = range(len(paths)) if res is None else np.flatnonzero(res[2])
    for i in rows:
        wav = read_wav(paths[i])[0][offsets[i]:offsets[i] + L]
        out[i, :len(wav)] = wav
        out[i, len(wav):] = 0


class _Failed:
    """A worker's exception, carried to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class MiniBatchLoader:
    """Yields (s, d, s_len, d_len, snr) int16/int32/float32 host batches,
    and where every item of a batch has `labels` (as a `batch_list_labelled`
    list's do) a sixth, the labels [B, L / N_s] int32 at the frame rate,
    zero past each list's labels.

    Per epoch the clean list is shuffled; for each utterance a noise file at
    least as long is drawn uniformly, then a random crop of it to the padded
    length, and an SNR from the training levels. The noise segment offset
    within the crop is drawn later, in `sig.mix.add_noise_batch`."""

    def __init__(self, train_s_list: List[Dict], train_d_list: List[Dict],
                 mbatch_size: int, snr_levels: List[int], seed: int = 0,
                 N_s: int = 256, frames_per_bucket: int = 32, prefetch: int = 4):
        self.s_list = list(train_s_list)
        self.d_list = list(train_d_list)
        self.mbatch_size = mbatch_size
        self.snr_levels = list(snr_levels)
        self.rng = np.random.default_rng(seed)
        self.N_s = N_s
        self.frames_per_bucket = frames_per_bucket
        self.prefetch = prefetch
        self.n_examples = len(self.s_list)
        self.n_iter = -(-self.n_examples // mbatch_size)

    def _load_batch(self, s_items: List[Dict]) -> Tuple[np.ndarray, ...]:
        B = len(s_items)
        L = bucket_length(max(it["wav_len"] for it in s_items), self.N_s,
                          self.frames_per_bucket)
        s = np.zeros((B, L), np.int16)
        d = np.zeros((B, L), np.int16)
        s_len = np.zeros(B, np.int32)
        d_len = np.zeros(B, np.int32)
        labelled = all("labels" in it for it in s_items)
        labels = np.zeros((B, L // self.N_s), np.int32) if labelled else None
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
            if labelled:
                lab = item["labels"][:labels.shape[1]]
                labels[i, :len(lab)] = lab
        _decode_rows([it["file_path"] for it in s_items], [0] * B, s)
        _decode_rows([p for p, _ in d_items], [off for _, off in d_items], d)
        snr = self.rng.choice(self.snr_levels, B).astype(np.float32)
        if labelled:
            return s, d, s_len, d_len, snr, labels
        return s, d, s_len, d_len, snr

    def epoch(self, epoch_idx: int) -> Iterator[Tuple[np.ndarray, ...]]:
        """One epoch of mini-batches, read on a background thread. Items
        shuffle globally, then sort by length within chunks of 8
        mini-batches whose order is shuffled. A read that raises ends the
        epoch with that exception in the consumer."""
        order = self.rng.permutation(self.n_examples)
        items = [self.s_list[i] for i in order]
        chunk = self.mbatch_size * 8
        chunks = [sorted(items[i:i + chunk], key=lambda it: it["wav_len"])
                  for i in range(0, len(items), chunk)]
        self.rng.shuffle(chunks)
        items = [it for c in chunks for it in c]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def put(v) -> bool:
            """Queue v unless the consumer has gone; whether it went in."""
            while not stop.is_set():
                try:
                    q.put(v, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for i in range(self.n_iter):
                    batch = items[i * self.mbatch_size:(i + 1) * self.mbatch_size]
                    if not batch or not put(self._load_batch(batch)):
                        break
            except BaseException as e:  # noqa: BLE001 -- raised in the consumer
                put(_Failed(e))
                return
            put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is done:
                    break
                if isinstance(b, _Failed):
                    raise b.error
                yield b
        finally:
            stop.set()
            t.join()
