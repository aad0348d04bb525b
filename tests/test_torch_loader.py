"""The training loader with its prefetch thread
(`deepxi_tpu_torch.data.loader`) against the JAX package's
(`deepxi_tpu.data.loader`) on the CPU: the same lists and seed give the
same batches in the same order, bitwise, over epochs, with the chunk-local
length-sorted order and other buckets (`frames_per_bucket`); a read that
fails raises in the port's consumer, where the JAX worker ends the epoch
early without a word (ROADMAP queue C); a consumer that stops early leaves
no worker behind."""

import os
import sys
import threading

import numpy as np
import pytest

from deepxi_tpu.data import MiniBatchLoader as MiniBatchLoaderJ
from deepxi_tpu.data.loader import bucket_length as bucket_length_j
from deepxi_tpu_torch.data.listing import batch_list
from deepxi_tpu_torch.data.loader import MiniBatchLoader, bucket_length
from deepxi_tpu_torch.data.wavio import save_wav

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from synth_corpus import synth_noise, synth_utterance  # noqa: E402


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    """11 clean utterances of 0.3-1.2 s and 3 noise clips of 3 s."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    for i in range(11):
        save_wav(str(root / "s" / f"sp{i}.wav"),
                 synth_utterance(rng, 0.3 + 0.09 * i), 16000)
    for j in range(3):
        save_wav(str(root / "d" / f"n{j}.wav"), synth_noise(rng, "white", 3.0), 16000)
    return (batch_list(str(root / "s"), "clean", str(root / "data")),
            batch_list(str(root / "d"), "noise", str(root / "data")))


def _equal(batches, batches_j, n=5):
    assert len(batches) == len(batches_j)
    for b, b_j in zip(batches, batches_j):
        assert len(b) == len(b_j) == n
        for u, v in zip(b, b_j):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("mbatch_size,frames_per_bucket,prefetch",
                         [(2, 32, 4), (3, 8, 1), (1, 4, 2)])
def test_batches_match_jax(lists, mbatch_size, frames_per_bucket, prefetch):
    """Three epochs: the same shuffles, noise draws, crops, SNRs and
    padded lengths as the JAX loader's."""
    s_list, d_list = lists
    kw = dict(seed=7, N_s=256, frames_per_bucket=frames_per_bucket, prefetch=prefetch)
    a = MiniBatchLoader(s_list, d_list, mbatch_size, [-5, 0, 5, 10], **kw)
    b = MiniBatchLoaderJ(s_list, d_list, mbatch_size, [-5, 0, 5, 10], **kw)
    for epoch in range(3):
        got = list(a.epoch(epoch))
        assert len(got) == -(-len(s_list) // mbatch_size)
        _equal(got, list(b.epoch(epoch)))
        assert all(x[0].shape[1] % (frames_per_bucket * 256) == 0 for x in got)


@pytest.mark.parametrize("mbatch_size,frames_per_bucket", [(2, 32), (3, 8)])
def test_labelled_batches_match_jax(lists, mbatch_size, frames_per_bucket):
    """Every clean item carries frame labels (as a `batch_list_labelled`
    list's do): each batch has a sixth member, the labels [B, L / N_s] at
    the frame rate, bitwise the JAX loader's with `with_labels`; with one
    item unlabelled, the batches are the five-member ones in both."""
    s_list, d_list = lists
    rng = np.random.RandomState(3)
    s_lab = [dict(it, labels=rng.randint(0, 98, -(-it["wav_len"] // 256)).astype(np.int32))
             for it in s_list]
    kw = dict(seed=5, N_s=256, frames_per_bucket=frames_per_bucket)
    a = MiniBatchLoader(s_lab, d_list, mbatch_size, [0, 5], **kw)
    b = MiniBatchLoaderJ(s_lab, d_list, mbatch_size, [0, 5], with_labels=True, **kw)
    got = list(a.epoch(0))
    _equal(got, list(b.epoch(0)), n=6)
    assert all(x[5].shape == (x[0].shape[0], x[0].shape[1] // 256) and x[5].any()
               for x in got)
    s_lab[0] = s_list[0]
    a = MiniBatchLoader(s_lab, d_list, len(s_lab), [0, 5], **kw)
    b = MiniBatchLoaderJ(s_lab, d_list, len(s_lab), [0, 5], with_labels=True, **kw)
    _equal(list(a.epoch(0)), list(b.epoch(0)))


def test_bucket_length_matches_jax():
    for n in (1, 255, 256, 8192, 8193, 50000):
        for fpb, mf in ((32, 32), (8, 32), (4, 1)):
            assert bucket_length(n, 128, fpb, mf) == bucket_length_j(n, 128, fpb, mf)


def test_a_failing_read_raises_where_jax_ends_the_epoch(lists, tmp_path):
    """The fourth clean file is missing: the port's consumer raises the
    worker's FileNotFoundError after the batches before it; the JAX
    loader's epoch ends there without an error."""
    s_list, d_list = lists
    s_list = [dict(it) for it in s_list]
    s_list[3]["file_path"] = str(tmp_path / "gone.wav")
    a = MiniBatchLoader(s_list, d_list, 1, [0], seed=1)
    got = []
    with pytest.raises(FileNotFoundError):
        for batch in a.epoch(0):
            got.append(batch)
    b = MiniBatchLoaderJ(s_list, d_list, 1, [0], seed=1)
    got_j = list(b.epoch(0))
    assert len(got_j) < len(s_list)
    _equal(got, got_j)


def test_an_abandoned_epoch_stops_its_worker(lists):
    """A consumer that takes one batch and leaves: the worker, blocked on a
    full queue, ends, and the next epoch starts clean."""
    s_list, d_list = lists
    a = MiniBatchLoader(s_list, d_list, 1, [0], seed=2, prefetch=1)
    before = threading.active_count()
    it = a.epoch(0)
    next(it)
    it.close()
    assert threading.active_count() == before
    assert len(list(a.epoch(1))) == len(s_list)
