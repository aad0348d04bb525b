"""The port's native wav decoder (`deepxi_tpu_torch.native`) against the JAX
package's (`deepxi_tpu.native`) and against the port's pure-Python path
(`data/wavio` with ``DEEPXI_TORCH_NO_NATIVE=1``), on the CPU: each case of
tests/test_native.py, bitwise where that file allows one step; the port's
loader epochs with and without native and against the JAX loader's; and a
build without a compiler, which raises where the JAX package falls back.
"""

import os
import wave

import numpy as np
import pytest

from deepxi_tpu import native as native_j
from deepxi_tpu.data.loader import MiniBatchLoader as MiniBatchLoaderJ
from deepxi_tpu_torch import native
from deepxi_tpu_torch.data import wavio
from deepxi_tpu_torch.data.loader import MiniBatchLoader
from deepxi_tpu_torch.data.wavio import read_wav, save_wav, wav_length


def _write_raw(path, frames, n_ch, sw, rate):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(n_ch)
        w.setsampwidth(sw)
        w.setframerate(rate)
        w.writeframes(frames)


@pytest.fixture
def python_path(monkeypatch):
    """The port's `data/wavio` with the native decoder off: its Python path."""
    def run(fn, *args):
        with monkeypatch.context() as m:
            m.setenv("DEEPXI_TORCH_NO_NATIVE", "1")
            return fn(*args)
    return run


def test_library_builds():
    assert native.available() and native_j.available()
    assert os.path.exists(native.library_path()) and native.build() == 0.0


def test_mono16_bit_exact_and_lengths(tmp_path, python_path):
    x = (np.random.RandomState(0).randn(33333) * 3000).astype(np.int16)
    p = str(tmp_path / "a.wav")
    save_wav(p, x, 16000)
    y = native.read_wav_i16(p)
    assert np.array_equal(x, y) and np.array_equal(y, native_j.read_wav_i16(p))
    assert native.wav_len(p) == native_j.wav_len(p) == 33333 == wav_length(p)
    assert python_path(wav_length, p) == 33333
    z, fs = read_wav(p)
    assert fs == 16000 and np.array_equal(z, x)
    assert np.array_equal(python_path(read_wav, p)[0], x)


@pytest.mark.parametrize("n_ch,sw", [(2, 2), (1, 1), (1, 4), (3, 2), (2, 4), (2, 1)])
def test_formats_match_jax_and_python(tmp_path, python_path, n_ch, sw):
    """8-, 16- and 32-bit, mono, stereo and three channels: the port's
    decoder gives the JAX package's decoder's samples and the Python
    path's, bitwise."""
    rng = np.random.RandomState(n_ch * 10 + sw)
    n = 4097
    if sw == 2:
        frames = (rng.randn(n, n_ch) * 8000).astype("<i2").tobytes()
    elif sw == 4:
        x = (rng.randn(n, n_ch) * 5e8).clip(-2 ** 31, 2 ** 31 - 1)
        frames = x.astype("<i4").tobytes()
    else:
        frames = (rng.randint(0, 256, (n, n_ch))).astype(np.uint8).tobytes()
    p = str(tmp_path / "f.wav")
    _write_raw(p, frames, n_ch, sw, 16000)
    yn = native.read_wav_i16(p)
    yp = python_path(read_wav, p)[0]
    assert yn is not None and len(yn) == len(yp) == n
    assert np.array_equal(yn, native_j.read_wav_i16(p))
    assert np.array_equal(yn, yp)
    assert np.array_equal(read_wav(p)[0], yn)


def test_rate_mismatch_falls_back(tmp_path, python_path):
    x = (np.random.RandomState(1).randn(8000) * 3000).astype(np.int16)
    p = str(tmp_path / "lo.wav")
    save_wav(p, x, 8000)
    assert native.read_wav_i16(p) is None  # Python resamples
    out, lens, status = native.load_batch([p], 16384)
    assert list(status) == [native.FALLBACK] and lens[0] == 0 and not out.any()
    assert native.wav_len(p) == 16000 == wav_length(p) == python_path(wav_length, p)
    y, _ = read_wav(p)
    assert len(y) == 16000 and np.array_equal(y, python_path(read_wav, p)[0])


def test_offset_read(tmp_path):
    x = (np.random.RandomState(2).randn(10000) * 3000).astype(np.int16)
    p = str(tmp_path / "o.wav")
    save_wav(p, x, 16000)
    y = native.read_wav_i16(p, offset=777)
    assert np.array_equal(x[777:], y) and np.array_equal(y, native_j.read_wav_i16(p, offset=777))


def test_malformed_file_is_an_error(tmp_path, python_path):
    """ERR natively; the Python path (what `read_wav` takes then) raises."""
    p = str(tmp_path / "bad.wav")
    with open(p, "wb") as f:
        f.write(b"RIFFxxxxWAVEjunkjunk")
    assert native.read_wav_i16(p) is None and native.wav_len(p) is None
    _, lens, status = native.load_batch([p], 64)
    assert list(status) == [native.ERR] and lens[0] == 0
    with pytest.raises(wave.Error):
        read_wav(p)
    with pytest.raises(wave.Error):
        python_path(read_wav, p)


def test_native_save_python_read_roundtrip(tmp_path, python_path):
    """The port's native writer, the JAX package's and the Python path write
    the same bytes, which both paths read back."""
    x = (np.random.RandomState(3).randn(5000) * 3000).astype(np.int16)
    paths = [str(tmp_path / f"w{i}.wav") for i in range(3)]
    assert native.save_wav_i16(paths[0], x, 16000)
    assert native_j.save_wav_i16(paths[1], x, 16000)
    python_path(save_wav, paths[2], x, 16000)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] == data[2]
    assert np.array_equal(python_path(read_wav, paths[0])[0], x)
    assert np.array_equal(native.read_wav_i16(paths[2]), x)


def test_load_batch_padding_and_fallback_rows(tmp_path):
    rng = np.random.RandomState(4)
    a = (rng.randn(3000) * 3000).astype(np.int16)
    b = (rng.randn(5000) * 3000).astype(np.int16)
    pa, pb, pc = (str(tmp_path / f"{n}.wav") for n in "abc")
    save_wav(pa, a, 16000)
    save_wav(pb, b, 16000)
    save_wav(pc, a, 8000)  # native rejects; row stays zeroed
    kw = dict(L=4096, offsets=[0, 1000, 0])
    out, lens, status = native.load_batch([pa, pb, pc], **kw)
    assert list(status) == [0, 0, native.FALLBACK]
    assert lens[0] == 3000 and np.array_equal(out[0, :3000], a)
    assert not out[0, 3000:].any()
    assert lens[1] == 4000 and np.array_equal(out[1, :4000], b[1000:5000])
    assert not out[2].any()
    out_j, lens_j, status_j = native_j.load_batch([pa, pb, pc], **kw)
    assert np.array_equal(out, out_j) and np.array_equal(lens, lens_j)
    assert np.array_equal(status, status_j)


def _corpus(tmp_path):
    """Four clean files (one at 8 kHz, which takes the Python path in every
    batch it is in) and two noise files."""
    rng = np.random.RandomState(7)
    s_items, d_items = [], []
    for i, n in enumerate([3000, 9000, 14000, 6000]):
        p = str(tmp_path / f"s{i}.wav")
        rate = 8000 if i == 3 else 16000
        save_wav(p, (rng.randn(n * rate // 16000) * 3000).astype(np.int16), rate)
        s_items.append({"file_path": p, "wav_len": n})
    for i, n in enumerate([20000, 30000]):
        p = str(tmp_path / f"d{i}.wav")
        save_wav(p, (rng.randn(n) * 2000).astype(np.int16), 16000)
        d_items.append({"file_path": p, "wav_len": n})
    return s_items, d_items


def test_epochs_bitwise_with_and_without_native_and_as_jax(tmp_path, monkeypatch):
    """Two epochs: the port's loader with native and without it, and the JAX
    loader (which takes its own native decoder) from the same seed, give the
    same batches bitwise; `load_batch` decodes the port's rows."""
    s_items, d_items = _corpus(tmp_path)

    def run(cls):
        loader = cls(s_items, d_items, 2, [0, 5, 10], seed=3)
        return [tuple(np.asarray(a).copy() for a in b)
                for e in range(2) for b in loader.epoch(e)]

    calls = []
    load_batch = native.load_batch
    monkeypatch.setattr(native, "load_batch",
                        lambda *a, **k: calls.append(len(a[0])) or load_batch(*a, **k))
    with_native = run(MiniBatchLoader)
    assert calls == [2] * 8  # speech and noise rows of 4 batches
    with monkeypatch.context() as m:
        m.setenv("DEEPXI_TORCH_NO_NATIVE", "1")
        without = run(MiniBatchLoader)
    jax_batches = run(MiniBatchLoaderJ)
    assert len(with_native) == len(without) == len(jax_batches) == 4
    for bn, bp, bj in zip(with_native, without, jax_batches):
        for an, ap, aj in zip(bn, bp, bj):
            assert np.array_equal(an, ap) and np.array_equal(an, aj)


def test_a_build_without_a_compiler_raises(tmp_path, monkeypatch):
    """With `CXX` pointing nowhere and a fresh build directory the first use
    raises (the JAX package would take the Python path without a word);
    ``DEEPXI_TORCH_NO_NATIVE=1`` still takes the Python path."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    p = str(tmp_path / "a.wav")
    with pytest.raises(RuntimeError, match="could not run the C.. compiler"):
        native.available()
    with pytest.raises(RuntimeError, match="could not run the C.. compiler"):
        wavio.read_wav(p)
    monkeypatch.setenv("DEEPXI_TORCH_NO_NATIVE", "1")
    x = np.arange(100, dtype=np.int16)
    save_wav(p, x, 16000)
    assert not native.available() and np.array_equal(read_wav(p)[0], x)
    assert not os.listdir(tmp_path / "build")
