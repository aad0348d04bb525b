"""The repo's tools without JAX, on the CPU: `tools/torch_make_artifact.py`
packages a port checkpoint holding the shipped resnet-1.1c weights, and
both packages' `load_artifact` give the shipped leaves bitwise;
`tools/torch_build_dataset.py` writes, byte for byte, what
`tools/build_dataset.py` writes from the same corpora and seed."""

import json
import os
import shutil
import sys
import wave

import jax
import numpy as np
import pytest

from deepxi_tpu.compat.artifact import load_artifact as load_artifact_j
from deepxi_tpu_torch.compat.artifact import (FLAGSHIP_ROOT, flax_order, load_artifact,
                                              load_flagship_artifact)
from deepxi_tpu_torch.data.wavio import save_wav
from deepxi_tpu_torch.training import TrainState, make_optimizer, save_checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import build_dataset  # noqa: E402
import torch_build_dataset  # noqa: E402
import torch_make_artifact  # noqa: E402
from synth_corpus import synth_noise, synth_utterance  # noqa: E402


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A work directory as the port's training leaves it (the shipped
    resnet-1.1c leaves saved as epoch 3's checkpoint, the statistics, a
    test pair), and the artifact the tool makes of it."""
    work = tmp_path_factory.mktemp("work")
    params = load_flagship_artifact(device="cpu").params
    save_checkpoint(str(work / "model" / "resnet-1.1c"), 2,
                    TrainState.create(params, make_optimizer("ResNetV2")))
    os.makedirs(work / "data")
    shutil.copy(os.path.join(FLAGSHIP_ROOT, "stats.npz"), work / "data" / "resnet-1.1c_stats.npz")
    for sub, name in (("test_clean_speech", "c012.wav"),
                      ("test_noisy_speech", "c012_white_5dB.wav")):
        os.makedirs(work / "set" / sub)
        shutil.copy(os.path.join(FLAGSHIP_ROOT, name), work / "set" / sub / name)
    out = str(tmp_path_factory.mktemp("artifact"))
    assert torch_make_artifact.main(["--work", str(work), "--ver", "resnet-1.1c",
                                     "--epoch", "3", "--out", out]) == 0
    return work, out


def _shipped():
    z = np.load(os.path.join(FLAGSHIP_ROOT, "params.npz"))
    return [z[f"p{i}"] for i in range(len(z.files))]


def test_artifact_layout_and_meta(artifact):
    work, out = artifact
    assert sorted(os.listdir(out)) == ["c012.wav", "c012_white_5dB.wav", "meta.json",
                                       "params.npz", "stats.npz"]
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta == {"ver": "resnet-1.1c", "epoch": 3, "clean": "c012.wav",
                    "noisy": "c012_white_5dB.wav", "n_leaves": 245,
                    "created_from": os.path.abspath(str(work))}
    for name in ("stats.npz", "c012.wav", "c012_white_5dB.wav"):
        assert open(os.path.join(out, name), "rb").read() == \
            open(os.path.join(FLAGSHIP_ROOT, name), "rb").read()


def test_both_loaders_give_the_shipped_leaves(artifact):
    _, out = artifact
    shipped = _shipped()
    art = load_artifact(out, device="cpu")
    ours = [art.params[k].numpy() for k in flax_order(art.params)]
    _, _, params_j, noisy_j, _ = load_artifact_j(out)
    theirs = [np.asarray(a) for a in jax.tree_util.tree_leaves(params_j)]
    assert len(ours) == len(theirs) == len(shipped) == 245
    for a, b, s in zip(ours, theirs, shipped):
        assert a.dtype == s.dtype and np.array_equal(a, s) and np.array_equal(b, s)
    assert np.array_equal(art.noisy, np.asarray(noisy_j))


def test_build_dataset_writes_what_the_jax_tool_writes(tmp_path, monkeypatch):
    """Six clean utterances (one at 8 kHz, one stereo at 16 kHz) and three
    noise clips through validation, test and train splits: every file of
    the two trees byte for byte."""
    rng = np.random.RandomState(9)
    clean, noise = tmp_path / "clean", tmp_path / "noise"
    for i in range(6):
        rate = 8000 if i == 2 else 16000
        save_wav(str(clean / f"u{i}.wav"), synth_utterance(rng, 0.5 + 0.1 * i, fs=rate), rate)
    two = np.stack([synth_utterance(rng, 0.7), synth_utterance(rng, 0.7)], 1)
    with wave.open(str(clean / "u4.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(two.astype("<i2").tobytes())
    for j, kind in enumerate(("white", "pink", "babble")):
        save_wav(str(noise / f"n_{j}.wav"), synth_noise(rng, kind, 2.0), 16000)
    args = ["--clean", str(clean), "--noise", str(noise), "--val_fraction", "0.34",
            "--test_fraction", "0.34", "--snr", "-5", "10", "5", "--seed", "7"]
    torch_build_dataset.main(args + ["--out", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["build_dataset.py", *args, "--out",
                                      str(tmp_path / "jax")])
    build_dataset.main()
    files = {}
    for tree in ("port", "jax"):
        root = tmp_path / tree
        files[tree] = {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f),
                                                                      "rb").read()
                       for d, _, fs in os.walk(root) for f in fs}
    assert len(files["port"]) == 2 + 3 + 2 * 2 + 2 * 3  # train, noise, val, test
    assert files["port"] == files["jax"]
