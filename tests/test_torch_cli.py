"""The port's command line (`python -m deepxi_tpu_torch`) against the JAX
package's (`deepxi_tpu.cli`) on the CPU: the Config of each of a list of
command lines (the rdlnet-1.0n and reslstm-1.0c presets among them),
`--enhance` from the trained mhanet-1.1c artifact (wavs at 16 kHz and one at
44.1 kHz in stereo, resampled), the resnet-1.1c artifact's missing
meta.json, `--prelim` (of every network type the port added last), a tiny
`--train --infer --test --spect_dist` run, `--infer` with the "block"
attention, the phoneme classifier's and the hybrid modes' flags and
out_types on tiny runs, the shard flags (taken as the JAX CLI takes them;
a mesh larger than the process group raises JAX's "exceeds" error), `--d_b`,
`--d_ff` and `--tcn_fused 0` (the plain ResNetV2's `infer` against JAX's),
and the refused `--platform tpu`."""

import os
import shutil
import subprocess
import sys
import wave

import numpy as np
import pytest
from scipy.io import loadmat

from deepxi_tpu import cli as cli_j
from deepxi_tpu.data.wavio import read_wav as read_wav_j
from deepxi_tpu_torch import cli
from deepxi_tpu_torch.compat.artifact import FLAGSHIP_ROOT, MHANET_ROOT
from deepxi_tpu_torch.data.wavio import read_wav, save_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from _torch_cli_checks import assert_config_matches_jax, assert_mesh_refused_as_jax  # noqa: E402
from torch_hybrid import write_phoneme_corpus  # noqa: E402

COMMAND_LINES = [
    [],
    ["--ver", "resnet-1.1c", "--train", "1", "--mbatch_size", "4"],
    ["--ver", "mhanet-1.1c", "--infer", "true", "--test_epoch", "10,20",
     "--gain", "mmse-lsa,srwf", "--out_type", "xi_hat"],
    ["--ver", "mhanet-1.1c-vb", "--test", "1", "--metric_workers", "1",
     "--test_s_path", "s", "--test_x_path", "x", "--log_path", "l"],
    ["--ver", "resnet-1.1c-vb", "--spect_dist", "1", "--sd_snr_levels", "neg_5,0,5",
     "--sd_target", "xi,gamma", "--test_d_path", "d"],
    ["--ver", "mhanet-1.0c", "--prelim", "yes", "--causal", "0", "--attention_impl",
     "stream", "--block_q", "128", "--mha_fused", "f", "--max_len", "1024"],
    ["--ver", "tiny", "--network_type", "ResNetV2", "--d_model", "32", "--n_blocks", "3",
     "--d_f", "16", "--k", "3", "--max_d_rate", "2", "--unit_type", "ReLU->LN->W+b",
     "--min_snr", "0", "--max_snr", "10", "--snr_inter", "5", "--seed", "3"],
    ["--ver", "resnet-1.1c", "--save_model", "0", "--save_every", "5", "--val_every", "2",
     "--val_flag", "false", "--reset_inp_tgt", "1", "--reset_sample", "t",
     "--eval_example", "1", "--log_iter", "1", "--resume_epoch", "3", "--max_epochs", "9",
     "--tcn_fused_train", "0", "--loss_fnc", "MeanSquaredError", "--outp_act", "Sigmoid"],
    ["--ver", "resnet-1.1c", "--f_s", "8000", "--T_d", "32", "--T_s", "16",
     "--n_filters", "26", "--warmup_steps", "100", "--n_heads", "4",
     "--map_type", "DBNormalCDF", "--dft_precision", "highest", "--tcn_fused", "1",
     "--n_model_shards", "1", "--export_path", "e"],
    ["--ver", "rdlnet-1.0n", "--train", "1", "--length", "5", "--m_1", "16",
     "--import_stats", "data/rdlnet-1.0n_inp_tgt.p"],
    ["--ver", "reslstm-1.0c", "--infer", "1", "--network_type", "ResBiLSTM",
     "--attention_impl", "block", "--block_q", "64"],
    ["--inp_tgt_type", "MagPhonemes", "--train", "1", "--Noutp", "120", "--ali_path", "a.ali",
     "--lexicon_path", "lex.txt"],
    ["--inp_tgt_type", "MagPhonme", "--infer", "1", "--out_type", "pho", "--lexicon_path", "l"],
    ["--infer", "1", "--out_type", "hybrid_mixmax", "--mixmax_stats", "g.npz"],
    ["--infer", "1", "--out_type", "tracking_vts", "--vts_stats", "g.npz", "--seed", "4"],
]


@pytest.mark.parametrize("argv", COMMAND_LINES, ids=range(len(COMMAND_LINES)))
def test_config_from_args_matches_jax(argv):
    assert_config_matches_jax(argv)


def _tcn_fused_0_infer(tmp_path, argv):
    """`infer` of the Configs of `argv` (d_model 32, `--tcn_fused 0`) in both
    packages on the same flax parameters (biases off zero) and statistics:
    the plain ResNetV2 in both (no kernel forward), waveforms within 2e-5."""
    import jax
    import jax.numpy as jnp

    from deepxi_tpu.framework import DeepXiTPU
    from deepxi_tpu_torch.compat.artifact import from_flax_params
    from deepxi_tpu_torch.data import listing
    from deepxi_tpu_torch.framework import DeepXiTorch

    rng = np.random.RandomState(0)
    test_dir = tmp_path / "test"
    for name, n in (("a_white_5dB", 9000), ("b_babble_0dB", 5000)):
        save_wav(str(test_dir / f"{name}.wav"), (rng.randn(n) * 3000).astype(np.int16), 16000)
    (tmp_path / "data").mkdir()
    np.savez(tmp_path / "data" / "tiny_stats.npz", **{
        "xi_map.mu": rng.randn(257).astype(np.float32) * 5,
        "xi_map.sigma": (np.abs(rng.randn(257)) * 5 + 1).astype(np.float32)})
    argv = argv + ["--ver", "tiny", "--network_type", "ResNetV2", "--d_model", "32",
                   "--n_blocks", "3", "--d_f", "16", "--k", "3", "--max_d_rate", "2",
                   "--unit_type", "ReLU->LN->W+b", "--test_x_path", str(test_dir),
                   "--data_path", str(tmp_path / "data"), "--platform", "cpu"]
    cfg, cfg_j = assert_config_matches_jax(argv)
    assert cfg.tcn_fused is False and cfg_j.tcn_fused is False
    dx_j = DeepXiTPU(cfg_j.replace(out_path=str(tmp_path / "out_j")))
    dx = DeepXiTorch(cfg.replace(out_path=str(tmp_path / "out")), device="cpu")
    assert dx.fast_apply() is None and dx_j._fast_apply()[1] is None
    params_j = dx_j.network.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 257)))
    params_j = jax.tree_util.tree_map(lambda a: np.asarray(a + 0.05 if a.ndim == 1 else a),
                                      params_j)
    written = dx.infer(params=from_flax_params(params_j), epochs=[1], gains=["mmse-lsa"])
    written_j = dx_j.infer(params=params_j, out_type="y", epochs=[1], gains=["mmse-lsa"])
    assert [os.path.basename(p) for p in written] == [os.path.basename(p) for p in written_j]
    x, lens, _, names = listing.test_batch(cfg.test_x_path)
    ys = dx.enhance_all(from_flax_params(params_j), x, lens, "mmse-lsa")
    ys_j = dx_j._enhance_all(params_j, x, lens, names, "mmse-lsa")
    for y, y_j in zip(ys, ys_j):
        assert y.shape == y_j.shape and np.abs(y_j).max() > 0.01
        assert np.abs(y - y_j).max() <= 2e-5


# Flags the JAX CLI takes that the port refused until it had their paths.
# The shard flags (beside the phoneme classifier's and the hybrid modes'
# flags) are taken as the JAX CLI takes them, and a mesh larger than this
# one-rank process raises JAX's error; `--d_ff` and `--d_b` are taken and
# read by no network; `--tcn_fused 0` runs the plain ResNetV2. `--platform
# tpu` still refuses.
REFUSED = [
    (["--export", "1", "--n_data_shards", "2"], "mesh"), (["--n_data_shards", "2"], "mesh"),
    (["--n_model_shards", "2"], "mesh"),
    (["--inp_tgt_type", "MagPhonemes", "--n_data_shards", "2"], "mesh"),
    (["--map_type", "NormalCDF", "--inp_tgt_type", "MagPhonme", "--n_model_shards", "4"],
     "mesh"),
    (["--out_type", "hybrid_omlsa", "--n_data_shards", "2"], "mesh"),
    (["--out_type", "pho", "--n_model_shards", "2"], "mesh"),
    (["--out_type", "tracking_vts", "--n_data_shards", "8"], "mesh"),
    (["--mixmax_stats", "g.npz", "--n_model_shards", "2"], "mesh"),
    (["--lexicon_path", "lex", "--n_data_shards", "2"], "mesh"),
    (["--d_ff", "1024"], "config"), (["--tcn_fused", "0"], "plain infer"),
    (["--platform", "tpu"], "cuda"), (["--d_b", "32"], "config"),
]


@pytest.mark.parametrize("argv,item", REFUSED, ids=[a[0] for a, _ in REFUSED])
def test_unported_flags_raise(tmp_path, argv, item):
    """Each flag that the port once refused runs as in the JAX CLI: the same
    Config; for a shard flag, JAX's "exceeds" error from a one-rank `main`;
    for `--tcn_fused 0`, the plain network's `infer` held to JAX's. `--platform
    tpu` raises SystemExit naming the port's platforms, in `main` and in
    `config_from_args` (and before any work)."""
    if item == "cuda":
        for fn in (cli.main, cli.config_from_args):
            with pytest.raises(SystemExit, match=item):
                fn(argv)
        return
    if item == "plain infer":
        _tcn_fused_0_infer(tmp_path, argv)
        return
    cfg, cfg_j = assert_config_matches_jax(argv)
    for flag in ("n_data_shards", "n_model_shards", "d_b", "d_ff"):
        if f"--{flag}" in argv:
            assert getattr(cfg, flag) == getattr(cfg_j, flag) == int(argv[argv.index(
                f"--{flag}") + 1])
    if item == "mesh":
        assert_mesh_refused_as_jax(argv)


def test_main_without_mode_and_help():
    assert cli.main(["--platform", "cpu", "--ver", "tiny"]) == 1
    r = subprocess.run([sys.executable, "-m", "deepxi_tpu_torch", "--help"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "--dft_precision" in r.stdout and "float32" in r.stdout


def test_prelim_converges(capsys):
    """`--prelim 1` trains its small ResNetV2 for 60 steps toward 0.75 on the
    CPU: mean |prediction - target| under 0.12 (the JAX test's limit;
    measured 0.054)."""
    assert cli.main(["--prelim", "1", "--platform", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if "mean|pred-target|" in ln]
    assert len(line) == 1 and float(line[0].split()[-1]) < 0.12


@pytest.mark.parametrize("network_type", ["MHANet", "ResLSTM", "ResBiLSTM", "RDLNet"])
def test_prelim_trains_the_new_networks(capsys, network_type):
    """`--prelim 1 --network_type <type>` on the CPU. The LSTMs and RDLNet
    reach the prelim test's 0.12 (measured 0.047, 0.038, 0.073). MHANet V1
    takes the Noam schedule (4000 warmup steps: a rate of 4e-5 at step 60),
    so it moves little, as the JAX harness's (0.267 after its 50 steps;
    the port's 0.244): its loss must fall from step 0 to step 50 and its
    distance stay under 0.3."""
    assert cli.main(["--prelim", "1", "--platform", "cpu", "--network_type",
                     network_type]) == 0
    out = capsys.readouterr().out.splitlines()
    mae = [float(ln.split()[-1]) for ln in out if "mean|pred-target|" in ln]
    loss = {ln.split()[2]: float(ln.split()[-1]) for ln in out if ln.startswith("prelim step")}
    assert len(mae) == 1 and np.isfinite(mae[0])
    if network_type == "MHANet":
        assert loss["50:"] < loss["0:"] and mae[0] < 0.3
    else:
        assert mae[0] < 0.12


def _stereo_44k(src, dst):
    """`src` resampled to 44.1 kHz by linear interpolation, in two
    channels of 32-bit PCM (left and half the right)."""
    x = read_wav(src)[0].astype(np.float64) / 32768.0
    t = np.arange(int(len(x) * 44100 / 16000)) * 16000 / 44100
    y = np.interp(t, np.arange(len(x)), x)
    raw = (np.stack([y, 0.5 * y], 1) * 2147483647.0 * 0.9).astype("<i4")
    with wave.open(dst, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(4)
        w.setframerate(44100)
        w.writeframes(raw.tobytes())


def test_enhance_matches_jax(tmp_path):
    """`--enhance` from the mhanet-1.1c artifact on a directory: the 4 s
    noisy utterance, its first 2.5 s, and the utterance at 44.1 kHz stereo
    32-bit; each written wav within one int16 step of the JAX CLI's
    (measured: at most one). Outputs keep the input's basename and are
    written at the artifact's rate."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    noisy = os.path.join(MHANET_ROOT, "c012_white_5dB.wav")
    shutil.copy(noisy, in_dir / "a.wav")
    save_wav(str(in_dir / "b.wav"), read_wav(noisy)[0][:40000], 16000)
    _stereo_44k(noisy, str(in_dir / "c.wav"))
    out, out_j = tmp_path / "out", tmp_path / "out_j"
    assert cli.main(["--enhance", MHANET_ROOT, "--in_wavs", str(in_dir),
                     "--out_dir", str(out), "--platform", "cpu"]) == 0
    assert cli_j.main(["--enhance", MHANET_ROOT, "--in_wavs", str(in_dir),
                       "--out_dir", str(out_j), "--platform", "cpu"]) == 0
    assert sorted(os.listdir(out)) == sorted(os.listdir(out_j)) == ["a.wav", "b.wav", "c.wav"]
    for name in ("a.wav", "b.wav", "c.wav"):
        with wave.open(str(out / name)) as w:
            assert w.getframerate() == 16000 and w.getnchannels() == 1
        y, y_j = read_wav(str(out / name))[0], read_wav_j(str(out_j / name))[0]
        assert y.shape == y_j.shape and np.abs(y).max() > 1000
        assert np.abs(y.astype(np.int32) - y_j).max() <= 1, name


def test_enhance_needs_meta_json(tmp_path):
    """The resnet-1.1c artifact holds no meta.json: both command lines raise."""
    wav = os.path.join(FLAGSHIP_ROOT, "c012_white_5dB.wav")
    for main in (cli.main, cli_j.main):
        with pytest.raises(FileNotFoundError, match="meta.json"):
            main(["--enhance", FLAGSHIP_ROOT, "--in_wavs", wav,
                  "--out_dir", str(tmp_path), "--platform", "cpu"])


def _dataset(root):
    """tests/test_framework.py's tiny corpus layout: train, val and test
    sets, and test noise as long as the test speech."""
    rng = np.random.RandomState(0)

    def noise(n):
        return (rng.randn(n) * 2000).astype(np.int16)

    def speech(n, seed):
        t = np.arange(n) / 16000
        return (np.random.RandomState(seed).randn(n) * 5000
                * (0.55 + 0.45 * np.sin(2 * np.pi * 4.0 * t))).astype(np.int16)

    for i in range(4):
        save_wav(str(root / "train_clean_speech" / f"sp{i}.wav"), speech(8000 + 1000 * i, i),
                 16000)
        save_wav(str(root / "train_noise" / f"n{i}.wav"), noise(24000), 16000)
    for i in range(2):
        save_wav(str(root / "val_clean_speech" / f"v{i}_5dB.wav"), speech(8000, 10 + i), 16000)
        save_wav(str(root / "val_noise" / f"v{i}_5dB.wav"), noise(8000), 16000)
        s = speech(16000, 20 + i)
        x = (s.astype(np.int32) + noise(16000)).clip(-32768, 32767).astype(np.int16)
        save_wav(str(root / "test_clean_speech" / f"c{i}.wav"), s, 16000)
        save_wav(str(root / "test_noisy_speech" / f"c{i}_white_5dB.wav"), x, 16000)
        save_wav(str(root / "test_noise" / f"d{i}.wav"), noise(16000), 16000)


def _written(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for top in ("log", "out") for d, _, fs in os.walk(os.path.join(root, top))
                  for f in fs)


def test_train_infer_test_spect_dist_write_the_jax_files(tmp_path):
    """One command line of every mode on a tiny ResNetV2: both packages
    write the same loss, result, spectral-distortion and enhanced-wav files,
    the map statistics and a checkpoint of epoch 0."""
    _dataset(tmp_path / "set")
    argv = ["--ver", "tiny", "--network_type", "ResNetV2", "--d_model", "16",
            "--n_blocks", "2", "--d_f", "8", "--k", "3", "--max_d_rate", "2",
            "--unit_type", "ReLU->LN->W+b", "--mbatch_size", "2", "--sample_size", "4",
            "--max_epochs", "1", "--test_epoch", "1", "--min_snr", "0", "--max_snr", "10",
            "--snr_inter", "5", "--metric_workers", "1", "--sd_snr_levels", "0,5",
            "--sd_target", "xi,gamma", "--train", "1", "--infer", "1", "--test", "1",
            "--spect_dist", "1", "--platform", "cpu",
            "--set_path", str(tmp_path / "set"),
            "--test_x_path", str(tmp_path / "set" / "test_noisy_speech"),
            "--test_s_path", str(tmp_path / "set" / "test_clean_speech"),
            "--test_d_path", str(tmp_path / "set" / "test_noise")]
    runs = {}
    for name, main in (("port", cli.main), ("jax", cli_j.main)):
        r = tmp_path / name
        assert main(argv + [f"--{k}_path={r / k}" for k in ("data", "model", "log", "out")]
                    ) == 0
        runs[name] = r
    files = _written(runs["port"])
    assert files == _written(runs["jax"])
    assert {"log/loss/tiny.csv", "log/results/tiny_e1_mmse-lsa.csv",
            "log/results/average.csv", "log/results/results.txt",
            "log/results/tiny_e1_spect_dist.csv", "log/results/tiny_e1_spect_dist_gamma.csv",
            "out/tiny/e1/y/mmse-lsa/c0_white_5dB.wav"} <= set(files)
    for r in runs.values():
        assert os.path.exists(r / "data" / "tiny_stats.npz")
        assert os.path.isdir(r / "model" / "tiny" / "epoch-0")


def test_infer_with_block_attention(tmp_path):
    """`--train 1 --infer 1 --attention_impl block` on a tiny MHANetV3 (the
    "block" attention trains and infers, as in the JAX package): the same
    files as the JAX command line's; each wav within one int16 step of
    `--infer 1 --attention_impl full` from the same checkpoint."""
    _dataset(tmp_path / "set")
    argv = ["--ver", "tiny", "--network_type", "MHANetV3", "--d_model", "16",
            "--n_blocks", "1", "--n_heads", "4", "--max_len", "128", "--mbatch_size", "2",
            "--sample_size", "4", "--max_epochs", "1", "--test_epoch", "1", "--min_snr", "0",
            "--max_snr", "10", "--snr_inter", "5", "--val_flag", "0", "--platform", "cpu",
            "--block_q", "16", "--set_path", str(tmp_path / "set"),
            "--test_x_path", str(tmp_path / "set" / "test_noisy_speech")]
    runs = {}
    for name, main in (("port", cli.main), ("jax", cli_j.main)):
        r = tmp_path / name
        paths = [f"--{k}_path={r / k}" for k in ("data", "model", "log", "out")]
        assert main(argv + paths + ["--train", "1", "--infer", "1",
                                    "--attention_impl", "block"]) == 0
        runs[name] = r
    assert _written(runs["port"]) == _written(runs["jax"])
    r = runs["port"]
    full = [f"--{k}_path={r / k}" for k in ("data", "model", "log")] + \
        [f"--out_path={r / 'out_full'}", "--infer", "1", "--attention_impl", "full"]
    assert cli.main(argv + full) == 0
    wavs = sorted(os.listdir(r / "out" / "tiny" / "e1" / "y" / "mmse-lsa"))
    assert wavs == ["c0_white_5dB.wav", "c1_white_5dB.wav"]
    for w in wavs:
        y = read_wav(str(r / "out" / "tiny" / "e1" / "y" / "mmse-lsa" / w))[0]
        y_f = read_wav(str(r / "out_full" / "tiny" / "e1" / "y" / "mmse-lsa" / w))[0]
        assert y.shape == y_f.shape and np.abs(y_f).max() > 30
        assert np.abs(y.astype(np.int32) - y_f).max() <= 1


def _phoneme_argv(root):
    """A tiny MagPhonemes command line on `write_phoneme_corpus(root)` with
    its Gaussians (tools/torch_build_gaussians.py)."""
    import torch_build_gaussians
    write_phoneme_corpus(str(root))
    g = str(root / "gaussians.npz")
    if not os.path.exists(g):
        assert torch_build_gaussians.main([
            "--clean", str(root / "set" / "train_clean_speech"), "--ali",
            str(root / "train.ali"), "--lexicon", str(root / "lexicon.txt"), "--noise",
            str(root / "set" / "train_noise"), "--out", g, "--platform", "cpu"]) == 0
    return ["--ver", "tiny", "--inp_tgt_type", "MagPhonemes", "--network_type", "ResNetV2",
            "--d_model", "16", "--n_blocks", "2", "--d_f", "8", "--k", "3",
            "--max_d_rate", "2", "--unit_type", "ReLU->LN->W+b", "--mbatch_size", "2",
            "--max_epochs", "1", "--test_epoch", "1", "--min_snr", "0", "--max_snr", "10",
            "--snr_inter", "5", "--val_flag", "0", "--platform", "cpu",
            "--set_path", str(root / "set"), "--test_x_path", str(root / "test"),
            "--ali_path", str(root / "train.ali"), "--lexicon_path", str(root / "lexicon.txt"),
            "--mixmax_stats", g, "--vts_stats", g]


def test_phoneme_classifier_trains_and_infers(tmp_path):
    """`--inp_tgt_type MagPhonemes --train 1 --infer 1 --out_type pho` and
    then `--out_type hybrid_mixmax` (the network's posteriors) from the
    checkpoint: both packages write the same files (the loss CSV, a
    checkpoint of epoch 0, each test utterance's posteriors [frames, 98] and
    token CSV, the wavs under e1/hybrid_mixmax), and without
    `--ali_path` training stops with rc 1. (Each package starts from its own
    initial weights: the values are held to JAX's in
    tests/test_torch_hybrid.py.)"""
    argv = _phoneme_argv(tmp_path)
    runs = {}
    for name, main in (("port", cli.main), ("jax", cli_j.main)):
        r = tmp_path / name
        paths = [f"--{k}_path={r / k}" for k in ("data", "model", "log", "out")]
        assert main(argv + paths + ["--train", "1", "--infer", "1", "--out_type", "pho"]) == 0
        assert main(argv + paths + ["--infer", "1", "--out_type", "hybrid_mixmax"]) == 0
        runs[name] = r
    files = _written(runs["port"])
    assert files == _written(runs["jax"])
    assert {"log/loss/tiny.csv", "out/tiny/e1/pho/t0_pink_5dB.mat",
            "out/tiny/e1/pho/t1_white_0dB.csv",
            "out/tiny/e1/hybrid_mixmax/t1_white_0dB.wav"} <= set(files)
    assert os.path.exists(runs["port"] / "model" / "tiny" / "epoch-0" / "state.pt")
    for name in ("t0_pink_5dB", "t1_white_0dB"):
        post = loadmat(runs["port"] / "out" / "tiny" / "e1" / "pho" / f"{name}.mat")["pho_post"]
        post_j = loadmat(runs["jax"] / "out" / "tiny" / "e1" / "pho" / f"{name}.mat")["pho_post"]
        assert post.shape == post_j.shape and post.shape[1] == 98
        assert ((post > 0) & (post < 1)).all()
        tokens = open(runs["port"] / "out" / "tiny" / "e1" / "pho" / f"{name}.csv").read()
        assert len(tokens.split()) == post.shape[0]
    bad = [a for a in argv if a != "--ali_path" and not a.endswith("train.ali")]
    assert cli.main(bad + ["--train", "1", "--data_path", str(tmp_path / "d2")]) == 1


CLASSICAL = ["hybrid_omlsa", "tracking_hist", "tracking_vts", "hybrid_mixmax"]


@pytest.mark.parametrize("out_type", CLASSICAL)
def test_classical_modes_match_jax(tmp_path, out_type):
    """`--infer 1 --out_type <mode>` without a network (hybrid_mixmax of a
    MagXi model: MixMax with the Gaussians' prior): the same wavs as the
    JAX command line's, each within one int16 step."""
    argv = _phoneme_argv(tmp_path) + ["--infer", "1", "--out_type", out_type]
    if out_type == "hybrid_mixmax":
        argv += ["--inp_tgt_type", "MagXi"]
    runs = {}
    for name, main in (("port", cli.main), ("jax", cli_j.main)):
        r = tmp_path / name
        if out_type == "hybrid_mixmax":
            os.makedirs(r / "data")
            np.savez(r / "data" / "tiny_stats.npz", **{
                "xi_map.mu": np.zeros(257, np.float32), "xi_map.sigma": np.ones(257, np.float32)})
        assert main(argv + [f"--{k}_path={r / k}" for k in ("data", "model", "log", "out")]
                    ) == 0
        runs[name] = r
    files = _written(runs["port"])
    assert files == _written(runs["jax"]) == [
        f"out/tiny/classical/{out_type}/{n}.wav" for n in ("t0_pink_5dB", "t1_white_0dB")]
    for f in files:
        y, y_j = read_wav(str(runs["port"] / f))[0], read_wav_j(str(runs["jax"] / f))[0]
        assert y.shape == y_j.shape and np.abs(y.astype(np.int32) - y_j).max() <= 1, f
