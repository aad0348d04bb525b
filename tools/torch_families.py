"""Every input/target family, a map other than DBNormalCDF, another framing
and the non-causal ResNetV2 on the card at resnet-1.1c's full widths
(d_model 256, 40 blocks, d_f 64, k 3, dilations to 16; chip_smoke.py phase
3k).

`families_phase(device, fail)` writes a synthetic corpus (24 clean 4 s
utterances, 6 noise files of 8 s) and, for each case (MagGamma, MagXiGamma,
MagGain with mmse-lsa and with ibm, MagMag, MagSMM, MagPhaXiPha, STDCTXiCD,
MagXi with a LaplaceCDF map, and MagXi at T_s = 8 ms, N_s = 128):

  * `DeepXiTorch` fits the map statistics on 16 utterances of the corpus
    and trains three steps at B = 8 x 4.096 s through the fused stack
    (`tcn_fused_train`: B5 and B6 must launch); the first step's gradients
    on 2 utterances x 32 frames of its batch, with the output layer scaled
    out of the sigmoid's saturation, are held to float64 autograd of the
    plain ResNetV2 along B5's trajectory (its ReLUs on the kernel's side;
    2e-4 of each leaf's max abs, chip_smoke.py's limit), and B5's block
    inputs to the plain network's (1e-3 of their scale);
  * the kernels' network forward (B1; B4 on the tiled utterance) is held
    to the plain network on the network input of the trained resnet-1.1c
    artifact's 4 s noisy utterance and of the same tiled 5x (T = 1250),
    1e-3 abs; `infer` then writes `y` and every out_type the family has
    for both, `y` also per utterance for the `gain_synthesis` families
    (B3), and the same `infer` with no spectral kernel and the same
    network forward writes the references (the batched `y` takes no
    spectral kernel: there the network check is the comparison): each
    per-utterance waveform within 1e-3 of its scale and its wav one int16
    step from it, each SNR or magnitude estimate within 1e-3 in the
    network's output units (read back through the family's map), other
    .mat values within 1e-3 of their scale, masks differing only where the
    plain route's a priori SNR lies within 1e-2 dB of 0 dB; each infer
    call's launches of B1-B4 are counted (zeroed just before it) and its
    wall ms printed; at N_s = 128 B2 and B3 must not launch, at N_s = 256
    each |X|-input family's per-utterance outputs launch B2;
  * resnet-1.1n (non-causal, seeded weights) enhances B=1 x 4 s and
    B=96 x 10 s through `make_enhancer` on its plain network (no TCN kernel
    may launch), timed beside resnet-1.1c's kernel route on weights drawn
    the same way.

Returns {"launches": {kernel: {what: launches}}, "times": {what: ms}}.
Run alone on a machine with a card: python3 tools/torch_families.py
"""

from __future__ import annotations

import copy
import functools
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
from torch.func import functional_call

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from deepxi_tpu_torch import enhance  # noqa: E402
from deepxi_tpu_torch.compat.artifact import FLAGSHIP_ROOT, load_flagship_artifact  # noqa: E402
from deepxi_tpu_torch.config import preset  # noqa: E402
from deepxi_tpu_torch.data.listing import batch_list  # noqa: E402
from deepxi_tpu_torch.data.loader import MiniBatchLoader  # noqa: E402
from deepxi_tpu_torch.data.wavio import read_wav, save_wav  # noqa: E402
from deepxi_tpu_torch.framework import DeepXiTorch, build_network, fast_apply_fn  # noqa: E402
from deepxi_tpu_torch.models.tcn import (cyclic_dilation, init_flax_like,  # noqa: E402
                                          layer_norm, output_activation)
from deepxi_tpu_torch.ops.kernels import spectral, tcn_fused, tcn_fused_train  # noqa: E402
from deepxi_tpu_torch.ops.kernels.tcn_fused import block_weights  # noqa: E402
from deepxi_tpu_torch.sig.mel import mel_filter_bank  # noqa: E402
from deepxi_tpu_torch.sig.mix import noise_offsets  # noqa: E402
from deepxi_tpu_torch.training import frame_mask, masked_loss  # noqa: E402

GRAD_TOL_REL = 2e-4    # chip_smoke.py's limit for the fused stack's gradients
NET_ATOL = 1e-3        # the network output against the plain network's
FWD_TOL_REL = 1e-3     # B5's block inputs against the plain network's, of their scale
Z_MAX = 4.0            # the output layer's largest pre-activation in the gradient check
OUT_TOL = 1e-3         # an output against the spectral plain route's
MASK_TIE_DB = 1e-2
TRAIN_B = 8
# the kernels of this path, by their PERF.md names
KERNELS = {"B1": tcn_fused.fused_block_group_whole, "B2": spectral.stft_mag_fused,
           "B3": spectral.enhance_frames_fused, "B4": tcn_fused.fused_block_group,
           "B5": tcn_fused_train.fused_block_group_whole_saved,
           "B6": tcn_fused_train.fused_block_group_bwd}
XI_OUT = ("xi_hat", "gamma_hat", "deepmmse", "ibm_hat", "subband_ibm_hat", "d_hat")
# case: (preset overrides, the out_types besides y)
CASES = {
    "MagGamma": (dict(inp_tgt_type="MagGamma"), XI_OUT),
    "MagXiGamma": (dict(inp_tgt_type="MagXiGamma",
                        map_type=["DBNormalCDF", "DBNormalCDF"]), XI_OUT),
    "MagGain mmse-lsa": (dict(inp_tgt_type="MagGain", gain="mmse-lsa"), ()),
    "MagGain ibm": (dict(inp_tgt_type="MagGain", gain="ibm"), ()),
    "MagMag": (dict(inp_tgt_type="MagMag"), ("mag_hat",)),
    "MagSMM": (dict(inp_tgt_type="MagSMM", loss_fnc="MeanSquaredError",
                    outp_act="Softplus"), ()),
    "MagPhaXiPha": (dict(inp_tgt_type="MagPhaXiPha",
                         map_type=[["DB", "NormalCDF"], ["UniformCDF"]]),
                    ("xi_hat", "ibm_hat", "subband_ibm_hat")),
    "STDCTXiCD": (dict(inp_tgt_type="STDCTXiCD", map_type=["DBNormalCDF", "NormalCDF"]),
                  ("xi_hat", "deepmmse", "ibm_hat", "cd_hat")),
    "MagXi LaplaceCDF": (dict(inp_tgt_type="MagXi", map_type="DBLaplaceCDF",
                              map_params=[0.0]), XI_OUT),
    "MagXi N_s=128": (dict(inp_tgt_type="MagXi", T_s=8), ("xi_hat", "d_hat")),
}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counts():
    return {k: fn.launches for k, fn in KERNELS.items()}


def _zero():
    for fn in KERNELS.values():
        fn.launches = 0


def write_corpus(root: str, seed: int = 3):
    """24 clean 4 s utterances and 6 noise files of 8 s from the numpy-only
    generators of tools/synth_corpus.py, as 16-bit wavs."""
    from synth_corpus import NOISE_KINDS, synth_noise, synth_utterance
    rng = np.random.RandomState(seed)
    dirs = (os.path.join(root, "train_clean_speech"), os.path.join(root, "train_noise"))
    for i in range(24):
        save_wav(os.path.join(dirs[0], f"sp{i:02d}.wav"), synth_utterance(rng, 4.0), 16000)
    for kind in NOISE_KINDS:
        save_wav(os.path.join(dirs[1], f"{kind}.wav"), synth_noise(rng, kind, 8.0), 16000)
    return dirs


def _trajectory(net, inp, forced=None):
    """The plain ResNetV2 `net` on `inp`: (output, [each block's input, then
    the stack's output], [every ReLU input]). With `forced` (that list from
    another route) each of those activations takes the forced value while
    its gradient follows the plain network's: autograd of the plain network
    along the other route's trajectory, each ReLU on that route's side."""
    x, acts, relu_in = net.feedforward(inp), [], []
    for i in range(net.n_blocks + 1):
        if forced is not None:
            x = forced[i].to(x.dtype) + (x - x.detach())
        acts.append(x)
        if i == net.n_blocks:
            break
        h = x
        for u in (1, 2, 3):
            relu_in.append(h)
            h = net._unit(h, getattr(net, f"block{i}_u{u}_conv"))
        x = x + h
    return output_activation(net.out_conv(x), net.outp_act), acts, relu_in


def _crop_grads(dx, s_list, d_list, dev):
    """The fused stack's gradients (`DeepXiTorch.apply_fn`: B5 forward, B6
    backward) on 2 utterances x 32 frames of the run's first batch, from
    its seeded initial parameters with the output layer scaled so that no
    pre-activation exceeds Z_MAX (there the loss is smooth: a saturated
    sigmoid meets Keras' clip of the prediction, where one f32 rounding of
    the output switches a bin's gradient between ~1 and 0). Held to float64
    autograd of the plain network along the kernels' trajectory (each
    block's input and the stack's output forced to B5's, so every ReLU takes
    the kernel's side). B5's block inputs are held to the plain f32
    network's. Returns (worst leaf against that reference over its max abs,
    the leaf, B5's worst block input over its scale, the crop's shape, a
    line of readings: against the plain f32 and float64 networks and the
    ReLU inputs whose side the two f32 trajectories do not share)."""
    cfg = dx.cfg
    params0 = dx.init_params()
    batch = next(MiniBatchLoader(s_list, d_list, TRAIN_B, cfg.snr_levels, seed=cfg.seed,
                                 N_s=cfg.N_s).epoch(0))
    s, d, s_len, d_len, snr = batch[:5]
    # a labelled list's batch (MagPhonemes) carries the frame labels
    labels = {"labels": torch.as_tensor(batch[5], device=dev)} if len(batch) > 5 else {}
    offs = noise_offsets(torch.as_tensor(s_len), torch.as_tensor(d_len),
                         torch.Generator().manual_seed(cfg.seed + 1))
    with torch.no_grad():
        inp, tgt, nf = dx.inp_tgt.example(
            torch.as_tensor(s, device=dev), torch.as_tensor(d, device=dev),
            torch.as_tensor(s_len), torch.as_tensor(d_len), torch.as_tensor(snr),
            offsets=offs, **labels)
    inp, tgt = inp[:2, :32].contiguous(), tgt[:2, :32].contiguous()
    mask = frame_mask(inp.shape[1], nf, dev)[:2, :32]
    net = copy.deepcopy(dx.network)
    with torch.no_grad():
        net.load_state_dict(params0)
        z = net.out_conv(_trajectory(net, inp)[1][-1])
        scale = min(1.0, Z_MAX / z.abs().max().item())
        for leaf in ("out_conv.kernel", "out_conv.bias"):
            params0[leaf] = params0[leaf] * scale
        net.load_state_dict(params0)

    def grads(apply, p0):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        m = inp.to(next(iter(p0.values())).dtype)
        loss = masked_loss(apply(p, m), tgt.to(m.dtype), mask.to(m.dtype), cfg.loss_fnc)
        return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    def worst(g, ref):
        return max(((g[k].double() - ref[k].double()).abs().max().item()
                    / max(ref[k].abs().max().item(), 1e-30), k) for k in ref)

    g_f = grads(dx.apply_fn(), params0)
    plain = lambda p, m: functional_call(dx.network, p, (m,))  # noqa: E731
    g_p = grads(plain, params0)
    g_64 = grads(plain, {k: v.double() for k, v in params0.items()})
    # B5's trajectory: the first layer as the train step computes it, then
    # the stack group by group as `resnetv2_apply_fused_train` runs it
    dil = [cyclic_dilation(i, cfg.max_d_rate) for i in range(cfg.n_blocks)]
    bw = [block_weights(params0, i) for i in range(cfg.n_blocks)]
    with torch.no_grad():
        h = torch.relu(layer_norm(inp @ params0["ff_conv.kernel"][0] + params0["ff_conv.bias"])
                       * params0["ff_ln.scale"])
        kern = []
        for g0 in range(0, cfg.n_blocks, 10):
            h, hs = tcn_fused_train.fused_block_group_whole_saved(
                h, bw[g0:g0 + 10], dil[g0:g0 + 10], cfg.k)
            kern += list(hs.unbind(1))
        kern.append(h)
        _, acts, relu_p = _trajectory(net, inp)
        _, _, relu_k = _trajectory(net, inp, kern)
    fwd = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
              for a, b in zip(kern, acts))
    flips = [(a > 0) != (b > 0) for a, b in zip(relu_k, relu_p)]
    n_flip = sum(int(f.sum()) for f in flips)
    flip_z = max([(b.abs()[f].max().item() / b.abs().max().item()) for f, b in
                  zip(flips, relu_p) if f.any()], default=0.0)
    # float64 autograd of the plain network along B5's trajectory
    net64 = copy.deepcopy(net).double()
    leaves = dict(net64.named_parameters())
    loss = masked_loss(_trajectory(net64, inp.double(), kern)[0], tgt.double(),
                       mask.double(), cfg.loss_fnc)
    g_t = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    w = worst(g_f, g_t)
    readings = (f"output layer x{scale:.4g}; against the plain f32 network {worst(g_f, g_p)[0]:.3e}"
                f", float64 {worst(g_f, g_64)[0]:.3e} (plain f32 against float64 "
                f"{worst(g_p, g_64)[0]:.3e}); {n_flip} ReLU inputs on the other side of 0 in "
                f"B5's trajectory than in the plain f32 network's, the largest "
                f"{flip_z:.2e} of its tensor's scale")
    return w[0], w[1], fwd, tuple(inp.shape), readings


def _wrapped_steps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest int16 difference, counted modulo 2^16 (samples past the
    range wrap when written)."""
    d = (a.astype(np.int64) - b.astype(np.int64) + 32768) % 65536 - 32768
    return int(np.abs(d).max())


def _map_device(m):
    """The device of a map's statistics (the CPU for a map without)."""
    for f in ("mu", "sigma", "b", "min", "max"):
        v = getattr(m, f, None)
        if torch.is_tensor(v):
            return v.device
    return torch.device("cpu")


def _network_units(it, out_type, a):
    """An estimate read back into the network's output units through the
    family's map (its image: where the map's inverse is ill-conditioned,
    near 0 and 1, the estimate magnifies the network's float32 rounding
    without bound, and the network output is what a route computes)."""
    typ = type(it).__name__
    if out_type == "mag_hat":
        m, pre = it.mag_map, a
    elif out_type == "cd_hat":
        m, pre = it.cd_map, a
    elif typ == "MagGamma":    # its map reads gamma; xi_hat = max(gamma - 1, 1e-12)
        m, pre = it.gamma_map, (a + 1.0 if out_type == "xi_hat" else a)
    elif out_type == "gamma_hat" and typ == "MagXiGamma":
        m, pre = it.gamma_map, a
    else:                      # xi_hat, and MagXi's gamma_hat = xi_hat + 1
        m, pre = it.xi_map, (a - 1.0 if out_type == "gamma_hat" else a)
    return m.map(torch.as_tensor(pre, device=_map_device(m))).cpu().numpy()


def _float_outputs(dx, params, out_type, test_dir) -> dict:
    """{wav name: the float waveform `infer` writes} of one per-utterance
    route (the gain synthesiser or `enhanced_speech`), as infer runs it."""
    it, out = dx.inp_tgt, {}
    names = sorted(os.listdir(test_dir))
    wavs = [read_wav(os.path.join(test_dir, n))[0] for n in names]
    for name, w in zip(names, wavs):
        if out_type == "d_hat" or it.gain_synthesis:
            g = "d_hat" if out_type == "d_hat" else "mmse-lsa"
            out[name] = dx.gain_synthesiser(g)(params, dx._padded(w, len(w)),
                                               dx.inp_tgt.n_frames(len(w)))[0].cpu().numpy()
        else:
            out[name] = dx._utterance_y(params, w, len(w), "mmse-lsa")
    return out


def _hold_wave(case, label, got_paths, y, y_ref, fail) -> str:
    """The route's float waveforms against the spectral plain route's, to
    OUT_TOL of each one's scale (an untrained family's gain or magnitude
    may put it far past full scale); the written wav is the route's
    waveform as `save_wav` quantises it (one int16 step at most, counted
    modulo 2^16 past the range); non-finite samples must match."""
    msgs = []
    for path in got_paths:
        name = os.path.basename(path)
        a, b = y[name], y_ref[name]
        fin = np.isfinite(b)
        if a.shape != b.shape or not np.array_equal(np.isfinite(a), fin):
            fail(f"[3k] {label} {name}: shape or non-finite samples differ")
        err = float(np.abs(a[fin] - b[fin]).max() / max(np.abs(b[fin]).max(), 1e-30))
        with np.errstate(invalid="ignore"):
            steps = _wrapped_steps(read_wav(path)[0][fin],
                                   np.asarray(a * 32768.0, np.int16)[fin])
        if not (err <= OUT_TOL and steps <= 1):
            fail(f"[3k] {label} {name}: {err:.3e} of the scale from the spectral plain "
                 f"route, the wav {steps} int16 steps from the route's waveform")
        msgs.append(f"{err:.3e} of the scale (peak {np.abs(b[fin]).max():.3g}"
                    + (f", {int((~fin).sum())} non-finite samples" if not fin.all() else "")
                    + ")")
    return "; ".join(msgs)


def _hold(case, it, out_type, got, ref, xi_ref, fail) -> str:
    """One written .mat file against the spectral plain route's; a
    message."""
    from scipy.io import loadmat
    key = "d_psd_hat" if out_type == "deepmmse" else out_type
    a, b = loadmat(got)[key], loadmat(ref)[key]
    if a.shape != b.shape:
        fail(f"[3k] {case} {out_type}: shape {a.shape}, plain {b.shape}")
    if out_type in ("ibm_hat", "subband_ibm_hat"):
        if xi_ref is None:
            fail(f"[3k] {case} {out_type}: no plain xi_hat to place the ties")
        xi = xi_ref if out_type == "ibm_hat" else xi_ref @ mel_filter_bank(
            40, it.K, it.f_s).T
        flips = a != b
        worst = float(np.abs(10 * np.log10(np.maximum(xi, 1e-30)))[flips].max()) \
            if flips.any() else 0.0
        if worst > MASK_TIE_DB:
            fail(f"[3k] {case} {out_type}: a bin at {worst:.3e} dB from 0 dB differs")
        return f"{int(flips.sum())} bins differ (within {MASK_TIE_DB:g} dB of 0 dB)"
    if out_type in ("xi_hat", "gamma_hat", "mag_hat", "cd_hat"):
        d = np.abs(_network_units(it, out_type, a) - _network_units(it, out_type, b))
        if out_type == "gamma_hat" and type(it).__name__ == "MagXi":
            # read back through xi = gamma - 1 only where float32 keeps xi
            # (gamma > 1.001: below, the subtraction cancels xi's digits)
            d = d[b > 1.001]
        err = float(d.max())
        unit = "abs in the network's output units"
    else:
        err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        unit = "of the scale"
    if not err <= OUT_TOL:
        fail(f"[3k] {case} {out_type}: {err:.3e} {unit} from the spectral plain route")
    return f"{err:.3e} {unit}"


def _padded_utterances(dx, test_dir):
    """(name, [1, bucket_length] int16 on the device) of each test wav, as
    infer pads it."""
    for name in sorted(os.listdir(test_dir)):
        x = read_wav(os.path.join(test_dir, name))[0]
        yield name, torch.as_tensor(dx._padded(x, len(x)), device=dx.device)


def _network_check(dx, params, test_dir, fail, phase="[3k]") -> str:
    """The kernels' network forward (`fast_apply`, B1/B4) against the plain
    network on each test utterance's network input, padded as infer pads
    it: the largest difference over its frames, NET_ATOL at most."""
    from deepxi_tpu_torch.sig.mix import normalise
    it, msgs = dx.inp_tgt, []
    for name, xp in _padded_utterances(dx, test_dir):
        with torch.no_grad():
            inp = spectral.stft_mag(normalise(xp), it.N_d, it.N_s, it.K) if it.mag_input \
                else it.observation(xp)[0]
            n = it.n_frames(int(read_wav(os.path.join(test_dir, name))[0].shape[0]))
            err = (dx.fast_apply()(params, inp) - functional_call(dx.network, params, (inp,))
                   )[:, :n].abs().max().item()
        if not err <= NET_ATOL:
            fail(f"{phase} {dx.cfg.inp_tgt_type} {name}: the kernels' network output is "
                 f"{err:.3e} from the plain network's")
        msgs.append(f"{name} (T={inp.shape[1]}) {err:.3e}")
    return ", ".join(msgs)


def _case(case, dirs, test_dir, tmp, dev, fail, launches, times):
    fields, out_types = CASES[case]
    cfg = preset("resnet-1.1c", mbatch_size=TRAIN_B, sample_size=16,
                 max_epochs=1, val_flag=False, seed=5, model_path=os.path.join(tmp, "model"),
                 log_path=os.path.join(tmp, "log"), data_path=os.path.join(tmp, "data"),
                 test_x_path=test_dir, out_path=os.path.join(tmp, "out"), **fields)
    cfg = cfg.replace(ver="resnet-1.1c-" + case.replace(" ", "-").replace("=", ""))
    s_list = batch_list(dirs[0], "clean", cfg.data_path)[:3 * TRAIN_B]
    d_list = batch_list(dirs[1], "noise", cfg.data_path)
    t0 = time.perf_counter()
    dx = DeepXiTorch(cfg, s_list, d_list, device=dev)
    it = dx.inp_tgt
    t_stats = time.perf_counter() - t0
    _zero()
    t0 = time.perf_counter()
    losses = dx.train(verbose=False)
    _sync(dev)
    t_train = time.perf_counter() - t0
    n = _counts()
    for k in ("B5", "B6"):
        launches.setdefault(k, {})[f"{case} train, 3 steps"] = n[k]
    if not (n["B5"] and n["B6"]) or not np.isfinite(losses).all():
        fail(f"[3k] {case}: training launched B5 {n['B5']}, B6 {n['B6']}; losses {losses}")
    w, leaf, fwd, shape, readings = _crop_grads(dx, s_list, d_list, dev)
    print(f"[3k] {case} ({type(it).__name__}, n_feat {it.n_feat}, n_outp {it.n_outp}, "
          f"N_s {cfg.N_s}): statistics {t_stats:.2f} s; 3 train steps at B={TRAIN_B} in "
          f"{t_train:.2f} s, loss {losses[0]:.5f}, B5 {n['B5']} B6 {n['B6']}; first step's "
          f"gradients on {shape} against float64 autograd of the plain network along "
          f"B5's trajectory: worst rel err {w:.3e} at {leaf} (tol {GRAD_TOL_REL:.0e}); B5's "
          f"block inputs {fwd:.3e} of their scale from the plain network's (tol "
          f"{FWD_TOL_REL:.0e}); {readings}")
    if not (w <= GRAD_TOL_REL and fwd <= FWD_TOL_REL):
        fail(f"[3k] {case}: the fused stack's gradients or B5's forward disagree with the "
             "plain ResNetV2")
    times[f"{case} train step"] = t_train / 3 * 1e3

    params = dx._state.params
    print(f"[3k] {case}: the kernels' network output against the plain network's, max abs "
          f"(tol {NET_ATOL:.0e}): {_network_check(dx, params, test_dir, fail)}")
    # the spectral plain route: the same network forward, no spectral kernel
    # (the batched `y` takes none, so there both routes are one computation:
    # its kernels, B1 and B4, are held by the network check above)
    plain = DeepXiTorch(cfg.replace(out_path=os.path.join(tmp, "out_plain")), device=dev)
    plain.fast_apply = dx.fast_apply
    plain.estimator = functools.partial(plain.estimator, kernels=False)
    plain.gain_synthesiser = functools.partial(plain.gain_synthesiser, kernels=False)
    kernel_route = spectral.kernel_takes(cfg.N_d, cfg.N_s, cfg.K)
    runs = [("y", True)] + ([("y", False)] if it.gain_synthesis else []) + \
        [(o, True) for o in out_types]
    xi_ref = {}
    for out_type, fast in runs:
        kw = dict(params=params, out_type=out_type, epochs=[1], gains=["mmse-lsa"],
                  fast=fast)
        batched = out_type == "y" and fast and it.gain_form
        ref = None if batched else plain.infer(**kw)
        _zero()
        t0 = time.perf_counter()
        got = dx.infer(**kw)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        n = _counts()
        label = f"{case} infer {out_type}{'' if fast else ' fast=False'}"
        times[label] = wall
        for k in ("B1", "B2", "B3", "B4"):
            launches.setdefault(k, {})[label] = n[k]
        synth = out_type == "d_hat" or (out_type == "y" and not batched
                                         and it.gain_synthesis)
        want_b2 = kernel_route and it.mag_input and not (batched or synth)
        want_b3 = kernel_route and synth
        if not (n["B1"] and n["B4"]) or (n["B2"] > 0) != want_b2 or \
                (n["B3"] > 0) != want_b3:
            fail(f"[3k] {label}: launches {n}")
        if out_type == "xi_hat":
            from scipy.io import loadmat
            xi_ref = {os.path.basename(p): loadmat(p)["xi_hat"] for p in ref}
        if batched:
            msgs = ["the batched route (no spectral kernel; B1/B4 held above)"]
        elif out_type in ("y", "d_hat"):
            y_ref = _float_outputs(plain, params, out_type, test_dir)
            msgs = [_hold_wave(case, label, got, _float_outputs(
                dx, params, out_type, test_dir), y_ref, fail)]
        else:
            msgs = [_hold(case, it, out_type, g, r, xi_ref.get(os.path.basename(g)), fail)
                    for g, r in zip(got, ref)]
        if not (batched or want_b2 or want_b3):
            msgs.append("no spectral kernel on this route: both sides are one computation, "
                        "its B1/B4 held by the network check")
        print(f"[3k] {label}: {wall:.1f} ms for 4 s + 20 s; launches B1 {n['B1']} B2 "
              f"{n['B2']} B3 {n['B3']} B4 {n['B4']}; against the spectral plain route: "
              f"{'; '.join(msgs)}")


def _resnet_1_1n(dev, fail, times):
    """resnet-1.1n's plain network through `make_enhancer` beside
    resnet-1.1c's kernel route, both on seeded weights."""
    art = load_flagship_artifact(device=dev)
    x4 = art.noisy[None]
    long = np.tile(art.noisy, -(-160000 // art.noisy.shape[0]))[:160000]
    x96 = np.stack([np.roll(long, 997 * i) for i in range(96)])
    for ver in ("resnet-1.1n", "resnet-1.1c"):
        cfg = preset(ver)
        net = init_flax_like(build_network(cfg, 257, 257),
                             torch.Generator().manual_seed(11)).to(dev).eval()
        params = {k: v.detach() for k, v in net.state_dict().items()}
        enh = enhance.make_enhancer(art.inp_tgt, net, apply_fn=fast_apply_fn(cfg), device=dev)
        for label, x in (("B=1 x 4 s", x4), ("B=96 x 10 s", x96)):
            _zero()
            y = enh(params, x)
            _sync(dev)
            n = _counts()
            if not torch.isfinite(y).all() or y.shape[0] != x.shape[0]:
                fail(f"[3k] {ver} {label}: the waveform is not finite")
            if (ver == "resnet-1.1n") == bool(n["B1"] + n["B4"]):
                fail(f"[3k] {ver} {label}: TCN kernel launches {n}")
            ts = []
            for _ in range(12):
                t0 = time.perf_counter()
                enh(params, x)
                _sync(dev)
                ts.append((time.perf_counter() - t0) * 1e3)
            ts = np.sort(ts[2:])
            times[f"{ver} make_enhancer {label}"] = float(np.median(ts))
            route = "plain network" if ver == "resnet-1.1n" else "fused TCN kernels"
            print(f"[3k] {ver} make_enhancer {label} ({route}): "
                  f"median {np.median(ts):.3f} ms (min {ts[0]:.3f}, max {ts[-1]:.3f}); "
                  f"B1 {n['B1']} B4 {n['B4']} a call")


def families_phase(device, fail) -> dict:
    dev = torch.device(device)
    launches, times = {}, {}
    tmp = tempfile.mkdtemp(prefix="deepxi_families_")
    try:
        t0 = time.perf_counter()
        dirs = write_corpus(os.path.join(tmp, "set"))
        art_noisy = read_wav(os.path.join(FLAGSHIP_ROOT, "c012_white_5dB.wav"))[0]
        test_dir = os.path.join(tmp, "test")
        save_wav(os.path.join(test_dir, "c012_white_5dB.wav"), art_noisy, 16000)
        save_wav(os.path.join(test_dir, "c012_white_5dB_x5.wav"), np.tile(art_noisy, 5), 16000)
        print(f"[3k] corpus of 24 x 4 s and test set ({time.perf_counter() - t0:.1f} s)")
        for case in CASES:
            _case(case, dirs, test_dir, os.path.join(tmp, case.replace(" ", "_")), dev, fail,
                  launches, times)
        _resnet_1_1n(dev, fail, times)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "times": times}


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False

    failures = []

    def _record(msg):
        print(f"FAIL: {msg}", flush=True)
        failures.append(msg)

    t = time.perf_counter()
    families_phase("cuda", _record)
    print(f"families phase: {time.perf_counter() - t:.1f} s, {len(failures)} failures")
    sys.exit(1 if failures else 0)
