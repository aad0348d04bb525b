"""The PyTorch port at widths other than the flagship's.

Every kernel's widths are compile-time constants, and the wrappers build one
library per set of widths. This module holds, for chip_smoke.py (phase 3f)
and tests/test_torch_cuda.py:

  * `kernel_checks(device)`: each kernel built for small widths (TCN d_model
    32 / d_f 16 / k 3 and 48 / 12 / 2; MHANet 4 heads of 8 and 12 heads of
    4, d_ff 4 d_model; the KV-cache step also at 5 heads of 4 and 16 of 64)
    against its plain version on the same inputs;
  * `small_widths_run(device, root)`: the routes a user calls at d_model 32
    (resnet-1.1c trained and run through `DeepXiTorch.infer`, MHANetV3 with
    4 heads through `mhanetv3_apply_fused` and "full", "fused" and "stream"
    attention, `StreamingMHANet(fused=True)`), whose outputs on the card are
    held against the same calls on the CPU;
  * `kernel_counts()`: every kernel wrapper's `launches` counter.

Run alone on a machine with a card: python3 tools/torch_small_widths.py
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from deepxi_tpu_torch.ops.kernels import (mha_block_fused, mha_cache,  # noqa: E402
                                          mha_flash_stream, mha_fused, spectral,
                                          tcn_fused, tcn_fused_train)

# (d_model, d_f, k) and (heads, head width); d_ff is 4 d_model, as the model's
SMALL_TCN = ((32, 16, 3), (48, 12, 2))
SMALL_HEADS = ((4, 8), (12, 4))
# and for the KV-cache step alone: bf16 rows of 40 bytes (the producer's
# 8-byte cp.async path), and 1024 columns (4-key f32 and 8-key bf16 tiles)
CACHE_HEADS = ((5, 4), (16, 64))
TOL_REL = 1e-4       # forward kernels: of the output's scale
BWD_TOL_REL = 2e-4   # the backward: of each leaf's scale, ReLU ties aside

WRAPPERS = (tcn_fused.fused_block_group_whole, tcn_fused.fused_block_group,
            tcn_fused.fused_block_group_whole_pack2,
            tcn_fused_train.fused_block_group_whole_saved,
            tcn_fused_train.fused_block_group_bwd,
            mha_block_fused.fused_transformer_block, mha_fused.flash_attention,
            mha_flash_stream.flash_attention_streaming, mha_cache.mha_cache_step,
            spectral.stft_mag_fused, spectral.enhance_frames_fused)

# The kernels `small_widths_run` must launch on the card.
ROUTE_KERNELS = ("fused_block_group_whole", "fused_block_group_whole_saved",
                 "fused_block_group_bwd", "fused_transformer_block",
                 "flash_attention", "flash_attention_streaming", "mha_cache_step")


def kernel_counts() -> Dict[str, int]:
    """Every kernel wrapper's `launches` counter, by name."""
    return {f.__name__: f.launches for f in WRAPPERS}


def build_specs():
    """The `_build` specs of every kernel at the small widths, to build them
    all at once."""
    specs = []
    for C, F, k in SMALL_TCN:
        specs += [tcn_fused.build_spec(n, C, F, k) for n in ("tcn_fused", "tcn_fused_train")]
    for H, d in SMALL_HEADS:
        specs += [("mha_attention", mha_fused.head_defines(H, d)),
                  mha_block_fused.build_spec(H, d, 4 * H * d)]
    return specs + [("mha_cache", mha_fused.head_defines(H, d))
                    for H, d in SMALL_HEADS + CACHE_HEADS]


def _rel(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max |y - ref| over ref's max abs; inf when y is not finite or not of
    ref's shape."""
    if y.shape != ref.shape or not torch.isfinite(y).all():
        return float("inf")
    return (y - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


def kernel_checks(device) -> Dict[str, float]:
    """Each kernel at the small widths against its plain version: the worst
    relative error by kernel and widths. The forward kernels are held to
    TOL_REL, the backward to BWD_TOL_REL (`bwd_ref_up_to_ties`)."""
    gen = torch.Generator().manual_seed(11)
    out = {}
    dil = [1, 2, 4]
    for C, F, k in SMALL_TCN:
        tag = f"d_model {C} d_f {F} k {k}"
        w = tcn_fused.random_block_weights(3, gen, device, d_model=C, d_f=F, k=k)
        x = torch.relu(torch.randn(3, 70, C, generator=gen)).to(device)
        dout = (torch.randn(3, 70, C, generator=gen) * 1e-3).to(device)
        tf = tcn_fused
        out[f"fused_block_group_whole, {tag}"] = _rel(
            tf.fused_block_group_whole(x, w, dil, k), tf.fused_block_group_whole_ref(x, w, dil, k))
        out[f"fused_block_group, {tag}"] = _rel(
            tf.fused_block_group(x, w, dil, k, tile_t=32),
            tf.fused_block_group_ref(x, w, dil, k, tile_t=32))
        for mode in tf.PACK2_LN_MODES:
            out[f"fused_block_group_whole_pack2 ({mode}), {tag}"] = _rel(
                tf.fused_block_group_whole_pack2(x, w, dil, k, mode),
                tf.fused_block_group_whole_pack2_ref(x, w, dil, k, mode))
        tt = tcn_fused_train
        y, hs = tt.fused_block_group_whole_saved(x, w, dil, k)
        y_r, hs_r = tt.fused_block_group_whole_saved_ref(x, w, dil, k)
        out[f"fused_block_group_whole_saved, {tag}"] = max(_rel(y, y_r), _rel(hs, hs_r))
        for saved in (hs, None):
            got = tt.fused_block_group_bwd(x, dout, w, dil, k, saved_h=saved)
            _, err, _ = tt.bwd_ref_up_to_ties(got, x, dout, w, dil, hs, BWD_TOL_REL, k)
            name = f"fused_block_group_bwd ({'saved' if saved is not None else 'replay'}), {tag}"
            out[name] = err
    for H, d in SMALL_HEADS:
        C = H * d
        tag = f"{H} heads of {d}"
        valid = (torch.arange(70)[None, :] < torch.tensor([[70], [41]])).to(device)
        q, kk, v = ((torch.randn(2, 70, H, d, generator=gen).to(device) * valid[:, :, None, None])
                    for _ in range(3))
        q = q * d ** -0.5
        errs = []
        for causal in (True, False):
            errs.append(_rel(mha_fused.flash_attention(q, kk, v, valid, causal),
                             mha_fused.flash_attention_ref(q, kk, v, valid, causal)))
        out[f"flash_attention, {tag}"] = max(errs)
        errs = []
        for causal in (True, False):
            errs.append(_rel(
                mha_flash_stream.flash_attention_streaming(q, kk, v, valid, causal, 32, 16),
                mha_flash_stream.flash_attention_streaming_ref(q, kk, v, valid, causal, 32, 16)))
        out[f"flash_attention_streaming, {tag}"] = max(errs)
        wb = mha_block_fused.random_block_weights(gen, device, d_model=C, n_heads=H,
                                                  d_ff=4 * C)
        xb = torch.randn(2, 70, C, generator=gen).to(device)
        vf = valid[:, None, :].float()
        out[f"fused_transformer_block, {tag}"] = max(
            _rel(mha_block_fused.fused_transformer_block(xb, vf, wb, causal),
                 mha_block_fused.fused_transformer_block_ref(xb, vf, wb, causal))
            for causal in (True, False))
    for H, d in SMALL_HEADS + CACHE_HEADS:
        # L = 300 ends on a partial 32-key chunk; the clock as an int and on
        # the device, past the cap too
        qc = (torch.randn(3, H, d, generator=gen) * d ** -0.5).to(device)
        for dtype in mha_cache.CACHE_DTYPES:
            kc, vc = (torch.randn(3, 300, H, d, generator=gen).to(device, dtype)
                      for _ in range(2))
            out[f"mha_cache_step ({str(dtype)[6:]}), {H} heads of {d}"] = max(
                _rel(mha_cache.mha_cache_step(qc, kc, vc, clock),
                     mha_cache.mha_cache_step_ref(qc, kc, vc, t))
                for t in (0, 31, 32, 150, 299, 400)
                for clock in (t, torch.tensor(t, dtype=torch.int32, device=device)))
    return out


def small_widths_run(device, root: str) -> Dict[str, torch.Tensor]:
    """The routes at d_model 32 on `device`: resnet-1.1c (d_f 16, 3 blocks)
    trained for one epoch of two steps through `DeepXiTorch.train` and then
    run through `infer`; an MHANetV3 with 4 heads of 8 through
    `mhanetv3_apply_fused` and "full", "fused" and "stream" attention; and
    `StreamingMHANet(fused=True)` at those widths. Returns every output."""
    from deepxi_tpu_torch.config import preset
    from deepxi_tpu_torch.data.listing import batch_list
    from deepxi_tpu_torch.data.wavio import read_wav, save_wav
    from deepxi_tpu_torch.framework import DeepXiTorch
    from deepxi_tpu_torch.inp_tgt import MagXi
    from deepxi_tpu_torch.models.attention import MHANetV3
    from deepxi_tpu_torch.ops.maps import NormalCDF
    from deepxi_tpu_torch.streaming import StreamingMHANet
    gen = torch.Generator().manual_seed(5)
    root = os.path.join(root, torch.device(device).type)
    dirs = {k: os.path.join(root, k) for k in ("clean", "noise", "data", "test")}
    for i in range(4):
        wav = (torch.randn(16000 + 700 * i, generator=gen) * 3000).to(torch.int16).numpy()
        save_wav(os.path.join(dirs["clean"], f"s{i}.wav"), wav, 16000)
        save_wav(os.path.join(dirs["test"], f"s{i}_white_5dB.wav"), wav, 16000)
    for i in range(2):
        wav = (torch.randn(32000, generator=gen) * 2000).to(torch.int16).numpy()
        save_wav(os.path.join(dirs["noise"], f"n{i}.wav"), wav, 16000)
    os.makedirs(dirs["data"])
    np.savez(os.path.join(dirs["data"], "resnet-1.1c_stats.npz"),
             **{"xi_map.mu": np.zeros(257, np.float32),
                "xi_map.sigma": np.full(257, 10.0, np.float32)})
    cfg = preset("resnet-1.1c", d_model=32, n_blocks=3, d_f=16, mbatch_size=2,
                 max_epochs=1, data_path=dirs["data"], set_path=root,
                 model_path=os.path.join(root, "model"), log_path=os.path.join(root, "log"),
                 out_path=os.path.join(root, "out"), test_x_path=dirs["test"])
    dx = DeepXiTorch(cfg, batch_list(dirs["clean"], "clean", dirs["data"]),
                     batch_list(dirs["noise"], "noise", dirs["data"]), device=device)
    out = {"losses": torch.tensor(dx.train(verbose=False))}
    out.update({f"trained {k}": v for k, v in dx._state.params.items()})
    for p in dx.infer(params=dx._state.params, epochs=[1]):
        out[os.path.basename(p)] = torch.as_tensor(read_wav(p)[0].astype(np.float32))

    net = MHANetV3(257, 257, d_model=32, n_blocks=2, n_heads=4, max_len=128)
    params = {k: torch.randn(v.shape, generator=gen) * 0.1 + k.endswith(".scale")
              for k, v in net.state_dict().items()}
    x = torch.rand(2, 40, 257, generator=gen)
    x[1, 29:] = 0.0  # a padded tail of invalid frames
    with torch.no_grad():
        y = mha_block_fused.mhanetv3_apply_fused(
            {k: v.to(device) for k, v in params.items()}, x.to(device), n_blocks=2,
            n_heads=4, d_model=32, max_len=128)
    out["mhanetv3_apply_fused"] = torch.cat([y[0], y[1, :29]])
    for impl in ("full", "fused", "stream"):
        net = MHANetV3(257, 257, d_model=32, n_blocks=2, n_heads=4, max_len=128,
                       attention_impl=impl, block_q=16)
        net.load_state_dict(params)
        with torch.no_grad():
            y = net.to(device)(x.to(device))
        out[f"MHANetV3 {impl}"] = torch.cat([y[0], y[1, :29]])
    it = MagXi(xi_map=NormalCDF(use_db=True, mu=torch.zeros(257),
                                sigma=torch.full((257,), 10.0)))
    wav = (torch.randn(2, 256 * 6, generator=gen) * 3000).to(torch.int16)
    out["StreamingMHANet(fused=True)"] = StreamingMHANet(
        it, net, params, fused=True, device=device).stream(wav)
    return {k: v.detach().cpu() for k, v in out.items()}


def compare_runs(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]):
    """(worst relative error of the non-wav outputs, its key, worst wav
    difference in int16 steps) of one `small_widths_run` against another;
    the error is inf where keys, shapes or finiteness differ."""
    if got.keys() != ref.keys():
        return float("inf"), "keys", float("inf")
    rel = {k: _rel(got[k], v) for k, v in ref.items() if not k.endswith(".wav")}
    worst = max(rel, key=rel.get)
    wav = max((got[k] - v).abs().max().item() if got[k].shape == v.shape else float("inf")
              for k, v in ref.items() if k.endswith(".wav"))
    return rel[worst], worst, wav


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    import tempfile
    errs = kernel_checks(torch.device("cuda"))
    for name, err in errs.items():
        print(f"{name}: {err:.3e}")
    with tempfile.TemporaryDirectory() as tmp:
        n = kernel_counts()
        got = small_widths_run("cuda", tmp)
        moved = {k: v - n[k] for k, v in kernel_counts().items() if v != n[k]}
        print("launches:", moved)
        print("against the CPU:", compare_runs(got, small_widths_run("cpu", tmp)))
