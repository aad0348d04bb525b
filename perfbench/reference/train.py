"""Deep Xi's training step, written plainly: the example (speech and noise
mixed at the SNR, the family's features of the noisy spectrum and its
target from the clean and noise spectra), the network, Keras's binary
cross-entropy weighted by the frame mask and averaged over the padded grid,
autograd's gradients, then an elementwise clip and Adam (optax's
arithmetic)."""

from __future__ import annotations

import math

import torch

import perfbench.reference as ref
from perfbench.reference import dsp


def example(batch: dict, cfg: dict, stats: dict):
    """(features [B, T, n_feat], target [B, T, n_outp], frame mask [B, T])."""
    N_d, N_s, K = cfg["N_d"], cfg["N_s"], cfg["K"]
    fam = ref.family(cfg)
    s = batch["s"].float() / 32768.0
    d = batch["d"].float() / 32768.0
    x, s, d = dsp.add_noise(s, d, batch["s_len"], batch["offsets"], batch["snr"])
    S, D, X = (dsp.stft(w, N_d, N_s, K) for w in (s, d, x))
    n_frames = torch.ceil(batch["s_len"].float() / N_s)
    mask = (torch.arange(X.shape[1], device=X.device)[None, :] < n_frames[:, None]).float()
    return fam.features(X), fam.target(S, D, cfg, stats), mask


def loss(pred, tgt, mask, loss_fnc: str):
    """Keras's loss, a frame's mean over bins, weighted by the mask and
    averaged over the padded grid (binary cross-entropy, the one loss of
    the configurations' networks)."""
    if loss_fnc != "BinaryCrossentropy":
        raise LookupError(f"the reference has no loss {loss_fnc!r}")
    p = pred.clamp(1e-7, 1.0 - 1e-7)
    frame = -(tgt * torch.log(p) + (1.0 - tgt) * torch.log(1.0 - p)).mean(-1)
    return (frame * mask).mean()


def adam_start(params: dict) -> dict:
    """The optimizer's state before its first update."""
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def steps(params: dict, batches, cfg: dict, stats: dict, tf32: bool = False, opt: dict = None):
    """Follow `len(batches)` train steps from `params` and the optimizer
    state `opt` (count, first and second moments; None: before the first
    update), the network's products in float32 (or with `tf32`, their
    operands rounded to TF32). Returns (losses, the first step's clipped
    gradients, the parameters after the last)."""
    o = cfg["optimizer"]
    lr, b1, b2, eps, clip = o["lr"], o["b1"], o["b2"], o["eps"], o["clip"]
    net = ref.net(cfg).forward
    mm = ref.matmul_tf32 if tf32 else ref.matmul
    opt = opt or adam_start(params)
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: v.detach().clone() for k, v in opt["mu"].items()}
    v2 = {k: v.detach().clone() for k, v in opt["nu"].items()}
    losses, first = [], None
    for n, batch in enumerate(batches, start=opt["count"] + 1):
        X, tgt, mask = example(batch, cfg, stats)
        leaves = {k: t.requires_grad_(True) for k, t in p.items()}
        value = loss(net(leaves, X, cfg, mm), tgt, mask, cfg["loss_fnc"])
        grads = torch.autograd.grad(value, list(leaves.values()))
        losses.append(float(value.detach()))
        with torch.no_grad():
            g = {k: gr.clamp(-clip, clip) for k, gr in zip(leaves, grads)}
            if first is None:
                first = g
            for k in p:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1 - b2) * g[k].square()
                step = (m[k] / (1 - b1 ** n)) / (torch.sqrt(v2[k] / (1 - b2 ** n)) + eps)
                p[k] = p[k].detach() - lr * step
    return losses, first, p


def norm(t: torch.Tensor) -> float:
    return math.sqrt(float(t.double().square().sum()))
