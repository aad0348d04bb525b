"""Synthetic sanity harness (follows deepxi_tpu/prelim.py): trains a network
on random sequences toward a known constant target and reports the
prediction's distance from it, a smoke test of the network, the masking and
the trainer that needs no audio. Reached through ``--prelim 1``."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch.func import functional_call

from deepxi_tpu_torch import resolve_device
from deepxi_tpu_torch.config import Config
from deepxi_tpu_torch.framework import build_network
from deepxi_tpu_torch.models import init_flax_like
from deepxi_tpu_torch.training import TrainState, make_optimizer, masked_loss


def run_prelim(network_type: str = "ResNetV2", n_steps: int = 60,
               batch: int = 4, T: int = 32, n_feat: int = 257,
               target_value: float = 0.75, seed: int = 0,
               verbose: bool = True, device=None, **net_kwargs) -> Tuple[float, float]:
    """Train the plain network under autograd for `n_steps` Adam steps on
    |N(0, 1)| inputs drawn each step from a generator on `device` (the card
    unless ``device="cpu"``) seeded with `seed + 1`, masked to lengths drawn
    from numpy's `RandomState(seed)`, toward `target_value` everywhere (the
    masked mean squared error). Returns (final loss, mean |prediction -
    target| over the valid frames of a last draw). The network defaults to
    d_model 32, 4 blocks, d_f 16, k 3, dilations up to 4, causal, Sigmoid
    output, as the JAX harness's (each network reads the keys it takes: RDLNet
    its 4 blocks at its default length and m_1, the LSTMs d_model and the
    blocks); its default of 50 steps is 60 here, the count its convergence
    test runs. An unknown `network_type` raises ValueError."""
    dev = resolve_device(device)
    kw = dict(d_model=32, n_blocks=4, d_f=16, k=3, max_d_rate=4, causal=True,
              unit_type="ReLU->LN->W+b", outp_act="Sigmoid")
    kw.update(net_kwargs)
    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(network_type=network_type,
                 **{k: v for k, v in kw.items() if v is not None and k in fields})
    if cfg.n_heads is None and "MHA" in network_type:
        cfg = cfg.replace(n_heads=8)
    net = build_network(cfg, n_feat, n_feat)
    init_flax_like(net, torch.Generator().manual_seed(seed))
    net.to(dev)
    tx = make_optimizer(network_type, cfg.d_model or 32, 4000)
    state = TrainState.create(dict(net.state_dict()), tx)

    lengths = np.random.RandomState(seed).randint(T // 2, T + 1, batch)
    mask = torch.as_tensor((np.arange(T)[None, :] < lengths[:, None]).astype(np.float32),
                           device=dev)
    tgt = torch.full((batch, T, n_feat), target_value, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def draw() -> torch.Tensor:
        return torch.randn(batch, T, n_feat, generator=gen, device=dev).abs() * mask[..., None]

    loss = torch.tensor(float("inf"))
    for i in range(n_steps):
        inp = draw()
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss = masked_loss(functional_call(net, params, (inp,)), tgt, mask,
                           "MeanSquaredError")
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        updates, opt_state = tx.update(grads, state.opt_state)
        with torch.no_grad():
            new = {k: state.params[k] + updates[k] for k in state.params}
        state = TrainState(state.step + 1, new, opt_state)
        if verbose and i % 10 == 0:
            print(f"prelim step {i}: loss {float(loss.detach()):.5f}")

    with torch.no_grad():
        pred = functional_call(net, state.params, (draw(),))
        mae = float(torch.sum(torch.abs(pred - tgt) * mask[..., None])
                    / (torch.sum(mask) * n_feat))
    if verbose:
        print(f"prelim: target {target_value} mean|pred-target| {mae:.4f}")
    return float(loss.detach()), mae
