"""Training: masked losses, the reference's optimizers, the train and eval
steps, and per-epoch checkpoints with optimizer state (follows
deepxi_tpu/training/trainer.py).

The example pipeline (SNR mix -> STFT -> map) runs on the device inside the
train step, as in the JAX package. The optimizer is written out here, in
optax's arithmetic (elementwise clip, then Adam with bias correction and a
step size from the update count), so that its state is a plain dict that
`torch.save` keeps.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import torch
from torch.func import functional_call


def transformer_schedule(d_model: int, warmup_steps: int) -> Callable[[int], float]:
    """rsqrt(d_model) * min(rsqrt(step), step * warmup^-1.5), step >= 1."""
    def sched(step: int) -> float:
        step = max(float(step), 1.0)
        return d_model ** -0.5 * min(step ** -0.5, step * warmup_steps ** -1.5)
    return sched


@dataclass(frozen=True)
class ClipAdam:
    """optax.chain(optax.clip(clip), optax.adam(lr, b1, b2, eps)): gradients
    clipped elementwise to [-clip, clip], then Adam; `lr` is a number or a
    schedule of the update count (0 for the first update)."""
    lr: Union[float, Callable[[int], float]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip: float = 1.0

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def update(self, grads: Dict[str, torch.Tensor], state: Dict):
        """Returns (updates to add to the parameters, new state)."""
        lr = self.lr(state["count"]) if callable(self.lr) else self.lr
        count = state["count"] + 1
        bc1, bc2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        keys = list(grads)
        # multi-tensor ops: a dozen launches for all tensors, not per tensor
        with torch.no_grad():
            g = torch._foreach_clamp_max(torch._foreach_clamp_min(
                [grads[k] for k in keys], -self.clip), self.clip)
            mu = torch._foreach_add(
                torch._foreach_mul(g, 1.0 - self.b1),
                torch._foreach_mul([state["mu"][k] for k in keys], self.b1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2),
                torch._foreach_mul([state["nu"][k] for k in keys], self.b2))
            den = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(nu, bc2)), self.eps)
            upd = torch._foreach_mul(
                torch._foreach_div(torch._foreach_div(mu, bc1), den), -lr)
        return dict(zip(keys, upd)), {"count": count, "mu": dict(zip(keys, mu)),
                                      "nu": dict(zip(keys, nu))}


def make_optimizer(network_type: str, d_model: int = 256,
                   warmup_steps: int = 40000) -> ClipAdam:
    """Adam 1e-3 after an elementwise clip of 1.0; MHA nets take the
    Transformer schedule with beta2 0.98 and eps 1e-9."""
    if "MHA" in network_type:
        return ClipAdam(lr=transformer_schedule(d_model, warmup_steps),
                        b2=0.98, eps=1e-9)
    return ClipAdam(lr=1e-3)


def masked_loss(pred: torch.Tensor, tgt: torch.Tensor, seq_mask: torch.Tensor,
                loss_fnc: str) -> torch.Tensor:
    """Keras loss with temporal sample weights: per-frame loss (mean over
    bins) weighted by the sequence mask, averaged over the padded [B, T]
    grid. BCE clips pred to [1e-7, 1 - 1e-7] as Keras does (not
    F.binary_cross_entropy, which clamps the log at -100)."""
    if loss_fnc == "BinaryCrossentropy":
        p = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
        frame = -torch.mean(tgt * torch.log(p) + (1.0 - tgt) * torch.log(1.0 - p),
                            dim=-1)
    elif loss_fnc == "MeanSquaredError":
        frame = torch.mean(torch.square(pred - tgt), dim=-1)
    else:
        raise ValueError(f"Invalid loss function: {loss_fnc!r}")
    return torch.mean(frame * seq_mask)


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict

    @classmethod
    def create(cls, params: Dict[str, torch.Tensor], tx: ClipAdam) -> "TrainState":
        params = {k: v.detach().clone() for k, v in params.items()}
        return cls(step=0, params=params, opt_state=tx.init(params))


def frame_mask(T: int, n_frames: torch.Tensor, device) -> torch.Tensor:
    """[B, T] float mask of each row's first n_frames frames."""
    return (torch.arange(T, device=device)[None, :]
            < n_frames.to(device)[:, None]).to(torch.float32)


def make_train_step(network: torch.nn.Module, inp_tgt, tx: ClipAdam,
                    loss_fnc: str = "BinaryCrossentropy",
                    apply_fn: Optional[Callable] = None) -> Callable:
    """Build (state, s, d, s_len, d_len, snr, generator=None, offsets=None)
    -> (state, {"loss"}): example synthesis, forward, backward and update.
    `s`, `d` are int16 [B, L] tensors on the device; the noise offsets come
    from `offsets` or are drawn from `generator`. `apply_fn(params, inp)`
    replaces the network's own forward, e.g.
    `tcn_fused_train.resnetv2_apply_fused_train`."""
    net_apply = apply_fn or (lambda p, m: functional_call(network, p, (m,)))

    def train_step(state: TrainState, s, d, s_len, d_len, snr,
                   generator: Optional[torch.Generator] = None,
                   offsets: Optional[torch.Tensor] = None):
        inp, tgt, n_frames = inp_tgt.example(s, d, s_len, d_len, snr,
                                             generator, offsets)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        pred = net_apply(params, inp)
        loss = masked_loss(pred, tgt, frame_mask(inp.shape[1], n_frames, inp.device),
                           loss_fnc)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        updates, opt_state = tx.update(grads, state.opt_state)
        with torch.no_grad():
            keys = list(state.params)
            new = dict(zip(keys, torch._foreach_add([state.params[k] for k in keys],
                                                    [updates[k] for k in keys])))
        return TrainState(state.step + 1, new, opt_state), {"loss": loss.detach()}

    return train_step


def make_eval_step(network: torch.nn.Module,
                   loss_fnc: str = "BinaryCrossentropy") -> Callable:
    """Validation loss on precomputed (inp, tgt, seq_mask) batches."""

    @torch.no_grad()
    def eval_step(params, inp, tgt, seq_mask):
        pred = functional_call(network, params, (inp,))
        return masked_loss(pred, tgt, seq_mask, loss_fnc)

    return eval_step


def _ckpt_path(model_dir: str, epoch: int) -> str:
    return os.path.join(model_dir, f"epoch-{epoch}", "state.pt")


def save_checkpoint(model_dir: str, epoch: int, state: TrainState) -> None:
    """Per-epoch checkpoint in the reference's `model/<ver>/epoch-<n>`
    layout: step, parameters and optimizer state, on the CPU."""
    path = _ckpt_path(model_dir, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cpu = lambda t: {k: v.detach().cpu() for k, v in t.items()}  # noqa: E731
    opt = state.opt_state
    torch.save({"step": state.step, "params": cpu(state.params),
                "opt_state": {"count": opt["count"], "mu": cpu(opt["mu"]),
                              "nu": cpu(opt["nu"])}}, path)


def restore_checkpoint(model_dir: str, epoch: int,
                       template: TrainState) -> TrainState:
    """Restore parameters AND optimizer state onto the devices of
    `template`'s parameters."""
    z = torch.load(_ckpt_path(model_dir, epoch), weights_only=True)
    dev = {k: v.device for k, v in template.params.items()}
    to = lambda t: {k: v.to(dev[k]) for k, v in t.items()}  # noqa: E731
    opt = z["opt_state"]
    return TrainState(z["step"], to(z["params"]),
                      {"count": opt["count"], "mu": to(opt["mu"]),
                       "nu": to(opt["nu"])})


def append_loss_csv(log_path: str, ver: str, epoch: int, loss: float,
                    val_loss: Optional[float] = None) -> None:
    """`log/loss/<ver>.csv` rows `epoch,loss[,val_loss]`."""
    d = os.path.join(log_path, "loss")
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, f"{ver}.csv")
    new = not os.path.exists(p)
    with open(p, "a") as f:
        if new:
            f.write("epoch,loss" + (",val_loss" if val_loss is not None else "") + "\n")
        row = f"{epoch},{loss}"
        if val_loss is not None:
            row += f",{val_loss}"
        f.write(row + "\n")
