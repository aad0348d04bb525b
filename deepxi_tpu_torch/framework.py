"""Framework facade: map statistics and the training loop (follows
deepxi_tpu/framework.py; `infer`, `test` and `spectral_distortion` are still
to port, and there is no device mesh and no phoneme mode).

Artifact layout as in the JAX package:

  model/<ver>/epoch-<n>/state.pt   checkpoints (params + optimizer state)
  data/<ver>_stats.npz             map statistics
  data/sample.npz                  cached training sample
  log/loss/<ver>.csv               epoch,loss[,val_loss]
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deepxi_tpu_torch import resolve_device
from deepxi_tpu_torch.config import Config
from deepxi_tpu_torch.data.listing import val_wav_batch
from deepxi_tpu_torch.data.loader import MiniBatchLoader, bucket_length
from deepxi_tpu_torch.inp_tgt import MagXi
from deepxi_tpu_torch.models.tcn import ResNetV2, init_flax_like
from deepxi_tpu_torch.ops.maps import NormalCDF
from deepxi_tpu_torch.training import (TrainState, append_loss_csv,
                                       frame_mask, make_eval_step,
                                       make_optimizer, make_train_step,
                                       restore_checkpoint, save_checkpoint)


class DeepXiTorch:
    """Deep Xi on one device (the card unless ``device="cpu"``): the MagXi
    target with the DBNormalCDF map and the causal ReLU->LN->W+b ResNetV2."""

    def __init__(self, cfg: Config, train_s_list: Optional[List[Dict]] = None,
                 train_d_list: Optional[List[Dict]] = None, device=None):
        if (cfg.inp_tgt_type, cfg.map_type, cfg.network_type) != (
                "MagXi", "DBNormalCDF", "ResNetV2"):
            raise ValueError("the port trains MagXi / DBNormalCDF / ResNetV2 so "
                             f"far, not {cfg.inp_tgt_type} / {cfg.map_type} / "
                             f"{cfg.network_type}")
        if not cfg.causal or cfg.unit_type != "ReLU->LN->W+b":
            raise ValueError("the port's ResNetV2 is causal with ReLU->LN->W+b units")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_s_list = train_s_list
        self.train_d_list = train_d_list
        self.inp_tgt = MagXi(cfg.N_d, cfg.N_s, cfg.K, NormalCDF(use_db=True))

        stats_path = os.path.join(cfg.data_path, f"{cfg.ver}_stats.npz")
        if os.path.exists(stats_path) and not cfg.reset_inp_tgt:
            self.inp_tgt = self._load_stats(stats_path)
        elif self._needs_stats():
            s, d, x, wl = self.sample(cfg.sample_size)
            self.inp_tgt = self.inp_tgt.with_stats(s, d, x, wl, device=self.device)
            self._save_stats(stats_path)

        self.network = ResNetV2(self.inp_tgt.n_feat, self.inp_tgt.n_outp,
                                n_blocks=cfg.n_blocks, d_model=cfg.d_model,
                                d_f=cfg.d_f, k=cfg.k, max_d_rate=cfg.max_d_rate,
                                outp_act=cfg.outp_act)

    # -- statistics ---------------------------------------------------------

    def _needs_stats(self) -> bool:
        return self.inp_tgt.xi_map.mu is None

    def _save_stats(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        m = self.inp_tgt.xi_map
        np.savez(path, **{"xi_map.mu": m.mu.cpu().numpy(),
                          "xi_map.sigma": m.sigma.cpu().numpy()})

    def _load_stats(self, path: str) -> MagXi:
        z = np.load(path)
        xi_map = NormalCDF(use_db=True,
                           mu=torch.as_tensor(z["xi_map.mu"], device=self.device),
                           sigma=torch.as_tensor(z["xi_map.sigma"], device=self.device))
        return MagXi(self.inp_tgt.N_d, self.inp_tgt.N_s, self.inp_tgt.K, xi_map)

    def sample(self, sample_size: int):
        """Training-set sample for the map statistics, cached as
        ``data/sample.npz``: utterances drawn with replacement, each mixed
        with a noise crop at a training SNR."""
        cfg = self.cfg
        sample_path = os.path.join(cfg.data_path, "sample.npz")
        if os.path.exists(sample_path) and not cfg.reset_sample:
            z = np.load(sample_path)
            return z["s_sample"], z["d_sample"], z["x_sample"], z["wav_len"]
        if not self.train_s_list:
            raise ValueError("no sample.npz and no training list to draw from")
        rng = np.random.default_rng(cfg.seed)
        idx_s = rng.choice(len(self.train_s_list), sample_size, replace=True)
        loader = MiniBatchLoader(self.train_s_list, self.train_d_list, 1,
                                 cfg.snr_levels, seed=cfg.seed)
        L = bucket_length(max(self.train_s_list[i]["wav_len"] for i in idx_s),
                          cfg.N_s)
        s_s = np.zeros((sample_size, L), np.float32)
        d_s, x_s = np.zeros_like(s_s), np.zeros_like(s_s)
        wl = np.zeros(sample_size, np.int32)
        gen = torch.Generator().manual_seed(cfg.seed)
        for j, i in enumerate(idx_s):
            s, d, s_len, d_len, snr = loader._load_batch([self.train_s_list[i]])
            s_f, d_f, x_f, _ = self.inp_tgt.mix(
                *(torch.as_tensor(a, device=self.device) for a in (s, d)),
                torch.as_tensor(s_len), torch.as_tensor(d_len),
                torch.as_tensor(snr), generator=gen)
            n = int(s_len[0])
            s_s[j, :n] = s_f[0, :n].cpu().numpy()
            d_s[j, :n] = d_f[0, :n].cpu().numpy()
            x_s[j, :n] = x_f[0, :n].cpu().numpy()
            wl[j] = n
        os.makedirs(cfg.data_path, exist_ok=True)
        np.savez(sample_path, s_sample=s_s, d_sample=d_s, x_sample=x_s, wav_len=wl)
        return s_s, d_s, x_s, wl

    # -- training -----------------------------------------------------------

    def init_params(self) -> Dict[str, torch.Tensor]:
        """Seeded initial parameters (flax's scheme, `cfg.seed`) on the
        device."""
        init_flax_like(self.network.to("cpu"),
                       torch.Generator().manual_seed(self.cfg.seed))
        self.network.to(self.device)
        return {k: v.detach().clone() for k, v in self.network.state_dict().items()}

    def apply_fn(self):
        """The network forward of the train step: the fused stack when
        `cfg.tcn_fused_train`, else None (the plain network)."""
        cfg = self.cfg
        if not cfg.tcn_fused_train:
            return None
        from deepxi_tpu_torch.ops.kernels.tcn_fused_train import \
            resnetv2_apply_fused_train
        # save_acts: the backward reads every block's input instead of
        # replaying the forward
        return (lambda p, m: resnetv2_apply_fused_train(
            p, m, n_blocks=cfg.n_blocks, max_d_rate=cfg.max_d_rate, k=cfg.k,
            save_acts=True, outp_act=cfg.outp_act))

    def train(self, verbose: bool = True) -> List[float]:
        """The training loop; returns the per-epoch mean losses. The final
        state is kept as `self._state`."""
        cfg = self.cfg
        model_dir = os.path.join(cfg.model_path, cfg.ver)
        os.makedirs(model_dir, exist_ok=True)
        tx = make_optimizer(cfg.network_type, cfg.d_model or 256, cfg.warmup_steps)
        state = TrainState.create(self.init_params(), tx)
        if cfg.resume_epoch > 0:
            state = restore_checkpoint(model_dir, cfg.resume_epoch - 1, state)
        train_step = make_train_step(self.network, self.inp_tgt, tx,
                                     cfg.loss_fnc, apply_fn=self.apply_fn())
        loader = MiniBatchLoader(self.train_s_list, self.train_d_list,
                                 cfg.mbatch_size, cfg.snr_levels, seed=cfg.seed,
                                 N_s=cfg.N_s)
        val_set = self._build_val_set() if cfg.val_flag else None
        eval_step = make_eval_step(self.network, cfg.loss_fnc)

        gen = torch.Generator().manual_seed(cfg.seed + 1)
        dev = self.device
        losses: List[float] = []
        for epoch in range(cfg.resume_epoch, cfg.max_epochs):
            t0 = time.time()
            step_losses = []
            for s, d, s_len, d_len, snr in loader.epoch(epoch):
                state, metrics = train_step(
                    state, torch.as_tensor(s, device=dev),
                    torch.as_tensor(d, device=dev), torch.as_tensor(s_len),
                    torch.as_tensor(d_len), torch.as_tensor(snr), generator=gen)
                step_losses.append(metrics["loss"])
            # one device-to-host read per epoch
            mean_loss = float(torch.stack(step_losses).mean()) if step_losses else 0.0
            val_loss = None
            if val_set and ((epoch + 1) % max(cfg.val_every, 1) == 0
                            or epoch == cfg.max_epochs - 1):
                val_loss = float(np.mean([float(eval_step(state.params, *b))
                                          for b in val_set]))
            losses.append(mean_loss)
            append_loss_csv(cfg.log_path, cfg.ver, epoch, mean_loss, val_loss)
            if cfg.save_model and ((epoch + 1) % max(cfg.save_every, 1) == 0
                                   or epoch == cfg.max_epochs - 1):
                save_checkpoint(model_dir, epoch, state)
            if verbose:
                msg = f"epoch {epoch}: loss {mean_loss:.4f}"
                if val_loss is not None:
                    msg += f" val {val_loss:.4f}"
                print(msg + f" ({time.time() - t0:.1f}s, {len(step_losses)} steps)")
        self._state = state
        return losses

    def _build_val_set(self):
        """Validation examples from paired files (offset 0: each pair has
        equal clean and noise lengths), or None without them."""
        cfg = self.cfg
        val_s_dir = os.path.join(cfg.set_path, "val_clean_speech")
        val_d_dir = os.path.join(cfg.set_path, "val_noise")
        if not os.path.isdir(val_s_dir):
            return None
        val_s, val_d, s_len, d_len, snr = val_wav_batch(val_s_dir, val_d_dir)
        out = []
        B = cfg.mbatch_size
        for i in range(0, len(val_s), B):
            sl = slice(i, i + B)
            L = bucket_length(int(s_len[sl].max()), cfg.N_s)
            s = torch.as_tensor(val_s[sl, :L], device=self.device)
            d = torch.as_tensor(val_d[sl, :L], device=self.device)
            with torch.no_grad():
                inp, tgt, nf = self.inp_tgt.example(
                    s, d, torch.as_tensor(s_len[sl]), torch.as_tensor(d_len[sl]),
                    torch.as_tensor(snr[sl], dtype=torch.float32),
                    offsets=torch.zeros(s.shape[0], dtype=torch.int64))
            out.append((inp, tgt, frame_mask(inp.shape[1], nf, self.device)))
        return out
