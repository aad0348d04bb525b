"""Framework facade: map statistics, the training loop (the phoneme
classifier's too), offline inference with the hybrid and classical modes,
objective testing, the spectral-distortion study and the serving export
(follows deepxi_tpu/framework.py; every network of the JAX selector, every
input/target family, every map). In a process group (`parallel`) training
runs on the ("data", "model") mesh of `n_data_shards` x `n_model_shards`,
one process a card; the other modes run on one card, as in the JAX package.

Artifact layout as in the JAX package:

  model/<ver>/epoch-<n>/state.pt   checkpoints (params + optimizer state)
  data/<ver>_stats.npz             map statistics
  data/sample.npz                  cached training sample
  log/loss/<ver>.csv               epoch,loss[,val_loss]
  log/results/*.csv, results.txt   per-condition and average objective
                                   scores, spectral distortion
  out/<ver>/e<epoch>/y/<gain>/     enhanced wavs
  out/<ver>/e<epoch>/<out_type>/   the other outputs (.mat; d_hat: wavs;
                                   pho: .mat and token .csv)
  out/<ver>/classical/<mode>/      the classical modes' wavs (hybrid_mixmax
                                   of MagPhonemes under e<epoch>/)
  out/<ver>/e<epoch>/serving/      the serving export (serving.export_enhancer)
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from deepxi_tpu_torch import resolve_device
from deepxi_tpu_torch.config import Config
from deepxi_tpu_torch.data.listing import test_batch, val_wav_batch
from deepxi_tpu_torch.data.loader import MiniBatchLoader, bucket_length
from deepxi_tpu_torch.data.wavio import save_wav
from deepxi_tpu_torch.inp_tgt import MAP_ATTRS, MagXi, inp_tgt_selector
from deepxi_tpu_torch.models import init_flax_like, network_selector
from deepxi_tpu_torch.ops.gains import gfunc
from deepxi_tpu_torch.ops.maps import STATS_FIELDS
from deepxi_tpu_torch.parallel import is_primary, make_mesh
from deepxi_tpu_torch.parallel.distributed import process_count
from deepxi_tpu_torch.parallel.mesh import check_mesh_size
from deepxi_tpu_torch.sig import mix as sig_mix
from deepxi_tpu_torch.training import (TrainState, append_loss_csv,
                                       checkpoint_params, frame_mask, gather_state,
                                       make_eval_step, make_optimizer,
                                       make_phoneme_train_step, make_train_step,
                                       restore_checkpoint, save_checkpoint,
                                       shard_state, shardings_of)

# The MagXi out_types `infer` writes (each family's are its `out_types`),
# and the hybrid and classical modes, which `infer` runs for any family.
OUT_TYPES = MagXi.out_types
FAMILY_OUT_TYPES = OUT_TYPES + ("mag_hat", "cd_hat", "pho")
HYBRID_OUT_TYPES = ("hybrid_omlsa", "hybrid_mixmax", "tracking_hist", "tracking_vts")
PHONEME_TYPES = ("MagPhonemes", "MagPhonme")


def _save_mat(path: str, data: np.ndarray, name: str) -> None:
    """One array as `name` in a .mat file (scipy.io)."""
    from scipy.io import savemat
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    savemat(path, {name: np.asarray(data)})


def build_network(cfg: Config, n_feat: int, n_outp: int) -> torch.nn.Module:
    """The configured network (`models.network_selector` of
    `cfg.network_type` with `cfg.network_kwargs()`; a field left None takes
    the module's default)."""
    return network_selector(cfg.network_type, n_feat, n_outp, **cfg.network_kwargs())


def tcn_stack_fusable(cfg: Config) -> bool:
    """Whether `cfg`'s network is the stack the fused TCN kernels compute:
    the causal ResNetV2 with ReLU->LN->W+b units."""
    return (cfg.network_type == "ResNetV2" and cfg.causal
            and cfg.unit_type == "ReLU->LN->W+b")


def tcn_fused_takes(cfg: Config) -> bool:
    """Whether the fused TCN kernels compute `cfg`'s network in inference:
    `cfg.tcn_fused` and the stack they compute (the others run their plain
    network, as they run plain XLA in the JAX package)."""
    return cfg.tcn_fused and tcn_stack_fusable(cfg)


def fast_apply_fn(cfg: Config) -> Optional[Callable]:
    """The network forward of the inference fast path for `cfg`: the fused
    TCN groups where `tcn_fused_takes`, or for MHANetV2/V3 with
    `cfg.mha_fused` and "full" attention the fused transformer blocks; None
    for the network's own forward (the other ResNets, RDLNet, ResLSTM,
    ResBiLSTM, MHANet V1, and MHANetV2/V3 whose attention follows
    `cfg.attention_impl`)."""
    if tcn_fused_takes(cfg):
        from deepxi_tpu_torch.ops.kernels.tcn_fused import resnetv2_apply_fused
        return (lambda p, m: resnetv2_apply_fused(
            p, m, n_blocks=cfg.n_blocks, max_d_rate=cfg.max_d_rate, k=cfg.k,
            outp_act=cfg.outp_act))
    if (cfg.network_type in ("MHANetV2", "MHANetV3") and cfg.mha_fused
            and cfg.attention_impl == "full"):
        from deepxi_tpu_torch.ops.kernels.mha_block_fused import mhanetv3_apply_fused
        return (lambda p, m: mhanetv3_apply_fused(
            p, m, n_blocks=cfg.n_blocks, n_heads=cfg.n_heads,
            d_model=cfg.d_model, max_len=cfg.max_len or 2048,
            causal=cfg.causal, outp_act=cfg.outp_act,
            positional=cfg.network_type == "MHANetV3"))
    return None


def mesh_size(cfg: Config) -> Tuple[int, int]:
    """(n_data, n_model) of `cfg`'s training mesh: data shards default to
    gcd(mbatch_size, world size // n_model_shards), as in the JAX package.
    Raises ValueError where the mesh does not cover the process group (one
    rank with no group) or the mini-batch does not divide over it."""
    n_data = cfg.n_data_shards
    if n_data is None:
        n_data = math.gcd(cfg.mbatch_size, max(process_count() // cfg.n_model_shards, 1))
    check_mesh_size(n_data, cfg.n_model_shards)
    if cfg.mbatch_size % n_data:
        raise ValueError(f"mbatch_size {cfg.mbatch_size} must divide over the "
                         f"{n_data}-way data axis")
    return n_data, cfg.n_model_shards


def train_mesh(cfg: Config):
    """`cfg`'s training mesh (`parallel.make_mesh` of `mesh_size`), or None
    in a process with no group, where the mesh can only be 1 x 1."""
    size = mesh_size(cfg)
    return make_mesh(*size) if dist.is_initialized() else None


class DeepXiTorch:
    """Deep Xi on one device (the card unless ``device="cpu"``): the
    configured input/target family and maps (`inp_tgt_selector`), and any
    network of `models.network_selector`, for training, inference,
    objective testing and the spectral-distortion study. With
    `cfg.import_stats` the maps take a reference statistics pickle's
    values (`import_reference_stats`), which are saved as the stats file.

    In a process group every rank builds it (the mesh, `self.mesh`, is made
    by all of them); rank 0 makes and writes the statistics and the others
    read them."""

    def __init__(self, cfg: Config, train_s_list: Optional[List[Dict]] = None,
                 train_d_list: Optional[List[Dict]] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = train_mesh(cfg)
        self.train_s_list = train_s_list
        self.train_d_list = train_d_list
        self.inp_tgt = inp_tgt_selector(
            cfg.inp_tgt_type, cfg.N_d, cfg.N_s, cfg.K, cfg.f_s, map_type=cfg.map_type,
            map_params=cfg.map_params, Noutp=cfg.Noutp,
            gain=cfg.gain if isinstance(cfg.gain, str) else cfg.gain[0])

        stats_path = os.path.join(cfg.data_path, f"{cfg.ver}_stats.npz")
        if not is_primary():
            dist.barrier()  # rank 0 has written the statistics
            if os.path.exists(stats_path):
                self.inp_tgt = self._load_stats(stats_path)
        elif cfg.import_stats:
            self.import_reference_stats(cfg.import_stats)
            self._save_stats(stats_path)
        elif os.path.exists(stats_path) and not cfg.reset_inp_tgt:
            self.inp_tgt = self._load_stats(stats_path)
        elif self._needs_stats():
            s, d, x, wl = self.sample(cfg.sample_size)
            self.inp_tgt = self.inp_tgt.with_stats(s, d, x, wl, device=self.device)
            self._save_stats(stats_path)
        if is_primary() and process_count() > 1:
            dist.barrier()

        self.network = build_network(cfg, self.inp_tgt.n_feat, self.inp_tgt.n_outp)
        self._enhancers: Dict[str, Callable] = {}

    # -- statistics ---------------------------------------------------------

    def _map_attrs(self) -> List[str]:
        """The family's maps, in the stats file's order."""
        return [m for m in MAP_ATTRS if getattr(self.inp_tgt, m, None) is not None]

    def _needs_stats(self) -> bool:
        """Whether the family has a map to fit (a sample is drawn even for a
        map without statistics, as in the JAX package)."""
        return bool(self._map_attrs())

    def _save_stats(self, path: str) -> None:
        """Every map's statistics under the JAX package's keys
        `<map attribute>.<field>`, field one of mu, sigma, b, min, max."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {}
        for m in self._map_attrs():
            mp = getattr(self.inp_tgt, m)
            for field in STATS_FIELDS:
                v = getattr(mp, field, None)
                if v is not None:
                    payload[f"{m}.{field}"] = (v.cpu().numpy() if torch.is_tensor(v)
                                               else np.asarray(v))
        np.savez(path, **payload)

    def _load_stats(self, path: str):
        """The family with each map's fields replaced by the stats file's."""
        z = np.load(path)
        it = self.inp_tgt
        for m in self._map_attrs():
            updates = {k.split(".", 1)[1]: torch.as_tensor(z[k], device=self.device)
                       for k in z.files if k.startswith(m + ".")}
            if updates:
                it = replace(it, **{m: replace(getattr(it, m), **updates)})
        return it

    def import_reference_stats(self, pickle_path: str) -> None:
        """Adopt the statistics of a reference `<ver>_inp_tgt.p` pickle
        (`compat.tf_import.load_inp_tgt_stats`, which needs TensorFlow to
        read the pickle's tensors): each of the family's maps takes the
        pickle's mu, sigma, b, min and max where it has them."""
        from deepxi_tpu_torch.compat.tf_import import load_inp_tgt_stats
        st = load_inp_tgt_stats(pickle_path)
        it = self.inp_tgt
        for m in self._map_attrs():
            if m in st:
                updates = {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
                           for k, v in st[m].items() if k in STATS_FIELDS}
                it = replace(it, **{m: replace(getattr(it, m), **updates)})
        self.inp_tgt = it

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
        init_flax_like(self.network.to("cpu"), torch.Generator().manual_seed(self.cfg.seed))
        self.network.to(self.device)
        return {k: v.detach().clone() for k, v in self.network.state_dict().items()}

    def apply_fn(self):
        """The network forward of the train step: the fused stack with
        `cfg.tcn_fused_train` where `tcn_stack_fusable`, else None (the plain
        network under autograd; for MHANet "full" attention, as in the JAX
        package; "block" attention, RDLNet and the LSTMs likewise)."""
        cfg = self.cfg
        if not (cfg.tcn_fused_train and tcn_stack_fusable(cfg)):
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
        state is kept as `self._state`. MagPhonemes trains the phoneme
        classifier (`make_phoneme_train_step`) on a labelled clean list
        (`data.listing.batch_list_labelled`), with no validation set."""
        cfg = self.cfg
        phoneme_mode = cfg.inp_tgt_type in PHONEME_TYPES
        if phoneme_mode and not (self.train_s_list and
                                 all("labels" in it for it in self.train_s_list)):
            raise ValueError("MagPhonemes training needs a labelled clean list; build it "
                             "with data.listing.batch_list_labelled (--ali_path/"
                             "--lexicon_path)")
        if "MHA" in cfg.network_type and cfg.attention_impl in ("fused", "stream"):
            raise ValueError(f"attention_impl {cfg.attention_impl!r} is inference-only "
                             "(its kernels have no backward): train MHANet with 'full' "
                             "or 'block'")
        model_dir = os.path.join(cfg.model_path, cfg.ver)
        os.makedirs(model_dir, exist_ok=True)
        tx = make_optimizer(cfg.network_type, cfg.d_model or 256, cfg.warmup_steps)
        state = TrainState.create(self.init_params(), tx)
        if cfg.resume_epoch > 0:
            state = restore_checkpoint(model_dir, cfg.resume_epoch - 1, state)
        # on a mesh each rank holds its part of the state; rank 0 alone
        # writes the whole state, the loss CSV and the log
        mesh, primary = self.mesh, is_primary()
        shardings = None
        if mesh is not None:
            shardings = shardings_of(mesh, state.params)
            state = shard_state(mesh, state, shardings)

        def whole(st: TrainState) -> TrainState:
            return st if mesh is None else gather_state(mesh, st, shardings)

        step_kw = dict(apply_fn=self.apply_fn(), mesh=mesh, shardings=shardings)
        if phoneme_mode:
            train_step = make_phoneme_train_step(self.network, self.inp_tgt, tx, **step_kw)
        else:
            train_step = make_train_step(self.network, self.inp_tgt, tx,
                                         cfg.loss_fnc, **step_kw)
        loader = MiniBatchLoader(self.train_s_list, self.train_d_list,
                                 cfg.mbatch_size, cfg.snr_levels, seed=cfg.seed,
                                 N_s=cfg.N_s)
        val_set = self._build_val_set() if cfg.val_flag and not phoneme_mode else None
        eval_step = make_eval_step(self.network, cfg.loss_fnc)
        if cfg.eval_example and primary:
            self._dump_eval_example(loader)

        gen = torch.Generator().manual_seed(cfg.seed + 1)
        dev = self.device
        losses: List[float] = []
        for epoch in range(cfg.resume_epoch, cfg.max_epochs):
            t0 = time.time()
            step_losses = []
            for batch in loader.epoch(epoch):
                s, d, s_len, d_len, snr = batch[:5]
                labels = [torch.as_tensor(b, device=dev) for b in batch[5:]]
                state, metrics = train_step(
                    state, torch.as_tensor(s, device=dev),
                    torch.as_tensor(d, device=dev), torch.as_tensor(s_len),
                    torch.as_tensor(d_len), torch.as_tensor(snr), *labels, generator=gen)
                step_losses.append(metrics["loss"])
            # one device-to-host read per epoch
            mean_loss = float(torch.stack(step_losses).mean()) if step_losses else 0.0
            val_loss = None
            if val_set and ((epoch + 1) % max(cfg.val_every, 1) == 0
                            or epoch == cfg.max_epochs - 1):
                params = whole(state).params
                val_loss = float(np.mean([float(eval_step(params, *b)) for b in val_set]))
            losses.append(mean_loss)
            if primary:
                append_loss_csv(cfg.log_path, cfg.ver, epoch, mean_loss, val_loss)
            if cfg.save_model and ((epoch + 1) % max(cfg.save_every, 1) == 0
                                   or epoch == cfg.max_epochs - 1):
                full = whole(state)
                if primary:
                    save_checkpoint(model_dir, epoch, full)
                if mesh is not None:
                    dist.barrier()
            if verbose and primary:
                msg = f"epoch {epoch}: loss {mean_loss:.4f}"
                if val_loss is not None:
                    msg += f" val {val_loss:.4f}"
                print(msg + f" ({time.time() - t0:.1f}s, {len(step_losses)} steps)")
        self._state = whole(state)
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

    def _dump_eval_example(self, loader: MiniBatchLoader) -> None:
        """One mini-batch of the first `mbatch_size` training utterances as
        `inp_batch.mat`, `tgt_batch.mat` and `seq_mask_batch.mat` in the
        working directory (for eval_example.m), and each row's target SNR
        beside the SNR of its mix. The noise offsets come from a generator
        seeded with `seed + 99`, the same draws for both."""
        cfg = self.cfg
        dev = self.device
        s, d, s_len, d_len, snr = loader._load_batch(self.train_s_list[:cfg.mbatch_size])
        args = (torch.as_tensor(s, device=dev), torch.as_tensor(d, device=dev),
                torch.as_tensor(s_len), torch.as_tensor(d_len), torch.as_tensor(snr))
        with torch.no_grad():
            inp, tgt, nf = self.inp_tgt.example(
                *args, generator=torch.Generator().manual_seed(cfg.seed + 99))
            seq_mask = frame_mask(inp.shape[1], nf, dev)
            _save_mat("./inp_batch.mat", inp.cpu().numpy(), "inp_batch")
            _save_mat("./tgt_batch.mat", tgt.cpu().numpy(), "tgt_batch")
            _save_mat("./seq_mask_batch.mat", seq_mask.cpu().numpy(), "seq_mask_batch")
            print("Testing if add_noise() works correctly...")
            s_f, d_f, _, _ = self.inp_tgt.mix(
                *args, generator=torch.Generator().manual_seed(cfg.seed + 99))
            for i in range(len(s)):
                n = int(s_len[i])
                actual = float(sig_mix.snr_db(s_f[i, :n], d_f[i, :n]))
                print("SNR target|actual: {:.2f}|{:.2f} (dB).".format(float(snr[i]), actual))

    def spectral_distortion(self, params: Optional[Dict[str, torch.Tensor]] = None,
                            epochs: Optional[Sequence[int]] = None,
                            snr_levels: Optional[Sequence[float]] = None,
                            target: str = "xi") -> Dict:
        """Spectral-distortion study: the mean over utterances of the RMS dB
        distance between an instantaneous SNR and the network's estimate,
        for each epoch and SNR level; returns {(epoch, snr): dB} and writes
        `log/results/<ver>_e<epoch>_spect_dist[_gamma].csv`. target "xi"
        scores xi = S^2/D^2 against xi_hat, "gamma" gamma = X^2/D^2 against
        gamma_hat. Clean utterance i (`test_s_path`) is mixed with noise
        clip i mod N (`test_d_path`), which must be at least as long, at an
        offset drawn from a generator seeded with `seed + 7` (0 when the
        clip is as long as the speech); the network (`fast_apply()`, else
        its own forward) reads |X| of the STFT."""
        if target not in ("xi", "gamma"):
            raise ValueError(f"spectral_distortion target must be xi|gamma, got {target!r}")
        it = self.inp_tgt
        if not it.mag_input or not hasattr(it, f"{target}_hat"):
            raise ValueError(f"spectral_distortion({target!r}) takes a family that reads "
                             f"|X| and estimates {target}, not {type(it).__name__}")
        cfg = self.cfg
        dev = self.device
        snr_levels = snr_levels or cfg.sd_snr_levels
        epochs = list(epochs) if epochs else (
            cfg.test_epoch if isinstance(cfg.test_epoch, list) else [cfg.test_epoch])
        s_batch, s_lens, _, s_names = test_batch(cfg.test_s_path)
        d_batch, d_lens, _, d_names = test_batch(cfg.test_d_path)
        apply = self.fast_apply() or (
            lambda p, m: functional_call(self.network, p, (m,)))
        estimate = it.xi_hat if target == "xi" else it.gamma_hat
        res_dir = os.path.join(cfg.log_path, "results")
        os.makedirs(res_dir, exist_ok=True)

        def padded(w: np.ndarray, L: int) -> torch.Tensor:
            return torch.as_tensor(np.pad(w, (0, max(L - w.shape[0], 0)))[:L][None],
                                   device=dev)

        results = {}
        for e in epochs:
            p = params if params is not None else self.load_epoch(e)
            rows = []
            for snr_level in snr_levels:
                vals = []
                for i in range(len(s_names)):
                    j = i % len(d_names)
                    L = bucket_length(int(s_lens[i]), cfg.N_s)
                    n_s, n_d = min(int(s_lens[i]), L), min(int(d_lens[j]), L)
                    if n_d < n_s:
                        raise ValueError(
                            f"noise {d_names[j]!r} ({int(d_lens[j])} samples) is shorter "
                            f"than speech {s_names[i]!r} ({int(s_lens[i])} samples); "
                            "cannot mix at SNR")
                    with torch.no_grad():
                        s_f, d_f, x_f, nf = it.mix(
                            padded(s_batch[i], L), padded(d_batch[j], L),
                            torch.tensor([n_s]), torch.tensor([n_d]),
                            torch.tensor([float(snr_level)]),
                            generator=torch.Generator().manual_seed(cfg.seed + 7))
                        D, X = it._stms(d_f)[0], it._stms(x_f)[0]
                        inst = (sig_mix.xi(it._stms(s_f)[0], D) if target == "xi"
                                else sig_mix.gamma(X, D))
                        n = int(nf[0])
                        tgt_hat = apply(p, X[None])[0][:n]
                        vals.append(float(sig_mix.spectral_distortion(inst[:n],
                                                                      estimate(tgt_hat))))
                results[(e, snr_level)] = float(np.mean(vals))
                rows.append((snr_level, float(np.mean(vals))))
            suffix = "spect_dist" if target == "xi" else "spect_dist_gamma"
            with open(os.path.join(res_dir, f"{cfg.ver}_e{e}_{suffix}.csv"), "w") as f:
                f.write(f"snr_db,{target}_spectral_distortion_db\n")
                for snr_level, v in rows:
                    f.write(f"{snr_level},{v:.4f}\n")
        return results

    # -- inference ----------------------------------------------------------

    def load_epoch(self, epoch: int) -> Dict[str, torch.Tensor]:
        """Parameters of a saved epoch, 1-indexed as the reference's
        test_epoch (`model/<ver>/epoch-<epoch - 1>`), on the device."""
        return checkpoint_params(os.path.join(self.cfg.model_path, self.cfg.ver),
                                 epoch - 1, self.device)

    def fast_apply(self) -> Optional[Callable]:
        """`fast_apply_fn` of the config: the kernels' forward, or None."""
        return fast_apply_fn(self.cfg)

    def fast_enhancer(self, gain: str) -> Callable:
        """The cached batched enhancer `enhance(params, x_int16[B, L])` for
        one gain function, through `fast_apply`."""
        if gain not in self._enhancers:
            from deepxi_tpu_torch.enhance import make_enhancer
            self._enhancers[gain] = make_enhancer(
                self.inp_tgt, self.network, gain, apply_fn=self.fast_apply(),
                device=self.device)
        return self._enhancers[gain]

    def enhance_all(self, params: Dict[str, torch.Tensor], x_batch: np.ndarray,
                    x_lens: np.ndarray, gain: str,
                    max_batch: int = 32) -> List[np.ndarray]:
        """Enhanced waveform of each utterance. A gain-form family's are
        trimmed to (n_frames + 1) * N_s samples: utterances are grouped by
        padded length (`bucket_length`) and enhanced at most `max_batch` at
        a time. The other families' (MagGamma, MagPhaXiPha, STDCTXiCD) come
        from `enhanced_speech`, an utterance at a time."""
        N_s = self.cfg.N_s
        if not self.inp_tgt.gain_form:
            return [self._utterance_y(params, x_batch[i], int(n), gain)
                    for i, n in enumerate(x_lens)]
        enhance = self.fast_enhancer(gain)
        ys: List[Optional[np.ndarray]] = [None] * len(x_lens)
        buckets: Dict[int, List[int]] = {}
        for i, n in enumerate(x_lens):
            buckets.setdefault(bucket_length(int(n), N_s), []).append(i)
        for L, idxs in sorted(buckets.items()):
            for j0 in range(0, len(idxs), max_batch):
                chunk = idxs[j0:j0 + max_batch]
                w = np.zeros((len(chunk), L), np.int16)
                for r, i in enumerate(chunk):
                    n = min(int(x_lens[i]), L)
                    w[r, :n] = x_batch[i, :n]
                y = enhance(params, w).cpu().numpy()
                for r, i in enumerate(chunk):
                    ys[i] = y[r, :(-(-int(x_lens[i]) // N_s) + 1) * N_s]
        return ys

    def export_serving(self, out_dir: Optional[str] = None,
                       epoch: Optional[int] = None,
                       gain: Optional[str] = None,
                       batch: int = 32,
                       buckets: Sequence[int] = (8192, 16384, 32768, 65536,
                                                 131072, 262144)) -> List[str]:
        """Serving export of a trained epoch: the batched enhancer through
        `fast_apply` (the kernels as `deepxi::` ops) as one `torch.export`
        program a bucket on this framework's device (`serving`); no model
        code or re-trace at load time. Returns the written paths."""
        from deepxi_tpu_torch.serving import export_enhancer
        cfg = self.cfg
        epoch = epoch or (cfg.test_epoch if isinstance(cfg.test_epoch, int)
                          else cfg.test_epoch[0])
        g = gain or (cfg.gain if isinstance(cfg.gain, str) else cfg.gain[0])
        params = self.load_epoch(epoch)
        out_dir = out_dir or os.path.join(cfg.out_path, cfg.ver, f"e{epoch}", "serving")
        return export_enhancer(self.inp_tgt, self.network, params, out_dir, gain=g,
                               batch=batch, buckets=buckets, apply_fn=self.fast_apply(),
                               ver=cfg.ver, device=self.device)

    def estimator(self, kernels: bool = True) -> Callable:
        """The cached `make_estimator` of `fast_apply` (the per-utterance
        route of the .mat out_types and of `enhanced_speech`): (network
        output, network input); ``kernels=False`` takes no spectral
        kernel."""
        key = ("estimate", kernels)
        if key not in self._enhancers:
            from deepxi_tpu_torch.enhance import make_estimator
            self._enhancers[key] = make_estimator(
                self.inp_tgt, self.network, apply_fn=self.fast_apply(),
                device=self.device, kernels=kernels)
        return self._enhancers[key]

    def gain_synthesiser(self, gain: str, kernels: bool = True) -> Callable:
        """The cached `make_gain_synthesiser` of `fast_apply` for the
        family's gain with a gain function, or for the noise estimate when
        `gain` is "d_hat" (the per-utterance route of `y` with
        ``fast=False`` and of `d_hat`); ``kernels=False`` takes no spectral
        kernel."""
        key = ("synthesis", gain, kernels)
        if key not in self._enhancers:
            from deepxi_tpu_torch.enhance import make_gain_synthesiser, noise_gain
            it = self.inp_tgt
            fn, reader = (noise_gain, None) if gain == "d_hat" else (
                lambda t: it.synthesis_gain(t, gain), lambda t: t)
            self._enhancers[key] = make_gain_synthesiser(
                it, self.network, fn, apply_fn=self.fast_apply(), device=self.device,
                reader=reader, kernels=kernels)
        return self._enhancers[key]

    def infer(self, params: Optional[Dict[str, torch.Tensor]] = None,
              test_x_path: Optional[str] = None, out_type: Optional[str] = None,
              gains: Optional[Sequence[str]] = None,
              epochs: Optional[Sequence[int]] = None, fast: bool = True) -> List[str]:
        """Write `out_type` of every wav of the test directory for each epoch
        and gain under `out/<ver>/e<epoch>/`: `y` (16-bit wavs under
        `y/<gain>/`, or `y/` for MagGain and MagMag), `d_hat` (wavs), and
        `xi_hat`, `gamma_hat`, `mag_hat`, `cd_hat`, `deepmmse` (key
        `d_psd_hat`), `ibm_hat` and `subband_ibm_hat` (.mat), each where the
        family has it (its `out_types`). `params` replaces the saved epochs'
        weights. Returns the written paths.

        `y` of a gain-form family with ``fast=True`` enhances utterances
        batched by length (`enhance_all`); every other output runs each
        utterance alone, padded to its `bucket_length` and cut to its
        frames. MagGamma's `y` takes the saved `xi_hat` .mat of each
        utterance from `cfg.saved_data_path` when it is set."""
        cfg = self.cfg
        it = self.inp_tgt
        out_type = out_type or cfg.out_type
        if out_type in HYBRID_OUT_TYPES:
            return self._infer_hybrid(out_type, params, test_x_path, epochs)
        if out_type not in FAMILY_OUT_TYPES:
            raise ValueError(f"Invalid output type: {out_type!r}")
        if out_type not in it.out_types:
            raise ValueError(f"{type(it).__name__} has no out_type {out_type!r}; it writes "
                             f"{', '.join(it.out_types)}")
        gains = list(gains) if gains else (
            cfg.gain if isinstance(cfg.gain, list) else [cfg.gain])
        epochs = list(epochs) if epochs else (
            cfg.test_epoch if isinstance(cfg.test_epoch, list) else [cfg.test_epoch])
        x_batch, x_lens, _, names = test_batch(test_x_path or cfg.test_x_path)
        mel_bank = None
        if out_type == "subband_ibm_hat":
            from deepxi_tpu_torch.sig.mel import mel_filter_bank
            mel_bank = mel_filter_bank(cfg.n_filters, cfg.K, cfg.f_s)
        written: List[str] = []
        for e in epochs:
            if e < 1:
                raise ValueError("test_epoch must be greater than 0")
            p = params if params is not None else self.load_epoch(e)
            for g in gains:
                sub = out_type
                if out_type == "y":
                    sub = os.path.join("y", g) if it.y_per_gain else "y"
                out_dir = os.path.join(cfg.out_path, cfg.ver, f"e{e}", sub)
                if out_type == "y" and fast and it.gain_form:
                    ys = self.enhance_all(p, x_batch, x_lens, g)
                    for name, y in zip(names, ys):
                        path = os.path.join(out_dir, name + ".wav")
                        save_wav(path, y, cfg.f_s)
                        written.append(path)
                    continue
                for i, name in enumerate(names):
                    written.append(self._write_output(
                        out_dir, name, out_type, g, p, x_batch[i], int(x_lens[i]),
                        mel_bank))
        return written

    def _padded(self, wav: np.ndarray, length: int) -> np.ndarray:
        """[1, bucket_length] int16: one utterance padded as infer pads it."""
        w = np.zeros((1, bucket_length(length, self.cfg.N_s)), np.int16)
        w[0, :length] = wav[:length]
        return w

    def _utterance_y(self, params: Dict[str, torch.Tensor], wav: np.ndarray,
                     length: int, gain: str, xi_hat: Optional[np.ndarray] = None
                     ) -> np.ndarray:
        """One utterance through the family's `enhanced_speech`: the
        network output of `estimator` and its input, with the noisy phase
        (of the observation) for the families that read |X|, cut to the
        utterance's frames; MagGamma takes `xi_hat` (a saved estimate) when
        it is given, MagPhonemes' gain "mixmax" the Gaussians of
        `cfg.mixmax_stats`."""
        it = self.inp_tgt
        w = self._padded(wav, length)
        n = it.n_frames(length)
        tgt_hat, inp = self.estimator()(params, w)
        tgt_hat, inp = tgt_hat[0, :n], inp[0, :n]
        if it.mag_input:
            with torch.no_grad():
                sup = it.observation(torch.as_tensor(w, device=self.device))[1][0, :n]
        else:
            sup = inp
        kw = {} if xi_hat is None else {
            "xi_hat": torch.as_tensor(xi_hat, dtype=torch.float32, device=self.device)}
        if gain == "mixmax" and self.cfg.inp_tgt_type in PHONEME_TYPES:
            kw["mixmax_model"] = self._load_mixmax_model()
        with torch.no_grad():
            return it.enhanced_speech(inp, sup, tgt_hat, gain, **kw).cpu().numpy()

    def _write_output(self, out_dir: str, name: str, out_type: str, gain: str,
                      params: Dict[str, torch.Tensor], wav: np.ndarray, length: int,
                      mel_bank: Optional[np.ndarray]) -> str:
        """One utterance's output on the per-utterance route: the waveform
        padded to `bucket_length` at B=1, the outputs cut to its frames."""
        cfg = self.cfg
        it = self.inp_tgt
        n = it.n_frames(length)
        if out_type == "d_hat" or (out_type == "y" and it.gain_synthesis):
            y = self.gain_synthesiser("d_hat" if out_type == "d_hat" else gain)(
                params, self._padded(wav, length), n)[0].cpu().numpy()
        elif out_type == "y":
            xi_hat = None
            if it.saved_xi_hat and cfg.saved_data_path is not None:
                from scipy.io import loadmat
                xi_hat = loadmat(os.path.join(cfg.saved_data_path, name + ".mat"))["xi_hat"]
            y = self._utterance_y(params, wav, length, gain, xi_hat)
        if out_type in ("y", "d_hat"):
            path = os.path.join(out_dir, name + ".wav")
            save_wav(path, y, cfg.f_s)
            return path
        tgt_hat, inp = self.estimator()(params, self._padded(wav, length))
        tgt_hat, inp = tgt_hat[0, :n], inp[0, :n]
        key = out_type
        if out_type == "pho":
            key, data = "pho_post", tgt_hat
            if cfg.lexicon_path:
                self._write_tokens(os.path.join(out_dir, name + ".csv"), tgt_hat)
        elif out_type in ("xi_hat", "gamma_hat", "mag_hat", "cd_hat"):
            data = getattr(it, out_type)(tgt_hat)
        elif out_type == "deepmmse":
            key = "d_psd_hat"
            xi_hat = it.xi_hat(tgt_hat)
            data = torch.square(inp) * gfunc(xi_hat, xi_hat + 1.0, "deepmmse")
        elif out_type == "ibm_hat":
            data = it.xi_hat(tgt_hat) > 1.0
        else:
            data = (it.xi_hat(tgt_hat).cpu().numpy() @ mel_bank.T) > 1.0
        path = os.path.join(out_dir, name + ".mat")
        _save_mat(path, data.cpu().numpy() if torch.is_tensor(data) else data, key)
        return path

    def _write_tokens(self, path: str, posteriors: torch.Tensor) -> None:
        """The lexicon token (`cfg.lexicon_path`, parsed once) of each frame's
        most likely class, a line a frame."""
        if getattr(self, "_pho_mapper", None) is None:
            from deepxi_tpu_torch.dsp.phoneme import Phoneme
            self._pho_mapper = Phoneme(self.cfg.lexicon_path)
        index2entry = self._pho_mapper.tkn_dict.index2Entry
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for i in posteriors.argmax(dim=-1).cpu().numpy():
                f.write(index2entry[int(i)] + "\n")

    def _load_mixmax_model(self):
        """The MixMax Gaussians of `cfg.mixmax_stats` (an npz of
        means/stds/probs, per-phoneme log-STMS statistics;
        tools/torch_build_gaussians.py) on the device."""
        if not self.cfg.mixmax_stats:
            raise ValueError("MixMax needs --mixmax_stats (npz with means/stds/"
                             "probs; see tools/torch_build_gaussians.py)")
        from deepxi_tpu_torch.dsp.mixmax import gaussians_from_stats
        z = np.load(self.cfg.mixmax_stats)
        return gaussians_from_stats(z["means"], z["stds"], z["probs"], device=self.device)

    def _load_vts_model(self):
        """The VTS model of `cfg.vts_stats` (an npz of x_mu/x_sigma/prio_p/
        g_mu/g_sigma), its noise components jittered with `cfg.seed`."""
        if not self.cfg.vts_stats:
            raise ValueError("tracking_vts needs --vts_stats (npz with x_mu/x_sigma/"
                             "prio_p/g_mu/g_sigma)")
        from deepxi_tpu_torch.dsp.vts import make_model
        z = np.load(self.cfg.vts_stats)
        return make_model(z["x_mu"], z["x_sigma"], z["prio_p"], z["g_mu"], z["g_sigma"],
                          seed=self.cfg.seed, device=self.device)

    def hybrid_enhancer(self, out_type: str,
                        params: Optional[Dict[str, torch.Tensor]] = None) -> Callable:
        """`enhance(x_int16[1, L]) -> y[(T - 1) N_s + N_d]` of one hybrid or
        classical mode on the device:

          hybrid_omlsa   MCRA-tracked OM-LSA
          hybrid_mixmax  per-phoneme MixMax with noise tracking; for a
                         MagPhonemes model with the network's posteriors
                         (`estimator`: the kernels' forward on |X| of the
                         fused spectral kernel), `params` its weights
          tracking_hist  spectral subtraction of the histogram tracker
          tracking_vts   VTS/GMM model compensation"""
        from deepxi_tpu_torch import hybrid_infer
        cfg = self.cfg
        dims = dict(N_d=cfg.N_d, N_s=cfg.N_s, K=cfg.K)
        dev = self.device

        def wav(x):
            return torch.as_tensor(x, device=dev)[0]

        if out_type == "hybrid_omlsa":
            return lambda x: hybrid_infer.enhance_omlsa(wav(x), **dims)
        if out_type == "tracking_hist":
            return lambda x: hybrid_infer.enhance_tracking_histogram(wav(x), **dims)
        if out_type == "tracking_vts":
            model = self._load_vts_model()
            return lambda x: hybrid_infer.enhance_vts(wav(x), model, **dims)
        if out_type != "hybrid_mixmax":
            raise ValueError(f"Invalid hybrid mode: {out_type!r}")
        model = self._load_mixmax_model()
        if cfg.inp_tgt_type not in PHONEME_TYPES:
            return lambda x: hybrid_infer.enhance_mixmax(wav(x), model, **dims)

        def enhance(x):
            posteriors = self.estimator()(params, x)[0][0]
            return hybrid_infer.enhance_mixmax(wav(x), model, posteriors=posteriors, **dims)
        return enhance

    def _infer_hybrid(self, out_type: str, params, test_x_path: Optional[str],
                      epochs: Optional[Sequence[int]]) -> List[str]:
        """Write the wavs of a hybrid or classical mode
        (`hybrid_enhancer`) under `out/<ver>/classical/<mode>/`, or for
        MagPhonemes' hybrid_mixmax under `out/<ver>/e<epoch>/hybrid_mixmax/`
        for each epoch. Each utterance is padded to its `bucket_length`
        (every padded frame enters VTS's sums) and its wav cut to
        (n_frames + 1) N_s samples."""
        cfg = self.cfg
        use_net = out_type == "hybrid_mixmax" and cfg.inp_tgt_type in PHONEME_TYPES
        epochs = list(epochs) if epochs else (
            cfg.test_epoch if isinstance(cfg.test_epoch, list) else [cfg.test_epoch])
        x_batch, x_lens, _, names = test_batch(test_x_path or cfg.test_x_path)
        written: List[str] = []
        for e in (epochs if use_net else [None]):
            p = None
            if use_net:
                p = params if params is not None else self.load_epoch(e)
            enhance = self.hybrid_enhancer(out_type, p)
            out_dir = os.path.join(cfg.out_path, cfg.ver,
                                   f"e{e}" if use_net else "classical", out_type)
            for i, name in enumerate(names):
                n = int(x_lens[i])
                with torch.no_grad():
                    y = enhance(self._padded(x_batch[i], n)).cpu().numpy()
                path = os.path.join(out_dir, name + ".wav")
                save_wav(path, y[:(self.inp_tgt.n_frames(n) + 1) * cfg.N_s], cfg.f_s)
                written.append(path)
        return written

    # -- objective testing --------------------------------------------------

    def test(self, params: Optional[Dict[str, torch.Tensor]] = None,
             epochs: Optional[Sequence[int]] = None,
             gains: Optional[Sequence[str]] = None) -> Dict:
        """Objective evaluation: enhance every noisy test utterance
        (`enhance_all`, through `fast_apply()`), score it against the clean
        utterance whose basename its own contains (STOI, eSTOI, PESQ,
        MOS-LQO and the DEMAND-VB composite CSIG, CBAK, COVL, SegSNR, SNR, by
        `metrics.scoring.score_many` over `cfg.metric_workers` processes),
        and write the per-condition CSV, a row of `average.csv` and of
        `results.txt` in the JAX package's formats. Conditions come from
        `<clean>_<noise>_<snr>dB` names. Returns {(epoch, gain): {(noise,
        snr, metric): [scores]}}. A noisy file no clean name matches is
        skipped with a warning."""
        from deepxi_tpu_torch.metrics.scoring import score_many

        cfg = self.cfg
        gains = list(gains) if gains else (
            cfg.gain if isinstance(cfg.gain, list) else [cfg.gain])
        epochs = list(epochs) if epochs else (
            cfg.test_epoch if isinstance(cfg.test_epoch, list) else [cfg.test_epoch])
        x_batch, x_lens, _, x_names = test_batch(cfg.test_x_path)
        s_batch, s_lens, _, s_names = test_batch(cfg.test_s_path)

        all_results = {}
        for e in epochs:
            p = params if params is not None else self.load_epoch(e)
            for g in gains:
                results: Dict[Tuple, List[float]] = {}
                ys = self.enhance_all(p, x_batch, x_lens, g)
                pairs, conds = [], []
                for i, name in enumerate(x_names):
                    ref_idx = next((j for j, b in enumerate(s_names) if b in name), None)
                    if ref_idx is None:
                        print(f"WARNING: no clean reference matches {name!r}; skipping",
                              flush=True)
                        continue
                    s = s_batch[ref_idx, :s_lens[ref_idx]].astype(np.float32) / 32768.0
                    pairs.append((s, ys[i][: len(s)]))
                    try:
                        noise_src = name.split("_")[-2]
                    except IndexError:
                        noise_src = "Null"
                    snr_level = 0 if noise_src == "Null" \
                        else int(name.split("_")[-1][:-2])
                    conds.append((noise_src, snr_level))

                scores = score_many(pairs, cfg.f_s, n_workers=cfg.metric_workers)
                for (noise_src, snr_level), sc in zip(conds, scores):
                    for m, v in sc.items():
                        results.setdefault((noise_src, snr_level, m), []).append(v)

                self._write_results(results, e, g)
                self._append_results_txt(results, e, g)
                all_results[(e, g)] = results
        return all_results

    def _append_results_txt(self, results: Dict, e: int, g: str) -> None:
        """Append the DEMAND-VB scorer's `results.txt` row: the means over
        all utterances of CSIG, CBAK, COVL, PESQ, STOI, SegSNR and SNR."""
        cfg = self.cfg
        res_dir = os.path.join(cfg.log_path, "results")
        os.makedirs(res_dir, exist_ok=True)
        cols = ("CSIG", "CBAK", "COVL", "PESQ", "STOI", "SegSNR", "SNR")
        means = {}
        for m in cols:
            vals = [v for (ns, sl, mm), vs in results.items() for v in vs if mm == m]
            means[m] = float(np.mean(vals)) if vals else float("nan")
        path = os.path.join(res_dir, "results.txt")
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write("ver, " + ", ".join(cols) + "\n")
        with open(path, "a") as f:
            f.write(f"{cfg.ver}_e{e}_{g}, "
                    + ", ".join(f"{means[m]:.2f}" for m in cols) + "\n")

    def _write_results(self, results: Dict, e: int, g: str) -> None:
        """`log/results/<ver>_e<epoch>_<gain>.csv` (noise, snr_db, the mean of
        each metric a condition; an empty cell where a metric failed) and a
        row of `average.csv` (each metric's mean over the conditions within
        [min_snr, max_snr])."""
        cfg = self.cfg
        res_dir = os.path.join(cfg.log_path, "results")
        os.makedirs(res_dir, exist_ok=True)
        noise_srcs = sorted({k[0] for k in results})
        snr_levels = sorted({k[1] for k in results})
        metrics = sorted({k[2] for k in results})

        with open(os.path.join(res_dir, f"{cfg.ver}_e{e}_{g}.csv"), "w") as f:
            f.write("noise,snr_db")
            for m in metrics:
                f.write("," + m)
            f.write("\n")
            for ns in noise_srcs:
                for sl in snr_levels:
                    f.write(f"{ns},{sl}")
                    for m in metrics:
                        if (ns, sl, m) in results:
                            f.write(",{:.2f}".format(np.mean(results[(ns, sl, m)])))
                        else:
                            f.write(",")
                    f.write("\n")

        avg: Dict[str, List[float]] = {}
        for (ns, sl, m), v in results.items():
            if cfg.min_snr <= sl <= cfg.max_snr:
                avg.setdefault(m, []).extend(v)
        avg_path = os.path.join(res_dir, "average.csv")
        if not os.path.exists(avg_path):
            with open(avg_path, "w") as f:
                f.write("ver")
                for m in metrics:
                    f.write("," + m)
                f.write("\n")
        with open(avg_path, "a") as f:
            f.write(f"{cfg.ver}_e{e}_{g}")
            for m in metrics:
                if m in avg:
                    f.write(",{:.2f}".format(np.mean(avg[m])))
                else:
                    f.write(",")
            f.write("\n")
