"""Typed configuration, the command line's flag parsers and the presets the
port runs (follows deepxi_tpu/config.py; every field of the JAX package's Config but
its TPU knob `dft_precision`): every preset of the JAX package, resnet-1.1c,
resnet-1.1n, resnet-1.0c, resnet-1.0n, mhanet-1.1c, mhanet-1.0c,
rdlnet-1.0n and reslstm-1.0c, and their DEMAND VoiceBank variants (`-vb`:
SNR 0..15 dB in steps of 5, no validation set, test epoch 125)."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Union


def str_to_list(x: str):
    """The reference's nested-flag mini-DSL: ';' splits sublists, ','
    splits items, 'neg_' -> '-', 'pi' -> math.pi, numbers become int or
    float."""
    def read_dtype(v: str):
        v = v.replace("neg_", "-")
        if v == "pi":
            return math.pi
        if v == "-pi":
            return -math.pi
        if any(c.isdigit() for c in v):
            return float(v) if "." in v else int(v)
        return v

    if ";" in x:
        return [[read_dtype(z) for z in y.split(",")] for y in x.split(";")]
    if "," in x:
        return [read_dtype(y) for y in x.split(",")]
    return read_dtype(x)


def str_to_bool(s: Union[str, bool]) -> bool:
    if isinstance(s, bool):
        return s
    return s.lower() in ("yes", "true", "t", "1")


@dataclasses.dataclass
class Config:
    """Framework configuration (the JAX package's field names and defaults)."""
    ver: str = "resnet-1.1c"
    network_type: str = "ResNetV2"
    inp_tgt_type: str = "MagXi"

    # modes
    train: bool = False
    infer: bool = False
    test: bool = False
    spect_dist: bool = False
    prelim: bool = False
    export: bool = False  # serving export (serving.export_enhancer)
    export_path: Optional[str] = None
    sd_snr_levels: Any = dataclasses.field(default_factory=lambda: [-5, 0, 5, 10, 15])
    sd_target: Any = "xi"  # "xi", "gamma", or a list of both

    # features
    f_s: int = 16000
    T_d: int = 32
    T_s: int = 16
    min_snr: int = -10
    max_snr: int = 20
    snr_inter: int = 1
    n_filters: int = 40   # mel filters of the subband_ibm_hat output

    # training
    mbatch_size: int = 8
    sample_size: int = 1000
    max_epochs: int = 200
    resume_epoch: int = 0
    test_epoch: Union[int, List[int]] = 200
    save_model: bool = True
    save_every: int = 1   # checkpoint every N epochs (always at the last)
    val_every: int = 1    # evaluate the validation set every N epochs
    log_iter: bool = False  # read by neither package's trainer
    eval_example: bool = False  # dump one mini-batch to .mat before training
    val_flag: bool = True
    loss_fnc: str = "BinaryCrossentropy"
    seed: int = 0

    # resets
    reset_inp_tgt: bool = False
    reset_sample: bool = False

    # network hyper-parameters
    d_model: Optional[int] = None
    n_blocks: Optional[int] = None
    n_heads: Optional[int] = None
    d_f: Optional[int] = None
    d_b: Optional[int] = None   # read by no network of either package
    d_ff: Optional[int] = None  # read by no network (MHANet's FFN is 4 d_model)
    k: Optional[int] = None
    max_d_rate: Optional[int] = None
    causal: bool = True
    warmup_steps: int = 40000
    length: Optional[int] = None   # RDLNet's lattice length
    m_1: Optional[int] = None      # RDLNet's filters at height 0
    unit_type: Optional[str] = None
    outp_act: str = "Sigmoid"
    max_len: Optional[int] = None
    Noutp: Optional[int] = None    # MagPhonemes' class count (default 98)
    # MHANet attention: "full" (the plain [B, H, T, T] reference), "block"
    # (query blocks of block_q, plain; O(T block_q) memory), "fused"
    # (ops/kernels/mha_fused.py) or "stream" (ops/kernels/mha_flash_stream.py)
    attention_impl: str = "full"
    block_q: int = 256
    # the fused TCN kernels of ops/kernels/tcn_fused.py in ResNetV2
    # inference (framework.tcn_fused_takes). On by default: the JAX
    # package's default is off (on in its resnet-1.1c presets, as here),
    # which would take the kernels from the configs without a preset that the
    # port runs through them.
    tcn_fused: bool = True
    # the fused forward/backward pair of ops/kernels/tcn_fused_train.py in
    # the train step
    tcn_fused_train: bool = False
    # the fused transformer block of ops/kernels/mha_block_fused.py in
    # MHANetV2/V3 inference when attention_impl is "full"
    mha_fused: bool = True

    # a reference `<ver>_inp_tgt.p` statistics pickle to adopt
    # (compat.tf_import.load_inp_tgt_stats; reading it needs TensorFlow)
    import_stats: Optional[str] = None

    # map
    map_type: Any = "DBNormalCDF"
    map_params: Any = None

    # inference
    out_type: str = "y"
    gain: Union[str, List[str]] = "mmse-lsa"
    # MagGamma's `y`: a directory of saved xi_hat .mat files (`infer` of a
    # MagXi model), one per test utterance
    saved_data_path: Optional[str] = None

    # the phoneme classifier (MagPhonemes): the forced alignment and the
    # lexicon of the labelled training list (data.listing.batch_list_labelled)
    ali_path: Optional[str] = None
    lexicon_path: Optional[str] = None

    # the hybrid modes' Gaussians (tools/torch_build_gaussians.py): the
    # per-phoneme log-STMS statistics of hybrid_mixmax and tracking_vts
    mixmax_stats: Optional[str] = None
    vts_stats: Optional[str] = None

    # paths
    model_path: str = "model"
    set_path: str = "set"
    log_path: str = "log"
    data_path: str = "data"
    test_x_path: str = "set/test_noisy_speech"
    test_s_path: str = "set/test_clean_speech"
    test_d_path: str = "set/test_noise"
    out_path: str = "out"

    # host metric processes in test(): 0 = one per CPU, 1 = serial
    metric_workers: int = 0

    # the ("data", "model") mesh of training (parallel.make_mesh): data
    # shards default to gcd(mbatch_size, world size // n_model_shards)
    n_data_shards: Optional[int] = None
    n_model_shards: int = 1

    @property
    def N_d(self) -> int:
        return int(self.f_s * self.T_d * 0.001)

    @property
    def N_s(self) -> int:
        return int(self.f_s * self.T_s * 0.001)

    @property
    def K(self) -> int:
        return int(2 ** math.ceil(math.log2(self.N_d)))

    @property
    def snr_levels(self) -> List[int]:
        return list(range(self.min_snr, self.max_snr + 1, self.snr_inter))

    def network_kwargs(self) -> Dict[str, Any]:
        """The fields `models.network_selector` reads."""
        return {k: getattr(self, k) for k in
                ("d_model", "n_blocks", "n_heads", "d_f", "k", "max_d_rate",
                 "causal", "unit_type", "outp_act", "max_len", "length", "m_1",
                 "attention_impl", "block_q")}

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# The presets carry the JAX package's tcn_fused: on in resnet-1.1c only (the
# other presets' networks are not the stack the fused TCN kernels compute).
_COMMON = dict(inp_tgt_type="MagXi", map_type="DBNormalCDF", sample_size=1000,
               f_s=16000, T_d=32, T_s=16, loss_fnc="BinaryCrossentropy",
               outp_act="Sigmoid", max_epochs=200, mbatch_size=8, tcn_fused=False)

# The JAX presets' dft_precision="default" is a TPU bf16 knob; the port's
# DFT is float32 throughout.
VERSION_PRESETS: Dict[str, Dict[str, Any]] = {
    "mhanet-1.1c": dict(network_type="MHANetV3", d_model=256, n_blocks=5,
                        n_heads=8, warmup_steps=40000, causal=True,
                        max_len=2048, test_epoch=200, **_COMMON),
    "mhanet-1.0c": dict(network_type="MHANetV2", d_model=256, n_blocks=5,
                        n_heads=8, warmup_steps=40000, causal=True,
                        test_epoch=200, **_COMMON),
    "resnet-1.1c": dict(_COMMON, network_type="ResNetV2", d_model=256, n_blocks=40,
                        d_f=64, k=3, max_d_rate=16, causal=True,
                        unit_type="ReLU->LN->W+b", test_epoch=200, tcn_fused=True,
                        tcn_fused_train=True),
    "resnet-1.1n": dict(network_type="ResNetV2", d_model=256, n_blocks=40,
                        d_f=64, k=3, max_d_rate=16, causal=False,
                        unit_type="ReLU->LN->W+b", test_epoch=180, **_COMMON),
    "resnet-1.0c": dict(network_type="ResNet", d_model=256, n_blocks=40,
                        d_f=64, k=3, max_d_rate=16, causal=True,
                        test_epoch=100, **_COMMON),
    "resnet-1.0n": dict(network_type="ResNet", d_model=256, n_blocks=40,
                        d_f=64, k=3, max_d_rate=16, causal=False,
                        test_epoch=180, **_COMMON),
    "rdlnet-1.0n": dict(network_type="RDLNet", n_blocks=18, length=7, m_1=32,
                        causal=False, unit_type="ReLU->LN->W+b",
                        test_epoch=180, **_COMMON),
    "reslstm-1.0c": dict(network_type="ResLSTM", d_model=512, n_blocks=5,
                         causal=True, test_epoch=200, **_COMMON),
}

# DEMAND VoiceBank training variants.
for _ver in list(VERSION_PRESETS):
    VERSION_PRESETS[_ver + "-vb"] = dict(VERSION_PRESETS[_ver], min_snr=0,
                                         max_snr=15, snr_inter=5,
                                         val_flag=False, test_epoch=125)


def preset(ver: str, **overrides: Any) -> Config:
    """Config for a version preset, with overrides."""
    if ver not in VERSION_PRESETS:
        raise ValueError(f"Unknown version preset: {ver!r} "
                         f"(known: {sorted(VERSION_PRESETS)})")
    kw = dict(VERSION_PRESETS[ver])
    kw.update(overrides)
    return Config(ver=ver, **kw)
