"""Typed configuration and the resnet-1.1c preset (follows
deepxi_tpu/config.py; only the fields that training and the statistics
sample read, and only the ResNetV2 presets the port runs so far)."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Config:
    """Framework configuration (the JAX package's field names and defaults)."""
    ver: str = "resnet-1.1c"
    network_type: str = "ResNetV2"
    inp_tgt_type: str = "MagXi"

    # features
    f_s: int = 16000
    T_d: int = 32
    T_s: int = 16
    min_snr: int = -10
    max_snr: int = 20
    snr_inter: int = 1

    # training
    mbatch_size: int = 8
    sample_size: int = 1000
    max_epochs: int = 200
    resume_epoch: int = 0
    save_model: bool = True
    save_every: int = 1   # checkpoint every N epochs (always at the last)
    val_every: int = 1    # evaluate the validation set every N epochs
    val_flag: bool = True
    loss_fnc: str = "BinaryCrossentropy"
    seed: int = 0

    # resets
    reset_inp_tgt: bool = False
    reset_sample: bool = False

    # network hyper-parameters
    d_model: Optional[int] = None
    n_blocks: Optional[int] = None
    d_f: Optional[int] = None
    k: Optional[int] = None
    max_d_rate: Optional[int] = None
    causal: bool = True
    warmup_steps: int = 40000
    unit_type: Optional[str] = None
    outp_act: str = "Sigmoid"
    # the fused forward/backward pair of ops/kernels/tcn_fused_train.py in
    # the train step
    tcn_fused_train: bool = False

    # map
    map_type: Any = "DBNormalCDF"

    # paths
    model_path: str = "model"
    set_path: str = "set"
    log_path: str = "log"
    data_path: str = "data"

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

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_COMMON = dict(inp_tgt_type="MagXi", map_type="DBNormalCDF", sample_size=1000,
               f_s=16000, T_d=32, T_s=16, loss_fnc="BinaryCrossentropy",
               outp_act="Sigmoid", max_epochs=200, mbatch_size=8)

VERSION_PRESETS: Dict[str, Dict[str, Any]] = {
    "resnet-1.1c": dict(network_type="ResNetV2", d_model=256, n_blocks=40,
                        d_f=64, k=3, max_d_rate=16, causal=True,
                        unit_type="ReLU->LN->W+b", tcn_fused_train=True,
                        **_COMMON),
}


def preset(ver: str, **overrides: Any) -> Config:
    """Config for a version preset, with overrides."""
    if ver not in VERSION_PRESETS:
        raise ValueError(f"Unknown version preset: {ver!r} "
                         f"(known: {sorted(VERSION_PRESETS)})")
    kw = dict(VERSION_PRESETS[ver])
    kw.update(overrides)
    return Config(ver=ver, **kw)
