"""The plain reference: PyTorch and NumPy only, nothing of the program.
It works out again from the benchmark's inputs what the program derives:
the spectra, the network, the map, the gain, the synthesis, the training
examples, the loss, the gradients and the optimizer's update.

What belongs to one kind of configuration is a file found by the name the
configuration gives: `networks/<network_type>.py`, `families/<inp_tgt_type>.py`,
`maps/<map_type>.py`, `gains/<gain>.py`. A configuration that names a part
with no file is refused."""

from __future__ import annotations

from perfbench import named
from perfbench.reference.ops import matmul, matmul_tf32


def net(cfg: dict):
    """The module of the configuration's network: `shapes`, `forward`,
    `flops_per_frame`, `train_flops_per_frame` (and, for a causal
    convolutional one, `receptive_field`)."""
    return named.module("reference/networks", cfg["network_type"])


def family(cfg: dict):
    """The module of the configuration's input-target family: `n_feat`,
    `n_outp`, `features`, `target`, `enhance_spectrum`."""
    return named.module("reference/families", cfg["inp_tgt_type"])


def map_(cfg: dict):
    """The module of the configuration's map: `forward`, `inverse`."""
    return named.module("reference/maps", cfg["map_type"])


def gain(cfg: dict):
    """The configuration's gain function g(xi, gamma)."""
    return named.module("reference/gains", cfg["gain"]).gain


def network(cfg: dict, params: dict, tf32: bool = False):
    """The configuration's network on `params`, its products in float32 or,
    with `tf32`, as TF32 makes them."""
    fn, mm = net(cfg).forward, matmul_tf32 if tf32 else matmul
    return lambda x: fn(params, x, cfg, mm)
