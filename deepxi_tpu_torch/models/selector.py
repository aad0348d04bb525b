"""Network selector (follows deepxi_tpu/models/selector.py): a
`network_type` string to a network, and `init_flax_like` for any of them.

Unlike flax modules, a PyTorch network is built with its input width, so
`network_selector` takes `n_feat` besides `n_outp`. `warmup_steps`, which
the JAX modules carry for the optimizer, is the optimizer's here
(`training.make_optimizer`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from deepxi_tpu_torch.models import attention, rnn
from deepxi_tpu_torch.models.attention import MHANet, MHANetV2, MHANetV3
from deepxi_tpu_torch.models.rdlnet import RDLNet
from deepxi_tpu_torch.models.rnn import ResBiLSTM, ResLSTM
from deepxi_tpu_torch.models.tcn import ResNet, ResNetV2, ResNetV3


def network_selector(network_type: str, n_feat: int, n_outp: int, **kwargs: Any) -> nn.Module:
    """The network for `network_type` with the keyword arguments it reads
    (the JAX selector's: d_model, n_blocks, d_f, k, max_d_rate, n_heads,
    causal, unit_type, outp_act, max_len, length, m_1, attention_impl,
    block_q); a None or another network's key is ignored. An unknown type
    raises ValueError."""
    def pick(*names) -> Dict[str, Any]:
        return {n: kwargs[n] for n in names if kwargs.get(n) is not None}

    if network_type == "MHANet":
        return MHANet(n_feat, n_outp, **pick("d_model", "n_blocks", "n_heads", "causal",
                                             "outp_act"))
    if network_type in ("MHANetV2", "MHANetV3"):
        kw = pick("d_model", "n_blocks", "n_heads", "causal", "outp_act",
                  "attention_impl", "block_q")
        if network_type == "MHANetV3":
            return MHANetV3(n_feat, n_outp, **pick("max_len"), **kw)
        return MHANetV2(n_feat, n_outp, **kw)
    if network_type == "ResNet":
        return ResNet(n_feat, n_outp, **pick("d_model", "n_blocks", "d_f", "k",
                                             "max_d_rate", "causal", "outp_act"))
    if network_type in ("ResNetV2", "ResNetV3"):
        cls = ResNetV2 if network_type == "ResNetV2" else ResNetV3
        return cls(n_feat, n_outp, **pick("d_model", "n_blocks", "d_f", "k", "max_d_rate",
                                          "causal", "unit_type", "outp_act"))
    if network_type in ("ResLSTM", "ResBiLSTM"):
        cls = ResLSTM if network_type == "ResLSTM" else ResBiLSTM
        return cls(n_feat, n_outp, **pick("d_model", "n_blocks", "outp_act"))
    if network_type == "RDLNet":
        return RDLNet(n_feat, n_outp, **pick("n_blocks", "length", "m_1", "causal",
                                             "unit_type", "outp_act"))
    raise ValueError(f"Invalid network type: {network_type!r}")


def init_flax_like(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise any network of the selector in place as flax does, from
    `generator` (a CPU generator; initialise on the CPU, then move): convs
    and dense kernels lecun_normal, V2/V3 attention kernels xavier_uniform,
    LSTM recurrent kernels orthogonal, embeddings normal, biases zero,
    LayerNorm scales one (`attention.init_flax_like`, then
    `rnn.init_recurrent_kernels_`)."""
    attention.init_flax_like(net, generator)
    return rnn.init_recurrent_kernels_(net, generator)
