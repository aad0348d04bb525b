"""Networks (follows deepxi_tpu/models/)."""

from deepxi_tpu_torch.models.attention import MHANet, MHANetV2, MHANetV3
from deepxi_tpu_torch.models.rdlnet import RDLNet
from deepxi_tpu_torch.models.rnn import ResBiLSTM, ResLSTM
from deepxi_tpu_torch.models.selector import init_flax_like, network_selector
from deepxi_tpu_torch.models.tcn import ResNet, ResNetV2, ResNetV3

__all__ = [
    "MHANet", "MHANetV2", "MHANetV3", "RDLNet", "ResBiLSTM", "ResLSTM",
    "ResNet", "ResNetV2", "ResNetV3", "init_flax_like", "network_selector",
]
