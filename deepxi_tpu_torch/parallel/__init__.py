"""The mesh and sharding layer over cards (follows deepxi_tpu/parallel/):
the process group, the ("data", "model") mesh, data-parallel and
model-sharded training (`training.trainer`), time-sharded enhancement of
one long recording (`seq_enhance` for the ResNet family, `ring_attention`
for MHANet) and multi-card serving bundles (`serving`)."""

from deepxi_tpu_torch.parallel.distributed import (init_distributed, is_primary,
                                                    local_batch_slice)
from deepxi_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    param_sharding,
    replicated,
    shard_batch,
    shard_params,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "batch_sharding", "init_distributed",
           "is_primary", "local_batch_slice", "make_mesh", "param_sharding",
           "replicated", "shard_batch", "shard_params"]
