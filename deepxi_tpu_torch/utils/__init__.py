"""Utility subsystems: profiling (follows deepxi_tpu/utils/)."""

from deepxi_tpu_torch.utils.profiling import StageTimer, annotate, trace

__all__ = ["StageTimer", "annotate", "trace"]
