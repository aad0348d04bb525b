"""L7 objective evaluation (follows deepxi_tpu/metrics/; ref:
deepxi/model.py:1814-1861 + MATLAB suite). numpy and scipy only."""

from deepxi_tpu_torch.metrics.pesq import pesq
from deepxi_tpu_torch.metrics.quality import composite, llr, seg_snr, snr_overall, wss
from deepxi_tpu_torch.metrics.stoi import stoi

__all__ = ["composite", "llr", "pesq", "seg_snr", "snr_overall", "stoi", "wss"]
