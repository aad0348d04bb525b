"""Classical DSP for the hybrid and classical enhancement modes and the
phoneme mode (follows deepxi_tpu/dsp/): the MCRA-family trackers and
OM-LSA, histogram noise tracking, MixMax, VTS, and the alignment and
lexicon parsers. The JAX package's `features`, `adaptive` and `vad`, which
no path of `framework` or `cli` reaches, are ROADMAP item A11b."""

from deepxi_tpu_torch.dsp.histnoise import HistOutputs, HistParams, histogram_track
from deepxi_tpu_torch.dsp.labels import frame_labels, one_hot_targets, read_alignment
from deepxi_tpu_torch.dsp.mixmax import MixMaxModel, default_delta, gaussians_from_stats
from deepxi_tpu_torch.dsp.mixmax import enhance as mixmax_enhance
from deepxi_tpu_torch.dsp.phoneme import Dictionary, Phoneme, parse_lexicon
from deepxi_tpu_torch.dsp.trackers import (MCRAParams, imcra_track, mcra2_track,
                                           mcra_tbrr_track, mcra_track, omlsa_enhance)
from deepxi_tpu_torch.dsp.vts import VTSModel, em_step, make_model, rt_vts_track, vts_enhance

__all__ = ["Dictionary", "HistOutputs", "HistParams", "MCRAParams", "MixMaxModel",
           "Phoneme", "VTSModel", "default_delta", "em_step", "frame_labels",
           "gaussians_from_stats", "histogram_track", "imcra_track", "make_model",
           "mcra2_track", "mcra_tbrr_track", "mcra_track", "mixmax_enhance",
           "omlsa_enhance", "one_hot_targets", "parse_lexicon", "read_alignment",
           "rt_vts_track", "vts_enhance"]
