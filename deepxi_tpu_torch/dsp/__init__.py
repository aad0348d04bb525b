"""Classical DSP (follows deepxi_tpu/dsp/): the MCRA-family trackers and
OM-LSA, histogram noise tracking, MixMax, VTS, and the alignment and
lexicon parsers of the hybrid, classical and phoneme modes; and the
utilities no path of `framework` or `cli` reaches: ASR features
(`features`), adaptive filters (`adaptive`) and an energy VAD (`vad`)."""

from deepxi_tpu_torch.dsp.adaptive import block_nlms, cancel_noise, lms, nlms
from deepxi_tpu_torch.dsp.features import delta, fbank, logfbank, mfcc, ssc

from deepxi_tpu_torch.dsp.histnoise import HistOutputs, HistParams, histogram_track
from deepxi_tpu_torch.dsp.labels import frame_labels, one_hot_targets, read_alignment
from deepxi_tpu_torch.dsp.mixmax import MixMaxModel, default_delta, gaussians_from_stats
from deepxi_tpu_torch.dsp.mixmax import enhance as mixmax_enhance
from deepxi_tpu_torch.dsp.phoneme import Dictionary, Phoneme, parse_lexicon
from deepxi_tpu_torch.dsp.trackers import (MCRAParams, imcra_track, mcra2_track,
                                           mcra_tbrr_track, mcra_track, omlsa_enhance)
from deepxi_tpu_torch.dsp.vad import energy_vad, frame_energies, smooth_vad, speech_segments
from deepxi_tpu_torch.dsp.vts import VTSModel, em_step, make_model, rt_vts_track, vts_enhance

__all__ = ["Dictionary", "HistOutputs", "HistParams", "MCRAParams", "MixMaxModel",
           "Phoneme", "VTSModel", "block_nlms", "cancel_noise", "default_delta", "delta",
           "em_step", "energy_vad", "fbank", "frame_energies", "frame_labels",
           "gaussians_from_stats", "histogram_track", "imcra_track", "lms", "logfbank",
           "make_model", "mcra2_track", "mcra_tbrr_track", "mcra_track", "mfcc",
           "mixmax_enhance", "nlms", "omlsa_enhance", "one_hot_targets", "parse_lexicon",
           "read_alignment", "rt_vts_track", "smooth_vad", "speech_segments", "ssc",
           "vts_enhance"]
