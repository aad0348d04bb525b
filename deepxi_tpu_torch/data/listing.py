"""Dataset file listing and validation pairing (follows
deepxi_tpu/data/listing.py; wav files only).

  * training lists are ``{file_path, wav_len}`` dicts gathered by glob over
    ``*.wav``, pickle-cached per hostname under ``data_path``;
  * validation pairs are identically named clean/noise files whose basename
    ends in ``_<snr>dB``, mixed at the filename SNR.
"""

from __future__ import annotations

import glob
import os
import pickle
import platform
from typing import Dict, List, Tuple

import numpy as np

from deepxi_tpu_torch.data.wavio import read_wav, wav_length


def batch_list(file_dir: str, list_name: str, data_path: str = "data") -> List[Dict]:
    """File-path + length list with a per-hostname pickle cache (used when
    its paths lie under `file_dir`)."""
    cache = os.path.join(data_path, f"{list_name}_list_{platform.node()}.p")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            cached = pickle.load(f)
        if cached and cached[0]["file_path"].find(file_dir) != -1:
            return cached
    out = [{"file_path": p, "wav_len": wav_length(p)}
           for p in sorted(glob.glob(os.path.join(file_dir, "*.wav")))]
    os.makedirs(data_path, exist_ok=True)
    with open(cache, "wb") as f:
        pickle.dump(out, f)
    return out


def val_wav_batch(val_s_dir: str, val_d_dir: str
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Paired clean/noise validation batch: (val_s, val_d, val_s_len,
    val_d_len, val_snr), int16 matrices padded to the longest file, lengths
    and the SNRs parsed from the `_XdB` basenames."""
    s_list, d_list, snrs = [], [], []
    s_paths = sorted(glob.glob(os.path.join(val_s_dir, "*.wav")))
    d_paths = sorted(glob.glob(os.path.join(val_d_dir, "*.wav")))
    for j, k in zip(s_paths, d_paths):
        sb = os.path.basename(os.path.splitext(j)[0])
        if sb != os.path.basename(os.path.splitext(k)[0]):
            raise ValueError(f"clean/noise validation files do not match: {j} vs {k}")
        if sb[-2:] != "dB":
            raise ValueError(f"validation basename must end in dB: {sb}")
        s_wav, _ = read_wav(j)
        d_wav, _ = read_wav(k)
        if len(s_wav) != len(d_wav):
            raise ValueError(f"validation clean/noise lengths differ for {sb}")
        s_list.append(s_wav)
        d_list.append(d_wav)
        snrs.append(float(sb.split("_")[-1][:-2]))
    if not s_list:
        raise ValueError("no validation files found")
    lens = np.asarray([len(w) for w in s_list], np.int32)
    val_s = np.zeros([len(s_list), lens.max()], np.int16)
    val_d = np.zeros_like(val_s)
    for i, (s, d) in enumerate(zip(s_list, d_list)):
        val_s[i, :len(s)] = s
        val_d[i, :len(d)] = d
    return val_s, val_d, lens, lens.copy(), np.asarray(snrs, np.int32)
