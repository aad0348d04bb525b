"""Importers for the reference's shipped artifacts (the port's own copy of
deepxi_tpu/compat/tf_import.py).

Two compatibility channels:

  * Keras SavedModel checkpoints (``model/<ver>/epoch-<n>/variables``) ->
    the JAX package's parameter trees of numpy arrays ({"params": {module:
    {leaf: array}}}, nested as flax nests them), which
    `compat.artifact.from_flax_params` turns into a state dict of the
    port's network (layer ordering is Keras ``layer_with_weights-N``
    creation order).
  * ``data/<ver>_inp_tgt.p`` stats pickles -> explicit (map_type, mu, sigma)
    arrays (`DeepXiTorch.import_reference_stats`, ``--import_stats``).

TensorFlow is needed only to *read* the TF-format artifacts (a checkpoint,
and the TF tensors inside a pickle); it is imported inside the functions
that need it, never when this module is imported, and never touches the
compute path. The card's machine has no TensorFlow.
"""

from __future__ import annotations

import pickle
import sys
import types
from typing import Any, Dict

import numpy as np


# ---------------------------------------------------------------------------
# Stats pickle import
# ---------------------------------------------------------------------------

_REF_CLASSES = {
    "deepxi.inp_tgt": ["MagXi", "MagGamma", "MagXiGamma", "MagGain", "MagMag",
                       "MagSMM", "MagPhaXiPha", "STDCTXiCD", "MagPhonemes",
                       "MagTgt"],
    "deepxi.map": ["NormalCDF", "LaplaceCDF", "TruncatedLaplaceCDF",
                   "UniformCDF", "Linear", "DB", "Square", "Clip", "Logistic",
                   "Standardise", "MinMaxScaling", "Map"],
    "deepxi.sig": ["InputTarget", "AnalysisSynthesis"],
}


class _ref_stub_scope:
    """Temporarily install stub `deepxi.*` modules so reference pickles
    resolve without the (broken) reference package on the path, restoring
    sys.modules on exit. TF tensors inside the pickle reconstruct through
    TF itself.

    Scoped (not permanent) because tests that execute the real reference
    modules as oracles (tests/test_ref_chain_oracle.py) share the process:
    a leaked fake `deepxi.inp_tgt` would shadow the real one for the rest
    of the pytest session. The unpickled objects keep the stub classes
    alive on their own; nothing needs to stay in sys.modules."""

    def __enter__(self):
        self._saved = {}
        names = set()
        for modname in _REF_CLASSES:
            parts = modname.split(".")
            names.update(".".join(parts[:i]) for i in range(1, len(parts) + 1))
        for name in names:
            self._saved[name] = sys.modules.get(name)
            sys.modules[name] = types.ModuleType(name)
        for modname, classes in _REF_CLASSES.items():
            mod = sys.modules[modname]
            for c in classes:
                setattr(mod, c, type(c, (), {}))
        return self

    def __exit__(self, *exc):
        for name, prev in self._saved.items():
            if prev is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = prev
        return False


def _to_np(v: Any) -> Any:
    try:
        return np.asarray(v)
    except Exception:
        return v


def load_inp_tgt_stats(path: str) -> Dict[str, Any]:
    """Load a reference ``<ver>_inp_tgt.p`` pickle into a plain dict.

    Returns a dict with keys: ``inp_tgt_type``, ``N_d``, ``N_s``, ``K``,
    ``f_s``, ``n_feat``, ``n_outp`` and one entry per map attribute found
    (e.g. ``xi_map`` -> {"map_type": str, "mu": np.ndarray, "sigma": ...}).
    """
    with _ref_stub_scope(), open(path, "rb") as f:
        obj = pickle.load(f)
    out: Dict[str, Any] = {"inp_tgt_type": type(obj).__name__}
    d = obj.__dict__
    for k in ("N_d", "N_s", "K", "f_s", "n_feat", "n_outp"):
        if k in d:
            out[k] = int(d[k])
    for k, v in d.items():
        if k.endswith("_map") and hasattr(v, "__dict__"):
            md = {"map_type": v.__dict__.get("map_type")}
            for stat in ("mu", "sigma", "b", "min", "max", "params"):
                if stat in v.__dict__ and v.__dict__[stat] is not None:
                    md[stat] = _to_np(v.__dict__[stat])
            out[k] = md
    return out


# ---------------------------------------------------------------------------
# Keras checkpoint import
# ---------------------------------------------------------------------------

def read_keras_checkpoint(ckpt_prefix: str) -> Dict[int, Dict[str, np.ndarray]]:
    """Read ``layer_with_weights-N`` variables from a SavedModel checkpoint.

    Args:
      ckpt_prefix: e.g. "model/resnet-1.1c/epoch-199/variables/variables".

    Returns:
      {layer_index: {attr_name: array}} with attrs like kernel/bias/gamma/
      beta/embeddings/query_kernel/... Nested sublayers (e.g. the custom
      MHANet V1 attention layer's ``linear_q`` Conv1Ds, or a
      TimeDistributed-wrapped Dense) keep their slash-joined subpath as the
      attr name ("linear_q/kernel", "layer/kernel", "cell/recurrent_kernel").
    """
    import re

    import tensorflow as tf  # lazy: reading TF artifacts only

    rdr = tf.train.load_checkpoint(ckpt_prefix)
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for key in rdr.get_variable_to_shape_map():
        m = re.match(r"layer_with_weights-(\d+)/(.+)/\.ATTRIBUTES/VARIABLE_VALUE$", key)
        if m:
            out.setdefault(int(m.group(1)), {})[m.group(2)] = rdr.get_tensor(key)
    return out


def import_resnet(ckpt_prefix, n_blocks: int = 40,
                  version: int = 2) -> Dict[str, Any]:
    """Map a ResNet/ResNetV2/ResNetV3 Keras checkpoint to our flax params.

    Keras creation order (verified against model/resnet-1.1c/epoch-199):
    0 ff_conv, 1 ff_ln(gamma), then 3 convs per block (the stat-only unit
    LNs have no weights), finally out_conv.
    For version==1 (ResNet 1.0): unit LNs carry gamma+beta and the layer
    ordering interleaves them; handled below.

    `ckpt_prefix` may also be a pre-read {layer_index: {attr: array}} dict
    (for round-trip tests without TF).
    """
    layers = (ckpt_prefix if isinstance(ckpt_prefix, dict)
              else read_keras_checkpoint(ckpt_prefix))
    p: Dict[str, Any] = {}

    def conv(entry):
        return {"kernel": entry["kernel"], "bias": entry["bias"]} \
            if "bias" in entry else {"kernel": entry["kernel"]}

    if version in (2, 3):
        p["ff_conv"] = conv(layers[0])
        p["ff_ln"] = {"scale": layers[1]["gamma"]}
        idx = 2
        for i in range(n_blocks):
            for j in range(1, 4):
                p[f"block{i}_u{j}_conv"] = conv(layers[idx]); idx += 1
        p["out_conv"] = conv(layers[idx])
    else:
        # ResNet v1: ff conv (no bias), ff LN(gamma,beta); per block 3 units
        # of [LN(gamma,beta), conv]; out conv.
        p["ff_conv"] = {"kernel": layers[0]["kernel"]}
        p["ff_ln"] = {"scale": layers[1]["gamma"], "bias": layers[1]["beta"]}
        idx = 2
        for i in range(n_blocks):
            for j in range(1, 4):
                p[f"block{i}_u{j}_ln"] = {"scale": layers[idx]["gamma"],
                                          "bias": layers[idx]["beta"]}
                idx += 1
                p[f"block{i}_u{j}_conv"] = conv(layers[idx]); idx += 1
        p["out_conv"] = conv(layers[idx])
    return {"params": _np_tree(p)}


def import_mhanet_v3(ckpt_prefix, n_blocks: int = 5) -> Dict[str, Any]:
    """Map an MHANetV3 Keras checkpoint to our flax params.

    Keras creation order (verified against model/mhanet-1.1c/epoch-199):
    0 in_conv(kernel), 1 in_ln(gamma,beta), 2 pos_emb, then per block
    [mha(4 kernels), ln1, ff1(conv), ff2(conv), ln2], finally out_conv.
    `ckpt_prefix` may also be a pre-read {layer_index: {attr: array}} dict.
    """
    layers = (ckpt_prefix if isinstance(ckpt_prefix, dict)
              else read_keras_checkpoint(ckpt_prefix))
    p: Dict[str, Any] = {}
    p["in_conv"] = {"kernel": layers[0]["kernel"]}
    p["in_ln"] = {"scale": layers[1]["gamma"], "bias": layers[1]["beta"]}
    p["pos_emb"] = {"embedding": layers[2]["embeddings"]}
    idx = 3
    for i in range(n_blocks):
        mha = layers[idx]; idx += 1
        p[f"block{i}_mha"] = {
            "query_kernel": mha["query_kernel"],
            "key_kernel": mha["key_kernel"],
            "value_kernel": mha["value_kernel"],
            "projection_kernel": mha["projection_kernel"],
        }
        ln1 = layers[idx]; idx += 1
        p[f"block{i}_ln1"] = {"scale": ln1["gamma"], "bias": ln1["beta"]}
        ff1 = layers[idx]; idx += 1
        # Keras 1x1 Conv1D kernel [1, in, out] -> Dense kernel [in, out].
        p[f"block{i}_ff1"] = {"kernel": ff1["kernel"][0], "bias": ff1["bias"]}
        ff2 = layers[idx]; idx += 1
        p[f"block{i}_ff2"] = {"kernel": ff2["kernel"][0], "bias": ff2["bias"]}
        ln2 = layers[idx]; idx += 1
        p[f"block{i}_ln2"] = {"scale": ln2["gamma"], "bias": ln2["beta"]}
    p["out_conv"] = {"kernel": layers[idx]["kernel"], "bias": layers[idx]["bias"]}
    return {"params": _np_tree(p)}


def import_mhanet_v1(ckpt_prefix, n_blocks: int = 5) -> Dict[str, Any]:
    """Map an MHANet (V1) Keras checkpoint to our flax params.

    Keras functional topological order (ref: deepxi/network/attention.py:
    15-101): 0 in_conv(kernel, no bias), 1 in_ln(gamma,beta), then per block
    [custom MultiHeadAttention (four no-bias Conv1D sublayers linear_q/k/v/o,
    ref: attention.py:119-122), ln1, ff1 Conv1D(d_ff, bias),
    ff2 Conv1D(d_model, bias), ln2], finally out_conv(bias).

    Our MultiHeadAttentionV1 projections are Dense [d, d]; the reference's
    1x1 Conv1D kernels [1, d, d] drop the leading axis.
    `ckpt_prefix` may also be a pre-read {layer_index: {attr: array}} dict.
    """
    layers = (ckpt_prefix if isinstance(ckpt_prefix, dict)
              else read_keras_checkpoint(ckpt_prefix))
    p: Dict[str, Any] = {}
    p["in_conv"] = {"kernel": layers[0]["kernel"]}
    p["in_ln"] = {"scale": layers[1]["gamma"], "bias": layers[1]["beta"]}
    idx = 2
    for i in range(n_blocks):
        mha = layers[idx]; idx += 1
        p[f"block{i}_mha"] = {
            name: {"kernel": np.asarray(mha[f"{name}/kernel"])[0]}
            for name in ("linear_q", "linear_k", "linear_v", "linear_o")}
        ln1 = layers[idx]; idx += 1
        p[f"block{i}_ln1"] = {"scale": ln1["gamma"], "bias": ln1["beta"]}
        ff1 = layers[idx]; idx += 1
        p[f"block{i}_ff1"] = {"kernel": np.asarray(ff1["kernel"])[0],
                              "bias": ff1["bias"]}
        ff2 = layers[idx]; idx += 1
        p[f"block{i}_ff2"] = {"kernel": np.asarray(ff2["kernel"])[0],
                              "bias": ff2["bias"]}
        ln2 = layers[idx]; idx += 1
        p[f"block{i}_ln2"] = {"scale": ln2["gamma"], "bias": ln2["beta"]}
    p["out_conv"] = {"kernel": layers[idx]["kernel"],
                     "bias": layers[idx]["bias"]}
    return {"params": _np_tree(p)}


def import_mhanet_v2(ckpt_prefix, n_blocks: int = 5) -> Dict[str, Any]:
    """Map an MHANetV2 Keras checkpoint: identical to V3 minus the learned
    positional embedding (ref: deepxi/network/attention.py:278-353)."""
    layers = (ckpt_prefix if isinstance(ckpt_prefix, dict)
              else read_keras_checkpoint(ckpt_prefix))
    # re-key so the V3 mapper sees a pos_emb slot; V2 has none, so shift
    # every block layer up by one and synthesise an empty embedding
    shifted: Dict[int, Dict[str, np.ndarray]] = {0: layers[0], 1: layers[1]}
    d_model = np.asarray(layers[0]["kernel"]).shape[-1]
    shifted[2] = {"embeddings": np.zeros((1, d_model), np.float32)}
    last = max(layers)
    for n in range(2, last + 1):
        shifted[n + 1] = layers[n]
    out = import_mhanet_v3(shifted, n_blocks=n_blocks)
    del out["params"]["pos_emb"]
    return out


def import_reslstm(ckpt_prefix, n_blocks: int = 5) -> Dict[str, Any]:
    """Map a ResLSTM Keras checkpoint to our flax params.

    Keras order (ref: deepxi/network/rnn.py:13-79): 0 ff Dense(no bias),
    1 ff LN(gamma,beta), one LSTM per block (cell/kernel [in, 4h],
    cell/recurrent_kernel [h, 4h], cell/bias [4h], gate order i|f|g|o),
    finally TimeDistributed(Dense) (layer/kernel, layer/bias).

    flax's OptimizedLSTMCell keeps per-gate parameters: i{i,f,g,o} input
    kernels (no bias) and h{i,f,g,o} recurrent kernels (with bias); Keras'
    single bias vector lands on the recurrent gates (the cell adds it once
    either way). `ckpt_prefix` may be a pre-read dict.
    """
    layers = (ckpt_prefix if isinstance(ckpt_prefix, dict)
              else read_keras_checkpoint(ckpt_prefix))
    p: Dict[str, Any] = {}
    p["ff_dense"] = {"kernel": layers[0]["kernel"]}
    p["ff_ln"] = {"scale": layers[1]["gamma"], "bias": layers[1]["beta"]}
    for i in range(n_blocks):
        lw = layers[2 + i]
        K = np.asarray(lw["cell/kernel"])
        R = np.asarray(lw["cell/recurrent_kernel"])
        b = np.asarray(lw["cell/bias"])
        h = R.shape[0]
        cell: Dict[str, Any] = {}
        for g, name in enumerate("ifgo"):
            sl = slice(g * h, (g + 1) * h)
            cell[f"i{name}"] = {"kernel": K[:, sl]}
            cell[f"h{name}"] = {"kernel": R[:, sl], "bias": b[sl]}
        p[f"block{i}_lstm"] = {"cell": cell}
    out = layers[2 + n_blocks]
    k = out.get("layer/kernel", out.get("kernel"))
    bo = out.get("layer/bias", out.get("bias"))
    p["out_dense"] = {"kernel": k, "bias": bo}
    return {"params": _np_tree(p)}


def _np_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)
