"""Frame-wise, sequence-wise and causal sequence-wise layer normalisation
(`deepxi_tpu_torch.ops.normalisation`) against `deepxi_tpu.ops.normalisation`
on the CPU: the same inputs (with garbage past each row's length, which the
sequence norms must mask), lengths and affine terms; 1e-5 of the scale."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu_torch.ops import normalisation as norm

# the module (the package's `ops.normalisation` name is its function)
norm_j = importlib.import_module("deepxi_tpu.ops.normalisation")

TYPES = ["FrameLayerNorm", "SeqLayerNorm", "SeqCausalLayerNorm", "unnormalised"]


def _inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 20, 12) * 3 + 1).astype(np.float32)
    seq_len = np.array([20, 13, 1], np.int32)
    beta, gamma = rng.randn(12).astype(np.float32), rng.rand(12).astype(np.float32) + 0.5
    return x, seq_len, beta, gamma


@pytest.mark.parametrize("norm_type", TYPES)
@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
def test_normalisation_matches_jax(norm_type, affine):
    x, seq_len, beta, gamma = _inputs()
    kw = dict(beta=beta, gamma=gamma) if affine else {}
    y = norm.normalisation(torch.as_tensor(x), norm_type, torch.as_tensor(seq_len),
                           **{k: torch.as_tensor(v) for k, v in kw.items()}).numpy()
    y_j = np.asarray(norm_j.normalisation(jnp.asarray(x), norm_type, jnp.asarray(seq_len),
                                          **{k: jnp.asarray(v) for k, v in kw.items()}))
    assert np.abs(y - y_j).max() <= 1e-5 * max(np.abs(y_j).max(), 1.0)
    if norm_type.startswith("Seq"):
        assert not y[1, 13:].any() and not y[2, 1:].any()


def test_unknown_type_raises():
    with pytest.raises(ValueError, match="does not exist"):
        norm.normalisation(torch.zeros(1, 2, 3), "BatchNorm")
