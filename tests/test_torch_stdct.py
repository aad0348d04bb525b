"""The short-time DCT (`deepxi_tpu_torch.sig.stdct`) against tf.signal's
numbers in tests/golden/stdct.npz (the JAX package's tolerances there,
2e-3 and 2e-2 on coefficients of up to ~1e2) and against
`deepxi_tpu.sig.stdct` on the CPU at several framings (1e-5 of the scale)."""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepxi_tpu_torch.sig import stdct

stdct_j = importlib.import_module("deepxi_tpu.sig.stdct")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "stdct.npz")


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0)


def test_stdct_matches_tf_signal():
    g = np.load(GOLDEN)
    S = stdct.stdct(torch.as_tensor(g["x"]), 512, 256, 512).numpy()
    np.testing.assert_allclose(S, g["S"], rtol=0, atol=2e-3)
    y = stdct.inverse_stdct(torch.as_tensor(g["S"]), 512, 256, 512).numpy()
    np.testing.assert_allclose(y, g["y"], rtol=0, atol=2e-2)


@pytest.mark.parametrize("N_d,N_s,K", [(512, 256, 512), (512, 128, 512), (400, 160, 512),
                                       (512, 256, 256)])
def test_stdct_matches_jax(N_d, N_s, K):
    """Analysis, synthesis (K < N_d zero-pads the frames) and the 2K round
    trip, and the DCTs alone with a length change."""
    x = np.random.RandomState(2).randn(2, 3001).astype(np.float32)
    S = stdct.stdct(torch.as_tensor(x), N_d, N_s, K)
    S_j = np.asarray(stdct_j.stdct(jnp.asarray(x), N_d, N_s, K))
    _close(S, S_j)
    _close(stdct.inverse_stdct(torch.as_tensor(S_j), N_d, N_s, K),
           stdct_j.inverse_stdct(jnp.asarray(S_j), N_d, N_s, K))
    for n in (K // 2, K, 2 * K):
        _close(stdct.dct2(torch.as_tensor(x[:, :K]), n), stdct_j.dct2(jnp.asarray(x[:, :K]), n))
        _close(stdct.dct3(torch.as_tensor(x[:, :K]), n), stdct_j.dct3(jnp.asarray(x[:, :K]), n))
    if K >= N_d:
        y = stdct.inverse_stdct(S, N_d, N_s, K).numpy() / (2.0 * K)
        inner = slice(N_d, 3001 - N_d)
        np.testing.assert_allclose(y[:, inner], x[:, inner], rtol=0, atol=1e-4)
