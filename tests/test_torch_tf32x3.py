"""The numerics of the split-TF32 tensor-core product (`csrc/mma_tf32x3.cuh`),
emulated on the CPU.

The redesigned kernels (the TCN forward and backward, the attention, the
fused transformer block's row kernels) take every product on the
tensor cores as three TF32 products: each f32 operand x is split as
hi = tf32(x) (round to nearest, ties away from zero, 10 mantissa bits, as
cvt.rna rounds; the kernels round with integer instructions) and
lo = tf32(x - hi), and a.b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi in f32;
two k-steps (16 terms) are summed on the tensor cores and then added to
the running sum in f32. Here numpy emulates that product, runs the plain
ResNetV2 block stack (flagship widths, 5 and 40 blocks), the masked
attention (B=1, T=250, 8 heads of 32) and the whole fused transformer block
(its row kernels' column and FFN partition over a cluster of 8 CTAs, the
partials summed in rank order) through it, and holds each against float64
with the kernels' card gate: 1e-4 of the output's scale, every row
compared; and the TCN backward's input- and weight-gradient products (the
weight gradients over 12 row splits summed in order) at 2e-4 of each
leaf's scale. Plain TF32 (one
product of the rounded operands) is measured beside it and reported in the
assertion message; it is no gate. These are the design's numerics on a
machine without a card; the kernels themselves are held to their plain
versions on the card (chip_smoke.py phase 2, tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from deepxi_tpu_torch.models.tcn import cyclic_dilation
from deepxi_tpu_torch.ops.kernels import (mha_block_fused, mha_fused, tcn_fused,
                                          tcn_fused_train)

GATE = 1e-4  # the forward kernels' card gate, of the output's max abs
GRAD_GATE = 2e-4  # the backward's card gate, of each leaf's max abs
KG_TERMS = 16  # terms summed on the tensor cores before an f32 add (2 k-steps)


def tf32(x):
    """x (float32) rounded to TF32 as cvt.rna.tf32.f32 does: the low 13
    mantissa bits dropped, rounding to nearest with ties away from zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mm_tf32x3(a, b):
    """a @ b as the kernels take it: hi.hi + hi.lo + lo.hi in f32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a, b):
    """a @ b with plain TF32 operands, f32 sums."""
    return tf32(np.asarray(a, np.float32)) @ tf32(np.asarray(b, np.float32))


def mm_f64(a, b):
    return np.asarray(a, np.float64) @ np.asarray(b, np.float64)


def _layer_norm(x):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + x.dtype.type(1e-6))


def resnet_stack(x, weights, dilations, mm, k=3):
    """The causal ReLU->LN->W+b bottleneck blocks (the plain
    `fused_block_group_whole_ref`) with every product taken by `mm`; the
    working type follows x."""
    relu = lambda v: np.maximum(v, 0)  # noqa: E731
    h = x
    for (w1, b1, w2, b2, w3, b3), d in zip(weights, dilations):
        reach = (k - 1) * d
        a2 = _layer_norm(relu(mm(_layer_norm(relu(h)), w1[0]) + b1)).astype(x.dtype)
        a2 = np.pad(a2, ((0, 0), (reach, 0), (0, 0)))
        T = h.shape[1]
        y = sum(mm(a2[:, j * d:j * d + T], w2[j]) for j in range(k)).astype(x.dtype)
        a3 = _layer_norm(relu(y + b2)).astype(x.dtype)
        h = (h + mm(a3, w3[0]) + b3).astype(x.dtype)
    return h


def _stack_inputs(G, seed=0):
    gen = torch.Generator().manual_seed(seed)
    w = tcn_fused.random_block_weights(G, gen, "cpu")
    x = torch.relu(torch.randn(2, 48, 256, generator=gen))
    return x, w, [cyclic_dilation(i, 16) for i in range(G)]


def _rel(y, ref):
    """Worst row's max abs error over the output's max abs."""
    return float(np.abs(y - ref).max() / np.abs(ref).max())


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's unit in the last place at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                  one + ulp, np.float32(3.0)], np.float32)
    np.testing.assert_array_equal(tf32(x), [one + ulp, -(one + ulp), one, one + ulp, 3.0])
    r = np.random.RandomState(0).randn(10000).astype(np.float32)
    hi = tf32(r)
    assert np.all(np.abs(r - hi) <= np.abs(r) * 2.0 ** -11)
    lo = tf32(r - hi)
    # hi + lo keeps 22 of f32's 24 significant bits
    assert np.all(np.abs(r - hi - lo) <= np.abs(r) * 2.0 ** -22)


@pytest.mark.parametrize("G", [5, 40])
def test_split_product_keeps_the_resnet_stack_inside_the_gate(G):
    """Flagship widths (d_model 256, d_f 64, k 3, dilations 1..16), B=2,
    T=48: the stack through the split product within 1e-4 of float64's
    scale; the f32 stack through numpy is first held to the port's plain
    version."""
    x, w, dil = _stack_inputs(G)
    wn = [tuple(t.numpy() for t in bw) for bw in w]
    x32 = x.numpy()
    ref64 = resnet_stack(x32.astype(np.float64), [tuple(t.astype(np.float64) for t in bw)
                                                  for bw in wn], dil, mm_f64)
    plain = tcn_fused.fused_block_group_whole_ref(
        x.double(), [tcn_fused.BlockWeights(*(t.double() for t in bw)) for bw in w],
        dil).numpy()
    assert _rel(ref64, plain) < 1e-12  # the emulated stack is the port's function
    x3 = resnet_stack(x32, wn, dil, mm_tf32x3)
    t1 = resnet_stack(x32, wn, dil, mm_tf32)
    f32 = resnet_stack(x32, wn, dil, lambda a, b: a @ b)
    err, err_tf32, err_f32 = _rel(x3, ref64), _rel(t1, ref64), _rel(f32, ref64)
    assert np.isfinite(x3).all()
    assert err <= GATE, (
        f"{G} blocks: split TF32 {err:.3e}, plain TF32 {err_tf32:.3e}, f32 "
        f"{err_f32:.3e} of the output's scale from float64")
    # the split keeps f32's accuracy, far inside plain TF32's error
    assert err <= 4 * err_f32 + 1e-6 and err < err_tf32, (err, err_f32, err_tf32)


def _attention(q, k, v, valid, mm):
    """Causal masked attention with the -1e10 additive mask as f32 takes it
    (q.k - 1e10 is -1e10 for |q.k| < 512, so an invalid row averages the
    keys it visits); products by `mm` per head; the softmax in the working
    type of q."""
    T = q.shape[1]
    allowed = valid[:, :, None] & valid[:, None, :] & np.tril(np.ones((T, T), bool))
    out = np.empty_like(q)
    for h in range(q.shape[2]):
        s = mm(q[0, :, h], k[0, :, h].T).astype(q.dtype)
        s = np.where(allowed[0], s, q.dtype.type(-1e10))
        p = np.exp(s - s.max(-1, keepdims=True))
        out[0, :, h] = mm(p, v[0, :, h]).astype(q.dtype) / p.sum(-1, keepdims=True)
    return out


def test_split_product_keeps_the_attention_inside_the_gate():
    """B=1, T=250, 8 heads of 32, causal, the last 20 frames invalid (they
    average the keys they visit): S = q.k^T and P.V through the split
    product within 1e-4 of float64's scale on every row; the float64
    emulation is first held to the port's plain `flash_attention_ref` on
    the rows whose keys it visits alike (the valid ones)."""
    gen = torch.Generator().manual_seed(3)
    valid = torch.arange(250)[None] < 230
    q, k, v = (torch.randn(1, 250, 8, 32, generator=gen) for _ in range(3))
    q = q * 32 ** -0.5
    qn, kn, vn, vn_ok = q.numpy(), k.numpy(), v.numpy(), valid.numpy()
    ref64 = _attention(qn.astype(np.float64), kn.astype(np.float64),
                       vn.astype(np.float64), vn_ok, mm_f64)
    plain = mha_fused.flash_attention_ref(q.double(), k.double(), v.double(), valid,
                                          True).numpy()
    assert _rel(ref64[:, :230], plain[:, :230]) < 1e-12
    x3 = _attention(qn, kn, vn, vn_ok, mm_tf32x3)
    t1 = _attention(qn, kn, vn, vn_ok, mm_tf32)
    err, err_tf32 = _rel(x3, ref64), _rel(t1, ref64)
    assert np.isfinite(x3).all()
    assert err <= GATE, f"split TF32 {err:.3e}, plain TF32 {err_tf32:.3e} of scale"
    assert err < err_tf32, (err, err_tf32)


def mm_grouped(a, b, mm=mm_tf32x3, group=KG_TERMS):
    """a @ b as a kernel sums it: `group` terms of the contraction at a
    time through `mm` (on the tensor cores), each group added to the
    running f32 sum in order."""
    dt = np.float64 if mm is mm_f64 else np.float32
    acc = np.zeros((a.shape[0], b.shape[1]), dt)
    for k0 in range(0, a.shape[1], group):
        acc = acc + mm(a[:, k0:k0 + group], b[k0:k0 + group]).astype(dt)
    return acc


def _ln_affine(x, scale, bias):
    return (_layer_norm(x) * scale + bias).astype(x.dtype)


def _block_emulated(x, valid, w, mm, cluster=8, chunk=128):
    """One causal transformer block on x [T, C] (one batch row) as the
    kernels compute it: q, k, v, o Wo and both FFN products through `mm`
    in KG_TERMS groups; the FFN's intermediate columns cut into `cluster`
    ranges (`chunk` at a time, the chunks' W2 products added in order), the
    ranks' partials summed in rank order, then x1 and b2 added. With
    mm = mm_f64 and float64 inputs it is the block's function."""
    f = x.dtype.type
    H, C, dk = w.qk.shape
    cat = lambda t: t.transpose(1, 0, 2).reshape(C, H * dk)  # noqa: E731
    mmg = lambda a, b: mm_grouped(a, b, mm).astype(x.dtype) if mm is not mm_f64 \
        else mm_f64(a, b)  # noqa: E731
    q = mmg(x, cat(w.qk)) * f(dk ** -0.5)
    k, v = mmg(x, cat(w.kk)), mmg(x, cat(w.vk))
    split = lambda t: t.reshape(1, -1, H, dk)  # noqa: E731
    o = _attention(split(q), split(k), split(v), valid[None], mm)[0].reshape(-1, C)
    x1 = _ln_affine(x + mmg(o, w.ok.reshape(C, C)), w.ln1_s, w.ln1_b)
    F = w.ff1_w.shape[1]
    partials = []
    for r in range(cluster):
        f0, f1 = r * F // cluster, (r + 1) * F // cluster
        z = np.zeros_like(x1)
        for c0 in range(f0, f1, chunk):
            c1 = min(c0 + chunk, f1)
            u = np.maximum(mmg(x1, w.ff1_w[:, c0:c1]) + w.ff1_b[c0:c1], 0)
            z = z + mmg(u, w.ff2_w[c0:c1])
        partials.append(z)
    s = partials[0]
    for z in partials[1:]:
        s = s + z
    return _ln_affine(x1 + s + w.ff2_b, w.ln2_s, w.ln2_b)


def test_split_product_keeps_the_transformer_block_inside_the_gate():
    """mhanet-1.1c's widths (d_model 256, 8 heads of 32, d_ff 1024), B=1,
    T=250 padded to Tp=256 (six zero, invalid rows): the block with the
    row kernels' products (split TF32, 16-term groups) and the cluster's
    partition and rank-order sum within 1e-4 of float64's scale on every
    row, padded rows included; the float64 emulation is first held to the
    port's plain `fused_transformer_block_ref`."""
    gen = torch.Generator().manual_seed(8)
    w = mha_block_fused.random_block_weights(gen, "cpu")
    valid = torch.arange(256)[None] < 250
    x = torch.randn(1, 256, 256, generator=gen) * valid[:, :, None]
    vf = valid[:, None, :].float()
    plain = mha_block_fused.fused_transformer_block_ref(
        x.double(), vf.double(), mha_block_fused.BlockWeights(*(t.double() for t in w)),
        True).numpy()[0]
    wn = mha_block_fused.BlockWeights(*(t.numpy() for t in w))
    w64 = mha_block_fused.BlockWeights(*(t.astype(np.float64) for t in wn))
    xn, vn = x.numpy()[0], valid.numpy()[0]
    ref64 = _block_emulated(xn.astype(np.float64), vn, w64, mm_f64)
    assert _rel(ref64, plain) < 1e-12  # the emulated block is the port's function
    x3 = _block_emulated(xn, vn, wn, mm_tf32x3)
    t1 = _block_emulated(xn, vn, wn, mm_tf32)
    err, err_tf32 = _rel(x3, ref64), _rel(t1, ref64)
    assert np.isfinite(x3).all()
    assert err <= GATE, f"split TF32 {err:.3e}, plain TF32 {err_tf32:.3e} of scale"
    assert err < err_tf32, (err, err_tf32)


def _wgrad_emulated(act, grad, mm, splits=12, stage=64):
    """act^T grad over the N rows as the weight-gradient kernel sums it:
    `splits` fixed row slices, each in stages of `stage` rows taken
    KG_TERMS rows at a time through `mm`, the slices' partials added in
    order."""
    N = act.shape[0]
    dt = np.float64 if mm is mm_f64 else np.float32
    total = np.zeros((act.shape[1], grad.shape[1]), dt)
    for s in range(splits):
        r0, r1 = N * s // splits, N * (s + 1) // splits
        part = np.zeros_like(total)
        for c0 in range(r0, r1, stage):
            for k0 in range(c0, min(c0 + stage, r1), KG_TERMS):
                k1 = min(k0 + KG_TERMS, r1)
                part = part + mm(act[k0:k1].T, grad[k0:k1]).astype(dt)
        total = total + part
    return total


def test_split_product_keeps_the_tcn_backward_products_inside_the_gate():
    """The TCN backward's products at full width (d_model 256, d_f 64, k 3,
    dilation 16) over N = 2048 rows (B=8, T=256), on one block's real
    activations and gradients from the port's plain backward: the input
    gradients da3 = dout W3^T, da2 = sum_j dy(shifted) W2[j]^T, da = du1
    W1^T (16-term groups, taps in turn) and the weight gradients dW1 =
    a^T du1, dW2[j] = a2(shifted)^T dy, dW3 = a3^T dout (12 row splits
    summed in order), each within 2e-4 of its float64 value's scale."""
    gen = torch.Generator().manual_seed(6)
    (bw,) = tcn_fused.random_block_weights(1, gen, "cpu")
    d, k, T = 16, 3, 256
    h = torch.relu(torch.randn(8, T, 256, generator=gen))
    dout = torch.randn(8, T, 256, generator=gen)
    a, u1, a2p, y = tcn_fused_train._block_preacts(h, bw, d, k)
    a3 = tcn_fused.layer_norm(torch.relu(y))
    dy = tcn_fused_train._ln_bwd(dout @ bw.w3[0].T, torch.relu(y)) * (y > 0)
    dyp = torch.nn.functional.pad(dy, (0, 0, 0, (k - 1) * d))
    da2 = sum(dyp[:, (k - 1 - j) * d:(k - 1 - j) * d + T] @ bw.w2[j].T for j in range(k))
    du1 = tcn_fused_train._ln_bwd(da2, torch.relu(u1)) * (u1 > 0)
    rows = lambda t: t.reshape(-1, t.shape[-1]).numpy()  # noqa: E731
    shifted = [rows(a2p[:, j * d:j * d + T]) for j in range(k)]
    ahead = [rows(dyp[:, (k - 1 - j) * d:(k - 1 - j) * d + T]) for j in range(k)]
    w1, w2, w3 = bw.w1[0].numpy(), bw.w2.numpy(), bw.w3[0].numpy()
    products = {
        "da3": lambda mm: mm_grouped(rows(dout), w3.T, mm),
        "da2": lambda mm: sum(mm_grouped(ahead[j], w2[j].T, mm) for j in range(k)),
        "da": lambda mm: mm_grouped(rows(du1), w1.T, mm),
        "dW1": lambda mm: _wgrad_emulated(rows(a), rows(du1), mm),
        "dW3": lambda mm: _wgrad_emulated(rows(a3), rows(dout), mm),
        **{f"dW2[{j}]": (lambda mm, j=j: _wgrad_emulated(shifted[j], rows(dy), mm))
           for j in range(k)},
    }
    for name, fn in products.items():
        ref64 = fn(mm_f64)
        x3, t1 = fn(mm_tf32x3), fn(mm_tf32)
        err, err_tf32 = _rel(x3, ref64), _rel(t1, ref64)
        assert np.isfinite(x3).all()
        assert err <= GRAD_GATE, f"{name}: split TF32 {err:.3e}, plain TF32 {err_tf32:.3e}"
        assert err < err_tf32, (name, err, err_tf32)
