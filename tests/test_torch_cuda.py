"""The port's CUDA kernels against their plain versions, on the card.

The card tests skip themselves without a card; the test of the tie-aware
comparison they use runs on the CPU. This file imports no JAX, so it also
runs where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from deepxi_tpu_torch.models.tcn import (ResNetV2, cyclic_dilation,
                                         init_flax_like)
from deepxi_tpu_torch.ops.kernels import tcn_fused, tcn_fused_train


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1, 1), (2, 37), (3, 250), (2, 1250)])
def test_kernels_match_plain(cuda, B, T):
    """Both kernels at full width, ragged last tiles included; the tolerance
    is chip_smoke.py's (1e-4 of the output's scale)."""
    gen = torch.Generator().manual_seed(T)
    w = tcn_fused.random_block_weights(5, gen, cuda)
    dil = [cyclic_dilation(i, 16) for i in range(5)]
    x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(cuda)
    for kernel, ref, kw in (
            (tcn_fused.fused_block_group_whole,
             tcn_fused.fused_block_group_whole_ref, {}),
            (tcn_fused.fused_block_group, tcn_fused.fused_block_group_ref,
             {"tile_t": tcn_fused.TILED_TILE_T})):
        y, y_ref = kernel(x, w, dil, **kw), ref(x, w, dil, **kw)
        torch.cuda.synchronize()
        assert (y - y_ref).abs().max().item() <= 1e-4 * y_ref.abs().max().item()


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_bad_input(cuda):
    w = tcn_fused.random_block_weights(5, torch.Generator().manual_seed(0), cuda)
    dil = [cyclic_dilation(i, 16) for i in range(5)]
    x = torch.zeros(1, 100, 256, device=cuda)
    n_whole, n_tiled = (tcn_fused.fused_block_group_whole.launches,
                        tcn_fused.fused_block_group.launches)
    tcn_fused.fused_block_group_whole(x, w, dil)
    tcn_fused.fused_block_group(x, w, dil)
    assert tcn_fused.fused_block_group_whole.launches == n_whole + 5
    assert tcn_fused.fused_block_group.launches == n_tiled + 1
    with pytest.raises(ValueError):  # window of 320 + 64 rows > one CTA
        tcn_fused.fused_block_group(x, w, dil, tile_t=320)
    with pytest.raises(ValueError):
        tcn_fused.fused_block_group_whole(x.double(), w, dil)
    with pytest.raises(ValueError):
        tcn_fused.fused_block_group_whole(x[:, :, :128].contiguous(), w, dil)


def _rel_err(a, ref):
    """max |a - ref| over ref's max abs."""
    return (a - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


def _close(a, ref, rel):
    """max |a - ref| within rel of ref's max abs (chip_smoke.py's limits)."""
    return _rel_err(a, ref) <= rel


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1, 37), (2, 128), (4, 256), (8, 256)])
def test_train_kernels_match_plain(cuda, B, T):
    """The saving forward (out and every block input, 1e-4 of scale) and the
    backward in saved and replay mode (dh and every weight gradient, 2e-4 of
    each leaf's scale) at full width, G 10, dilations 1..16. (8, 256) is the
    train step's shape: 12 weight-gradient row splits of 170 or 171 rows,
    whose edges fall inside utterances and 32-row chunks."""
    gen = torch.Generator().manual_seed(T)
    G = 10
    w = tcn_fused.random_block_weights(G, gen, cuda)
    dil = [cyclic_dilation(i, 16) for i in range(G)]
    x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(cuda)
    dout = (torch.randn(B, T, 256, generator=gen) * 1e-3).to(cuda)
    out, hs = tcn_fused_train.fused_block_group_whole_saved(x, w, dil)
    out_r, hs_r = tcn_fused_train.fused_block_group_whole_saved_ref(x, w, dil)
    torch.cuda.synchronize()
    assert hs.shape == (B, G, T, 256)
    assert _close(out, out_r, 1e-4), _rel_err(out, out_r)
    assert _close(hs, hs_r, 1e-4), _rel_err(hs, hs_r)
    # the plain backward takes the kernel's block inputs (see chip_smoke.py:
    # the plain forward's differ by rounding, which can flip a ReLU at 0),
    # and a ReLU input within 1e-5 of 0 inside a block takes the kernel's
    # side (at (8, 256) one u1 lies 1.3e-7 from 0)
    for saved in (hs, None):
        dh, dw = tcn_fused_train.fused_block_group_bwd(x, dout, w, dil,
                                                       saved_h=saved)
        torch.cuda.synchronize()
        (dh_r, dw_r), _, flips = tcn_fused_train.bwd_ref_up_to_ties(
            (dh, dw), x, dout, w, dil, hs, 2e-4)
        assert len(flips) <= 2, flips
        assert _close(dh, dh_r, 2e-4), (_rel_err(dh, dh_r), flips)
        for g in range(G):
            for leaf, ref in zip(dw[g], dw_r[g]):
                assert leaf.shape == ref.shape
                assert _close(leaf, ref, 2e-4), (g, _rel_err(leaf, ref), flips)


def test_tie_check_takes_the_kernels_side_and_no_more():
    """`bwd_ref_up_to_ties` explains a backward that took the other side of
    a ReLU input within 1e-5 of 0, and does not explain a wrong gradient."""
    gen = torch.Generator().manual_seed(3)
    dil = [1, 2]
    w = tcn_fused.random_block_weights(2, gen, "cpu", d_model=32, d_f=16)
    x = torch.relu(torch.randn(2, 16, 32, generator=gen))
    dout = torch.randn(2, 16, 32, generator=gen)
    _, hs = tcn_fused_train.fused_block_group_whole_saved_ref(x, w, dil)
    # put block 1's u1 at (1, 9, 3) 1e-7 from 0 through its bias
    _, u1, _, _ = tcn_fused_train._block_preacts(hs[:, 1], w[1], dil[1], 3)
    w[1].b1[3] -= u1[1, 9, 3] - 1e-7
    tie = (1, "u1", (1, 9, 3))
    assert tie in tcn_fused_train.relu_ties(hs, w, dil)
    plain = tcn_fused_train.fused_block_group_bwd_ref(x, dout, w, dil, saved_h=hs)
    got = tcn_fused_train.fused_block_group_bwd_ref(x, dout, w, dil, saved_h=hs,
                                                    flips=[tie])
    assert tcn_fused_train._worst_rel(got, plain) > 1e-3
    _, err, flips = tcn_fused_train.bwd_ref_up_to_ties(got, x, dout, w, dil, hs, 2e-4)
    assert flips == [tie] and err == 0.0
    wrong = (got[0], [type(bw)(*(t.clone() for t in bw)) for bw in got[1]])
    wrong[1][0].w2[1, 2, 3] += 1e-2 * wrong[1][0].w2.abs().max()
    _, err, _ = tcn_fused_train.bwd_ref_up_to_ties(wrong, x, dout, w, dil, hs, 2e-4)
    assert err > 2e-4


@pytest.mark.cuda
def test_weight_gradients_are_deterministic(cuda):
    """Two calls give bitwise equal gradients: the splits of the batch rows
    are summed in a fixed order, with no atomics."""
    gen = torch.Generator().manual_seed(1)
    w = tcn_fused.random_block_weights(10, gen, cuda)
    dil = [cyclic_dilation(i, 16) for i in range(10)]
    x = torch.relu(torch.randn(8, 256, 256, generator=gen)).to(cuda)
    dout = torch.randn(8, 256, 256, generator=gen).to(cuda)
    _, hs = tcn_fused_train.fused_block_group_whole_saved(x, w, dil)
    runs = [tcn_fused_train.fused_block_group_bwd(x, dout, w, dil, saved_h=hs)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    for g in range(10):
        for a, b in zip(runs[0][1][g], runs[1][1][g]):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("save_acts", [True, False])
def test_apply_fused_train_matches_plain_autograd(cuda, save_acts):
    """Gradients of the fused stack against autograd of the plain ResNetV2,
    10 blocks at full width, groups of 4 (a ragged last group); the seeded
    flax-style initialisation with biases shifted off zero. Few frames: the
    more pre-activations, the likelier one lies within f32 rounding of 0,
    where the two forwards can take opposite sides of a ReLU (at B=2, T=200
    both f32 versions then differ from float64 by 4e-2)."""
    gen = torch.Generator().manual_seed(2)
    net = init_flax_like(ResNetV2(257, 257, n_blocks=10), gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 1:
                p.add_(0.05)
    net.to(cuda)
    x = torch.rand(2, 64, 257, generator=gen).to(cuda)
    tgt = torch.rand(2, 64, 257, generator=gen).to(cuda)
    params = dict(net.named_parameters())
    n = [tcn_fused_train.fused_block_group_whole_saved.launches,
         tcn_fused_train.fused_block_group_bwd.launches]
    pred = tcn_fused_train.resnetv2_apply_fused_train(
        params, x, n_blocks=10, group=4, save_acts=save_acts)
    g_fused = torch.autograd.grad(torch.square(pred - tgt).mean(), list(params.values()))
    g_plain = torch.autograd.grad(torch.square(net(x) - tgt).mean(),
                                  list(params.values()))
    torch.cuda.synchronize()
    assert n[0] + (10 if save_acts else 0) == \
        tcn_fused_train.fused_block_group_whole_saved.launches
    assert tcn_fused_train.fused_block_group_bwd.launches > n[1]
    for name, a, b in zip(params, g_fused, g_plain):
        assert _close(a, b, 2e-4), (name, _rel_err(a, b))


# -- the MHANet kernels ---------------------------------------------------------

def _heads(B, T, lengths, gen, device):
    """q (scaled), k, v [B, T, 8, 32] and valid [B, T] with padded tails of
    zero frames (rows at or past each length invalid and zero)."""
    valid = torch.arange(T)[None, :] < torch.as_tensor(lengths)[:, None]
    q, k, v = (torch.randn(B, T, 8, 32, generator=gen) * valid[:, :, None, None]
               for _ in range(3))
    return [t.to(device) for t in (q * 32 ** -0.5, k, v, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,lengths", [(2, 37, [37, 20]), (3, 250, [250, 190, 64]),
                                         (1, 700, [650])])
def test_attention_kernels_match_plain(cuda, B, T, lengths):
    """flash_attention and flash_attention_streaming (JAX tiles 256/512 and
    small 32/16 tiles, causal and not) against their plain versions on
    every row, padded rows included: 1e-4 of the output's scale."""
    from deepxi_tpu_torch.ops.kernels import mha_flash_stream, mha_fused
    q, k, v, valid = _heads(B, T, lengths, torch.Generator().manual_seed(T), cuda)
    for causal in (True, False):
        cases = [(mha_fused.flash_attention, mha_fused.flash_attention_ref, {})]
        for bq, bk in ((256, 512), (32, 16)):
            cases.append((mha_flash_stream.flash_attention_streaming,
                          mha_flash_stream.flash_attention_streaming_ref,
                          {"block_q": bq, "block_k": bk}))
        for kernel, ref, kw in cases:
            y, y_ref = kernel(q, k, v, valid, causal, **kw), ref(q, k, v, valid, causal, **kw)
            torch.cuda.synchronize()
            assert _close(y, y_ref, 1e-4), (kernel.__name__, causal, kw, _rel_err(y, y_ref))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,lengths", [(2, 100, [100, 61]), (3, 256, [250, 256, 130])])
def test_transformer_block_kernel_matches_plain(cuda, B, T, lengths):
    """fused_transformer_block at full width (d_model 256, 8 heads, d_ff
    1024) on a hidden state whose padded rows are invalid, causal and not;
    T = 100 leaves a ragged 32-row tile. 1e-4 of the output's scale."""
    from deepxi_tpu_torch.ops.kernels import mha_block_fused as mb
    gen = torch.Generator().manual_seed(T)
    w = mb.random_block_weights(gen, cuda)
    x = torch.randn(B, T, 256, generator=gen).to(cuda)
    vf = (torch.arange(T)[None, :] < torch.as_tensor(lengths)[:, None]).float()
    vf = vf[:, None, :].to(cuda)
    for causal in (True, False):
        y, y_ref = (mb.fused_transformer_block(x, vf, w, causal),
                    mb.fused_transformer_block_ref(x, vf, w, causal))
        torch.cuda.synchronize()
        assert torch.isfinite(y).all()
        assert _close(y, y_ref, 1e-4), (causal, _rel_err(y, y_ref))


@pytest.mark.cuda
def test_mha_wrappers_count_launches_and_refuse_autograd(cuda):
    from deepxi_tpu_torch.ops.kernels import (mha_block_fused, mha_flash_stream,
                                              mha_fused)
    gen = torch.Generator().manual_seed(0)
    q, k, v, valid = _heads(1, 64, [50], gen, cuda)
    w = mha_block_fused.random_block_weights(gen, cuda)
    x = torch.randn(1, 64, 256, generator=gen).to(cuda)
    vf = valid[:, None, :].float()
    fns = (mha_fused.flash_attention, mha_flash_stream.flash_attention_streaming,
           mha_block_fused.fused_transformer_block)
    n = [f.launches for f in fns]
    fns[0](q, k, v, valid, True)
    fns[1](q, k, v, valid, True)
    fns[2](x, vf, w, True)
    assert [f.launches for f in fns] == [c + 1 for c in n]
    q.requires_grad_(True)
    x.requires_grad_(True)
    for call in (lambda: fns[0](q, k, v, valid, True),
                 lambda: fns[1](q, k, v, valid, True),
                 lambda: fns[2](x, vf, w, True)):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    with pytest.raises(ValueError):
        fns[0](q.detach()[..., :16].contiguous(), k[..., :16].contiguous(),
               v[..., :16].contiguous(), valid, True)
    with pytest.raises(ValueError):
        fns[2](x.detach()[:, :, :128].contiguous(), vf, w, True)
    assert [f.launches for f in fns] == [c + 1 for c in n]


# -- the KV-cache attention step of streaming MHANet ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_step_kernel_matches_plain(cuda, B, dtype):
    """mha_cache_step at full width (8 heads of 32, L = 2048) against its
    plain version, every cache row nonzero so only the mask removes the
    unwritten ones; t at 0, in the middle, L - 1 and past the cap; 1e-4 of
    the output's scale."""
    from deepxi_tpu_torch.ops.kernels import mha_cache
    gen = torch.Generator().manual_seed(B)
    q = (torch.randn(B, 8, 32, generator=gen) * 32 ** -0.5).to(cuda)
    kc, vc = (torch.randn(B, 2048, 8, 32, generator=gen).to(cuda, dtype) for _ in range(2))
    for t in (0, 700, 2047, 2500):
        y, y_ref = (mha_cache.mha_cache_step(q, kc, vc, t),
                    mha_cache.mha_cache_step_ref(q, kc, vc, t))
        torch.cuda.synchronize()
        assert torch.isfinite(y).all()
        assert _close(y, y_ref, 1e-4), (t, _rel_err(y, y_ref))


@pytest.mark.cuda
def test_cache_step_counts_launches_and_refuses_autograd(cuda):
    from deepxi_tpu_torch.ops.kernels import mha_cache
    fn = mha_cache.mha_cache_step
    q = torch.randn(2, 8, 32, device=cuda)
    kc, vc = torch.randn(2, 64, 8, 32, device=cuda), torch.randn(2, 64, 8, 32, device=cuda)
    n = fn.launches
    fn(q, kc, vc, 5)
    assert fn.launches == n + 1
    with pytest.raises(RuntimeError, match="no backward"):
        fn(q.clone().requires_grad_(True), kc, vc, 5)
    for bad in ((q[:, :4].contiguous(), kc[:, :, :4].contiguous(), vc[:, :, :4].contiguous(), 5),
                (q, kc, vc.to(torch.bfloat16), 5), (q, kc.half(), vc.half(), 5),
                (q, kc, vc, -1)):
        with pytest.raises(ValueError):
            fn(*bad)
    assert fn.launches == n + 1


@pytest.mark.cuda
def test_streaming_mhanet_fused_launches_the_kernel(cuda):
    """fused=True runs each block's cache attention through the kernel (one
    launch a block and hop) and gives the einsum route's waveform."""
    from deepxi_tpu_torch.inp_tgt import MagXi
    from deepxi_tpu_torch.models.attention import MHANetV3
    from deepxi_tpu_torch.ops.kernels import mha_cache
    from deepxi_tpu_torch.ops.maps import NormalCDF
    from deepxi_tpu_torch.streaming import StreamingMHANet
    gen = torch.Generator().manual_seed(4)
    net = MHANetV3(257, 257, n_blocks=2)
    params = {k: torch.randn(v.shape, generator=gen) * 0.05 + (k.endswith(".scale"))
              for k, v in net.state_dict().items()}
    it = MagXi(xi_map=NormalCDF(use_db=True, mu=torch.zeros(257), sigma=torch.full((257,), 10.0)))
    x = (torch.randn(2, 256 * 6, generator=gen) * 3000).to(torch.int16)
    n = mha_cache.mha_cache_step.launches
    y = StreamingMHANet(it, net, params, fused=True, device=cuda).stream(x)
    assert mha_cache.mha_cache_step.launches == n + 2 * 6
    y_ref = StreamingMHANet(it, net, params, device=cuda).stream(x)
    torch.cuda.synchronize()
    assert y.shape == (2, 256 * 6) and torch.isfinite(y).all()
    assert (y - y_ref).abs().max().item() <= 1e-4
