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
