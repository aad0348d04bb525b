"""The port's CUDA kernels against their plain versions, on the card.

The card tests skip themselves without a card; the test of the tie-aware
comparison they use runs on the CPU. This file imports no JAX, so it also
runs where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os
import sys

import pytest
import torch

from deepxi_tpu_torch.models.tcn import (ResNetV2, cyclic_dilation,
                                         init_flax_like)
from deepxi_tpu_torch.ops.kernels import tcn_fused, tcn_fused_train

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import torch_small_widths  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,d_f", [(1, 1, 64), (2, 37, 64), (3, 250, 64), (2, 1250, 64),
                                     (1, 17, 64), (96, 625, 64), (2, 100, 128)])
def test_kernels_match_plain(cuda, B, T, d_f):
    """Both kernels at full width, ragged last tiles included (T = 17 and 37
    under one 64-row tile, 625 = 9 x 64 + 49); at B <= 3 the per-block
    kernel takes 16-row tiles, so the d = 16 conv reaches 32 rows past the
    tile. The halo-tiled kernel runs the route's groups of TILED_GROUP
    blocks with the smallest and the largest halo (dilations 1, 2 and 8,
    16). At d_f 128 the weights are too wide to stage beside the window and
    are read from global memory. The tolerance is chip_smoke.py's (1e-4 of
    the output's scale)."""
    gen = torch.Generator().manual_seed(T)
    w = tcn_fused.random_block_weights(5, gen, cuda, d_f=d_f)
    dil = [cyclic_dilation(i, 16) for i in range(5)]
    x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(cuda)
    G = tcn_fused.TILED_GROUP
    for kernel, ref, ws, ds in (
            (tcn_fused.fused_block_group_whole,
             tcn_fused.fused_block_group_whole_ref, w, dil),
            (tcn_fused.fused_block_group, tcn_fused.fused_block_group_ref,
             w[:G], dil[:G]),
            (tcn_fused.fused_block_group, tcn_fused.fused_block_group_ref,
             w[-G:], dil[-G:])):
        y, y_ref = kernel(x, ws, ds), ref(x, ws, ds)
        torch.cuda.synchronize()
        assert (y - y_ref).abs().max().item() <= 1e-4 * y_ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,tile", [(1, 1, None), (3, 37, None), (4, 250, None),
                                      (5, 130, None), (3, 101, 8), (3, 101, 32),
                                      (7, 75, None)])
@pytest.mark.parametrize("ln_mode", ["slice", "matmul"])
def test_pack2_kernel_matches_plain(cuda, monkeypatch, B, T, tile, ln_mode):
    """The two-rows-per-CTA kernel at full width, odd B (a zero second row)
    and ragged tiles included, both LayerNorm modes, against its plain
    version and, for "slice", against the unpacked kernel: 1e-4 of the
    output's scale. The rows differ, so rows of a pair swapped would fail.
    These shapes take 16-row tiles; `tile` forces the 8-row one (taken
    where 16 does not fit) or the 32-row one (taken from 132 row-pair CTAs
    on, where two windows of 32 rows and the reach fit: four blocks, d <= 8)."""
    if tile is not None:
        monkeypatch.setattr(tcn_fused, "_pack2_tile", lambda *a: tile)
    gen = torch.Generator().manual_seed(T + B)
    G = 4 if tile == 32 else 5
    w = tcn_fused.random_block_weights(G, gen, cuda)
    dil = [cyclic_dilation(i, 16) for i in range(G)]
    x = torch.relu(torch.randn(B, T, 256, generator=gen)).to(cuda)
    y = tcn_fused.fused_block_group_whole_pack2(x, w, dil, ln_mode=ln_mode)
    y_ref = tcn_fused.fused_block_group_whole_pack2_ref(x, w, dil, ln_mode=ln_mode)
    torch.cuda.synchronize()
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert _close(y, y_ref, 1e-4), _rel_err(y, y_ref)
    if ln_mode == "slice":
        assert _close(y, tcn_fused.fused_block_group_whole(x, w, dil), 1e-4)


@pytest.mark.cuda
def test_pack2_counts_launches_refuses_autograd_and_bad_input(cuda):
    w = tcn_fused.random_block_weights(3, torch.Generator().manual_seed(0), cuda)
    dil = [1, 2, 4]
    x = torch.zeros(3, 50, 256, device=cuda)
    fn = tcn_fused.fused_block_group_whole_pack2
    n, n_whole = fn.launches, tcn_fused.fused_block_group_whole.launches
    fn(x, w, dil)
    fn(x, w, dil, ln_mode="matmul")
    assert fn.launches == n + 6
    with pytest.raises(RuntimeError, match="no backward"):
        fn(x.clone().requires_grad_(True), w, dil)
    for bad in ((x.double(), w, dil), (x[:, :, :128].contiguous(), w, dil),
                (x, w, dil[:2]), (x, w, [1, 2, 200])):
        with pytest.raises(ValueError):
            fn(*bad)
    with pytest.raises(ValueError):
        fn(x, w, dil, ln_mode="lanes")
    assert (fn.launches, tcn_fused.fused_block_group_whole.launches) == (n + 6, n_whole)


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_bad_input(cuda):
    w = tcn_fused.random_block_weights(5, torch.Generator().manual_seed(0), cuda)
    dil = [cyclic_dilation(i, 16) for i in range(5)]
    x = torch.zeros(1, 100, 256, device=cuda)
    n_whole, n_tiled = (tcn_fused.fused_block_group_whole.launches,
                        tcn_fused.fused_block_group.launches)
    G = tcn_fused.TILED_GROUP
    tcn_fused.fused_block_group_whole(x, w, dil)
    tcn_fused.fused_block_group(x, w[:G], dil[:G])
    assert tcn_fused.fused_block_group_whole.launches == n_whole + 5
    assert tcn_fused.fused_block_group.launches == n_tiled + 1
    with pytest.raises(ValueError):  # window of 320 + 8 rows > one CTA
        tcn_fused.fused_block_group(x, w[:G], dil[:G], tile_t=320)
    with pytest.raises(ValueError):  # the five blocks' halo of 64 > the tile
        tcn_fused.fused_block_group(x, w, dil)
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
@pytest.mark.parametrize("B,T", [(1, 1), (1, 37), (2, 40), (2, 128), (4, 256),
                                 (8, 256)])
def test_train_kernels_match_plain(cuda, B, T):
    """The saving forward (out and every block input, 1e-4 of scale) and the
    backward in saved and replay mode (dh and every weight gradient, 2e-4 of
    each leaf's scale) at full width, G 10, dilations 1..16. (8, 256) is the
    train step's shape: 12 weight-gradient row splits of 170 or 171 rows,
    whose edges fall inside utterances and 32-row stages. T = 1 is one row;
    at (2, 40) the 16-row tiles' edges fall inside the d = 16 conv's 32-row
    reach, back (the recompute) and forward (the input gradient)."""
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


@pytest.mark.parametrize("d_model,d_f,k", [(32, 16, 3), (48, 12, 2)])
def test_transposed_weights_are_each_blocks_transposes(d_model, d_f, k):
    """The input-gradient kernels' operands, packed for a group on the CPU:
    block g's row of `_transposed` is W1^T, then W2[j]^T for each tap, then
    W3^T."""
    gen = torch.Generator().manual_seed(d_model)
    w = tcn_fused.random_block_weights(3, gen, "cpu", d_model=d_model, d_f=d_f, k=k)
    wt = tcn_fused_train._transposed(w)
    assert wt.shape == (3, 2 * d_model * d_f + k * d_f * d_f)
    for g, bw in enumerate(w):
        w1t, w2t, w3t = torch.split(wt[g], [d_f * d_model, k * d_f * d_f, d_model * d_f])
        assert torch.equal(w1t.view(d_f, d_model), bw.w1[0].T)
        assert torch.equal(w2t.view(k, d_f, d_f), bw.w2.transpose(1, 2))
        assert torch.equal(w3t.view(d_model, d_f), bw.w3[0].T)


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
    # three launches a block, and the replayed forward's one a block
    assert tcn_fused_train.fused_block_group_bwd.launches == \
        n[1] + 3 * 10 + (0 if save_acts else 10)
    for name, a, b in zip(params, g_fused, g_plain):
        assert _close(a, b, 2e-4), (name, _rel_err(a, b))


# -- the spectral kernels -------------------------------------------------------

SPECTRAL_SHAPES = [(256, 512), (128, 256), (200, 512), (768, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("N_s,K", SPECTRAL_SHAPES)
@pytest.mark.parametrize("B,T,F", [(1, 1, None), (2, 63, None), (3, 130, 3), (1, 250, None),
                                   (3, 1001, None)])
def test_spectral_kernels_match_plain(cuda, monkeypatch, N_s, K, B, T, F):
    """stft_mag_fused and enhance_frames_fused at each (N_s, K) of the
    tests on the CPU (the main path's 512, where 257 bins and 514 spectrum
    columns are no multiple of 4; N_d < K with N_s = 200), against their
    plain versions on every row: 1e-4 of the output's scale. T = 1, and T
    off every run of frames a CTA takes: the small shapes take one frame a
    CTA, (3, 1001) its 1024 points (4 frames at K = 512, 8 at 256), and
    F = 3 is forced once (2 at K = 2048: a CTA's buffers hold 2048 points)."""
    from deepxi_tpu_torch.ops.kernels import spectral
    if F is not None:
        monkeypatch.setattr(spectral, "_frames_per_cta",
                            lambda ctas, K, device: min(F, 2048 // (K // 2)))
    N_d, nb = 2 * N_s, K // 2 + 1
    gen = torch.Generator().manual_seed(T + K)
    x2d = torch.randn(B, T + 1, N_s, generator=gen).to(cuda)
    Y = torch.randn(B, T, 2 * nb, generator=gen).to(cuda)
    G = torch.rand(B, T, nb, generator=gen).to(cuda)
    for y, y_ref in ((spectral.stft_mag_fused(x2d, N_d, K),
                      spectral.stft_mag_fused_ref(x2d, N_d, K)),
                     (spectral.enhance_frames_fused(Y, G, N_d, N_s, K),
                      spectral.enhance_frames_fused_ref(Y, G, N_d, N_s, K))):
        torch.cuda.synchronize()
        assert y.shape == y_ref.shape and torch.isfinite(y).all()
        rows = (y - y_ref).abs().amax(-1) / y_ref.abs().amax(-1)
        assert rows.max().item() <= 1e-4, rows.max().item()


@pytest.mark.cuda
def test_spectral_wrappers_count_launches_and_refuse_bad_input(cuda):
    from deepxi_tpu_torch.ops.kernels import spectral
    x2d = torch.randn(2, 9, 256, device=cuda)
    Y, G = torch.randn(2, 8, 514, device=cuda), torch.rand(2, 8, 257, device=cuda)
    fns = (spectral.stft_mag_fused, spectral.enhance_frames_fused)
    n = [f.launches for f in fns]
    fns[0](x2d, 512, 512)
    fns[1](Y, G, 512, 256, 512)
    fns[0](torch.randn(2, 9, 200, device=cuda), 400, 512)  # N_d < K, 32 ∤ N_s
    fns[1](Y, G, 400, 200, 512)
    assert [f.launches for f in fns] == [c + 2 for c in n]
    with pytest.raises(RuntimeError, match="no backward"):
        fns[0](x2d.clone().requires_grad_(True), 512, 512)
    with pytest.raises(RuntimeError, match="no backward"):
        fns[1](Y, G.clone().requires_grad_(True), 512, 256, 512)
    for call in (lambda: fns[0](x2d, 400, 512),                      # N_d != 2 N_s
                 lambda: fns[0](x2d[:, :, :128].contiguous(), 512, 512),
                 lambda: fns[0](x2d[:, :, 8:], 512, 512),             # not contiguous
                 lambda: fns[0](torch.randn(2, 9, 80, device=cuda), 160, 160),  # K not 2^n
                 lambda: fns[0](x2d, 512, 256),                       # K < N_d
                 lambda: fns[1](Y, G, 512, 200, 512),
                 lambda: fns[1](Y[..., :500].contiguous(), G, 512, 256, 512),
                 lambda: fns[1](Y, G[:, :7].contiguous(), 512, 256, 512)):
        with pytest.raises(ValueError):
            call()
    assert [f.launches for f in fns] == [c + 2 for c in n]


@pytest.mark.cuda
def test_xi_estimator_launches_stft_kernel(cuda):
    """make_xi_estimator on the card takes |X| from one stft_mag_fused
    launch a call and gives the plain route's estimate."""
    from deepxi_tpu_torch.enhance import make_xi_estimator
    from deepxi_tpu_torch.inp_tgt import MagXi
    from deepxi_tpu_torch.ops.kernels import spectral
    from deepxi_tpu_torch.ops.maps import NormalCDF
    from deepxi_tpu_torch.sig.stft import hop_rows
    gen = torch.Generator().manual_seed(6)
    net = init_flax_like(ResNetV2(257, 257, n_blocks=3, d_model=32, d_f=16), gen).to(cuda)
    params = {k: v.detach() for k, v in net.state_dict().items()}
    it = MagXi(xi_map=NormalCDF(use_db=True, mu=torch.zeros(257, device=cuda),
                                sigma=torch.full((257,), 10.0, device=cuda)))
    x = (torch.randn(2, 5000, generator=gen) * 3000).to(torch.int16)
    n = spectral.stft_mag_fused.launches
    xi = make_xi_estimator(it, net, device=cuda)(params, x)
    assert spectral.stft_mag_fused.launches == n + 1
    with torch.no_grad():
        mag = spectral.stft_mag_fused_ref(hop_rows(x.to(cuda) / 32768.0, 256), 512, 512)
        tgt = net(mag)
    keep = (tgt >= 1e-3) & (tgt <= 1 - 1e-3)  # away from the map's ends
    err_db = (10 * torch.log10(xi / it.xi_hat(tgt)))[keep].abs().max().item()
    assert xi.shape == (2, 20, 257) and torch.isfinite(xi).all()
    assert keep.float().mean().item() > 0.5 and err_db <= 1e-2, err_db


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
                                         (1, 700, [650]), (1, 1, [1]), (1, 17, [17]),
                                         (2, 17, [0, 0]), (2, 250, [250, 83]),
                                         (2, 2250, [2250, 750])])
def test_attention_kernels_match_plain(cuda, B, T, lengths):
    """flash_attention and flash_attention_streaming (JAX tiles 256/512,
    64/128 and small 32/16 tiles, causal and not) against their plain
    versions on every row, padded rows included: 1e-4 of the output's
    scale. T = 1 and 17 fill part of one 16-row slab; lengths [0, 0] leave
    every row invalid; the short sequences split a slab's keys over a CTA's
    warps, T = 2250 at B = 2 does not."""
    from deepxi_tpu_torch.ops.kernels import mha_flash_stream, mha_fused
    gen = torch.Generator().manual_seed(T)
    q, k, v, valid = _heads(B, T, lengths, gen, cuda)
    if not any(lengths):  # invalid rows that still hold values: their means
        q, k, v = (torch.randn(q.shape, generator=gen).to(cuda) for _ in range(3))
    for causal in (True, False):
        cases = [(mha_fused.flash_attention, mha_fused.flash_attention_ref, {})]
        for bq, bk in ((256, 512), (64, 128), (32, 16)):
            cases.append((mha_flash_stream.flash_attention_streaming,
                          mha_flash_stream.flash_attention_streaming_ref,
                          {"block_q": bq, "block_k": bk}))
        for kernel, ref, kw in cases:
            y, y_ref = kernel(q, k, v, valid, causal, **kw), ref(q, k, v, valid, causal, **kw)
            torch.cuda.synchronize()
            assert _close(y, y_ref, 1e-4), (kernel.__name__, causal, kw, _rel_err(y, y_ref))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,lengths", [(2, 100, [100, 61]), (3, 256, [250, 256, 130]),
                                         (1, 1, [1]), (2, 17, [17, 0]), (1, 17, [17]),
                                         (1, 250, [250]), (1, 256, [250]),
                                         (3, 37, [37, 20, 5]), (2, 17, [0, 0]),
                                         (36, 256, [256] * 18 + [200] * 18)])
def test_transformer_block_kernel_matches_plain(cuda, B, T, lengths):
    """fused_transformer_block at full width (d_model 256, 8 heads, d_ff
    1024) on a hidden state whose padded rows are invalid, causal and not,
    every row compared: 1e-4 of the output's scale. The row kernels take
    16-row slabs (a cluster of 8 CTAs each after the attention) while the
    rows are few: T = 1 and 17 fill part of one slab, B=3 T=37 leaves 111
    rows (no multiple of the slab), lengths [0, 0] leave every row invalid;
    B=36 T=256 (9,216 rows) takes the many-row shapes, 64-row CTAs without
    clusters."""
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
def test_transformer_block_kernel_is_deterministic_and_ignores_allow_tf32(cuda, monkeypatch):
    """Two calls give bitwise equal outputs (the cluster sums the FFN's
    partials in rank order, no atomics); with
    torch.backends.cuda.matmul.allow_tf32 pinned False the reference runs in
    full f32 and the kernel, whose products are its own split-TF32 ones,
    stays within 1e-4 of it."""
    from deepxi_tpu_torch.ops.kernels import mha_block_fused as mb
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator().manual_seed(4)
    w = mb.random_block_weights(gen, cuda)
    x = torch.randn(1, 256, 256, generator=gen).to(cuda)
    vf = (torch.arange(256) < 250).float()[None, None].to(cuda)
    y = [mb.fused_transformer_block(x, vf, w, True) for _ in range(2)]
    y_ref = mb.fused_transformer_block_ref(x, vf, w, True)
    torch.cuda.synchronize()
    assert torch.equal(y[0], y[1])
    assert _close(y[0], y_ref, 1e-4), _rel_err(y[0], y_ref)


@pytest.mark.cuda
def test_transformer_block_launch_shapes(cuda):
    """B=1 T=256 spreads both row kernels over more than 8 CTAs (16-row
    slabs; the post kernel a cluster a slab); B=64 T=640 takes the
    many-row shapes."""
    from deepxi_tpu_torch.ops.kernels import mha_block_fused as mb
    few, many = mb.block_grid(1, 256), mb.block_grid(64, 640)
    assert few["qkv_ctas"] > 8 and few["post_ctas"] > 8, few
    assert few["qkv_rows"] == 16 and few["post_rows"] == 16 and few["post_cluster"] > 1
    assert many["post_cluster"] == 1 and many["post_rows"] > 16, many


@pytest.mark.cuda
@pytest.mark.parametrize("n_heads,head_dim,d_ff", [(1, 4, 4), (5, 4, 40), (16, 64, 1024)])
def test_transformer_block_kernel_at_domain_edges(cuda, n_heads, head_dim, d_ff):
    """Widths at the edges of `kernel_takes`: one head of 4 (C = 4), C = 20
    (no multiple of the m16n8k8 tile's 8), and 1024 columns; few rows and
    many. 1e-4 of the output's scale."""
    from deepxi_tpu_torch.ops.kernels import mha_block_fused as mb
    gen = torch.Generator().manual_seed(n_heads)
    C = n_heads * head_dim
    w = mb.random_block_weights(gen, cuda, d_model=C, n_heads=n_heads, d_ff=d_ff)
    for B, T, lengths in ((2, 40, [40, 23]), (40, 128, [128] * 40)):
        x = torch.randn(B, T, C, generator=gen).to(cuda)
        vf = (torch.arange(T)[None] < torch.as_tensor(lengths)[:, None]).float()
        vf = vf[:, None, :].to(cuda)
        y, y_ref = mb.fused_transformer_block(x, vf, w, True), mb.fused_transformer_block_ref(
            x, vf, w, True)
        torch.cuda.synchronize()
        assert _close(y, y_ref, 1e-4), (B, T, _rel_err(y, y_ref))


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
    with pytest.raises(ValueError):  # a head width no kernel takes
        fns[0](q.detach()[..., :6].contiguous(), k[..., :6].contiguous(),
               v[..., :6].contiguous(), valid, True)
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
    for bad in ((q[..., :6].contiguous(), kc[..., :6].contiguous(), vc[..., :6].contiguous(), 5),
                (q[:, :4].contiguous(), kc, vc, 5),
                (q, kc, vc.to(torch.bfloat16), 5), (q, kc.half(), vc.half(), 5),
                (q, kc, vc, -1)):
        with pytest.raises(ValueError):
            fn(*bad)
    assert fn.launches == n + 1


@pytest.mark.cuda
def test_kernels_match_plain_at_small_widths(cuda):
    """Every kernel built for widths other than the flagship's (TCN 32/16/3
    and 48/12/2, MHANet 4 heads of 8 and 12 heads of 4) against its plain
    version: 1e-4 of the output's scale, the backward 2e-4 of each leaf's
    (tools/torch_small_widths.py, as chip_smoke.py phase 3f)."""
    errs = torch_small_widths.kernel_checks(cuda)
    torch.cuda.synchronize()
    for name, err in errs.items():
        tol = (torch_small_widths.BWD_TOL_REL if "bwd" in name
               else torch_small_widths.TOL_REL)
        assert err <= tol, (name, err)


@pytest.mark.cuda
def test_non_flagship_widths_run_the_kernels_on_the_card(cuda, tmp_path):
    """C1: at d_model 32 every route launches the kernels built for those
    widths, and the card's results match the CPU's: 1e-4 of each output's
    scale (f32 sums in other orders; the wavs within an int16 step)."""
    n = torch_small_widths.kernel_counts()
    got = torch_small_widths.small_widths_run(cuda, str(tmp_path))
    torch.cuda.synchronize()
    counts = torch_small_widths.kernel_counts()
    for name in torch_small_widths.ROUTE_KERNELS:
        assert counts[name] > n[name], name
    ref = torch_small_widths.small_widths_run("cpu", str(tmp_path))
    rel, worst, wav = torch_small_widths.compare_runs(got, ref)
    assert rel <= 1e-4 and wav <= 1.0, (rel, worst, wav)


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
