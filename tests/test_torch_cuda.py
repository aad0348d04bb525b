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
                                         init_flax_like, layer_norm)
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

    def ties():
        """The blocks' ReLU inputs within TIE_TOL of 0, from the block inputs
        of the plain saving forward (no launch)."""
        with torch.no_grad():
            h0 = torch.relu(layer_norm(x @ params["ff_conv.kernel"][0]
                                       + params["ff_conv.bias"]) * params["ff_ln.scale"])
            w = [tcn_fused.block_weights(params, i) for i in range(10)]
            dil = [cyclic_dilation(i, 16) for i in range(10)]
            _, hs = tcn_fused_train.fused_block_group_whole_saved_ref(h0, w, dil)
            return tcn_fused_train.relu_ties(hs, w, dil)
    for name, a, b in zip(params, g_fused, g_plain):
        assert _close(a, b, 2e-4), (name, _rel_err(a, b), "ReLU ties:", ties())


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


@pytest.mark.cuda
@pytest.mark.parametrize("T", [32, 96, 250, 640, 1280])
def test_spectral_kernels_at_per_utterance_shapes(cuda, T):
    """The per-utterance route of `DeepXiTorch.infer` launches each spectral
    kernel at B=1 on one utterance's frames (bucketed to 32-frame multiples
    for |X|, cut to its own count for the synthesis): every row within 1e-4
    of the output's scale of the plain version."""
    from deepxi_tpu_torch.ops.kernels import spectral
    gen = torch.Generator().manual_seed(T)
    x2d = torch.randn(1, T + 1, 256, generator=gen).to(cuda)
    Y = torch.randn(1, T, 514, generator=gen).to(cuda)
    G = torch.rand(1, T, 257, generator=gen).to(cuda)
    for y, y_ref in ((spectral.stft_mag_fused(x2d, 512, 512),
                      spectral.stft_mag_fused_ref(x2d, 512, 512)),
                     (spectral.enhance_frames_fused(Y, G, 512, 256, 512),
                      spectral.enhance_frames_fused_ref(Y, G, 512, 256, 512))):
        torch.cuda.synchronize()
        assert y.shape == y_ref.shape and torch.isfinite(y).all()
        rows = (y - y_ref).abs().amax(-1) / y_ref.abs().amax(-1)
        assert rows.max().item() <= 1e-4, rows.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("gain", ["d_hat", "mmse-stsa"])
def test_gain_synthesiser_launches_the_synthesis_kernel(cuda, gain):
    """make_gain_synthesiser on the card: one enhance_frames_fused launch a
    call, and the waveform of the polar synthesis of the gained magnitude
    with the noisy phase (the noise estimate for "d_hat"), on the card."""
    from deepxi_tpu_torch.enhance import make_gain_synthesiser, noise_gain
    from deepxi_tpu_torch.inp_tgt import MagXi
    from deepxi_tpu_torch.ops.gains import gfunc
    from deepxi_tpu_torch.ops.kernels import spectral
    from deepxi_tpu_torch.ops.maps import NormalCDF
    gen = torch.Generator().manual_seed(7)
    net = init_flax_like(ResNetV2(257, 257, n_blocks=3, d_model=32, d_f=16), gen).to(cuda)
    params = {k: v.detach() for k, v in net.state_dict().items()}
    it = MagXi(xi_map=NormalCDF(use_db=True, mu=torch.zeros(257, device=cuda),
                                sigma=torch.full((257,), 10.0, device=cuda)))
    fn = noise_gain if gain == "d_hat" else (lambda xi: gfunc(xi, xi + 1.0, gain))
    x = torch.zeros(1, 8192, dtype=torch.int16)
    x[0, :7000] = (torch.randn(7000, generator=gen) * 3000).to(torch.int16)
    n = spectral.enhance_frames_fused.launches
    y = make_gain_synthesiser(it, net, fn, device=cuda)(params, x, 28)
    assert spectral.enhance_frames_fused.launches == n + 1
    with torch.no_grad():
        mag, pha = it.observation(x.to(cuda))
        G = fn(it.xi_hat(net(mag)))[:, :28]
        y_ref = it.polar_synthesis(mag[:, :28] * G, pha[:, :28])
    assert y.shape == y_ref.shape == (1, 29 * 256) and torch.isfinite(y).all()
    assert (y - y_ref).abs().max().item() <= 1e-4 * y_ref.abs().max().item()


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

CACHE_CLOCKS = (0, 31, 32, 700, 2047, 2500)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_step_kernel_matches_plain(cuda, B, dtype):
    """mha_cache_step at full width (8 heads of 32, L = 2048) against its
    plain version, every cache row nonzero so only the mask removes the
    unwritten ones; t at 0, a chunk's last and next key, in the middle,
    L - 1 and past the cap, as an int and as a device int32 tensor; 1e-4 of
    the output's scale; a second call bitwise the same."""
    from deepxi_tpu_torch.ops.kernels import mha_cache
    gen = torch.Generator().manual_seed(B)
    q = (torch.randn(B, 8, 32, generator=gen) * 32 ** -0.5).to(cuda)
    kc, vc = (torch.randn(B, 2048, 8, 32, generator=gen).to(cuda, dtype) for _ in range(2))
    for t in CACHE_CLOCKS:
        y_ref = mha_cache.mha_cache_step_ref(q, kc, vc, t)
        for clock in (t, torch.tensor(t, dtype=torch.int32, device=cuda)):
            y = mha_cache.mha_cache_step(q, kc, vc, clock)
            torch.cuda.synchronize()
            assert torch.isfinite(y).all()
            assert _close(y, y_ref, 1e-4), (t, _rel_err(y, y_ref))
            assert torch.equal(mha_cache.mha_cache_step(q, kc, vc, clock), y), t


@pytest.mark.cuda
@pytest.mark.parametrize("n_heads,head_dim", [(1, 4), (5, 4), (16, 64), (32, 32)])
def test_cache_step_kernel_at_domain_edges(cuda, n_heads, head_dim):
    """The kernel at the edges of `kernel_takes`: one head of 4, bf16 rows
    that are no multiple of 16 bytes (5 heads of 4: the 8-byte copy path),
    1024 columns (4- and 8-key tiles), 32 heads; L = 300 (a partial last
    chunk), B = 1 and 3, both cache types; 1e-4 of the output's scale."""
    from deepxi_tpu_torch.ops.kernels import mha_cache
    gen = torch.Generator().manual_seed(n_heads)
    for B in (1, 3):
        q = (torch.randn(B, n_heads, head_dim, generator=gen) * head_dim ** -0.5).to(cuda)
        kv = [torch.randn(B, 300, n_heads, head_dim, generator=gen) for _ in range(2)]
        for dtype in (torch.float32, torch.bfloat16):
            kc, vc = (c.to(cuda, dtype) for c in kv)
            for t in (0, 31, 32, 299, 400):
                y = mha_cache.mha_cache_step(q, kc, vc, t)
                y_ref = mha_cache.mha_cache_step_ref(q, kc, vc, t)
                torch.cuda.synchronize()
                assert _close(y, y_ref, 1e-4), (B, dtype, t, _rel_err(y, y_ref))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 256])
def test_cache_step_graph_replays_read_the_clock(cuda, B):
    """One call captured in a CUDA graph at t = 5 and replayed after the
    device clock is set to 31, 700 and 2500: each replay matches the plain
    version at the new clock (the kernel reads the clock when it runs), and
    the merge's counters stay usable for eager calls in between."""
    from deepxi_tpu_torch.ops.kernels import mha_cache
    gen = torch.Generator().manual_seed(5)
    q = (torch.randn(B, 8, 32, generator=gen) * 32 ** -0.5).to(cuda)
    kc, vc = (torch.randn(B, 2048, 8, 32, generator=gen).to(cuda, torch.bfloat16)
              for _ in range(2))
    clock = torch.tensor(5, dtype=torch.int32, device=cuda)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = mha_cache.mha_cache_step(q, kc, vc, clock)
    for t in (31, 700, 2500, 5):
        clock.fill_(t)
        graph.replay()
        y_ref = mha_cache.mha_cache_step_ref(q, kc, vc, t)
        torch.cuda.synchronize()
        assert _close(y, y_ref, 1e-4), (t, _rel_err(y, y_ref))
        assert torch.equal(mha_cache.mha_cache_step(q, kc, vc, clock), y), t


@pytest.mark.cuda
def test_cache_step_on_two_streams_at_once(cuda):
    """B = 1 (64 key splits, so the merge's scratch and counters are used):
    a captured call replayed on one stream while eager calls of the same
    shape run on another, and eager calls on two streams, 20 of each
    without a synchronisation; every output matches the plain version."""
    from deepxi_tpu_torch.ops.kernels import mha_cache
    gen = torch.Generator().manual_seed(9)
    q = (torch.randn(3, 1, 8, 32, generator=gen) * 32 ** -0.5).to(cuda)
    kv = [torch.randn(1, 2048, 8, 32, generator=gen).to(cuda) for _ in range(6)]
    ts = (700, 2047, 31)
    clocks = [torch.tensor(t, dtype=torch.int32, device=cuda) for t in ts]

    def call(i):
        return mha_cache.mha_cache_step(q[i], kv[2 * i], kv[2 * i + 1], clocks[i])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_graph = call(0)
    sides = [torch.cuda.Stream() for _ in range(3)]
    for side in sides:
        side.wait_stream(torch.cuda.current_stream())
    outs = [[], [], []]
    for _ in range(20):
        with torch.cuda.stream(sides[0]):
            graph.replay()
            outs[0].append(y_graph.clone())
        for i in (1, 2):
            with torch.cuda.stream(sides[i]):
                outs[i].append(call(i))
    torch.cuda.synchronize()
    for i, t in enumerate(ts):
        y_ref = mha_cache.mha_cache_step_ref(q[i], kv[2 * i], kv[2 * i + 1], t)
        for y in outs[i]:
            assert _close(y, y_ref, 1e-4), (i, t, _rel_err(y, y_ref))


@pytest.mark.cuda
def test_cache_step_counts_launches_and_refuses_autograd(cuda):
    from deepxi_tpu_torch.ops.kernels import mha_cache
    fn = mha_cache.mha_cache_step
    q = torch.randn(2, 8, 32, device=cuda)
    kc, vc = torch.randn(2, 64, 8, 32, device=cuda), torch.randn(2, 64, 8, 32, device=cuda)
    n = fn.launches
    fn(q, kc, vc, 5)
    assert fn.launches == n + 1
    fn(q, kc, vc, torch.tensor(5, dtype=torch.int32, device=cuda))
    assert fn.launches == n + 2
    with pytest.raises(RuntimeError, match="no backward"):
        fn(q.clone().requires_grad_(True), kc, vc, 5)
    for bad in ((q[..., :6].contiguous(), kc[..., :6].contiguous(), vc[..., :6].contiguous(), 5),
                (q[:, :4].contiguous(), kc, vc, 5),
                (q, kc, vc.to(torch.bfloat16), 5), (q, kc.half(), vc.half(), 5),
                (q, kc, vc, -1), (q, kc, vc, torch.tensor(5, device=cuda)),
                (q, kc, vc, torch.tensor([5], dtype=torch.int32, device=cuda)),
                (q, kc, vc, torch.tensor(5, dtype=torch.int32))):
        with pytest.raises(ValueError):
            fn(*bad)
    assert fn.launches == n + 2


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


def _small_stream(gen):
    """A 2-block MHANetV3 StreamingMHANet's pieces with random weights."""
    from deepxi_tpu_torch.inp_tgt import MagXi
    from deepxi_tpu_torch.models.attention import MHANetV3
    from deepxi_tpu_torch.ops.maps import NormalCDF
    net = MHANetV3(257, 257, n_blocks=2)
    params = {k: torch.randn(v.shape, generator=gen) * 0.05 + (k.endswith(".scale"))
              for k, v in net.state_dict().items()}
    it = MagXi(xi_map=NormalCDF(use_db=True, mu=torch.zeros(257), sigma=torch.full((257,), 10.0)))
    return it, net, params


@pytest.mark.cuda
def test_streaming_mhanet_fused_launches_the_kernel(cuda):
    """fused=True runs each block's cache attention through the kernel (one
    launch a block and hop) and gives the einsum route's waveform."""
    from deepxi_tpu_torch.ops.kernels import mha_cache
    from deepxi_tpu_torch.streaming import StreamingMHANet
    gen = torch.Generator().manual_seed(4)
    it, net, params = _small_stream(gen)
    x = (torch.randn(2, 256 * 6, generator=gen) * 3000).to(torch.int16)
    n = mha_cache.mha_cache_step.launches
    y = StreamingMHANet(it, net, params, fused=True, device=cuda).stream(x)
    assert mha_cache.mha_cache_step.launches == n + 2 * 6
    y_ref = StreamingMHANet(it, net, params, device=cuda).stream(x)
    torch.cuda.synchronize()
    assert y.shape == (2, 256 * 6) and torch.isfinite(y).all()
    assert (y - y_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_streaming_mhanet_hop_replays_as_a_cuda_graph(cuda):
    """One fused hop captured in a CUDA graph and replayed hop by hop (each
    chunk copied into the static input, the returned state into the
    captured one) gives the eager stream's samples bitwise; an eager hop
    synchronises nothing with the host."""
    import torch_profile
    from deepxi_tpu_torch.streaming import StreamingMHANet
    gen = torch.Generator().manual_seed(6)
    it, net, params = _small_stream(gen)
    s = StreamingMHANet(it, net, params, fused=True, device=cuda)
    x = (torch.randn(2, 256 * 12, generator=gen) * 3000).to(torch.int16).to(cuda)
    y_eager = s.stream(x)
    chunks = torch.cat([x, torch.zeros(2, 256, dtype=x.dtype, device=cuda)], 1)
    state = s.prime(s.init_state(2), chunks[:, :256])
    state, y1 = s.step(state, chunks[:, 256:512])
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, y2 = s.step(state, chunks[:, 512:768])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    state, y = torch_profile.stream_replayed(s, state, chunks[:, 768:])
    torch.cuda.synchronize()
    assert int(state.t) == 12
    assert torch.equal(torch.cat([y1, y2, y], 1), y_eager)


@pytest.mark.cuda
def test_enhance_and_test_on_the_card_match_the_plain_route(cuda, tmp_path):
    """The mhanet-1.1c artifact on the card: `cli.main(["--enhance", ...])`
    launches the fused blocks and writes the plain network's waveform within
    one int16 step; `DeepXiTorch.test` scores the 4 s utterance as the plain
    waveform scores (PESQ, MOS-LQO, composites, SegSNR and SNR within 0.01,
    STOI and eSTOI within 0.1 %)."""
    import numpy as np

    from deepxi_tpu_torch import cli
    from deepxi_tpu_torch.compat.artifact import MHANET_ROOT, load_artifact
    from deepxi_tpu_torch.config import preset
    from deepxi_tpu_torch.data.loader import bucket_length
    from deepxi_tpu_torch.data.wavio import read_wav, save_wav
    from deepxi_tpu_torch.enhance import make_enhancer
    from deepxi_tpu_torch.framework import DeepXiTorch
    from deepxi_tpu_torch.metrics.scoring import score_utterance
    from deepxi_tpu_torch.ops.kernels import mha_block_fused

    art = load_artifact(device=cuda)
    plain = make_enhancer(art.inp_tgt, art.net, "mmse-lsa", device=cuda)
    save_wav(str(tmp_path / "noisy" / "c012_white_5dB.wav"), art.noisy, 16000)
    save_wav(str(tmp_path / "clean" / "c012.wav"), art.clean, 16000)
    n0 = mha_block_fused.fused_transformer_block.launches
    assert cli.main(["--enhance", MHANET_ROOT, "--in_wavs", str(tmp_path / "noisy"),
                     "--out_dir", str(tmp_path / "enh")]) == 0
    assert mha_block_fused.fused_transformer_block.launches > n0
    xp = np.zeros((1, -(-len(art.noisy) // 256) * 256), np.int16)
    xp[0, :len(art.noisy)] = art.noisy
    y_plain = plain(art.params, xp)[0, :len(art.noisy)].cpu().numpy()
    y = read_wav(str(tmp_path / "enh" / "c012_white_5dB.wav"))[0]
    assert np.abs(y.astype(np.int32) - (y_plain * 32768.0).astype(np.int16)).max() <= 1

    (tmp_path / "data").mkdir()
    np.savez(tmp_path / "data" / "mhanet-1.1c_stats.npz",
             **dict(np.load(os.path.join(MHANET_ROOT, "stats.npz"))))
    dx = DeepXiTorch(preset("mhanet-1.1c", data_path=str(tmp_path / "data"),
                            log_path=str(tmp_path / "log"), metric_workers=1,
                            test_x_path=str(tmp_path / "noisy"),
                            test_s_path=str(tmp_path / "clean")), device=cuda)
    got = dx.test(params=art.params, epochs=[1])[(1, "mmse-lsa")]
    xb = np.zeros((1, bucket_length(len(art.noisy))), np.int16)
    xb[0, :len(art.noisy)] = art.noisy
    ref = score_utterance(art.clean.astype(np.float32) / 32768.0,
                          plain(art.params, xb)[0, :len(art.clean)].cpu().numpy(), 16000)
    for m, v in ref.items():
        assert abs(got[("white", 5, m)][0] - v) <= (0.1 if "STOI" in m else 0.01), m


@pytest.mark.cuda
def test_resampled_wav_feeds_the_card(cuda, tmp_path):
    """A 44.1 kHz stereo 32-bit wav read at 16 kHz by `read_wav` (its length
    `wav_length`'s) enhances on the card through the fused TCN as through the
    plain network (waveform within 1e-3)."""
    import wave

    import numpy as np

    from deepxi_tpu_torch.compat.artifact import load_flagship_artifact
    from deepxi_tpu_torch.data.wavio import read_wav, wav_length
    from deepxi_tpu_torch.enhance import make_enhancer

    art = load_flagship_artifact(device=cuda)
    x = art.noisy.astype(np.float64) / 32768.0
    t = np.arange(int(len(x) * 44100 / 16000)) * 16000 / 44100
    y = np.interp(t, np.arange(len(x)), x)
    path = str(tmp_path / "x.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(4)
        w.setframerate(44100)
        w.writeframes((np.stack([y, y], 1) * 2 ** 31 * 0.9).astype("<i4").tobytes())
    wav, f_s = read_wav(path, 16000)
    assert f_s == 16000 and len(wav) == wav_length(path, 16000)
    assert abs(len(wav) - len(art.noisy)) <= 1
    xp = np.zeros((1, -(-len(wav) // 256) * 256), np.int16)
    xp[0, :len(wav)] = wav
    n0 = tcn_fused.fused_block_group_whole.launches
    y_k = make_enhancer(art.inp_tgt, art.net, "mmse-lsa",
                        apply_fn=tcn_fused.resnetv2_apply_fused, device=cuda)(art.params, xp)
    assert tcn_fused.fused_block_group_whole.launches > n0
    y_p = make_enhancer(art.inp_tgt, art.net, "mmse-lsa", device=cuda)(art.params, xp)
    assert torch.isfinite(y_k).all() and (y_k - y_p).abs().max().item() <= 1e-3


# -- the kernels as `deepxi::` ops, and the servers on the card ----------------

@pytest.mark.cuda
def test_kernel_ops_equal_their_wrappers(cuda):
    """Each `deepxi::` op called directly (as an exported program calls it)
    gives its public wrapper's output bitwise, and both count the same
    launches: one a block for the per-block TCN kernels, one a call for the
    others."""
    from deepxi_tpu_torch.ops.kernels import (lstm, mha_block_fused, mha_cache,
                                              mha_flash_stream, mha_fused)
    ops = torch.ops.deepxi
    gen = torch.Generator().manual_seed(0)
    w = tcn_fused.random_block_weights(4, gen, cuda)
    flat, dil = tcn_fused.flat_weights(w), [1, 2, 4, 8]
    x = torch.relu(torch.randn(3, 100, 256, generator=gen)).to(cuda)
    q, k, v, valid = _heads(2, 100, [100, 61], gen, cuda)
    bw = mha_block_fused.random_block_weights(gen, cuda)
    h = torch.randn(2, 128, 256, generator=gen).to(cuda)
    vf = torch.nn.functional.pad(valid, (0, 28))[:, None, :].float()
    qc = (torch.randn(3, 8, 32, generator=gen) * 32 ** -0.5).to(cuda)
    kc, vc = (torch.randn(3, 2048, 8, 32, generator=gen).to(cuda) for _ in range(2))
    t = torch.tensor(700, dtype=torch.int32, device=cuda)
    xp, w_h, mask = (a.to(cuda) for a in _lstm_inputs(30, 3, 64, torch.float32, 1))
    b_x, *w_x = (torch.randn(*shape, generator=gen).to(cuda)
                 for shape in ((64,),) + ((256, 16),) * 4)
    cases = (
        (tcn_fused.fused_block_group_whole, (x, w, dil),
         ops.fused_block_group_whole, (x, flat, dil, 3), 4),
        (tcn_fused.fused_block_group, (x, w[:2], dil[:2]),
         ops.fused_block_group, (x, flat[:12], dil[:2], 3, tcn_fused.TILED_TILE_T), 1),
        (tcn_fused.fused_block_group_whole_pack2, (x, w, dil, 3, "matmul"),
         ops.fused_block_group_whole_pack2, (x, flat, dil, 3, "matmul"), 4),
        (mha_block_fused.fused_transformer_block, (h, vf, bw, True),
         ops.fused_transformer_block, (h, vf, list(bw), True), 1),
        (mha_fused.flash_attention, (q, k, v, valid, True),
         ops.flash_attention, (q, k, v, valid, True), 1),
        (mha_flash_stream.flash_attention_streaming, (q, k, v, valid, True, 64, 128),
         ops.flash_attention_streaming, (q, k, v, valid, True, 64, 128), 1),
        (mha_cache.mha_cache_step, (qc, kc, vc, t), ops.mha_cache_step, (qc, kc, vc, t), 1),
        (lstm.masked_lstm, (xp, w_h, mask, True), ops.masked_lstm, (xp, w_h, mask, True),
         1),
        (lstm.lstm_input_proj, (h, w_x, b_x), ops.lstm_input_proj, (h, w_x, b_x), 1))
    for wrapper, args, op, op_args, n in cases:
        n0 = wrapper.launches
        y = wrapper(*args)
        n1 = wrapper.launches
        y_op = op(*op_args)
        torch.cuda.synchronize()
        assert (n1 - n0, wrapper.launches - n1) == (n, n), wrapper.__name__
        assert torch.equal(y, y_op), wrapper.__name__


def _small_streamers(device, gen):
    """A StreamingEnhancer (d_model 32, d_f 16, 4 blocks) and a fused
    StreamingMHANet (d_model 32, 4 heads of 8, 2 blocks) with random
    weights (nonzero biases) and map statistics, on `device`."""
    from deepxi_tpu_torch.inp_tgt import MagXi
    from deepxi_tpu_torch.models.attention import MHANetV3
    from deepxi_tpu_torch.ops.maps import NormalCDF
    from deepxi_tpu_torch.streaming import StreamingEnhancer, StreamingMHANet

    def rnd(net):
        return {name: torch.randn(p.shape, generator=gen) * 0.2 + name.endswith(".scale")
                for name, p in net.state_dict().items()}

    it = MagXi(xi_map=NormalCDF(use_db=True, mu=torch.randn(257, generator=gen).to(device),
                                sigma=torch.full((257,), 10.0, device=device)))
    tcn = ResNetV2(257, 257, d_model=32, n_blocks=4, d_f=16, k=3, max_d_rate=4)
    mha = MHANetV3(257, 257, d_model=32, n_blocks=2, n_heads=4, max_len=128)
    return {"resnet": StreamingEnhancer(it, tcn, rnd(tcn), device=device),
            "mhanet": StreamingMHANet(it, mha, rnd(mha), fused=True, device=device)}


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["resnet", "mhanet"])
def test_streaming_server_replays_the_eager_hop(cuda, tmp_path, net):
    """The streaming server on the card (one CUDA graph captured at its
    first step, replayed every step) against the live streamer's eager steps
    on the same chunks: bitwise expected, held to 1e-6 of the output's
    scale; one replay a step; the KV-cache kernel launches only at capture
    (the warm-ups and the captured step, one a block each)."""
    from deepxi_tpu_torch import serving
    from deepxi_tpu_torch.ops.kernels import mha_cache
    gen = torch.Generator().manual_seed(3)
    sm = _small_streamers(cuda, gen)[net]
    serving.export_streaming(sm, str(tmp_path), batch=2)
    srv = serving.load_streaming_server(str(tmp_path))
    chunks = [(torch.randn(2, 256, generator=gen) * 3000).to(torch.int16) for _ in range(6)]
    n0 = mha_cache.mha_cache_step.launches
    state, ys = srv.init_state(), []
    for c in chunks:
        state, y = srv.step(state, c.numpy())
        ys.append(y)
    n_server = mha_cache.mha_cache_step.launches - n0
    state_l, ys_l = sm.init_state(2), []
    for c in chunks:
        state_l, y = sm.step(state_l, c.to(cuda))
        ys_l.append(y)
    y, y_l = torch.cat(ys, 1), torch.cat(ys_l, 1)
    assert srv.replays == len(chunks)
    assert torch.isfinite(y).all() and (y - y_l).abs().max().item() <= 1e-6 * y_l.abs().max()
    assert n_server == (0 if net == "resnet" else (serving.WARMUPS + 1) * 2)


@pytest.mark.cuda
def test_enhancer_server_runs_the_kernels(cuda, tmp_path):
    """A bundle exported on the card runs the fused TCN (one launch a block
    a call) and gives the live enhancer's output (1e-6 of its scale)."""
    import numpy as np

    from deepxi_tpu_torch import serving
    from deepxi_tpu_torch.enhance import make_enhancer
    gen = torch.Generator().manual_seed(4)
    sm = _small_streamers(cuda, gen)["resnet"]
    net = ResNetV2(257, 257, d_model=32, n_blocks=4, d_f=16, k=3, max_d_rate=4)
    params = {k: v.to(cuda) for k, v in zip(net.state_dict(), (
        torch.randn(p.shape, generator=gen) * 0.2 for p in net.state_dict().values()))}
    apply = lambda p, m: tcn_fused.resnetv2_apply_fused(p, m, n_blocks=4, max_d_rate=4)  # noqa: E731
    serving.export_enhancer(sm.it, net, params, str(tmp_path), batch=2, buckets=(8192,),
                            apply_fn=apply)
    srv = serving.load_server(str(tmp_path))
    x = (torch.randn(2, 8000, generator=gen) * 3000).to(torch.int16).numpy()
    n0 = tcn_fused.fused_block_group_whole.launches
    y = srv(x)
    assert tcn_fused.fused_block_group_whole.launches - n0 == 4
    xp = np.zeros((2, 8192), np.int16)
    xp[:, :8000] = x
    y_l = make_enhancer(sm.it, net, apply_fn=apply)(params, xp).cpu().numpy()[:, :y.shape[1]]
    assert np.isfinite(y).all() and np.abs(y - y_l).max() <= 1e-6 * np.abs(y_l).max()


def _family(inp_tgt_type, device, **kw):
    """A family with seeded statistics on `device` (JAX-free: the port's own
    `with_stats` on a seeded sample)."""
    import numpy as np

    from deepxi_tpu_torch.inp_tgt import inp_tgt_selector
    it = inp_tgt_selector(inp_tgt_type, 512, kw.pop("N_s", 256), 512, 16000,
                          gain=kw.pop("gain", "mmse-lsa"), **kw)
    rng = np.random.RandomState(8)
    s, d = rng.randn(3, 6000) * 0.3, rng.randn(3, 6000) * 0.1
    return it.with_stats(*(a.astype(np.float32) for a in (s, d, s + d)),
                         np.array([6000, 4500, 3000]), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("N_s,kernel", [(256, True), (128, False)])
def test_spectral_route_by_framing_on_the_card(cuda, N_s, kernel):
    """The estimator and the gain synthesiser launch stft_mag_fused and
    enhance_frames_fused once a call at N_s = 256 and never at N_s = 128
    (the matmul route, chosen by the framing), with the CPU route's results
    (1e-4 of the scale)."""
    from deepxi_tpu_torch.enhance import make_gain_synthesiser, make_xi_estimator, noise_gain
    from deepxi_tpu_torch.ops.kernels import spectral
    gen = torch.Generator().manual_seed(9)
    net = init_flax_like(ResNetV2(257, 257, n_blocks=3, d_model=32, d_f=16), gen)
    params = {k: v.detach() for k, v in net.state_dict().items()}
    x = (torch.randn(1, 7000, generator=gen) * 3000).to(torch.int16)
    out = {}
    for dev in ("cpu", cuda):
        it = _family("MagXi", dev, map_type="DBNormalCDF", N_s=N_s)
        n = spectral.stft_mag_fused.launches, spectral.enhance_frames_fused.launches
        p = {k: v.to(dev) for k, v in params.items()}
        xi = make_xi_estimator(it, net.to(dev), device=dev)(p, x)
        y = make_gain_synthesiser(it, net, noise_gain, device=dev)(p, x)
        out[str(dev)] = (xi.cpu(), y.cpu(), (spectral.stft_mag_fused.launches - n[0],
                                             spectral.enhance_frames_fused.launches - n[1]))
    (xi_c, y_c, n_c), (xi_g, y_g, n_g) = out["cpu"], out[str(cuda)]
    assert n_c == (0, 0) and n_g == ((1, 1) if kernel else (0, 0))
    keep = xi_c > 1e-6
    assert ((xi_g - xi_c).abs() / xi_c)[keep].max().item() <= 1e-3
    assert (y_g - y_c).abs().max().item() <= 1e-4 * y_c.abs().max().item()


@pytest.mark.cuda
def test_plain_spectral_route_launches_no_spectral_kernel(cuda):
    """With ``kernels=False`` the estimator and the gain synthesiser take the
    matrix products at N_s = 256 too (the reference route of the card
    checks): no stft_mag_fused or enhance_frames_fused launch, and the
    kernel route's results (1e-3 relative on xi, 1e-4 of the scale on y)."""
    from deepxi_tpu_torch.enhance import make_gain_synthesiser, make_xi_estimator, noise_gain
    from deepxi_tpu_torch.ops.kernels import spectral
    gen = torch.Generator().manual_seed(9)
    net = init_flax_like(ResNetV2(257, 257, n_blocks=3, d_model=32, d_f=16), gen).to(cuda)
    params = {k: v.detach() for k, v in net.state_dict().items()}
    x = (torch.randn(1, 7000, generator=gen) * 3000).to(torch.int16)
    it = _family("MagXi", cuda, map_type="DBNormalCDF", N_s=256)
    out = {}
    for kernels in (True, False):
        n = spectral.stft_mag_fused.launches, spectral.enhance_frames_fused.launches
        xi = make_xi_estimator(it, net, device=cuda, kernels=kernels)(params, x)
        y = make_gain_synthesiser(it, net, noise_gain, device=cuda, kernels=kernels)(params, x)
        out[kernels] = (xi.cpu(), y.cpu(), (spectral.stft_mag_fused.launches - n[0],
                                            spectral.enhance_frames_fused.launches - n[1]))
    (xi_k, y_k, n_k), (xi_p, y_p, n_p) = out[True], out[False]
    assert n_k == (1, 1) and n_p == (0, 0)
    keep = xi_p > 1e-6
    assert ((xi_k - xi_p).abs() / xi_p)[keep].max().item() <= 1e-3
    assert (y_k - y_p).abs().max().item() <= 1e-4 * y_p.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("family,kw", [
    ("MagXiGamma", dict(map_type=["DBNormalCDF", "DBNormalCDF"])),
    ("MagGain", dict(gain="mmse-lsa")), ("MagSMM", {}), ("MagMag", dict(map_type="DBNormalCDF")),
    ("MagXi", dict(map_type="DBLaplaceCDF", map_params=[0.0]))])
def test_family_enhancers_run_the_kernels(cuda, family, kw):
    """Each gain-form family's batched enhancer on the card through the fused
    TCN (a launch a block) against the plain route on the CPU, at small
    widths: 1e-4 of the waveform's scale (MagMag's magnitudes through the
    same network output on both, as its map's inverse magnifies the
    routes' float32 differences near 0 and 1)."""
    from deepxi_tpu_torch.enhance import make_enhancer
    gen = torch.Generator().manual_seed(10)
    it_c = _family(family, "cpu", **dict(kw))
    it_g = _family(family, cuda, **dict(kw))
    net = init_flax_like(ResNetV2(257, it_c.n_outp, n_blocks=4, d_model=32, d_f=16,
                                  max_d_rate=4), gen)
    params = {k: v.detach() for k, v in net.state_dict().items()}
    apply = lambda p, m: tcn_fused.resnetv2_apply_fused(p, m, n_blocks=4, max_d_rate=4)  # noqa: E731
    x = (torch.randn(2, 8192, generator=gen) * 3000).to(torch.int16)
    n0 = tcn_fused.fused_block_group_whole.launches
    y = make_enhancer(it_g, net, apply_fn=apply, device=cuda)(
        {k: v.to(cuda) for k, v in params.items()}, x).cpu()
    assert tcn_fused.fused_block_group_whole.launches - n0 == 4
    y_c = make_enhancer(it_c, net.cpu(), device="cpu")(params, x)
    if family == "MagMag":
        with torch.no_grad():
            from deepxi_tpu_torch.ops.kernels.spectral import stft_mag
            t = apply({k: v.to(cuda) for k, v in params.items()},
                      stft_mag(x.to(cuda) / 32768.0, 512, 256, 512)).cpu()
        y_c = make_enhancer(it_c, None, apply_fn=lambda p, m: t, device="cpu")(None, x)
    assert torch.isfinite(y).all() and y.shape == y_c.shape
    assert (y - y_c).abs().max().item() <= 1e-4 * y_c.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("ver", ["resnet-1.1n", "resnet-1.0c", "resnet-1.0n"])
def test_plain_resnets_on_the_card(cuda, ver):
    """resnet-1.1n, resnet-1.0c and resnet-1.0n at small widths: their
    plain networks (the fused kernels compute only the causal ReLU->LN->W+b
    ResNetV2) on the card against the CPU, 1e-4, and no TCN kernel
    launches."""
    from deepxi_tpu_torch.config import preset
    from deepxi_tpu_torch.framework import build_network, fast_apply_fn
    cfg = preset(ver, d_model=32, n_blocks=5, d_f=16, max_d_rate=4)
    assert fast_apply_fn(cfg) is None
    net = init_flax_like(build_network(cfg, 257, 257), torch.Generator().manual_seed(12))
    x = torch.rand(2, 300, 257, generator=torch.Generator().manual_seed(13))
    with torch.no_grad():
        y_c = net(x)
        n = tcn_fused.fused_block_group_whole.launches, tcn_fused.fused_block_group.launches
        y = net.to(cuda)(x.to(cuda)).cpu()
    assert (tcn_fused.fused_block_group_whole.launches,
            tcn_fused.fused_block_group.launches) == n
    assert (y - y_c).abs().max().item() <= 1e-4


NEW_NETWORKS = [("MHANet", dict(d_model=64, n_blocks=2, n_heads=8)),
                ("ResLSTM", dict(d_model=64, n_blocks=2)),
                ("ResBiLSTM", dict(d_model=64, n_blocks=2)),
                ("RDLNet", dict(n_blocks=3, length=5, m_1=16)),
                ("MHANetV3", dict(d_model=64, n_blocks=2, n_heads=8, max_len=256,
                                  attention_impl="block", block_q=64))]


@pytest.mark.cuda
@pytest.mark.parametrize("nt,kw", NEW_NETWORKS, ids=[n for n, _ in NEW_NETWORKS])
def test_new_networks_on_the_card_match_the_cpu(cuda, monkeypatch, nt, kw):
    """MHANet V1, ResLSTM, ResBiLSTM, RDLNet and the "block" attention at
    small widths, f32 on the card (TF32 off) against the same network in
    float64 on the CPU, on two rows of 200 frames, one padded after 130 and
    the other with an all-zero frame inside: within 1e-4 of the output's
    scale on the valid frames. (A masked frame's V2/V3 attention row is
    -1e10 on every key: f32 rounds each logit away, float64 keeps it.)"""
    from deepxi_tpu_torch.models import init_flax_like as init_any, network_selector
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    net = init_any(network_selector(nt, 257, 257, **kw), torch.Generator().manual_seed(14))
    x = torch.rand(2, 200, 257, generator=torch.Generator().manual_seed(15)) + 1e-3
    x[0, 130:] = 0.0
    x[1, 60] = 0.0
    with torch.no_grad():
        y64 = net.double()(x.double())
        y = net.float().to(cuda)(x.to(cuda)).cpu().double()
    valid = (x != 0).any(-1)
    assert torch.isfinite(y).all() and y.shape == y64.shape
    assert (y - y64)[valid].abs().max().item() <= 1e-4 * y64[valid].abs().max().item()


def _lstm_inputs(T, B, H, dtype, seed):
    """xp [T, B, 4H], w_h [H, 4H] and a mask [T, B] with an all-zero frame
    inside row 0 and row B-1 padded over its last fifth; from B = 3 on, row 1
    all masked and row 0's first two frames masked (the reverse direction's
    last processed frames)."""
    gen = torch.Generator().manual_seed(seed)
    xp = (torch.randn(T, B, 4 * H, generator=gen) * 0.5).to(dtype)
    w_h = (torch.randn(H, 4 * H, generator=gen) * H ** -0.5).to(dtype)
    mask = torch.ones(T, B, dtype=torch.bool)
    mask[T // 3, 0] = False
    mask[T - T // 5:, B - 1] = False
    if B >= 3:
        mask[:, 1] = False
        mask[:2, 0] = False
    return xp, w_h, mask


def _row_rel(a, ref):
    """The worst batch row's max |a - ref| over ref's max abs."""
    return ((a - ref).abs().amax(dim=(0, 2)).max() / ref.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 8, 100, 512, 1024])
@pytest.mark.parametrize("B", [1, 3, 8, 33, 96])
@pytest.mark.parametrize("T", [1, 7, 1025])
def test_masked_lstm_kernel_matches_plain(cuda, H, B, T):
    """The forward kernel (inference and training, csrc/lstm.cu) and the
    backward kernel against `masked_lstm_train_plain` and
    `masked_lstm_backward_plain` on the card, both directions, f32 and f64:
    ys, the saved gates and cell state and dxp within 1e-4 (f32; the
    products sum in another order) or 1e-12 (f64) of each output's scale on
    every batch row; one launch a call; a second call of each bitwise (T = 1025 frames
    of barriers: a CTA reading h_{t-1} or a partial dh before its writers'
    stores would show here). H = 1 and 1024 are the domain's edges; H = 100
    is no multiple of the units a CTA. B = 8 is the train shape (both
    products on FMAs); at B = 33 and 96 both products take the tensor cores
    where the grid allows (the backward from 7 rows a CTA; the forward from
    6 with U >= 4 where all of a CTA's rows fit one stage, at most 32, so
    H = 1024, B = 96 (96 rows a CTA) stays on its FMAs), and float64 stays
    on FMAs."""
    from deepxi_tpu_torch.ops.kernels import lstm
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-12)):
        for reverse in (False, True):
            xp, w_h, mask = (t.to(cuda) for t in _lstm_inputs(T, B, H, dtype, H + B + T))
            dys = torch.randn(T, B, H, generator=torch.Generator().manual_seed(T),
                              dtype=dtype).to(cuda)
            with torch.no_grad():
                n0, b0 = lstm.masked_lstm.launches, lstm.masked_lstm_backward.launches
                ys = lstm.masked_lstm(xp, w_h, mask, reverse)
                ys_t, gates, cs = lstm.masked_lstm_train(xp, w_h, mask, reverse)
                dxp = lstm.masked_lstm_backward(dys, gates, cs, w_h, mask, reverse)
                assert (lstm.masked_lstm.launches - n0,
                        lstm.masked_lstm_backward.launches - b0) == (2, 1)
                ref, g_ref, c_ref = lstm.masked_lstm_train_plain(xp, w_h, mask, reverse)
                dxp_ref = lstm.masked_lstm_backward_plain(dys, g_ref, c_ref, w_h, mask,
                                                          reverse)
                again = lstm.masked_lstm(xp, w_h, mask, reverse)
                dxp_again = lstm.masked_lstm_backward(dys, gates, cs, w_h, mask, reverse)
            torch.cuda.synchronize()
            assert ys.shape == (T, B, H) and dxp.shape == (T, B, 4 * H)
            assert torch.equal(ys, again) and torch.equal(ys, ys_t)
            assert torch.equal(dxp, dxp_again)
            for name, a, r in (("ys", ys, ref), ("gates", gates, g_ref), ("cs", cs, c_ref),
                               ("dxp", dxp, dxp_ref)):
                assert _row_rel(a, r) <= tol, (name, dtype, reverse, _row_rel(a, r))


@pytest.mark.cuda
def test_masked_lstm_refuses_outside_its_domain(cuda, monkeypatch):
    """A width past 1024, bfloat16 and a mask of another shape raise on the
    card before any launch; a grid that cannot be resident at once (one
    hidden unit a CTA at H = 1024, one row group: 1,024 CTAs) is refused by
    the cooperative launch of either kernel and raises, never hangs (the
    backward's row-group barrier spins only on co-resident CTAs), and the
    next call of each runs. The kernels' own grids fit: every row group's
    CTAs within the SMs."""
    from deepxi_tpu_torch.ops.kernels import lstm
    xp, w_h, mask = (t.to(cuda) for t in _lstm_inputs(4, 33, 1024, torch.float32, 0))
    with torch.no_grad():
        _, gates, cs = lstm.masked_lstm_train(xp, w_h, mask)
    n0, b0 = lstm.masked_lstm.launches, lstm.masked_lstm_backward.launches
    for T, B, H, dtype in ((4, 1, 1025, torch.float32), (4, 2, 16, torch.bfloat16)):
        xo, wo, mo = (t.to(cuda) for t in _lstm_inputs(T, B, H, torch.float32, 0))
        with pytest.raises(ValueError):
            lstm.masked_lstm(xo.to(dtype), wo.to(dtype), mo)
    x6, w6, m6 = (t.to(cuda) for t in _lstm_inputs(6, 2, 16, torch.float32, 0))
    with pytest.raises(ValueError):
        lstm.masked_lstm(x6, w6, m6[:5])
    with monkeypatch.context() as m:
        m.setattr(lstm, "grid", lambda backward, B, H, dtype: (1, 1))
        for fn in (lambda: lstm.masked_lstm(xp, w_h, mask),
                   lambda: lstm.masked_lstm_train(xp, w_h, mask),
                   lambda: lstm.masked_lstm_backward(torch.ones_like(cs), gates, cs, w_h, mask)):
            with pytest.raises(RuntimeError, match="cooperative launch"):
                fn()
    assert (lstm.masked_lstm.launches, lstm.masked_lstm_backward.launches) == (n0, b0)
    ys = lstm.masked_lstm(xp, w_h, mask)
    dxp = lstm.masked_lstm_backward(torch.ones_like(cs), gates, cs, w_h, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(ys).all() and torch.isfinite(dxp).all()
    assert (lstm.masked_lstm.launches, lstm.masked_lstm_backward.launches) == (n0 + 1, b0 + 1)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B in (1, 3, 8, 33, 96):
        for H in (1, 100, 512, 1024):
            for backward in (False, True):
                for dtype in (torch.float32, torch.float64):
                    plan = lstm.kernel_plan(backward, B, H, dtype)
                    assert plan["ctas"] <= sms and plan["NB"] >= 1, (B, H, backward, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("H, B", [(512, 8), (512, 33), (100, 33), (1024, 96)])
def test_masked_lstm_backward_tensor_core_route(cuda, monkeypatch, H, B):
    """The backward's split-TF32 tensor-core route at every row count
    (csrc/lstm.cu built with LSTM_TC_ROWS=1; the default build takes it from
    7 rows a CTA) against `masked_lstm_backward_plain` within 1e-4 of the scale on
    every batch row, both directions, with its A fragments in shared memory
    (the plan says so), and a second call bitwise."""
    from deepxi_tpu_torch.ops.kernels import _build, lstm
    lib = _build.load("lstm", {"LSTM_TC_ROWS": 1})
    monkeypatch.setattr(lstm, "_lib", lambda: lib)
    assert lstm.kernel_plan(True, B, H)["w_h_in_shared"]
    T = 257
    for reverse in (False, True):
        xp, w_h, mask = (t.to(cuda) for t in _lstm_inputs(T, B, H, torch.float32, H + B))
        dys = torch.randn(T, B, H, generator=torch.Generator().manual_seed(B)).to(cuda)
        with torch.no_grad():
            _, gates, cs = lstm.masked_lstm_train(xp, w_h, mask, reverse)
            dxp = lstm.masked_lstm_backward(dys, gates, cs, w_h, mask, reverse)
            again = lstm.masked_lstm_backward(dys, gates, cs, w_h, mask, reverse)
            _, g_ref, c_ref = lstm.masked_lstm_train_plain(xp, w_h, mask, reverse)
            ref = lstm.masked_lstm_backward_plain(dys, g_ref, c_ref, w_h, mask, reverse)
        torch.cuda.synchronize()
        assert torch.equal(dxp, again)
        assert _row_rel(dxp, ref) <= 1e-4, (reverse, _row_rel(dxp, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("H, B", [(512, 96), (512, 33), (100, 33), (1024, 96), (512, 8)])
def test_masked_lstm_forward_tensor_core_route(cuda, monkeypatch, H, B):
    """The forward's split-TF32 tensor-core route at every row count
    (csrc/lstm.cu built with LSTM_FWD_TC_ROWS=1; the default build takes it
    from 6 rows a CTA) against `masked_lstm_train_plain`: ys, the saved gates
    and cell state within 1e-4 of each output's scale on every batch row,
    both directions, the op's ys bitwise the training forward's and a second
    call's; every launch counted as a tensor-core launch. (512, 8) takes the
    route in one n-block of 8 with 2 rows. (1024, 96) has 96 rows a CTA
    (U = 8, one row group), more than one stage of the route holds: it keeps
    the FMA route, within the same limits, and no launch is counted as a
    tensor-core launch."""
    from deepxi_tpu_torch.ops.kernels import _build, lstm
    lib = _build.load("lstm", {"LSTM_FWD_TC_ROWS": 1})
    monkeypatch.setattr(lstm, "_lib", lambda: lib)
    plan = lstm.kernel_plan(False, B, H)
    one_stage = -(-B // plan["R"]) <= 32
    assert one_stage == ((H, B) != (1024, 96))
    assert plan["tensor_cores"] == one_stage, plan
    T = 257
    for reverse in (False, True):
        xp, w_h, mask = (t.to(cuda) for t in _lstm_inputs(T, B, H, torch.float32, H + B + 1))
        with torch.no_grad():
            n0, c0 = lstm.masked_lstm.launches, lstm.masked_lstm.tensor_core_launches
            ys = lstm.masked_lstm(xp, w_h, mask, reverse)
            ys_t, gates, cs = lstm.masked_lstm_train(xp, w_h, mask, reverse)
            again = lstm.masked_lstm(xp, w_h, mask, reverse)
            assert (lstm.masked_lstm.launches - n0,
                    lstm.masked_lstm.tensor_core_launches - c0) == (3, 3 * one_stage)
            ref, g_ref, c_ref = lstm.masked_lstm_train_plain(xp, w_h, mask, reverse)
        torch.cuda.synchronize()
        assert torch.equal(ys, again) and torch.equal(ys, ys_t)
        for name, a, r in (("ys", ys, ref), ("gates", gates, g_ref), ("cs", cs, c_ref)):
            assert _row_rel(a, r) <= 1e-4, (name, reverse, _row_rel(a, r))


@pytest.mark.cuda
def test_masked_lstm_forward_route_by_rows(cuda):
    """The default build's forward product takes the tensor cores by the
    rows a CTA in its input shape: at H = 512, B = 96 (24 rows a CTA) it
    does, at the train shape B = 8 (2 rows) and in float64 it does not; the
    backward's plan reports its own route. `tensor_core_launches` counts the
    former's launches only."""
    from deepxi_tpu_torch.ops.kernels import lstm
    assert lstm.kernel_plan(False, 96, 512)["tensor_cores"]
    assert not lstm.kernel_plan(False, 8, 512)["tensor_cores"]
    assert not lstm.kernel_plan(False, 96, 512, torch.float64)["tensor_cores"]
    assert lstm.kernel_plan(True, 96, 512)["tensor_cores"]
    assert not lstm.kernel_plan(True, 8, 512)["tensor_cores"]
    for B, dtype, n_tc in ((96, torch.float32, 1), (8, torch.float32, 0),
                           (96, torch.float64, 0)):
        xp, w_h, mask = (t.to(cuda) for t in _lstm_inputs(9, B, 512, dtype, B))
        n0, c0 = lstm.masked_lstm.launches, lstm.masked_lstm.tensor_core_launches
        with torch.no_grad():
            lstm.masked_lstm(xp, w_h, mask)
        assert (lstm.masked_lstm.launches - n0,
                lstm.masked_lstm.tensor_core_launches - c0) == (1, n_tc), (B, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 32])
def test_masked_lstm_backward_on_two_streams(cuda, B):
    """Two backward calls in flight at once on two streams, on the same
    saved state with different upstream gradients, each give their lone
    call's dxp bitwise: each call's row-group barrier counters and partial
    sums are its own scratch (B = 8: the product on FMAs, 32: on the tensor
    cores)."""
    from deepxi_tpu_torch.ops.kernels import lstm
    T, H = 129, 512
    xp, w_h, mask = (t.to(cuda) for t in _lstm_inputs(T, B, H, torch.float32, 11))
    gen = torch.Generator().manual_seed(12)
    dys = [torch.randn(T, B, H, generator=gen).to(cuda) for _ in range(2)]
    with torch.no_grad():
        _, gates, cs = lstm.masked_lstm_train(xp, w_h, mask)
        alone = [lstm.masked_lstm_backward(d, gates, cs, w_h, mask) for d in dys]
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream(cuda) for _ in dys]
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        b0 = lstm.masked_lstm_backward.launches
        outs = []
        for st, d in zip(streams, dys):
            with torch.cuda.stream(st):
                outs.append(lstm.masked_lstm_backward(d, gates, cs, w_h, mask))
        torch.cuda.synchronize()
    assert lstm.masked_lstm_backward.launches == b0 + 2
    for a, o in zip(alone, outs):
        assert torch.equal(a, o)
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("nt", ["ResLSTM", "ResBiLSTM"])
def test_lstm_training_runs_the_kernels(cuda, monkeypatch, nt):
    """A ResLSTM / ResBiLSTM loss under autograd on the card (d_model 64, 2
    blocks, rows with an interior all-zero frame and a padded tail) runs the
    forward and the backward kernel once a direction a block and never the
    plain loop; its gradients are within 2e-4 of each leaf's scale of plain
    autograd through the plain loop, and a second backward is bitwise."""
    from deepxi_tpu_torch.models import init_flax_like as init_any, network_selector, rnn
    from deepxi_tpu_torch.ops.kernels import lstm
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    net = init_any(network_selector(nt, 257, 257, d_model=64, n_blocks=2),
                   torch.Generator().manual_seed(4)).to(cuda)
    x = torch.rand(3, 120, 257, generator=torch.Generator().manual_seed(5)) + 1e-3
    x[0, 40:42] = 0.0
    x[2, 90:] = 0.0
    x = x.to(cuda)
    params = list(net.parameters())
    n_dir = 2 * (2 if nt == "ResBiLSTM" else 1)

    def grads():
        return torch.autograd.grad(torch.square(net(x) - 0.5).mean(), params)

    with monkeypatch.context() as m:
        m.setattr(lstm, "_plain_steps", None)        # the plain loop must not run
        m.setattr(lstm, "masked_lstm_backward_plain", None)
        n0, b0 = lstm.masked_lstm.launches, lstm.masked_lstm_backward.launches
        g = grads()
        assert (lstm.masked_lstm.launches - n0,
                lstm.masked_lstm_backward.launches - b0) == (n_dir, n_dir)
        g2 = grads()
    with monkeypatch.context() as m:
        m.setattr(rnn, "masked_lstm", lstm.masked_lstm_plain)
        g_ref = grads()
    torch.cuda.synchronize()
    for (p, _), a, b, r in zip(net.named_parameters(), g, g2, g_ref):
        assert torch.equal(a, b), p
        assert _rel_err(a, r) <= 2e-4, (p, _rel_err(a, r))


def _proj_inputs(B, T, C, H, dtype=torch.float32, seed=0):
    """x [B, T, C] (~N(0, 1)), the four gate kernels [C, H] (~N(0, 1/C)) and
    b [4H] (~N(0, 1))."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(B, T, C, generator=gen, dtype=dtype),
            [torch.randn(C, H, generator=gen, dtype=dtype) * C ** -0.5 for _ in range(4)],
            torch.randn(4 * H, generator=gen, dtype=dtype))


def _proj_err(xp, ref):
    return ((xp.cpu().double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,H", [(96, 626, 512, 512), (8, 256, 512, 512),
                                     (1, 250, 512, 512), (3, 37, 512, 512), (2, 45, 36, 10)])
def test_lstm_input_proj_kernel_matches_float64(cuda, B, T, C, H):
    """The projection kernel (csrc/lstm_input_proj.cu, split TF32 on the
    tensor cores) against the float64 product: xp [T, B, 4H] time-major and
    contiguous, within 1e-6 of its scale (cuBLAS's f32 product: 5e-7 to
    8.4e-7 at C = 512); the first call launches W_x's split and the product,
    a second call the product alone, bitwise. B = 96 T = 626 is the offline
    cell's block, B = 8 T = 256 the train shape, B = 1 T = 250 a 4 s
    utterance (64-wide tiles), 111 and 90 rows no multiple of the 128-row
    tile, C = 36 and 4H = 40 no multiple of the 32-deep k-tile and of the
    tile's columns."""
    from deepxi_tpu_torch.ops.kernels import lstm
    x, w_x, b = _proj_inputs(B, T, C, H, seed=B + T)
    ref = lstm.lstm_input_proj_plain(x.double(), [w.double() for w in w_x], b.double())
    x, w_x, b = x.to(cuda), [w.to(cuda) for w in w_x], b.to(cuda)
    n0, s0 = lstm.lstm_input_proj.launches, lstm.lstm_input_proj.split_launches
    with torch.no_grad():
        xp = lstm.lstm_input_proj(x, w_x, b)
        again = lstm.lstm_input_proj(x, w_x, b)
    torch.cuda.synchronize()
    assert lstm.lstm_input_proj.launches - n0 == 2
    assert lstm.lstm_input_proj.split_launches - s0 == 1
    assert xp.shape == (T, B, 4 * H) and xp.is_contiguous() and torch.equal(xp, again)
    assert _proj_err(xp, ref) <= 1e-6, _proj_err(xp, ref)


@pytest.mark.cuda
def test_lstm_input_proj_splits_again_when_the_weights_change(cuda):
    """An in-place update of a gate kernel (an optimizer step, a
    `load_state_dict`) makes the split anew: the next call reads the new
    weights, within 1e-6 of the float64 product of them."""
    from deepxi_tpu_torch.ops.kernels import lstm
    x, w_x, b = _proj_inputs(2, 50, 64, 32, seed=3)
    x, w_x, b = x.to(cuda), [torch.nn.Parameter(w.to(cuda)) for w in w_x], b.to(cuda)
    with torch.no_grad():
        lstm.lstm_input_proj(x, w_x, b)
        s0 = lstm.lstm_input_proj.split_launches
        w_x[1].mul_(-2.0)
        w_x[3].add_(0.5)
        xp = lstm.lstm_input_proj(x, w_x, b)
    torch.cuda.synchronize()
    assert lstm.lstm_input_proj.split_launches - s0 == 1
    ref = lstm.lstm_input_proj_plain(x.double().cpu(), [w.double().cpu() for w in w_x],
                                     b.double().cpu())
    assert _proj_err(xp, ref) <= 1e-6, _proj_err(xp, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,H", [(96, 626, 512, 512), (3, 37, 36, 10)])
def test_lstm_input_proj_float64_kernel(cuda, B, T, C, H):
    """float64 takes the FMA kernel: one launch, no split, within 1e-13 of
    the float64 product's scale on the CPU."""
    from deepxi_tpu_torch.ops.kernels import lstm
    x, w_x, b = _proj_inputs(B, T, C, H, dtype=torch.float64, seed=B + T)
    ref = lstm.lstm_input_proj_plain(x, w_x, b)
    n0, s0 = lstm.lstm_input_proj.launches, lstm.lstm_input_proj.split_launches
    with torch.no_grad():
        xp = lstm.lstm_input_proj(x.to(cuda), [w.to(cuda) for w in w_x], b.to(cuda))
    torch.cuda.synchronize()
    assert lstm.lstm_input_proj.launches - n0 == 1
    assert lstm.lstm_input_proj.split_launches == s0
    assert xp.shape == (T, B, 4 * H) and xp.dtype == torch.float64 and xp.is_contiguous()
    assert _proj_err(xp, ref) <= 1e-13, _proj_err(xp, ref)


@pytest.mark.cuda
def test_lstm_input_proj_routes_and_refuses_on_the_card(cuda):
    """Inputs the kernels do not take raise on the card before any launch
    (float32 with an input width that is no multiple of 4, mixed dtypes,
    float16, shapes that do not fit); no rows give an empty xp and no
    launch."""
    from deepxi_tpu_torch.ops.kernels import lstm
    n0, s0 = lstm.lstm_input_proj.launches, lstm.lstm_input_proj.split_launches
    x, w_x, b = _proj_inputs(2, 9, 16, 8)
    x, w_x, b = x.to(cuda), [w.to(cuda) for w in w_x], b.to(cuda)
    for bad in ((x, [w[:12] for w in w_x], b), (x, w_x, b[:8]), (x[0], w_x, b),
                (x, w_x[:3], b), (x, w_x, b.double()),
                (x.half(), [w.half() for w in w_x], b.half()),
                (x[..., :6], [w[:6] for w in w_x], b)):
        with pytest.raises(ValueError, match="float32 with C a multiple of 4 or float64"):
            lstm.lstm_input_proj(*bad)
    empty = lstm.lstm_input_proj(x[:, :0], w_x, b)
    assert empty.shape == (0, 2, 32) and empty.device == x.device
    assert (lstm.lstm_input_proj.launches, lstm.lstm_input_proj.split_launches) == (n0, s0)


@pytest.mark.cuda
def test_resbilstm_inference_takes_the_projection_kernel(cuda, monkeypatch):
    """A ResBiLSTM call with grad off on the card (d_model 64, 2 blocks, an
    interior all-zero frame and a padded tail) takes the projection kernel
    once a direction a block, within 1e-5 of its scale of the same network
    on cuBLAS's product and the copy."""
    from deepxi_tpu_torch.models import init_flax_like as init_any, network_selector, rnn
    from deepxi_tpu_torch.ops.kernels import lstm
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    net = init_any(network_selector("ResBiLSTM", 257, 257, d_model=64, n_blocks=2),
                   torch.Generator().manual_seed(6)).to(cuda)
    x = torch.rand(3, 120, 257, generator=torch.Generator().manual_seed(7)) + 1e-3
    x[0, 40:42] = 0.0
    x[2, 90:] = 0.0
    x = x.to(cuda)
    with torch.no_grad():
        n0, s0 = lstm.lstm_input_proj.launches, lstm.lstm_input_proj.split_launches
        y = net(x)
        assert lstm.lstm_input_proj.launches - n0 == 4
        assert lstm.lstm_input_proj.split_launches - s0 == 4
        monkeypatch.setattr(rnn, "lstm_input_proj", lstm.lstm_input_proj_plain)
        y_ref = net(x)
    torch.cuda.synchronize()
    assert _rel_err(y, y_ref) <= 1e-5, _rel_err(y, y_ref)


@pytest.mark.cuda
def test_projection_launches_in_reslstm_inference_not_in_training(cuda):
    """reslstm-1.0c's widths (257 in, d_model 512, 5 blocks): a call with
    grad off launches the projection 5 times and W_x's split 5 times, a
    second call the projection alone; a train step's forward and backward
    neither (its product is autograd's addmm); after an SGD step the next
    call splits the new weights again and gives the network's output on
    them."""
    from deepxi_tpu_torch.models import init_flax_like as init_any, network_selector, rnn
    from deepxi_tpu_torch.ops.kernels import lstm
    net = init_any(network_selector("ResLSTM", 257, 257, d_model=512, n_blocks=5),
                   torch.Generator().manual_seed(8)).to(cuda)
    x = (torch.rand(2, 100, 257, generator=torch.Generator().manual_seed(9)) + 1e-3).to(cuda)

    def counts():
        return lstm.lstm_input_proj.launches, lstm.lstm_input_proj.split_launches

    n0, s0 = counts()
    with torch.no_grad():
        net(x)
        assert counts() == (n0 + 5, s0 + 5)
        net(x)
    assert counts() == (n0 + 10, s0 + 5)
    torch.square(net(x) - 0.5).mean().backward()
    torch.cuda.synchronize()
    assert counts() == (n0 + 10, s0 + 5)
    assert all(p.grad is not None for p in net.parameters())
    with torch.no_grad():
        for p in net.parameters():
            p.sub_(0.1 * p.grad)
        y = net(x)
        assert counts() == (n0 + 15, s0 + 10)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rnn, "lstm_input_proj", lstm.lstm_input_proj_plain)
            y_ref = net(x)
    torch.cuda.synchronize()
    assert _rel_err(y, y_ref) <= 1e-5, _rel_err(y, y_ref)


@pytest.mark.cuda
def test_tracker_and_mixmax_on_the_card_match_float64(cuda):
    """MCRA and IMCRA OM-LSA, and MixMax with noise tracking and posteriors,
    on the card in float32 under `set_sync_debug_mode("error")` (no frame
    loop reads back from the card) against the same calls on the CPU in
    float64: within 1e-4 of each output's scale (float32 against float64 on
    the CPU: up to 4.3e-6)."""
    import numpy as np

    from deepxi_tpu_torch.dsp import mixmax, trackers
    rng = np.random.RandomState(0)
    T, F, P = 230, 257, 9
    pwr = np.abs(rng.randn(T, F)) ** 2 * 0.5 + 0.05
    pwr *= 1 + ((np.sin(np.arange(T) / 9.0) > 0.3)[:, None] * 20 * rng.rand(1, F)
                * np.abs(rng.randn(T, F)) ** 2)
    arrays = (rng.randn(P, F) - 2.5, 0.5 + rng.rand(P, F))
    post = rng.rand(T, P)
    post /= post.sum(1, keepdims=True)

    def inputs(dev, dtype):
        t = [torch.tensor(a, dtype=dtype, device=dev) for a in arrays + (post, np.sqrt(pwr))]
        m, s, p, mag = t
        mm = mixmax.MixMaxModel(m, s, m[0], s[0], torch.full((P,), 1.0 / P, dtype=dtype,
                                                               device=dev))
        return mm, p, mag, torch.log(torch.clamp(mag, min=1.2e-7))

    def run(mm, p, mag, log_mag):
        return [trackers.omlsa_enhance(mag), trackers.omlsa_enhance(mag, tracker="imcra"),
                mixmax.enhance(mm, log_mag, p)]

    ref = run(*inputs("cpu", torch.float64))
    args = inputs(cuda, torch.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, r in zip(got, ref):
        assert g.device.type == "cuda" and g.dtype == torch.float32 and g.shape == r.shape
        assert (g.double().cpu() - r).abs().max().item() <= 1e-4 * r.abs().max().item()


@pytest.fixture
def nccl_world1(cuda, tmp_path):
    """A one-rank NCCL group (a `file://` rendezvous) for the test, left
    after it: the card's machine has one card, and NCCL puts no two ranks on
    one card."""
    import torch.distributed as dist

    from deepxi_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed(f"file://{tmp_path}/rendezvous", world_size=1, rank=0)
    try:
        assert dist.get_backend() == "nccl"
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def _small_magxi(dev):
    from deepxi_tpu_torch.inp_tgt import MagXi
    from deepxi_tpu_torch.ops.maps import NormalCDF
    g = torch.Generator().manual_seed(3)
    return MagXi(xi_map=NormalCDF(use_db=True, mu=(torch.randn(257, generator=g) * 5).to(dev),
                                  sigma=(torch.rand(257, generator=g) * 5 + 5).to(dev)))


@pytest.mark.cuda
def test_dp_step_on_the_1x1_nccl_mesh_is_the_unsharded_step(nccl_world1):
    """A train step of a small ResNetV2 through the fused training stack
    (B5/B6 at d_model 32) on the 1 x 1 mesh of a one-rank NCCL group: the
    loss and parameters bitwise the unsharded step's, and B5/B6 launched."""
    from deepxi_tpu_torch.ops.kernels.tcn_fused_train import resnetv2_apply_fused_train
    from deepxi_tpu_torch.parallel.mesh import mesh_shape
    from deepxi_tpu_torch.training import (TrainState, make_optimizer, make_train_step,
                                           shard_state, shardings_of)
    dev = torch.device("cuda")
    assert mesh_shape(nccl_world1) == {"data": 1, "model": 1}
    net = ResNetV2(257, 257, n_blocks=3, d_model=32, d_f=16, k=3, max_d_rate=2)
    init_flax_like(net, torch.Generator().manual_seed(0))
    net.to(dev)
    params = {k: (v + 0.05 if v.ndim == 1 else v) for k, v in net.state_dict().items()}
    g = torch.Generator().manual_seed(1)
    s = (torch.randn(4, 8192, generator=g) * 3000).to(torch.int16).to(dev)
    d = (torch.randn(4, 8192, generator=g) * 1000).to(torch.int16).to(dev)
    lens = torch.tensor([8192, 6000, 8192, 7000])
    snr = torch.tensor([0.0, 5.0, 10.0, -5.0])
    tx = make_optimizer("ResNetV2")
    apply = (lambda p, m: resnetv2_apply_fused_train(p, m, n_blocks=3, max_d_rate=2, k=3,
                                                     save_acts=True))
    shardings = shardings_of(nccl_world1, params)
    out = {}
    for name, mesh in (("mesh", nccl_world1), ("none", None)):
        state = TrainState.create(params, tx)
        if mesh is not None:
            state = shard_state(mesh, state, shardings)
        step = make_train_step(net, _small_magxi(dev), tx, apply_fn=apply, mesh=mesh,
                               shardings=shardings if mesh is not None else None)
        n5 = tcn_fused_train.fused_block_group_whole_saved.launches
        for _ in range(2):
            state, m = step(state, s, d, lens, lens, snr,
                            generator=torch.Generator().manual_seed(7))
        out[name] = (m["loss"].item(), state.params,
                     tcn_fused_train.fused_block_group_whole_saved.launches - n5)
    assert out["mesh"][0] == out["none"][0] and out["mesh"][2] == out["none"][2] > 0
    assert all(torch.equal(out["mesh"][1][k], out["none"][1][k]) for k in params)


@pytest.mark.cuda
def test_seq_sharded_enhancer_on_the_1x1_nccl_mesh(nccl_world1):
    """The sequence-sharded enhancer of a small causal ResNetV2 through the
    fused TCN kernels on the 1 x 1 mesh against the offline enhancer on the
    card: 2e-5 (the JAX package's limit for its sharded enhancer)."""
    import numpy as np

    from deepxi_tpu_torch.enhance import make_enhancer
    from deepxi_tpu_torch.parallel.seq_enhance import make_seq_sharded_enhancer
    dev = torch.device("cuda")
    net = ResNetV2(257, 257, n_blocks=6, d_model=32, d_f=16, k=3, max_d_rate=4)
    init_flax_like(net, torch.Generator().manual_seed(2))
    params = {k: (v + 0.05 if v.ndim == 1 else v).to(dev) for k, v in net.state_dict().items()}
    kw = dict(n_blocks=6, max_d_rate=4, k=3)
    apply = (lambda p, m: tcn_fused.resnetv2_apply_fused(p, m, **kw))
    it = _small_magxi(dev)
    x = (np.random.RandomState(1).randn(256 * 1300 + 77) * 3000).astype(np.int16)
    n1, n4 = (f.launches for f in (tcn_fused.fused_block_group_whole,
                                   tcn_fused.fused_block_group))
    y = make_seq_sharded_enhancer(it, net, mesh=nccl_world1, apply_fn=apply, device=dev,
                                  **kw)(params, x)
    assert tcn_fused.fused_block_group_whole.launches > n1
    assert tcn_fused.fused_block_group.launches > n4
    y_off = make_enhancer(it, net, apply_fn=apply, device=dev)(params, x[None])[0, :len(x)]
    assert y.shape == (len(x),) and y_off.abs().max().item() > 1e-3
    assert (y - y_off).abs().max().item() <= 2e-5
