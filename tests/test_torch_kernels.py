"""The CUDA kernels K1-K9 against their plain versions at ragged and full
shapes, and the bi-GRU's, the fused pool's and the affinity attention's
gradients on the card against the CPU.  They need the card (a CUDA kernel
has no CPU mode): the ``cuda`` fixture skips them elsewhere.  On a machine
with a card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import pytest
import torch

from umpr_tpu_torch.ops import gru_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("M,E,N", [(1, 50, 384), (130, 17, 100), (130, 17, 102),
                                   (51200, 50, 384), (1000, 300, 384), (1000, 400, 384),
                                   (3000, 520, 102), (1048576, 50, 384)])
def test_gru_input_proj_matches_plain(cuda, M, E, N):
    """N = 102 (odd H): an odd row length, stored one float at a time;
    E = 300 and 400 take the mma.sync kernel (word2vec widths), E = 520
    the one that reads its fragments from global memory; w is scaled so
    that every case's sums have the spread of E = 50's.  Two launches give
    the same bits."""
    g = torch.Generator().manual_seed(M)
    x, w, b = (torch.randn(s, generator=g).to(cuda) for s in ((M, E), (E, N), (N,)))
    w *= min(1.0, (50 / E) ** 0.5)
    before = gru_cuda.gru_input_proj.launches
    out = gru_cuda.gru_input_proj(x, w, b)
    torch.cuda.synchronize()
    assert gru_cuda.gru_input_proj.launches == before + 1
    torch.testing.assert_close(out, gru_cuda.gru_input_proj_ref(x, w, b),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(gru_cuda.gru_input_proj(x, w, b), out)


def test_gru_input_proj_past_the_old_grid_cap(cuda):
    """4,194,240 rows (65,535 x 64) was the old kernel's grid cap; the
    persistent grid has none.  Sampled row slices against the plain
    version, the cap's neighbourhood among them."""
    M, E, N, cap = 4_194_240 + 4_103, 50, 384, 4_194_240
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(M, E, generator=g, device=cuda)
    w = torch.randn(E, N, generator=g, device=cuda)
    b = torch.randn(N, generator=g, device=cuda)
    out = gru_cuda.gru_input_proj(x, w, b)
    torch.cuda.synchronize()
    for lo in (0, M // 2, cap - 700, M - 1500):
        rows = slice(lo, lo + 1500)
        torch.testing.assert_close(out[rows], gru_cuda.gru_input_proj_ref(x[rows], w, b),
                                   rtol=1e-5, atol=1e-5)
    assert torch.equal(gru_cuda.gru_input_proj(x, w, b), out)


@pytest.mark.parametrize("N,L,H", [(1, 1, 64), (37, 5, 32), (300, 20, 64), (50, 9, 128),
                                   (37, 5, 8), (50, 9, 100), (40, 7, 256), (20, 4, 192),
                                   (3, 2, 1900)])
def test_bigru_recurrence_matches_plain(cuda, N, L, H):
    """H = 8 and 100 (gru_size 8 and 100) run the shared-memory kernel with
    a ragged block; H = 192 and 256 the wide kernel, W_hh from L2; H =
    1900 keeps the wide kernel's state in global scratch.  Two launches
    give the same bits."""
    g = torch.Generator().manual_seed(N)
    xg = torch.randn(N, L, 6 * H, generator=g).to(cuda)
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    lengths[0] = L
    lengths[-1] = 1
    lengths = lengths.to(cuda)
    w_hh = (torch.rand(2, H, 3 * H, generator=g) / H ** 0.5).to(cuda)
    b_hh = (torch.rand(2, 3 * H, generator=g) / H ** 0.5).to(cuda)
    y = gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        y, gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh),
        rtol=1e-5, atol=1e-5)
    past = torch.arange(L, device=cuda)[None, :] >= lengths[:, None]
    assert (y[past] == 0).all()
    assert torch.equal(gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh), y)


@pytest.mark.parametrize("N,L,H,lengths_kind", [
    (300, 20, 64, "all_1"), (300, 20, 64, "all_L"), (40, 9, 64, "adjacent_L"),
    (16385, 20, 64, "mixed"), (2000, 64, 64, "mixed"), (40, 9, 100, "adjacent_L"),
    (37, 5, 8, "all_1"), (50, 9, 33, "mixed"), (33, 6, 1, "all_L"), (40, 9, 256, "mixed"),
    (300, 20, 128, "mixed")])
def test_bigru_recurrence_rows_by_length(cuda, N, L, H, lengths_kind):
    """K2 walks 16-row tiles of the rows ordered by length (a counting
    sort whose order within a length varies from run to run): all rows 1
    or L long, two full rows side by side, 16,385 rows
    (a ragged last tile after sorting), L = 64 (the long-history length),
    odd H (33, 1: the padded unit) and the wide kernel (H = 256).  Within
    1e-5 of the plain version, exact zeros past each length, and the same
    bits on a second launch."""
    _, xg, _, _, _, lengths, w_hh, b_hh = _backward_inputs(cuda, N, L, H, lengths_kind)
    before = gru_cuda.bigru_recurrence.launches
    y = gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_recurrence.launches == before + 1
    torch.testing.assert_close(y, gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh),
                               rtol=1e-5, atol=1e-5)
    past = torch.arange(L, device=cuda)[None, :] >= lengths[:, None]
    assert (y[past] == 0).all()
    assert torch.equal(gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh), y)


def _backward_inputs(cuda, N, L, H, lengths_kind, E=17, S=1):
    g = torch.Generator().manual_seed(N * 7 + H)
    x = torch.randn(N * L, E, generator=g).to(cuda)
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    if lengths_kind == "all_1":
        lengths[:] = 1
    elif lengths_kind == "all_L":
        lengths[:] = L
    elif lengths_kind == "adjacent_L":  # two full rows side by side
        lengths[0], lengths[1], lengths[-1] = L, L, 1
    else:
        lengths[0], lengths[-1] = L, 1
    lengths = lengths.to(cuda)
    w_ih = (torch.rand(E, 6 * H, generator=g) / H ** 0.5).to(cuda)
    b_ih = (torch.rand(6 * H, generator=g) / H ** 0.5).to(cuda)
    w_hh = (torch.rand(2, H, 3 * H, generator=g) / H ** 0.5).to(cuda)
    b_hh = (torch.rand(2, 3 * H, generator=g) / H ** 0.5).to(cuda)
    xg = gru_cuda.gru_input_proj_ref(x, w_ih, b_ih).view(N, L, 6 * H)
    y = gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh)
    dy_sent = torch.randn(N, L, 2 * H, generator=g).to(cuda)
    dy_pos = torch.randn(N // S, S * L, 2 * H, generator=g).to(cuda)
    return x, xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh


def _close_rel(got, want, rtol):
    scale = want.abs().max().clamp(min=1.0)
    assert (got - want).abs().max() <= rtol * scale, (got - want).abs().max()


@pytest.mark.parametrize("N,L,H,lengths_kind", [
    (1, 1, 64, "mixed"), (1, 7, 32, "all_L"), (37, 5, 32, "mixed"),
    (300, 20, 64, "mixed"), (64, 20, 64, "all_1"), (64, 20, 64, "all_L"),
    (50, 9, 128, "mixed"), (33, 6, 96, "mixed"), (37, 5, 8, "mixed"), (50, 9, 100, "mixed"),
    (64, 20, 100, "all_L"), (40, 7, 256, "mixed"), (20, 4, 48, "mixed"), (20, 4, 192, "all_1"),
    (130, 20, 100, "mixed"), (9, 3, 800, "mixed"), (40, 9, 64, "adjacent_L"),
    (40, 9, 100, "adjacent_L"), (40, 9, 256, "adjacent_L"), (65600, 16, 64, "mixed"),
    (30, 7, 33, "mixed"), (20, 5, 1, "mixed")])
def test_bigru_backward_matches_plain(cuda, N, L, H, lengths_kind):
    """Every H runs the hg pass (wgmma, depth chunks of 128 past H = 128),
    the row order, a sweep and the dW pass (3xTF32 split-K, then a
    fixed-order sum).  Up to H = 128 the sweep keeps W_hh in shared memory
    (KS slices: 16 at H = 8, 1 at H = 128); past it (192, 256, 800) the
    wide sweep reads W_hh^T from L2, and at H = 800 its state lies in
    global scratch.  Two full rows side by side (adjacent_L) fail unless
    the dW pass masks h_prev at each direction's first step; 65,600 x 16 =
    1,049,600 rows pass 2^20 and 2^16 - 1 blocks of 16 rows, in 864
    chunks; H = 33 and 1 take the 4-byte copies and single stores of widths
    that are not multiples of 4."""
    _, xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh = _backward_inputs(
        cuda, N, L, H, lengths_kind)
    before = gru_cuda.bigru_backward.launches
    dxg, dw, db = gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_backward.launches == before + 1
    want = gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    torch.testing.assert_close(dxg, want[0], rtol=1e-5, atol=1e-5)
    _close_rel(dw, want[1], 1e-4)  # sums over N*L rows in another order
    _close_rel(db, want[2], 1e-4)
    past = torch.arange(L, device=cuda)[None, :] >= lengths[:, None]
    assert (dxg[past] == 0).all()
    again = gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    for a, b in zip(again, (dxg, dw, db)):  # fixed-order sums: same bits
        assert torch.equal(a, b)


@pytest.mark.parametrize("M,E,G", [(1, 50, 384), (130, 17, 100), (130, 17, 102), (0, 17, 192),
                                   (5000, 17, 192), (51200, 50, 384), (1000, 300, 384),
                                   (1000, 400, 384), (777, 521, 102), (1048576, 50, 384)])
def test_gru_input_proj_bwd_matches_plain(cuda, M, E, G):
    """G = 102: dxg rows copied 4 bytes at a time; E = 300: five E tiles;
    E = 400 and 521: past the whole-row x copy, each block copies its E
    tile (521: 4 bytes at a time); 1,048,576 rows: 863 chunks of 1,216."""
    g = torch.Generator().manual_seed(M + E)
    x = torch.randn(M, E, generator=g).to(cuda)
    dxg = torch.randn(M, G, generator=g).to(cuda)
    before = gru_cuda.gru_input_proj_bwd.launches
    dw, db = gru_cuda.gru_input_proj_bwd(x, dxg)
    torch.cuda.synchronize()
    assert gru_cuda.gru_input_proj_bwd.launches == before + 1
    want_dw, want_db = gru_cuda.gru_input_proj_bwd_ref(x, dxg)
    _close_rel(dw, want_dw, 1e-4)
    _close_rel(db, want_db, 1e-4)
    again = gru_cuda.gru_input_proj_bwd(x, dxg)
    assert torch.equal(again[0], dw) and torch.equal(again[1], db)


def test_bigru_split_grads_on_the_card_match_the_cpu(cuda):
    from umpr_tpu_torch.ops.gru import BiGRU, bigru_split
    g = torch.Generator().manual_seed(3)
    N, L, E, H, S = 40, 9, 17, 64, 4
    x = torch.randn(N, L, E, generator=g)
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    c_pos = torch.randn(N // S, S * L, 2 * H, generator=g)
    c_sent = torch.randn(N, L, 2 * H, generator=g)
    grads = []
    for dev in ("cpu", cuda):
        gru = BiGRU(E, H, generator=torch.Generator().manual_seed(4)).to(dev)
        pos, sent = bigru_split(gru, x.to(dev), lengths.to(dev), S)
        ((pos * c_pos.to(dev)).sum() + (sent * c_sent.to(dev)).sum()).backward()
        grads.append({n: p.grad.cpu() for n, p in gru.named_parameters()})
    for n, want in grads[0].items():
        _close_rel(grads[1][n], want, 1e-4)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn(8, 4, device=cuda)
    w = torch.randn(4, 12, device=cuda)
    b = torch.randn(12, device=cuda)
    with pytest.raises(TypeError):
        gru_cuda.gru_input_proj(x.bfloat16(), w.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError):
        gru_cuda.gru_input_proj(x, w.t().contiguous().t(), b)
    with pytest.raises(ValueError):  # w_hh of another H than xg's
        gru_cuda.bigru_recurrence(
            torch.zeros(2, 3, 6 * 192, device=cuda),
            torch.ones(2, dtype=torch.int32, device=cuda),
            torch.zeros(2, 191, 3 * 191, device=cuda), torch.zeros(2, 3 * 191, device=cuda))
    with pytest.raises(TypeError):
        gru_cuda.bigru_recurrence(
            torch.zeros(2, 3, 6, device=cuda), torch.ones(2, device=cuda),
            torch.zeros(2, 1, 3, device=cuda), torch.zeros(2, 3, device=cuda))
    H = 48
    z = torch.zeros(2, 3, 2 * H, device=cuda)
    with pytest.raises(ValueError, match="H=48"):  # dy_sent of another length
        gru_cuda.bigru_backward(
            torch.zeros(2, 3, 6 * H, device=cuda), z, z[:, :2].contiguous(), z,
            torch.ones(2, dtype=torch.int32, device=cuda),
            torch.zeros(2, H, 3 * H, device=cuda), torch.zeros(2, 3 * H, device=cuda))
    with pytest.raises(ValueError):
        gru_cuda.gru_input_proj_bwd(x, torch.zeros(7, 12, device=cuda))
    with pytest.raises(RuntimeError, match="BiGRUSplit"):
        gru_cuda.gru_input_proj(x, w.requires_grad_(), b)


@pytest.mark.parametrize("N,H,W,C,kind", [
    (1, 2, 2, 3, "normal"), (1, 2, 2, 64, "normal"), (2, 4, 6, 128, "normal"),
    (1, 2, 2, 512, "normal"), (3, 6, 14, 64, "grid"), (2, 8, 10, 3, "grid"),
    (2, 4, 4, 64, "tie"), (1, 10, 10, 5, "tie"), (1, 56, 56, 256, "grid"),
    (2, 6, 8, 64, "nan"), (1, 4, 4, 3, "nan")])
def test_bias_relu_pool_kernels_match_plain_bit_for_bit(cuda, N, H, W, C, kind):
    """W = 6, 10, 14: W/2 positions do not fill a block's position rows;
    C = 3, 5: the one-channel path; "tie": every window all equal; "nan":
    NaN inputs pool to NaN with argmax 3, and pass no gradient."""
    from umpr_tpu_torch.ops import pool_cuda
    g = torch.Generator().manual_seed(N * H * W + C)
    x = torch.randn(N, H, W, C, generator=g)
    b = torch.randn(C, generator=g) * 0.1
    if kind == "grid":
        x, b = (x * 2).round() / 2, (b * 4).round() / 4
    if kind == "tie":
        x = x[:, ::2, ::2].repeat_interleave(2, 1).repeat_interleave(2, 2).contiguous()
    if kind == "nan":
        x[torch.rand(x.shape, generator=g) < 0.05] = float("nan")
    dyp = torch.randn(N, H // 2, W // 2, C, generator=g)
    x, b, dyp = x.to(cuda), b.to(cuda), dyp.to(cuda)
    before = (pool_cuda.bias_relu_pool.launches, pool_cuda.bias_relu_pool_bwd.launches)
    yp, idx = pool_cuda.bias_relu_pool(x, b)
    dx, db = pool_cuda.bias_relu_pool_bwd(dyp, idx, yp)
    torch.cuda.synchronize()
    assert (pool_cuda.bias_relu_pool.launches,
            pool_cuda.bias_relu_pool_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_yp, want_idx = pool_cuda.bias_relu_pool_ref(x, b)
    want_dx, want_db = pool_cuda.bias_relu_pool_bwd_ref(dyp, want_idx, want_yp)
    torch.testing.assert_close(yp, want_yp, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(idx, want_idx) and torch.equal(dx, want_dx)
    if kind == "nan":
        assert yp.isnan().any() and (idx[yp.isnan()] == 3).all()
        assert torch.isfinite(dx).all() and torch.isfinite(db).all()
    g64 = torch.where(want_yp > 0, dyp, 0.0).double().sum((0, 1, 2))
    _close_rel(db.double(), g64, 1e-5)
    if kind == "tie":
        assert not idx.any()  # every tie went to the first corner
    again = (*pool_cuda.bias_relu_pool(x, b), *pool_cuda.bias_relu_pool_bwd(dyp, idx, yp))
    for a, c in zip(again, (yp, idx, dx, db)):
        torch.testing.assert_close(a, c, rtol=0, atol=0, equal_nan=True)


def test_fused_bias_relu_pool_grads_on_the_card_match_the_cpu(cuda):
    from umpr_tpu_torch.ops.pool import fused_bias_relu_pool
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 12, 10, 64, generator=g)
    b = torch.randn(64, generator=g) * 0.1
    c = torch.randn(2, 6, 5, 64, generator=g)
    out = []
    for dev in ("cpu", cuda):
        xd, bd = (t.detach().to(dev).requires_grad_() for t in (x, b))
        y = fused_bias_relu_pool(xd, bd)
        (y * c.to(dev)).sum().backward()
        out.append((y.detach().cpu(), xd.grad.cpu(), bd.grad.cpu()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    _close_rel(out[1][2], out[0][2], 1e-5)


def test_pool_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from umpr_tpu_torch.ops import pool_cuda
    x = torch.randn(1, 4, 4, 8, device=cuda)
    b = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError):
        pool_cuda.bias_relu_pool(x.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        pool_cuda.bias_relu_pool(x.permute(0, 2, 1, 3), b)
    with pytest.raises(ValueError, match="even"):
        pool_cuda.bias_relu_pool(x[:, :3], b)
    with pytest.raises(RuntimeError, match="FusedBiasReluPool"):
        pool_cuda.bias_relu_pool(x.requires_grad_(), b)


@pytest.mark.parametrize("M,G,E", [(1, 384, 50), (130, 100, 17), (0, 192, 17),
                                   (5000, 192, 70), (51200, 384, 50), (3000, 384, 400),
                                   (777, 102, 521), (51200, 600, 50), (20000, 1536, 50),
                                   (4000, 48, 50), (1000, 384, 64), (1000, 386, 57)])
def test_gru_input_proj_dx_matches_plain(cuda, M, G, E):
    """6H = 384 at E <= 64: the wgmma kernel (n = 56 or 64), 6H = 192 at E
    = 70: its n = 128 form; 6H = 600 and 1,536 (gru_size 100 and 256), E
    = 400 and 521: past its shared memory, the mma.sync kernel; 6H = 48
    (gru_size 8) and 386: ragged depth.  Two launches give the same
    bits."""
    g = torch.Generator().manual_seed(M + G)
    dxg = torch.randn(M, G, generator=g).to(cuda)
    w = torch.randn(E, G, generator=g).to(cuda)
    before = gru_cuda.gru_input_proj_dx.launches
    dx = gru_cuda.gru_input_proj_dx(dxg, w)
    torch.cuda.synchronize()
    assert gru_cuda.gru_input_proj_dx.launches == before + 1
    assert dx.shape == (M, E)
    if M:
        _close_rel(dx, gru_cuda.gru_input_proj_dx_ref(dxg, w), 1e-5)
    assert torch.equal(gru_cuda.gru_input_proj_dx(dxg, w), dx)


def test_gru_input_proj_dx_past_the_old_grid_cap(cuda):
    """4,194,240 rows (65,535 x 64) was the old kernel's grid cap; the
    persistent grid has none.  Sampled row slices against the plain
    version, the cap's neighbourhood among them."""
    M, G, E, cap = 4_194_240 + 4_103, 384, 50, 4_194_240
    g = torch.Generator(device=cuda).manual_seed(12)
    dxg = torch.randn(M, G, generator=g, device=cuda)
    w = torch.randn(E, G, generator=g, device=cuda) / G ** 0.5
    dx = gru_cuda.gru_input_proj_dx(dxg, w)
    torch.cuda.synchronize()
    for lo in (0, M // 2, cap - 700, M - 1500):
        rows = slice(lo, lo + 1500)
        _close_rel(dx[rows], gru_cuda.gru_input_proj_dx_ref(dxg[rows], w), 1e-5)
    assert torch.equal(gru_cuda.gru_input_proj_dx(dxg, w), dx)


def test_bigru_split_input_grad_on_the_card_matches_the_cpu(cuda):
    from umpr_tpu_torch.ops.gru import BiGRU, bigru_split
    g = torch.Generator().manual_seed(13)
    N, L, E, H, S = 40, 9, 17, 64, 4
    x = torch.randn(N, L, E, generator=g)
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    c_pos = torch.randn(N // S, S * L, 2 * H, generator=g)
    c_sent = torch.randn(N, L, 2 * H, generator=g)
    dx = []
    for dev in ("cpu", cuda):
        gru = BiGRU(E, H, generator=torch.Generator().manual_seed(4)).to(dev)
        xd = x.to(dev).detach().requires_grad_()
        pos, sent = bigru_split(gru, xd, lengths.to(dev), S)
        ((pos * c_pos.to(dev)).sum() + (sent * c_sent.to(dev)).sum()).backward()
        dx.append(xd.grad.cpu())
    _close_rel(dx[1], dx[0], 1e-5)


def _attention_inputs(B, P, D, kind, seed=0):
    """U, I (B, P, D), M (D, D), exists (P,) bool on the CPU.  kind: "rand"
    (80% existing), "all", "none" (every row and column masked), "tie"
    (tanh exactly +-1 nearly everywhere), "nan" (a NaN in an existing row
    of T, one in a masked column of U)."""
    g = torch.Generator().manual_seed(seed * 1000 + B * P + D)
    U = torch.randn(B, P, D, generator=g)
    I = torch.randn(B, P, D, generator=g)
    M = torch.randn(D, D, generator=g) * (10.0 if kind == "tie" else 0.005)
    exists = torch.rand(P, generator=g) < 0.8
    if kind == "all":
        exists[:] = True
    elif kind == "none":
        exists[:] = False
    elif kind == "nan":
        exists[:] = True
        exists[P // 2:] = False
        I[0, 0, 0] = float("nan")
        U[-1, P - 1, 0] = float("nan")
    elif kind == "nan_rank":  # a NaN score inside one of K8's blocks' positions only
        exists[:] = True
        exists[P - P // 10:] = False
        U[0, 5 * P // 8 + 1, 0] = float("nan")  # colmax of sample 0 at one position
        I[-1, 2 * P // 8 + 1, 0] = float("nan")  # row_val of the last sample at one
    return U, I, M, exists


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("B,P,D,kind", [
    (1, 1, 128, "all"), (1, 1, 128, "none"), (2, 130, 128, "rand"), (3, 300, 100, "rand"),
    (2, 257, 16, "all"), (1, 1000, 128, "rand"), (2, 200, 128, "none"), (2, 300, 128, "tie"),
    (2, 260, 100, "tie"), (2, 150, 128, "nan"), (1, 129, 100, "nan"), (2, 300, 16, "rand"),
    (2, 257, 200, "rand"), (1, 300, 512, "rand"), (3, 77, 128, "rand"), (2, 450, 128, "rand"),
    (2, 333, 50, "rand"), (2, 200, 16, "tie"), (1, 260, 512, "nan"), (2, 63, 200, "all"),
    (2, 1003, 128, "rand"), (2, 3, 128, "rand"), (1, 3, 50, "all"), (1, 8192, 128, "rand"),
    (2, 8192, 128, "tie"), (200, 300, 128, "rand"), (2, 1000, 128, "nan_rank"),
    (2, 1003, 200, "nan_rank"), (3, 5, 16, "none")])
def test_affinity_kernels_match_plain(cuda, B, P, D, kind):
    """K7, then K8 on K7's partials, against their plain versions on the same
    card inputs: P not a multiple of the 128-row tile or the 64-column
    tile, P < 128, P = 1, B = 1; D = 16, 50, 100, 128 (the wgmma kernel;
    50: U's rows copied 4 bytes at a time) and 200, 512 (gru_size 100 and
    256: the CUDA-core kernel); every position masked, exact ties, NaN;
    two launches give the same bits.  K8 splits a sample's positions over
    a cluster of 8 blocks: P not a multiple of 8 (1003), P < 8 (1, 3, 5:
    blocks with no position), P = 8192 at B = 1 and 2, B = 200 (more
    clusters than SMs), a NaN inside one block's positions only."""
    from umpr_tpu_torch.ops import attention_cuda as ac
    U, I, M, exists = (t.to(cuda) for t in _attention_inputs(B, P, D, kind))
    T = I @ M
    before = (ac.affinity_tiles.launches, ac.affinity_finish.launches)
    parts = ac.affinity_tiles(T, U, exists)
    out = ac.affinity_finish(parts[0], parts[1], parts[2], exists, U, I)
    torch.cuda.synchronize()
    assert (ac.affinity_tiles.launches, ac.affinity_finish.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    want = ac.affinity_tiles_ref(T, U, exists)
    for got, ref in zip(parts[::2], want[::2]):  # the maxima, f32 sums in another order
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6, equal_nan=True)
    for got, ref in zip(parts[1::2], want[1::2]):  # the first argmax, exactly
        assert torch.equal(got, ref)
    ref_out = ac.affinity_finish_ref(parts[0], parts[1], parts[2], exists, U, I)
    for got, ref in zip(out[:4], ref_out[:4]):  # soft_u, soft_i, atte_u, atte_i
        scale = ref.abs().nan_to_num().max().clamp(min=1e-30)
        torch.testing.assert_close(got / scale, ref / scale, rtol=0, atol=1e-5,
                                   equal_nan=True)
    _same(out[4], ref_out[4])  # colmax: the same partials, the same merge
    assert torch.equal(out[5], ref_out[5])
    if kind == "tie":
        assert (parts[2] == 1.0).float().mean() > 0.99
    if kind == "none":  # every max is -1e30, reached first at index 0
        assert (parts[3] == 0).all() and (out[5] == 0).all()
    if kind in ("nan", "nan_rank"):
        assert parts[2].isnan().any() and out[4].isnan().any()
    again = ac.affinity_tiles(T, U, exists)
    again_out = ac.affinity_finish(again[0], again[1], again[2], exists, U, I)
    for a, b in zip((*again, *again_out), (*parts, *out)):
        _same(a, b)


def test_affinity_attention_grads_on_the_card_match_the_cpu(cuda):
    """The kernel path (use_pallas on B10's shapes) forward and backward,
    card against CPU; the backward twice gives the same bits."""
    from umpr_tpu_torch.ops.attention import affinity_attention
    U, I, M, exists = _attention_inputs(3, 300, 128, "rand", seed=1)
    c = torch.randn(3, 300, generator=torch.Generator().manual_seed(2))
    runs = []
    for dev in ("cpu", cuda, cuda):
        u, i, m = (t.to(dev).detach().requires_grad_() for t in (U, I, M))
        su, si, au, ai = affinity_attention(u, i, m, exists.to(dev), use_pallas=True)
        ((au ** 2).sum() + (ai ** 2).sum() + (su * c.to(dev)).sum()
         + (si ** 2).sum()).backward()
        runs.append([t.detach().cpu() for t in (su, si, au, ai, u.grad, i.grad, m.grad)])
    for got, want in zip(runs[1], runs[0]):
        _close_rel(got, want, 1e-4)
    for a, b in zip(runs[1], runs[2]):
        assert torch.equal(a, b)


def test_attention_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from umpr_tpu_torch.ops import attention_cuda as ac
    T = torch.randn(2, 10, 8, device=cuda)
    e = torch.ones(10, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        ac.affinity_tiles(T.double(), T.double(), e)
    with pytest.raises(TypeError):
        ac.affinity_tiles(T, T, e.float())
    with pytest.raises(ValueError):
        ac.affinity_tiles(T, T[:, :9].contiguous(), e)
    with pytest.raises(ValueError, match="contiguous"):
        ac.affinity_tiles(T.transpose(1, 2).contiguous().transpose(1, 2), T, e)
    with pytest.raises(RuntimeError, match="AffinityAttention"):
        ac.affinity_tiles(T.requires_grad_(), T, e)
