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


def _proj_f64(x, w, b):
    """K1's plain version evaluated in f64, rounded to f32.  f32 K1 is held
    against it, not against the plain version in f32 (cuBLAS's f32
    product): at E = 300 and 400, 51,200 rows, that product itself has
    values past rtol = atol = 1e-5 of the f64 one (chip_smoke.py
    k1_f32_widths counts them)."""
    return gru_cuda.gru_input_proj_ref(x.double(), w.double(), b.double()).float()


# f32 K1's routes by E (csrc/gru_input_proj.cu): the wgmma kernel up to
# 112, the transposed kernel (gru_input_proj_xt) up to 352, the mma.sync
# kernel up to 452, past it the one that reads global memory
K1_F32_WGMMA_MAX_E = 112
K1_F32_XT_MAX_E = 352


@pytest.mark.parametrize("M,E,N", [
    (1, 50, 384), (130, 17, 100), (130, 17, 102), (51200, 50, 384), (1000, 300, 384),
    (1000, 400, 384), (3000, 520, 102), (1048576, 50, 384),
    (1, K1_F32_WGMMA_MAX_E + 1, 384), (65, K1_F32_WGMMA_MAX_E + 1, 102),
    (1000, K1_F32_WGMMA_MAX_E + 1, 384), (65, 200, 384), (51200, 200, 384),
    (1, 300, 384), (65, 300, 102), (51200, 300, 384), (1000, 301, 384), (65, 301, 102),
    (1000, 302, 384), (1000, K1_F32_XT_MAX_E, 384), (129, K1_F32_XT_MAX_E, 102),
    (1000, K1_F32_XT_MAX_E + 1, 384), (65, K1_F32_XT_MAX_E + 1, 102)])
def test_gru_input_proj_matches_plain(cuda, M, E, N):
    """N = 102 (odd H): an odd row length, stored one float at a time;
    E = 113 .. 352 the transposed kernel (E = 200, 300, 352: float4 loads,
    113, 301, 302: single floats; M = 1, 65, 129, 1000: a last tile of one
    to a few rows; 6H = 102: a column tile of 102 - 64 = 38 columns), 353
    and 400 the mma.sync kernel, E = 520 the one that reads its fragments
    from global memory; w is scaled so that every case's sums have the spread of
    E = 50's.  Held against the plain version in f64 (_proj_f64).  Two
    launches give the same bits."""
    g = torch.Generator().manual_seed(M)
    x, w, b = (torch.randn(s, generator=g).to(cuda) for s in ((M, E), (E, N), (N,)))
    w *= min(1.0, (50 / E) ** 0.5)
    before = gru_cuda.gru_input_proj.launches
    out = gru_cuda.gru_input_proj(x, w, b)
    torch.cuda.synchronize()
    assert gru_cuda.gru_input_proj.launches == before + 1
    torch.testing.assert_close(out, _proj_f64(x, w, b), rtol=1e-5, atol=1e-5)
    assert torch.equal(gru_cuda.gru_input_proj(x, w, b), out)


@pytest.mark.parametrize("E", [K1_F32_WGMMA_MAX_E + 1, 200, 300, 301, 400])
def test_gru_input_proj_at_unaligned_addresses(cuda, E):
    """f32 K1 on an x view that starts one element into its buffer (rows
    4-byte aligned): the transposed kernel then loads single floats (E =
    113 .. 301), the mma.sync kernel copies single floats (E = 400);
    against the plain version in f64, the same bits twice."""
    M, N = 1000, 384
    g = torch.Generator().manual_seed(E)
    x = torch.randn(M * E + 1, generator=g).to(cuda)[1:].view(M, E)
    w = (torch.randn(E, N, generator=g) * (50 / E) ** 0.5).to(cuda)
    b = torch.randn(N, generator=g).to(cuda)
    out = gru_cuda.gru_input_proj(x, w, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, _proj_f64(x, w, b), rtol=1e-5, atol=1e-5)
    assert torch.equal(gru_cuda.gru_input_proj(x, w, b), out)


@pytest.mark.parametrize("E,N", [(300, 384), (301, 102), (K1_F32_WGMMA_MAX_E + 1, 102)])
def test_gru_input_proj_ignores_nan_past_the_data(cuda, E, N):
    """f32 K1's transposed kernel (E = 113 .. 352) zeroes what lies past
    its data by selects, never by multiplying: after
    a launch over all-NaN x of the same shape (NaN left in the shared
    memory), x followed by NaN in memory gives finite outputs equal to the
    plain version's (in f64), at M = 65 (a last tile of one row) and a last
    chunk of 12, 13, 17 columns."""
    M = 65
    g = torch.Generator().manual_seed(E + N)
    x = torch.randn(M, E, generator=g).to(cuda)
    w = (torch.randn(E, N, generator=g) * (50 / E) ** 0.5).to(cuda)
    b = torch.randn(N, generator=g).to(cuda)
    gru_cuda.gru_input_proj(torch.full_like(x, float("nan")), w, b)
    x = _after_nan(x, 64 * E)
    out = gru_cuda.gru_input_proj(x, w, b)
    torch.cuda.synchronize()
    assert out.isfinite().all()
    torch.testing.assert_close(out, _proj_f64(x, w, b), rtol=1e-5, atol=1e-5)


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
    with pytest.raises(TypeError):  # bf16 is taken, but not mixed with f32
        gru_cuda.gru_input_proj(x.bfloat16(), w, b)
    with pytest.raises(TypeError):
        gru_cuda.gru_input_proj(x.half(), w.half(), b.half())
    with pytest.raises(TypeError):  # K9 takes bf16, but not mixed with f32
        gru_cuda.gru_input_proj_dx(torch.zeros(8, 12, device=cuda).bfloat16(), w)
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


def _bf16(t):
    return t.to(torch.bfloat16)


def _within_ulp(got, want):
    """bf16 outputs within one bf16 ulp (of the larger magnitude) of the
    plain version's, but for at most a 1e-4 share of the elements, and
    those within one ulp at the tensor's largest magnitude: where an f32
    sum cancels, its order moves the rounded value by many of its own
    ulps, and in K2/K3 a rounding flip of the bf16 operand is carried along
    the recurrence (on an H100: 38 of 19.7 million K1 outputs past one
    ulp; 98 of 41.9 million K2 outputs, the largest 1.8e-4 off; K3's
    largest 2.9e-3 at a largest |dxg| of 125)."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -120)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    top = torch.exp2(torch.floor(torch.log2(w.abs().max().clamp(min=2.0 ** -120))) - 7)
    err = (g - w).abs()
    past = int((err > ulp).sum())
    assert past <= 1e-4 * err.numel(), f"{past} of {err.numel()} past one ulp"
    assert (err <= ulp + top).all(), f"{(err / ulp).max().item()} ulp, {err.max().item()} off"


def _l2_close(got, want, tol=1e-4):
    """f32 sums within tol of the plain version's l2 norm."""
    assert got.dtype == want.dtype == torch.float32
    assert (got - want).norm() <= tol * want.norm().clamp(min=1e-30)


# csrc/gru_input_proj.cu: the bf16 wgmma kernel's E range, the streaming
# kernel's after it (the mma.sync kernel and the deep one past it), and
# the last E whose xg is rounded once (gru_cuda.PROJ_ROUND_ONCE_MAX_E)
K1_BF16_WGMMA_MAX_E = 256
K1_BF16_STREAM_MAX_E = 544
K1_BF16_ROUND_ONCE_MAX_E = gru_cuda.PROJ_ROUND_ONCE_MAX_E


@pytest.mark.parametrize("M,E,N", [
    (51200, 50, 384), (130, 17, 102), (1000, 400, 384), (3000, 520, 102), (777, 521, 384),
    (700, 800, 384), (1, 50, 384), (63, 8, 384), (65, 16, 768), (130, 64, 102),
    (51200, 17, 102), (65, 50, 768), (63, 64, 384), (130, K1_BF16_WGMMA_MAX_E, 384),
    (130, K1_BF16_WGMMA_MAX_E + 1, 384), (1048576, 50, 384),
    (130, K1_BF16_ROUND_ONCE_MAX_E, 384), (130, K1_BF16_ROUND_ONCE_MAX_E + 1, 384),
    (65, K1_BF16_ROUND_ONCE_MAX_E + 1, 102), (777, K1_BF16_WGMMA_MAX_E + 1, 102),
    (51200, 300, 384), (63, 300, 102), (1000, 258, 384), (1000, 264, 768), (1000, 301, 384),
    (65, 300, 768), (1000, K1_BF16_STREAM_MAX_E, 384), (777, K1_BF16_STREAM_MAX_E, 102),
    (1000, K1_BF16_STREAM_MAX_E + 1, 384), (777, K1_BF16_STREAM_MAX_E + 1, 102)])
def test_gru_input_proj_bf16_matches_plain(cuda, M, E, N):
    """K1 in bf16: up to E = 256 the bf16 wgmma kernel (E = 50: a 100-byte
    row, the tile copies take 16-byte pieces of the whole span and 2-byte
    copies for the tail; odd E = 17 reads its fragments in 2-byte halves;
    6H = 102 stores 2 bytes at a time, 384 and 768 whole 16-byte pieces;
    M = 1, 63, 65, 130: ragged last tiles), 257 .. 544 the streaming kernel
    (E = 264: 16-byte row pieces, 300 and 520: 8-byte, 258: 4-byte, 257,
    301, 521: 4-byte pieces of rows that start at odd elements), 545 the
    mma.sync kernel, 800 the one that reads global memory; E = 64 | 65 the
    rounding switch (the product rounded before the bias past 64); within
    one bf16 ulp, launches and bf16 launches +1, the same bits twice."""
    g = torch.Generator().manual_seed(M + E)
    x, w, b = (_bf16(torch.randn(s, generator=g)).to(cuda) for s in ((M, E), (E, N), (N,)))
    w = _bf16(w.float() * min(1.0, (50 / E) ** 0.5))
    before = gru_cuda.gru_input_proj.launches
    before_bf16 = gru_cuda.gru_input_proj.launches_bf16
    out = gru_cuda.gru_input_proj(x, w, b)
    torch.cuda.synchronize()
    assert gru_cuda.gru_input_proj.launches == before + 1 and out.dtype == torch.bfloat16
    assert gru_cuda.gru_input_proj.launches_bf16 == before_bf16 + 1
    _within_ulp(out, gru_cuda.gru_input_proj_ref(x, w, b))
    assert torch.equal(gru_cuda.gru_input_proj(x, w, b), out)


def _after_nan(t, pad):
    """t's values in a buffer whose next `pad` elements are NaN: a view of
    t's shape, contiguous, with NaN right past its data."""
    buf = torch.full((t.numel() + pad,), float("nan"), device=t.device, dtype=t.dtype)
    buf[:t.numel()] = t.flatten()
    return buf[:t.numel()].view(t.shape)


def test_bf16_projection_kernels_ignore_nan_past_the_data(cuda):
    """K1's and K4's bf16 kernels zero what lies past their data by
    selects (and K4's rows past a chunk by the copy's zero fill), never by
    multiplying: after launches over all-NaN inputs of the same shapes
    (NaN left in the shared memory), inputs followed by NaN in memory give
    finite outputs equal to the plain version's, at M = 65 (a last tile of
    one row) and E = 50 (k past E inside the tile)."""
    M, E, G = 65, 50, 384
    g = torch.Generator().manual_seed(3)
    x, w, b, dxg = (_bf16(torch.randn(s, generator=g)).to(cuda)
                    for s in ((M, E), (E, G), (G,), (M, G)))
    nan_x, nan_g = torch.full_like(x, float("nan")), torch.full_like(dxg, float("nan"))
    gru_cuda.gru_input_proj(nan_x, w, b)
    gru_cuda.gru_input_proj_bwd(nan_x, nan_g)
    x, dxg = _after_nan(x, 64 * E), _after_nan(dxg, 64 * G)
    out = gru_cuda.gru_input_proj(x, w, b)
    dw, db = gru_cuda.gru_input_proj_bwd(x, dxg)
    torch.cuda.synchronize()
    assert out.isfinite().all() and dw.isfinite().all() and db.isfinite().all()
    _within_ulp(out, gru_cuda.gru_input_proj_ref(x, w, b))
    want_dw, want_db = gru_cuda.gru_input_proj_bwd_ref(x, dxg)
    _l2_close(dw, want_dw)
    _l2_close(db, want_db)


@pytest.mark.parametrize("E", [50, 300, 301])
def test_bf16_projection_kernels_at_unaligned_addresses(cuda, E):
    """K1 and K9 in bf16 on views that start one element into their
    buffers (2-byte aligned addresses, every row start odd or even in
    turn): K1's streaming kernel (E = 300, 301) and K9's kernel then copy
    4-byte pieces from each row's aligned start, K1's wgmma kernel (E =
    50) its 2-byte tail path; against the plain versions, the same bits
    twice."""
    M, G = 1000, 384
    g = torch.Generator().manual_seed(E)

    def unaligned(shape, scale=1.0):
        n = shape[0] * shape[1]
        buf = _bf16(torch.randn(n + 1, generator=g) * scale).to(cuda)
        return buf[1:].view(shape)

    x, dxg = unaligned((M, E)), unaligned((M, G))
    w = _bf16(torch.randn(E, G, generator=g) * (50 / E) ** 0.5).to(cuda)
    b = _bf16(torch.randn(G, generator=g)).to(cuda)
    w9 = unaligned((E, G), G ** -0.5)
    out, dx = gru_cuda.gru_input_proj(x, w, b), gru_cuda.gru_input_proj_dx(dxg, w9)
    torch.cuda.synchronize()
    _within_ulp(out, gru_cuda.gru_input_proj_ref(x, w, b))
    _within_ulp(dx, gru_cuda.gru_input_proj_dx_ref(dxg, w9))
    assert torch.equal(gru_cuda.gru_input_proj(x, w, b), out)
    assert torch.equal(gru_cuda.gru_input_proj_dx(dxg, w9), dx)


@pytest.mark.parametrize("E,H", [(300, 64), (50, 64), (300, 17)])
def test_bf16_stream_kernels_ignore_nan_past_the_data(cuda, E, H):
    """K1's streaming kernel (E = 300) and K9's bf16 kernel zero what lies
    past their data by selects, never by multiplying: after launches over
    all-NaN inputs of the same shapes (NaN left in the shared memory),
    inputs followed by NaN in memory give finite outputs within one ulp of
    the plain version's, at M = 65 (a last tile of one row), E = 300 (a
    last chunk of 44 columns) and H = 17 (3H = 51: a last k16 step of 3
    columns, 2-byte halves)."""
    M, G = 65, 6 * H
    g = torch.Generator().manual_seed(E + H)
    x, dxg = (_bf16(torch.randn(s, generator=g)).to(cuda) for s in ((M, E), (M, G)))
    w = _bf16(torch.randn(E, G, generator=g) * (50 / E) ** 0.5).to(cuda)
    b = _bf16(torch.randn(G, generator=g)).to(cuda)
    gru_cuda.gru_input_proj(torch.full_like(x, float("nan")), w, b)
    gru_cuda.gru_input_proj_dx(torch.full_like(dxg, float("nan")), w)
    x, dxg = _after_nan(x, 64 * E), _after_nan(dxg, 64 * G)
    out, dx = gru_cuda.gru_input_proj(x, w, b), gru_cuda.gru_input_proj_dx(dxg, w)
    torch.cuda.synchronize()
    assert out.isfinite().all() and dx.isfinite().all()
    _within_ulp(out, gru_cuda.gru_input_proj_ref(x, w, b))
    _within_ulp(dx, gru_cuda.gru_input_proj_dx_ref(dxg, w))


def _bf16_backward_inputs(cuda, N, L, H, kind, E=50):
    x, xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh = _backward_inputs(cuda, N, L, H, kind, E)
    x, xg, w_hh, b_hh, dy_sent, dy_pos = map(_bf16, (x, xg, w_hh, b_hh, dy_sent, dy_pos))
    y = gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh)
    return x, xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh


# bf16 K2's mma.sync kernel (csrc/bigru_recurrence.cu
# bigru_recurrence_bf16_kernel) and K3's sweep (csrc/bigru_backward.cu
# bigru_backward_bf16_sweep) take H up to 128, padded to 16 units a warp;
# past it the wide kernels (and K3's hg pass)
BF16_SWEEP_MAX_H = 128
BF16_GRU_SHAPES = [(2560, 20, 64, "mixed"), (37, 5, 8, "mixed"), (50, 9, 100, "mixed"),
                   (40, 7, 256, "mixed"), (300, 20, 128, "all_L"), (40, 9, 64, "adjacent_L"),
                   (16385, 20, 64, "mixed"), (300, 20, 16, "mixed"), (300, 20, 48, "mixed"),
                   (300, 20, 120, "mixed"), (300, 20, BF16_SWEEP_MAX_H, "mixed"),
                   (70, 11, 33, "mixed"), (100, 9, BF16_SWEEP_MAX_H + 1, "mixed"),
                   (300, 20, 32, "mixed"), (70, 11, 80, "mixed"), (50, 9, 96, "all_L"),
                   (16385, 64, 64, "mixed")]  # the bf16 long-history shape (maxlen 64)


@pytest.mark.parametrize("N,L,H,kind", BF16_GRU_SHAPES)
def test_bigru_recurrence_bf16_matches_plain(cuda, N, L, H, kind):
    """K2 in bf16: up to H = 128 the mma.sync kernel (HP / 16 = 1 .. 8
    warps: H = 8, 16, 32, 33, 48, 64, 80, 96, 100, 120, 128; 8, 33, 100,
    120 padded, 33 odd, so 2-byte accesses), past it the wide kernel (129,
    256): y within one bf16 ulp, exact zeros past each length, the same
    bits twice; L = 64 at N = 16,385: the bf16 long-history shape."""
    _, xg, _, _, _, lengths, w_hh, b_hh = _bf16_backward_inputs(cuda, N, L, H, kind)
    before = gru_cuda.bigru_recurrence.launches
    y = gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_recurrence.launches == before + 1 and y.dtype == torch.bfloat16
    _within_ulp(y, gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh))
    past = torch.arange(L, device=cuda)[None, :] >= lengths[:, None]
    assert (y[past] == 0).all()
    assert torch.equal(gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh), y)


@pytest.mark.parametrize("N,L,H,kind", BF16_GRU_SHAPES)
def test_bigru_backward_bf16_matches_plain(cuda, N, L, H, kind):
    """K3 in bf16: dxg within one bf16 ulp, dW_hh and db_hh (f32) within
    1e-4 of their l2 norms, the same bits twice.  Up to H = 128 the sweep
    with hg fused (H = 16, 48, 64, 128: whole warps of units; 8, 33, 100,
    120: padded, 33 odd, so 2-byte accesses), past it the hg pass and the
    wide sweep (129, 256); L = 64 at N = 16,385: the bf16 long-history
    shape."""
    _, xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh = _bf16_backward_inputs(cuda, N, L, H, kind)
    before = gru_cuda.bigru_backward.launches
    dxg, dw, db = gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_backward.launches == before + 1 and dxg.dtype == torch.bfloat16
    want = gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    _within_ulp(dxg, want[0])
    _l2_close(dw, want[1])
    _l2_close(db, want[2])
    again = gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    for a, b in zip(again, (dxg, dw, db)):
        assert torch.equal(a, b)


# csrc/gru_input_proj_bwd.cu: x's rows copied whole up to E = 64, with four
# stages up to the first E, two past it; E tiles past 64
K4_BF16_FOUR_STAGES_MAX_E, K4_BF16_WHOLE_ROWS_MAX_E = 52, 64


@pytest.mark.parametrize("M,E,G", [
    (51200, 50, 384), (130, 17, 102), (1000, 400, 384), (3000, 520, 102), (777, 521, 384),
    (1, 50, 384), (63, 8, 384), (65, 16, 768), (130, 64, 102), (51200, 17, 102),
    (0, 50, 384), (65, 50, 768), (130, K4_BF16_FOUR_STAGES_MAX_E, 384),
    (130, K4_BF16_FOUR_STAGES_MAX_E + 1, 102), (130, K4_BF16_WHOLE_ROWS_MAX_E, 384),
    (130, K4_BF16_WHOLE_ROWS_MAX_E + 1, 102), (130, 286, 384), (130, 287, 384),
    (130, 708, 102), (130, 709, 384), (1048576, 50, 384), (130, 1032, 102), (130, 1033, 384),
    (130, 1616, 384), (130, 1617, 102), (65, 1624, 384)])
def test_gru_input_proj_bwd_bf16_matches_plain(cuda, M, E, G):
    """K4 in bf16: f32 dW and db within 1e-4 of their l2 norms (G = 102:
    dxg rows copied 2 bytes at a time; E = 8 .. 64 one E tile of n56 or
    n64; whole x rows with four stages up to E = 52, with two up to 64;
    past that each block copies its E tile of x, two stages, 2 bytes at a
    time at odd E and by cp.async at E % 8 == 0; 1,048,576 rows: 432
    chunks of 2,432, the longest accumulation chains), launches and bf16
    launches +1, the same bits twice."""
    g = torch.Generator().manual_seed(M + E + 1)
    x = _bf16(torch.randn(M, E, generator=g)).to(cuda)
    dxg = _bf16(torch.randn(M, G, generator=g)).to(cuda)
    before = gru_cuda.gru_input_proj_bwd.launches
    before_bf16 = gru_cuda.gru_input_proj_bwd.launches_bf16
    dw, db = gru_cuda.gru_input_proj_bwd(x, dxg)
    torch.cuda.synchronize()
    assert gru_cuda.gru_input_proj_bwd.launches == before + 1
    assert gru_cuda.gru_input_proj_bwd.launches_bf16 == before_bf16 + 1
    want_dw, want_db = gru_cuda.gru_input_proj_bwd_ref(x, dxg)
    _l2_close(dw, want_dw)
    _l2_close(db, want_db)
    again = gru_cuda.gru_input_proj_bwd(x, dxg)
    assert torch.equal(again[0], dw) and torch.equal(again[1], db)


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


@pytest.mark.parametrize("N,H,W,C,kind", [
    (1, 2, 2, 3, "normal"), (2, 4, 6, 64, "normal"), (2, 4, 6, 128, "grid"),
    (1, 2, 2, 512, "normal"), (3, 6, 14, 12, "grid"), (2, 4, 4, 64, "tie"),
    (1, 56, 56, 256, "grid"), (4, 112, 112, 128, "grid"), (2, 6, 8, 64, "nan"),
    (1, 4, 4, 5, "nan")])
def test_bias_relu_pool_bf16_kernels_match_plain(cuda, N, H, W, C, kind):
    """K5/K6 in bf16 (8 channels per 16-byte access; C = 3, 5 and 12 the
    one-channel path): yp, idx and dx bit-equal to the plain bf16
    versions, db within one bf16 ulp (f32 sums in another order, rounded
    once), the same bits twice."""
    from umpr_tpu_torch.ops import pool_cuda
    g = torch.Generator().manual_seed(N * H * W + C + 1)
    x = torch.randn(N, H, W, C, generator=g)
    b = torch.randn(C, generator=g) * 0.1
    if kind == "grid":
        x, b = (x * 2).round() / 2, (b * 4).round() / 4
    if kind == "tie":
        x = x[:, ::2, ::2].repeat_interleave(2, 1).repeat_interleave(2, 2).contiguous()
    if kind == "nan":
        x[torch.rand(x.shape, generator=g) < 0.05] = float("nan")
    dyp = torch.randn(N, H // 2, W // 2, C, generator=g)
    x, b, dyp = (_bf16(t).to(cuda) for t in (x, b, dyp))
    before = (pool_cuda.bias_relu_pool.launches_bf16, pool_cuda.bias_relu_pool_bwd.launches_bf16)
    yp, idx = pool_cuda.bias_relu_pool(x, b)
    dx, db = pool_cuda.bias_relu_pool_bwd(dyp, idx, yp)
    torch.cuda.synchronize()
    assert (pool_cuda.bias_relu_pool.launches_bf16,
            pool_cuda.bias_relu_pool_bwd.launches_bf16) == (before[0] + 1, before[1] + 1)
    assert yp.dtype == dx.dtype == db.dtype == torch.bfloat16
    want_yp, want_idx = pool_cuda.bias_relu_pool_ref(x, b)
    want_dx, want_db = pool_cuda.bias_relu_pool_bwd_ref(dyp, want_idx, want_yp)
    torch.testing.assert_close(yp, want_yp, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(idx, want_idx) and torch.equal(dx, want_dx)
    _within_ulp(db, want_db)
    if kind == "nan":
        assert yp.isnan().any() and (idx[yp.isnan()] == 3).all()
    if kind == "tie":
        assert not idx.any()
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


@pytest.mark.parametrize("M,G,E", [(1, 384, 50), (130, 102, 17), (0, 192, 17),
                                   (51200, 384, 50), (3000, 384, 400), (777, 102, 521),
                                   (20000, 1536, 50), (1000, 1800, 50), (1000, 600, 70),
                                   (63, 102, 56), (65, 102, 64), (130, 102, 65), (1000, 102, 300),
                                   (1, 384, 56), (63, 384, 64), (65, 384, 65), (3000, 384, 300),
                                   (51200, 384, 300), (1000, 48, 50), (1000, 120, 50),
                                   (1000, 1086, 56), (1000, 1092, 56), (1000, 924, 64),
                                   (1000, 930, 64), (1000, 1248, 64)])
def test_gru_input_proj_dx_bf16_matches_plain(cuda, M, G, E):
    """K9 in bf16: each direction's f32 sum rounded to bf16, then one bf16
    add, within one bf16 ulp of the plain version.  The wgmma kernel: E =
    56, 64 one column tile (n = 56, 64), 65, 300, 400, 521 column tiles of
    64; 6H = 102 (H = 17, odd: 4-byte row pieces from aligned starts,
    2-byte halves; 3H = 51 ends inside a k16 step), 48 (H = 8, 3H = 24),
    120 (H = 20: 8-byte pieces), 384, 600 (H = 100: 3H = 300); M = 1, 63,
    65: ragged last tiles; 6H = 1,086 at E = 56 and 924 at E = 64 its
    last widths (3H = 543, 462).  Past them (1,092, 930, 1,248, 1,536) the
    mma.sync kernel with W's fragments in shared memory, past 3H = 896
    (1,800) from L2; the same bits twice."""
    g = torch.Generator().manual_seed(M + G + 1)
    dxg = _bf16(torch.randn(M, G, generator=g)).to(cuda)
    w = _bf16(torch.randn(E, G, generator=g) / G ** 0.5).to(cuda)
    before = gru_cuda.gru_input_proj_dx.launches_bf16
    dx = gru_cuda.gru_input_proj_dx(dxg, w)
    torch.cuda.synchronize()
    assert gru_cuda.gru_input_proj_dx.launches_bf16 == before + 1
    assert dx.shape == (M, E) and dx.dtype == torch.bfloat16
    if M:
        _within_ulp(dx, gru_cuda.gru_input_proj_dx_ref(dxg, w))
    assert torch.equal(gru_cuda.gru_input_proj_dx(dxg, w), dx)


def test_bigru_split_bf16_input_grad_on_the_card_matches_the_cpu(cuda):
    """A bf16 x that requires grad through bigru_split: K1-K4 and K9 in
    bf16 on the card against the plain versions on the CPU (dx within the
    bf16 gradient tolerance, 5e-2 of its l2 norm)."""
    from umpr_tpu_torch.ops.gru import BiGRU, bigru_split
    g = torch.Generator().manual_seed(3)
    N, L, E, H, S = 60, 9, 50, 64, 6
    gru = BiGRU(E, H, generator=g)
    x = torch.randn(N, L, E, generator=g).bfloat16()
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    c = torch.randn(N, L, 2 * H, generator=g)
    grads = []
    for dev in ("cpu", cuda):
        xd = x.to(dev).detach().requires_grad_()  # a leaf on either device
        _, sent = bigru_split(gru.to(dev), xd, lengths.to(dev), S)
        (sent.float() * c.to(dev)).sum().backward()
        grads.append(xd.grad.float().cpu())
    assert (grads[1] - grads[0]).norm() <= 5e-2 * grads[0].norm()


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


def _no_plain(*args):
    raise AssertionError("a custom op on CUDA tensors reached a plain version")


@pytest.mark.parametrize("B,P,D", [(2, 300, 128), (1, 8192, 128), (3, 77, 200), (2, 1003, 16)])
def test_affinity_custom_ops_launch_the_kernels(cuda, monkeypatch, B, P, D):
    """torch.ops.umpr_tpu_torch.affinity_tiles / affinity_finish on CUDA
    tensors: each launches its kernel once (never a plain version), gives
    the wrapper's bits, and agrees with the plain versions as
    test_affinity_kernels_match_plain holds the wrappers."""
    from umpr_tpu_torch.ops import attention_cuda as ac
    U, I, M, exists = (t.to(cuda) for t in _attention_inputs(B, P, D, "rand"))
    T = I @ M
    with monkeypatch.context() as m:
        m.setattr(ac, "affinity_tiles_ref", _no_plain)
        m.setattr(ac, "affinity_finish_ref", _no_plain)
        before = (ac.affinity_tiles.launches, ac.affinity_finish.launches)
        parts = torch.ops.umpr_tpu_torch.affinity_tiles(T, U, exists)
        out = torch.ops.umpr_tpu_torch.affinity_finish(parts[0], parts[1], parts[2], exists,
                                                       U, I)
        torch.cuda.synchronize()
        assert (ac.affinity_tiles.launches, ac.affinity_finish.launches) == (
            before[0] + 1, before[1] + 1)
    want = ac.affinity_tiles(T, U, exists)
    want_out = ac.affinity_finish(want[0], want[1], want[2], exists, U, I)
    for a, b in zip((*parts, *out), (*want, *want_out)):
        _same(a, b)
    ref = ac.affinity_tiles_ref(T, U, exists)
    for got, r in zip(parts[::2], ref[::2]):
        torch.testing.assert_close(got, r, rtol=1e-5, atol=1e-6)
    for got, r in zip(parts[1::2], ref[1::2]):
        assert torch.equal(got, r)
    ref_out = ac.affinity_finish_ref(parts[0], parts[1], parts[2], exists, U, I)
    for got, r in zip(out[:4], ref_out[:4]):
        scale = r.abs().max().clamp(min=1e-30)
        torch.testing.assert_close(got / scale, r / scale, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_export_attention_route_gives_the_kernel_path_bits(cuda, monkeypatch, dtype):
    """The kernel-free model's forward-only route (custom ops) above the
    threshold gives AffinityAttention's forward bits on the card."""
    from umpr_tpu_torch.ops import attention
    monkeypatch.setattr(attention, "TILED_BYTES_THRESHOLD", 1)
    U, I, M, exists = (t.to(cuda) for t in _attention_inputs(2, 1000, 128, "rand", seed=3))
    U, I, M = (t.to(dtype) for t in (U, I, M))
    with torch.no_grad():
        got = attention.affinity_attention(U, I, M, exists, use_kernels=False)
        want = attention.AffinityAttention.apply(U, I, M, exists)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _same(a, b)


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
