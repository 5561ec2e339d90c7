"""The bi-GRU kernels: wrappers, plain versions, launch counts.

Five CUDA C++ kernels for Hopper carry the Pallas GRU stack of the JAX
package (``bigru_pallas_split`` and ``bigru_pallas_split_nodx``,
umpr_tpu/ops/gru_pallas.py).
Forward:

- K1 ``gru_input_proj`` (csrc/gru_input_proj.cu) replaces B5 (stack-pad)
  and B3 (input projection): xg = x @ [W_ih_f | W_ih_b] + b_ih in true time,
  a persistent streaming kernel with 3xTF32 products on the tensor cores
  (f32-accurate, as B3's Precision.HIGHEST; csrc/tf32x3.cuh);
- K2 ``bigru_recurrence`` (csrc/bigru_recurrence.cu) replaces B1 (the
  masked recurrence, ``emit_hs=False``) and B6 (output repack): y in true
  time, exact zeros past each length; up to H = 128 the rows ordered by
  length (csrc/row_order.cuh, shared with K3) and walked in 16-row tiles
  with W_hh in shared memory, past it W_hh in L2 (any H).

Backward:

- K3 ``bigru_backward`` (csrc/bigru_backward.cu) replaces B7 (the sum of
  the two output cotangents) and B2 (the reverse sweep): dxg in true time,
  dW_hh and db_hh; the states come from y, so K2 emits no ``hs``.  One
  launch runs three passes: hg = y @ W_hh on the tensor cores, a sweep
  that keeps only the product on the carried gradient, and dW_hh / db_hh
  on the tensor cores over a fixed split of the rows (any H; the plain
  versions of the parts are ``bigru_backward_hg_ref``,
  ``bigru_backward_sweep_ref`` and ``bigru_backward_dw_ref``);
- K4 ``gru_input_proj_bwd`` (csrc/gru_input_proj_bwd.cu) replaces B4
  with ``emit_dxc=False``: dW_ih = x^T dxg and db_ih = sum(dxg), 3xTF32
  over a fixed split of the rows into chunks, whose partials a second
  kernel of the same launch sums in a fixed order;
- K9 ``gru_input_proj_dx`` (csrc/gru_input_proj_dx.cu) replaces B4's
  ``emit_dxc=True`` branch: the input gradient dx = dxg @ W_ih^T, K1's
  persistent 3xTF32 wgmma design transposed (no grid cap), launched
  only when x requires grad (every UMPR config feeds the frozen
  embedding, and pays nothing for it).

Each wrapper takes its plain PyTorch version for CPU tensors and only
then.  For CUDA tensors it launches the kernel or raises; it never falls
back.  The kernels write through raw pointers, so their results carry no
autograd graph: on a non-CPU device the wrappers raise on an input that
requires grad.  ``ops.gru.BiGRUSplit`` calls them on detached tensors and
gives the graph its backward.  ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from umpr_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


def gru_input_proj_ref(x, w, b):
    """Plain version of K1: x (M, E) @ w (E, 6H) + b (6H,) -> (M, 6H)."""
    return x @ w + b


def bigru_recurrence_ref(xg, lengths, w_hh, b_hh):
    """Plain version of K2, a Python loop over time with selects.

    xg (N, L, 6H) as [fwd r z n | bwd r z n]; lengths (N,) int; w_hh
    (2, H, 3H); b_hh (2, 3H) -> y (N, L, 2H) = [fwd | bwd] in true time."""
    N, L, _ = xg.shape
    H = w_hh.shape[1]
    y = xg.new_zeros(N, L, 2 * H)
    for d, steps in ((0, range(L)), (1, range(L - 1, -1, -1))):
        h = xg.new_zeros(N, H)
        for t in steps:
            x = xg[:, t, 3 * H * d:3 * H * (d + 1)]
            hg = h @ w_hh[d] + b_hh[d]
            r = torch.sigmoid(x[:, :H] + hg[:, :H])
            z = torch.sigmoid(x[:, H:2 * H] + hg[:, H:2 * H])
            c = torch.tanh(x[:, 2 * H:] + r * hg[:, 2 * H:])
            h_new = (1.0 - z) * c + z * h
            valid = (t < lengths)[:, None]
            h = torch.where(valid, h_new, h)
            y[:, t, H * d:H * (d + 1)] = torch.where(valid, h_new, 0.0)
    return y


RECURRENCE_ROWS = 16  # rows per tile of K2 and K3's sweep (csrc/bigru_recurrence.cu ROWS)


def bigru_row_order_ref(lengths, L):
    """Plain version of the row order of K2 and K3 (csrc/row_order.cuh):
    the rows 0 .. N-1 by length clamped to [0, L], longest first, as int32.
    Within one length the kernel's order varies from run to run; this one
    keeps the rows' own order there."""
    return torch.sort(lengths.clamp(0, L), descending=True, stable=True).indices.int()


def bigru_recurrence_tiles_ref(xg, lengths, w_hh, b_hh, order, rows=RECURRENCE_ROWS):
    """Plain version of K2's walk over its tiles: the rows of ``order`` in
    tiles of ``rows``, each tile's loop running to its longest row (fwd
    t = 0 .. maxlen-1, bwd t = maxlen-1 .. 0) and zeros past it.  Equals
    ``bigru_recurrence_ref`` for any order, since a row's steps do not
    depend on its tile.  -> y (N, L, 2H)."""
    N, L, _ = xg.shape
    H = w_hh.shape[1]
    y = xg.new_zeros(N, L, 2 * H)
    for start in range(0, N, rows):
        tile = order[start:start + rows].long()
        maxlen = int(lengths[tile].clamp(0, L).max())
        if maxlen:
            y[tile, :maxlen] = bigru_recurrence_ref(xg[tile, :maxlen], lengths[tile], w_hh,
                                                    b_hh)
    return y


def h_prev_from_y(y, t, d):
    """The state direction d held before its step t, read from K2's output
    y (N, L, 2H): fwd y[t-1], bwd y[t+1], zeros at the sequence's start.
    Exact at every valid step (t < length): y is zero past each length, so
    the bwd state before its first step t = len-1 is y_b[len] = 0."""
    H = y.shape[2] // 2
    s = t - 1 if d == 0 else t + 1
    if s < 0 or s >= y.shape[1]:
        return y.new_zeros(y.shape[0], H)
    return y[:, s, H * d:H * (d + 1)]


def bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh):
    """Plain version of K3, a Python loop over time with selects.

    xg (N, L, 6H) and y (N, L, 2H) of the forward; dy_sent, dy_pos: the
    cotangents of y_sent (N, L, 2H) and of its view y_pos (N/S, S*L, 2H).
    -> dxg (N, L, 6H) in true time (zeros at invalid steps), dw_hh
    (2, H, 3H), db_hh (2, 3H)."""
    N, L, _ = xg.shape
    H = w_hh.shape[1]
    dy = dy_sent + dy_pos.reshape(N, L, 2 * H)
    dxg = xg.new_zeros(N, L, 6 * H)
    dw_hh, db_hh = torch.zeros_like(w_hh), torch.zeros_like(b_hh)
    for d, steps in ((0, range(L - 1, -1, -1)), (1, range(L))):
        g = xg.new_zeros(N, H)  # d loss / d (state after step t)
        for t in steps:
            valid = (t < lengths)[:, None]
            hp = h_prev_from_y(y, t, d)
            x = xg[:, t, 3 * H * d:3 * H * (d + 1)]
            hg = hp @ w_hh[d] + b_hh[d]
            r = torch.sigmoid(x[:, :H] + hg[:, :H])
            z = torch.sigmoid(x[:, H:2 * H] + hg[:, H:2 * H])
            n = torch.tanh(x[:, 2 * H:] + r * hg[:, 2 * H:])
            g = g + torch.where(valid, dy[:, t, H * d:H * (d + 1)], 0.0)
            dn = torch.where(valid, g * (1.0 - z) * (1.0 - n * n), 0.0)
            dz = torch.where(valid, g * (hp - n) * z * (1.0 - z), 0.0)
            dr = torch.where(valid, dn * hg[:, 2 * H:] * r * (1.0 - r), 0.0)
            dxg[:, t, 3 * H * d:3 * H * (d + 1)] = torch.cat([dr, dz, dn], 1)
            ghh = torch.cat([dr, dz, dn * r], 1)
            dw_hh[d] += hp.t() @ ghh
            db_hh[d] += ghh.sum(0)
            g = torch.where(valid, g * z + ghh @ w_hh[d].t(), g)
    return dxg, dw_hh, db_hh


def bigru_backward_hg_ref(y, w_hh):
    """Plain version of K3's hg pass: y (N, L, 2H), w_hh (2, H, 3H) ->
    Z (N, L, 6H), Z[..., 3H d:3H (d+1)] = y_d @ w_hh[d] (no bias), the
    gate pre-activations of the state y holds, for both directions."""
    H = w_hh.shape[1]
    return torch.cat([y[..., H * d:H * (d + 1)] @ w_hh[d] for d in (0, 1)], -1)


def bigru_backward_sweep_ref(xg, y, z, dy_sent, dy_pos, lengths, w_hh, b_hh):
    """Plain version of K3's sweep: ``bigru_backward_ref`` with hg read
    from the hg pass's Z (N, L, 6H) at the step where y holds h_prev, and
    no dW.  Where h_prev is known to be zero (tp outside [0, length)) hg
    is b_hh alone.  -> (dxg (N, L, 6H), ghn (N, L, 2H) = dn * r, the
    third part of ghh; both zero at invalid steps)."""
    N, L, _ = xg.shape
    H = w_hh.shape[1]
    dy = dy_sent + dy_pos.reshape(N, L, 2 * H)
    dxg = xg.new_zeros(N, L, 6 * H)
    ghn = xg.new_zeros(N, L, 2 * H)
    for d, steps in ((0, range(L - 1, -1, -1)), (1, range(L))):
        g = xg.new_zeros(N, H)
        for t in steps:
            valid = (t < lengths)[:, None]
            tp = t - 1 if d == 0 else t + 1
            if 0 <= tp < L:
                prev = (tp < lengths)[:, None]
                hg = torch.where(prev, z[:, tp, 3 * H * d:3 * H * (d + 1)], 0.0) + b_hh[d]
                hp = torch.where(prev, y[:, tp, H * d:H * (d + 1)], 0.0)
            else:
                hg, hp = b_hh[d].expand(N, 3 * H), xg.new_zeros(N, H)
            x = xg[:, t, 3 * H * d:3 * H * (d + 1)]
            r = torch.sigmoid(x[:, :H] + hg[:, :H])
            zg = torch.sigmoid(x[:, H:2 * H] + hg[:, H:2 * H])
            n = torch.tanh(x[:, 2 * H:] + r * hg[:, 2 * H:])
            g = g + torch.where(valid, dy[:, t, H * d:H * (d + 1)], 0.0)
            dn = torch.where(valid, g * (1.0 - zg) * (1.0 - n * n), 0.0)
            dz = torch.where(valid, g * (hp - n) * zg * (1.0 - zg), 0.0)
            dr = torch.where(valid, dn * hg[:, 2 * H:] * r * (1.0 - r), 0.0)
            dxg[:, t, 3 * H * d:3 * H * (d + 1)] = torch.cat([dr, dz, dn], 1)
            ghn[:, t, H * d:H * (d + 1)] = dn * r
            ghh = torch.cat([dr, dz, dn * r], 1)
            g = torch.where(valid, g * zg + ghh @ w_hh[d].t(), g)
    return dxg, ghn


def bigru_backward_dw_ref(y, dxg, ghn):
    """Plain version of K3's dW pass over the N*L rows m = n L + t:
    dW_hh[d] = sum_m h_prev[m]^T ghh[m], db_hh[d] = sum_m ghh[m], with ghh
    = [dr | dz | dn r] from dxg and ghn and h_prev the row m - 1 (fwd) or
    m + 1 (bwd) of y, zero at each direction's first step (t = 0 fwd,
    t = L - 1 bwd), where the shifted row belongs to another sentence.
    -> (dw_hh (2, H, 3H), db_hh (2, 3H))."""
    N, L, H2 = y.shape
    H, M = H2 // 2, N * L
    yf, dxf, gnf = y.reshape(M, H2), dxg.reshape(M, 3 * H2), ghn.reshape(M, H2)
    t = torch.arange(M, device=y.device) % L
    dw, db = [], []
    for d in (0, 1):
        ghh = torch.cat([dxf[:, 3 * H * d:3 * H * d + 2 * H], gnf[:, H * d:H * (d + 1)]], 1)
        hp = y.new_zeros(M, H)
        if d == 0:
            hp[1:] = yf[:-1, :H]
            hp[t == 0] = 0.0
        else:
            hp[:-1] = yf[1:, H:]
            hp[t == L - 1] = 0.0
        dw.append(hp.t() @ ghh)
        db.append(ghh.sum(0))
    return torch.stack(dw), torch.stack(db)


def gru_input_proj_bwd_ref(x, dxg):
    """Plain version of K4: x (M, E), dxg (M, 6H) -> (dw_ih (E, 6H),
    db_ih (6H,))."""
    return x.t() @ dxg, dxg.sum(0)


def gru_input_proj_dx_ref(dxg, w):
    """Plain version of K9: dxg (M, 6H), w (E, 6H) -> dx (M, E)."""
    return dxg @ w.t()


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype} only")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_kernel(name, *tensors, node="ops.gru.BiGRUSplit"):
    """For a non-CPU call: raise unless the tensors are CUDA tensors that
    need no graph (a kernel's output would silently cut it); `node` is the
    autograd node that gives the kernel its backward."""
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel's output would "
            f"carry no graph; call it through {node}, which gives the "
            "kernels their backward")
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")


def _launch(name, argtypes, *args):
    fn, error_string = _build.kernel_function(name, argtypes)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(err).decode()}")


def gru_input_proj(x, w, b):
    """K1: x (M, E) f32 @ w (E, 6H) f32 + b (6H,) f32 -> xg (M, 6H) f32."""
    if x.device.type == "cpu":
        return gru_input_proj_ref(x, w, b)
    _device_kernel("gru_input_proj", x, w, b)
    for name, t, nd in (("x", x, 2), ("w", w, 2), ("b", b, 1)):
        _check(name, t, torch.float32, nd, x.device)
    M, E = x.shape
    if w.shape[0] != E or b.shape[0] != w.shape[1]:
        raise ValueError(f"gru_input_proj: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)} disagree")
    out = torch.empty(M, w.shape[1], device=x.device, dtype=torch.float32)
    _launch("gru_input_proj", [_P] * 4 + [_I] * 3 + [_P],
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            M, E, w.shape[1])
    gru_input_proj.launches += 1
    return out


gru_input_proj.launches = 0


def _check_recurrence(name, xg, lengths, w_hh, b_hh):
    """Checks shared by K2 and K3; returns (N, L, H)."""
    _check("xg", xg, torch.float32, 3, xg.device)
    _check("lengths", lengths, torch.int32, 1, xg.device)
    _check("w_hh", w_hh, torch.float32, 3, xg.device)
    _check("b_hh", b_hh, torch.float32, 2, xg.device)
    N, L, G6 = xg.shape
    H = w_hh.shape[1]
    if (G6 != 6 * H or tuple(w_hh.shape) != (2, H, 3 * H)
            or tuple(b_hh.shape) != (2, 3 * H) or lengths.shape[0] != N):
        raise ValueError(
            f"{name}: shapes xg {tuple(xg.shape)}, lengths "
            f"{tuple(lengths.shape)}, w_hh {tuple(w_hh.shape)}, b_hh "
            f"{tuple(b_hh.shape)} disagree")
    return N, L, H


def _scratch(name, N, H, device):
    """The global scratch buffer the wide K2/K3 kernels need at (N, H),
    as the library's ``<name>_scratch`` sizes it: empty where their state
    fits the shared memory (every H up to 725 for K3, 1814 for K2)."""
    fn = getattr(_build.library(name), f"{name}_scratch")
    fn.argtypes, fn.restype = [_I, _I], ctypes.c_longlong
    return torch.empty(fn(N, H), device=device, dtype=torch.float32)


def bigru_recurrence(xg, lengths, w_hh, b_hh):
    """K2: xg (N, L, 6H) f32, lengths (N,) int32, w_hh (2, H, 3H) f32,
    b_hh (2, 3H) f32 -> y (N, L, 2H) f32.

    Up to H = 128 one launch of the C entry point orders the rows by
    length (a counting sort) and runs the recurrence over 16-row tiles of
    that order; a row's result does not depend on its tile
    (``bigru_recurrence_tiles_ref`` is the plain version of that walk)."""
    if xg.device.type == "cpu":
        return bigru_recurrence_ref(xg, lengths, w_hh, b_hh)
    _device_kernel("bigru_recurrence", xg, w_hh, b_hh)
    N, L, H = _check_recurrence("bigru_recurrence", xg, lengths, w_hh, b_hh)
    y = torch.empty(N, L, 2 * H, device=xg.device, dtype=torch.float32)
    order = torch.empty(N, device=xg.device, dtype=torch.int32)  # the rows by length (H <= 128)
    scratch = _scratch("bigru_recurrence", N, H, xg.device)
    _launch("bigru_recurrence", [_P] * 7 + [_I] * 3 + [_P],
            xg.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            y.data_ptr(), order.data_ptr(), scratch.data_ptr(), N, L, H)
    bigru_recurrence.launches += 1
    return y


bigru_recurrence.launches = 0

PROJ_BWD_STEP = 32  # rows per K4 pipeline stage (csrc/gru_input_proj_bwd.cu STEP)
# K4 splits the rows into chunks, each one block per 128-column tile of 6H
# and one dW/db partial.  Up to PROJ_BWD_CHUNKS chunks: 88 x 3 column tiles
# (6H = 384) fill 132 SMs twice.  A chunk has at most PROJ_BWD_MAX_ROWS
# rows: the tensor core accumulates a chunk's products in chains of rows/8
# steps, and its accumulation rounds more coarsely than an f32 add, so the
# chains stay short (at 1,048,576 rows: 863 chunks, partials 4.1% of dxg's
# bytes).
PROJ_BWD_CHUNKS = 88
PROJ_BWD_MAX_ROWS = 1216


def _row_chunks(M, target):
    """About `target` chunks of M rows for a split-K pass: (rows per chunk,
    a multiple of PROJ_BWD_STEP, at most PROJ_BWD_MAX_ROWS; chunk count)."""
    per = -(-M // target)
    rows = max(PROJ_BWD_STEP, -(-per // PROJ_BWD_STEP) * PROJ_BWD_STEP)
    rows = min(rows, PROJ_BWD_MAX_ROWS)
    return rows, max(1, -(-M // rows))


BWD_SWEEP_MAX_H = 128  # K3's sweep keeps W_hh in shared memory up to here;
                       # past it the wide sweep reads W_hh^T from L2
# K3's dW pass splits the N*L rows into chunks, each a dW_hh/db_hh partial
# of both directions (K4's kernels): about BWD_CHUNKS of them (2 column
# tiles x 2 directions x 66 blocks at H = 64 fill 132 SMs twice), capped
# as K4's are, so the tensor core's accumulation chains stay as short.
BWD_CHUNKS = 66


def bwd_chunks(M):
    """K3's split of M = N*L rows for its dW pass: (rows per chunk, a
    multiple of PROJ_BWD_STEP, at most PROJ_BWD_MAX_ROWS; chunk count).  A
    function of M alone, so the partials and their fixed-order sum give
    the same bits on every card."""
    return _row_chunks(M, BWD_CHUNKS)


def bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh):
    """K3: xg (N, L, 6H), y (N, L, 2H), dy_sent (N, L, 2H), dy_pos (any
    shape of N*L*2H elements, read as (N, L, 2H)), lengths (N,) int32,
    w_hh (2, H, 3H), b_hh (2, 3H), f32 -> (dxg (N, L, 6H), dw_hh
    (2, H, 3H), db_hh (2, 3H)).

    One launch of the C entry point runs the hg pass, the sweep (its rows
    ordered by length) and the dW pass, whose partials
    (``bwd_chunks(N*L)``) a last kernel sums in a fixed order (no float
    atomics), so the result is the same on every run."""
    if xg.device.type == "cpu":
        return bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    _device_kernel("bigru_backward", xg, y, dy_sent, dy_pos, w_hh, b_hh)
    N, L, H = _check_recurrence("bigru_backward", xg, lengths, w_hh, b_hh)
    _check("y", y, torch.float32, 3, xg.device)
    _check("dy_sent", dy_sent, torch.float32, 3, xg.device)
    _check("dy_pos", dy_pos, torch.float32, dy_pos.dim(), xg.device)
    if (tuple(y.shape) != (N, L, 2 * H) or tuple(dy_sent.shape) != (N, L, 2 * H)
            or dy_pos.numel() != N * L * 2 * H):
        raise ValueError(
            f"bigru_backward: shapes y {tuple(y.shape)}, dy_sent "
            f"{tuple(dy_sent.shape)}, dy_pos {tuple(dy_pos.shape)} do not "
            f"fit N={N}, L={L}, H={H}")
    dev, f32 = xg.device, torch.float32
    w_hh_t = (w_hh.transpose(1, 2).contiguous() if H > BWD_SWEEP_MAX_H
              else torch.empty(0, device=dev, dtype=f32))
    rows, chunks = bwd_chunks(N * L)
    dxg = torch.empty(N, L, 6 * H, device=dev, dtype=f32)  # holds the hg pass's Z first
    ghn = torch.empty(N, L, 2 * H, device=dev, dtype=f32)
    order = torch.empty(N, device=dev, dtype=torch.int32)  # the sweep's rows by length
    scratch = _scratch("bigru_backward", N, H, dev)
    part = torch.empty(chunks * 2 * (H + 1) * 3 * H, device=dev, dtype=f32)
    out = torch.empty(2 * (H + 1) * 3 * H, device=dev, dtype=f32)
    n_dw = 2 * H * 3 * H
    _launch("bigru_backward", [_P] * 16 + [_I] * 4 + [_P],
            xg.data_ptr(), y.data_ptr(), dy_sent.data_ptr(), dy_pos.data_ptr(),
            lengths.data_ptr(), w_hh.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
            dxg.data_ptr(), ghn.data_ptr(), order.data_ptr(), scratch.data_ptr(),
            part.data_ptr(), part.data_ptr() + 4 * n_dw * chunks, out.data_ptr(),
            out.data_ptr() + 4 * n_dw, N, L, H, rows)
    bigru_backward.launches += 1
    return dxg, out[:n_dw].view(2, H, 3 * H), out[n_dw:].view(2, 3 * H)


bigru_backward.launches = 0


def proj_bwd_chunks(M):
    """K4's split of M rows: (rows per chunk, a multiple of PROJ_BWD_STEP;
    chunk count).  A function of M alone, never of the card, so the
    partials and their fixed-order sum give the same bits on every card."""
    return _row_chunks(M, PROJ_BWD_CHUNKS)


def gru_input_proj_bwd(x, dxg):
    """K4: x (M, E) f32, dxg (M, 6H) f32 -> (dw_ih (E, 6H), db_ih (6H,)).

    One launch of the C entry point runs two kernels: the first reduces
    each chunk of rows (``proj_bwd_chunks``) into a dW and a db partial,
    the second sums the partials in a fixed order (no atomics, the same
    bits on every run)."""
    if x.device.type == "cpu":
        return gru_input_proj_bwd_ref(x, dxg)
    _device_kernel("gru_input_proj_bwd", x, dxg)
    _check("x", x, torch.float32, 2, x.device)
    _check("dxg", dxg, torch.float32, 2, x.device)
    M, E = x.shape
    G = dxg.shape[1]
    if dxg.shape[0] != M:
        raise ValueError(f"gru_input_proj_bwd: x {tuple(x.shape)} and dxg "
                         f"{tuple(dxg.shape)} differ in rows")
    rows, chunks = proj_bwd_chunks(M)
    # scratch: the dW partials (chunks, E, G), then db's (chunks, G)
    part = torch.empty((E * G + G) * chunks, device=x.device, dtype=torch.float32)
    out = torch.empty(E * G + G, device=x.device, dtype=torch.float32)
    _launch("gru_input_proj_bwd", [_P] * 6 + [_I] * 4 + [_P],
            x.data_ptr(), dxg.data_ptr(), part.data_ptr(),
            part.data_ptr() + 4 * E * G * chunks, out.data_ptr(),
            out.data_ptr() + 4 * E * G, M, E, G, rows)
    gru_input_proj_bwd.launches += 1
    return out[:E * G].view(E, G), out[E * G:]


gru_input_proj_bwd.launches = 0


def gru_input_proj_dx(dxg, w):
    """K9: dxg (M, 6H) f32, w (E, 6H) f32 (the packed W_ih) -> dx (M, E)
    f32."""
    if dxg.device.type == "cpu":
        return gru_input_proj_dx_ref(dxg, w)
    _device_kernel("gru_input_proj_dx", dxg, w)
    _check("dxg", dxg, torch.float32, 2, dxg.device)
    _check("w", w, torch.float32, 2, dxg.device)
    M, G = dxg.shape
    E = w.shape[0]
    if w.shape[1] != G:
        raise ValueError(f"gru_input_proj_dx: dxg {tuple(dxg.shape)} and w "
                         f"{tuple(w.shape)} differ in 6H")
    dx = torch.empty(M, E, device=dxg.device, dtype=torch.float32)
    _launch("gru_input_proj_dx", [_P] * 3 + [_I] * 3 + [_P],
            dxg.data_ptr(), w.data_ptr(), dx.data_ptr(), M, G, E)
    gru_input_proj_dx.launches += 1
    return dx


gru_input_proj_dx.launches = 0

KERNELS = (gru_input_proj, bigru_recurrence, bigru_backward, gru_input_proj_bwd,
           gru_input_proj_dx)


def reset_launches():
    for k in KERNELS:
        k.launches = 0
