"""The affinity-attention kernels: wrappers, plain versions, launch counts.

Two CUDA C++ kernels for Hopper carry both Pallas forms of the R-Net
affinity attention of the JAX package (umpr_tpu/ops/attention_pallas.py),
which compute one function with one residual contract: B9
(``_tiled_forward``, the column-tiled kernel that umpr_tpu/ops/attention.py
routes to above 4 GiB of (B, P, P) f32) and B10 (``_forward``, the
whole-tile kernel of ``use_pallas=True``):

- K7 ``affinity_tiles`` (csrc/affinity_tiles.cu): A = tanh(T @ U^T) tile by
  tile, T = gru_i @ M; per row its masked max over existing columns and
  the first column reaching it (final), per 128-row tile and column the
  masked max over the tile's existing rows and the first row reaching it
  (partials).  A never reaches device memory.  Up to D = 128 the products
  run on the tensor cores as 3xTF32 wgmma (f32-accurate), U's column
  tiles streamed through a cp.async ring; past it a CUDA-core kernel;
- K8 ``affinity_finish`` (csrc/affinity_finish.cu): the partials combined
  in a fixed order into colmax / amax_u, both masked softmaxes, and the
  attended vectors atte_u = soft_u^T U, atte_i = soft_i^T I; one thread
  block cluster of FINISH_CLUSTER blocks per sample, each block a share
  of the positions, the blocks' maxima, sums and column sums combined in
  rank order through the cluster's shared memory
  (``affinity_finish_cluster_ref`` is the plain version of that order).

Max and argmax follow torch.amax and torch.argmax: NaN propagates and is
the argmax, a tie goes to the lowest index.  Masked entries are -1e30 (the
mask value of ops/masking.py), as in the JAX kernels.

Each wrapper takes its plain PyTorch version for CPU tensors and only
then.  For CUDA tensors it launches the kernel or raises; it never falls
back.  On a non-CPU device the wrappers raise on an input that requires
grad: ``ops.attention.AffinityAttention`` calls them on detached tensors
and gives the graph its backward.  ``<wrapper>.launches`` counts kernel
launches.

Both kernels are also ``torch.library`` custom ops,
``torch.ops.umpr_tpu_torch.affinity_tiles`` and ``.affinity_finish``, for
the one caller that runs under ``torch.export``: the forward-only
long-history route of the kernel-free model
(``ops.attention.affinity_attention_ops``), which export.py bakes into an
artifact.  On CUDA tensors an op is the wrapper (it launches the kernel
and counts it), on CPU tensors the plain version; its fake
implementation gives a trace the outputs' shapes and dtypes.  They are
registered when this module is imported, and nothing is compiled then.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from umpr_tpu_torch.ops.gru_cuda import _check, _device_kernel, _launch
from umpr_tpu_torch.ops.masking import NEG_INF, masked_softmax

_P, _I = ctypes.c_void_p, ctypes.c_int

ROW_TILE = 128  # rows p per K7 block: one column partial each (affinity_tiles.cu BR)
FINISH_CLUSTER = 8  # K8's blocks per sample, one cluster (affinity_finish.cu CLUSTER)
PLAIN_ELEMENTS = 1 << 26  # entries of A the plain version holds at a time


def affinity_tiles_ref(T, U, exists):
    """Plain version of K7: T, U (B, P, D) f32, exists (P,) bool ->
    (col_val (B, R, P), col_idx (B, R, P) int32, row_val (B, P), row_idx
    (B, P) int32), R = ceil(P / ROW_TILE).  A is formed a few samples at a
    time (PLAIN_ELEMENTS), so a full (B, P, P) tensor never exists."""
    B, P, _ = T.shape
    R = -(-P // ROW_TILE)
    col_val = T.new_empty(B, R, P)
    col_idx = torch.empty(B, R, P, dtype=torch.int32, device=T.device)
    row_val = T.new_empty(B, P)
    row_idx = torch.empty(B, P, dtype=torch.int32, device=T.device)
    first_row = torch.arange(0, R * ROW_TILE, ROW_TILE, device=T.device)[:, None]
    step = max(1, PLAIN_ELEMENTS // (P * P))
    for b0 in range(0, B, step):
        s = slice(b0, b0 + step)
        A = torch.tanh(T[s] @ U[s].transpose(1, 2))  # (c, P, P): rows p, columns q
        # the last tile's rows past P are -inf: they lose to every entry
        Ar = F.pad(torch.where(exists[:, None], A, NEG_INF),
                   (0, 0, 0, R * ROW_TILE - P), value=float("-inf"))
        Ar = Ar.view(-1, R, ROW_TILE, P)
        col_val[s] = Ar.amax(2)
        col_idx[s] = (Ar.argmax(2) + first_row).int()
        del Ar
        Ac = torch.where(exists[None, :], A, NEG_INF)
        row_val[s] = Ac.amax(2)
        row_idx[s] = Ac.argmax(2).int()
        del A, Ac
    return col_val, col_idx, row_val, row_idx


def affinity_finish_ref(col_val, col_idx, row_val, exists, U, I):
    """Plain version of K8: K7's outputs (row_idx aside), exists (P,) bool,
    U, I (B, P, D) -> (soft_u, soft_i (B, P), atte_u, atte_i (B, D),
    colmax (B, P), amax_u (B, P) int32)."""
    tile = col_val.argmax(1, keepdim=True)  # the first tile holding the max
    colmax = col_val.gather(1, tile)[:, 0]
    amax_u = col_idx.gather(1, tile)[:, 0]
    soft_u = masked_softmax(colmax, exists[None, :], dim=-1)
    soft_i = masked_softmax(row_val, exists[None, :], dim=-1)
    atte_u = torch.einsum("bpd,bp->bd", U, soft_u)
    atte_i = torch.einsum("bpd,bp->bd", I, soft_i)
    return soft_u, soft_i, atte_u, atte_i, colmax, amax_u


def _max_nan(a, b):
    """max that is NaN where either side is (torch.amax's rule)."""
    return torch.where((a > b) | a.isnan(), a, b)


def affinity_finish_cluster_ref(col_val, col_idx, row_val, exists, U, I, C=FINISH_CLUSTER):
    """Plain version of K8's order of work: the positions cut into C
    chunks [c P / C, (c + 1) P / C), one per block of the sample's
    cluster; each chunk's masked maximum, folded in chunk order (an empty
    chunk gives -inf); ex = exp(s - max) where the position exists; each
    chunk's sum of ex and its column sums ex^T U, ex^T I (masked positions
    included: 0 * NaN stays NaN), each added in chunk order; soft = ex /
    sum, atte = (column sums) / sum.  Same outputs as
    ``affinity_finish_ref``."""
    B, P, D = U.shape
    tile = col_val.argmax(1, keepdim=True)  # the merge: as affinity_finish_ref
    colmax = col_val.gather(1, tile)[:, 0]
    amax_u = col_idx.gather(1, tile)[:, 0]
    bounds = [c * P // C for c in range(C + 1)]
    chunks = [slice(lo, hi) for lo, hi in zip(bounds, bounds[1:])]
    out = []
    for score, X in ((colmax, U), (row_val, I)):
        s = torch.where(exists, score, NEG_INF)
        m = s.new_full((B,), float("-inf"))
        for c in chunks:
            if c.stop > c.start:
                m = _max_nan(m, s[:, c].amax(1))
        ex = torch.where(exists, torch.exp(s - m[:, None]), 0.0)
        total, cols = s.new_zeros(B), X.new_zeros(B, D)
        for c in chunks:
            total = total + ex[:, c].sum(1)
            cols = cols + torch.einsum("bp,bpd->bd", ex[:, c], X[:, c])
        out.append((ex / total[:, None], cols / total[:, None]))
    (soft_u, atte_u), (soft_i, atte_i) = out
    return soft_u, soft_i, atte_u, atte_i, colmax, amax_u


NODE = "ops.attention.AffinityAttention"


def _check_positions(name, X, B, P, exists):
    _check(name, X, torch.float32, 3, exists.device)
    _check("exists", exists, torch.bool, 1, exists.device)
    if X.shape[:2] != (B, P) or exists.shape[0] != P:
        raise ValueError(f"{name} {tuple(X.shape)} and exists {tuple(exists.shape)} "
                         f"do not fit B={B}, P={P}")


def affinity_tiles(T, U, exists):
    """K7: T, U (B, P, D) f32, exists (P,) bool -> (col_val (B, R, P) f32,
    col_idx (B, R, P) int32, row_val (B, P) f32, row_idx (B, P) int32)."""
    if T.device.type == "cpu":
        return affinity_tiles_ref(T, U, exists)
    _device_kernel("affinity_tiles", T, U, node=NODE)
    B, P, D = T.shape
    _check_positions("T", T, B, P, exists)
    _check_positions("U", U, B, P, exists)
    if U.shape[2] != D or D == 0:
        raise ValueError(f"affinity_tiles: T {tuple(T.shape)} and U {tuple(U.shape)} "
                         "differ in D or have none")
    if B > 65535:
        raise ValueError(f"affinity_tiles: B={B} exceeds the grid")
    R = -(-P // ROW_TILE)
    col_val = torch.empty(B, R, P, device=T.device, dtype=torch.float32)
    col_idx = torch.empty(B, R, P, device=T.device, dtype=torch.int32)
    row_val = torch.empty(B, P, device=T.device, dtype=torch.float32)
    row_idx = torch.empty(B, P, device=T.device, dtype=torch.int32)
    _launch("affinity_tiles", [_P] * 7 + [_I] * 3 + [_P],
            T.data_ptr(), U.data_ptr(), exists.data_ptr(), col_val.data_ptr(),
            col_idx.data_ptr(), row_val.data_ptr(), row_idx.data_ptr(), B, P, D)
    affinity_tiles.launches += 1
    return col_val, col_idx, row_val, row_idx


affinity_tiles.launches = 0


def affinity_finish(col_val, col_idx, row_val, exists, U, I):
    """K8: K7's col_val, col_idx (B, R, P), row_val (B, P), exists (P,)
    bool, U, I (B, P, D) f32 -> (soft_u, soft_i (B, P), atte_u, atte_i
    (B, D), colmax (B, P) f32, amax_u (B, P) int32)."""
    if U.device.type == "cpu":
        return affinity_finish_ref(col_val, col_idx, row_val, exists, U, I)
    _device_kernel("affinity_finish", U, I, col_val, row_val, node=NODE)
    B, P, D = U.shape
    R = -(-P // ROW_TILE)
    _check_positions("U", U, B, P, exists)
    _check_positions("I", I, B, P, exists)
    _check("col_val", col_val, torch.float32, 3, U.device)
    _check("col_idx", col_idx, torch.int32, 3, U.device)
    _check("row_val", row_val, torch.float32, 2, U.device)
    if (I.shape[2] != D or tuple(col_val.shape) != (B, R, P)
            or tuple(col_idx.shape) != (B, R, P) or tuple(row_val.shape) != (B, P)):
        raise ValueError(
            f"affinity_finish: col_val {tuple(col_val.shape)}, col_idx "
            f"{tuple(col_idx.shape)}, row_val {tuple(row_val.shape)}, I "
            f"{tuple(I.shape)} do not fit U {tuple(U.shape)}")
    if B * FINISH_CLUSTER > 2 ** 31 - 1:
        raise ValueError(f"affinity_finish: B={B} exceeds the grid")
    soft_u, soft_i, colmax = (torch.empty(B, P, device=U.device, dtype=torch.float32)
                              for _ in range(3))
    atte_u, atte_i = (torch.empty(B, D, device=U.device, dtype=torch.float32)
                      for _ in range(2))
    amax_u = torch.empty(B, P, device=U.device, dtype=torch.int32)
    _launch("affinity_finish", [_P] * 12 + [_I] * 4 + [_P],
            col_val.data_ptr(), col_idx.data_ptr(), row_val.data_ptr(), exists.data_ptr(),
            U.data_ptr(), I.data_ptr(), soft_u.data_ptr(), soft_i.data_ptr(),
            atte_u.data_ptr(), atte_i.data_ptr(), colmax.data_ptr(), amax_u.data_ptr(),
            B, R, P, D)
    affinity_finish.launches += 1
    return soft_u, soft_i, atte_u, atte_i, colmax, amax_u


affinity_finish.launches = 0

KERNELS = (affinity_tiles, affinity_finish)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


_TILES_SCHEMA = "(Tensor T, Tensor U, Tensor exists) -> (Tensor, Tensor, Tensor, Tensor)"
_FINISH_SCHEMA = ("(Tensor col_val, Tensor col_idx, Tensor row_val, Tensor exists, Tensor U, "
                  "Tensor I) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")


@torch.library.custom_op("umpr_tpu_torch::affinity_tiles", mutates_args=(),
                         device_types="cpu", schema=_TILES_SCHEMA)
def affinity_tiles_op(T, U, exists):
    """K7 as a custom op (see the module docstring)."""
    return affinity_tiles_ref(T, U, exists)


affinity_tiles_op.register_kernel("cuda")(affinity_tiles)


@affinity_tiles_op.register_fake
def _(T, U, exists):
    B, P, _ = T.shape
    R = -(-P // ROW_TILE)
    return (T.new_empty(B, R, P), T.new_empty(B, R, P, dtype=torch.int32),
            T.new_empty(B, P), T.new_empty(B, P, dtype=torch.int32))


@torch.library.custom_op("umpr_tpu_torch::affinity_finish", mutates_args=(),
                         device_types="cpu", schema=_FINISH_SCHEMA)
def affinity_finish_op(col_val, col_idx, row_val, exists, U, I):
    """K8 as a custom op (see the module docstring)."""
    return affinity_finish_ref(col_val, col_idx, row_val, exists, U, I)


affinity_finish_op.register_kernel("cuda")(affinity_finish)


@affinity_finish_op.register_fake
def _(col_val, col_idx, row_val, exists, U, I):
    B, P, D = U.shape
    return (*(U.new_empty(B, P) for _ in range(2)), *(U.new_empty(B, D) for _ in range(2)),
            U.new_empty(B, P), U.new_empty(B, P, dtype=torch.int32))
