"""R-Net affinity attention (paper eq. 3-4), routed as in
umpr_tpu/ops/attention.py:33-77.

    A      = tanh(gru_i @ M @ gru_u^T)            (B, P, P), P = S*L
    soft_u = softmax_q( max_p A[p, q] )           over existing positions
    soft_i = softmax_p( max_q A[p, q] )
    atte_u = gru_u^T @ soft_u,  atte_i = gru_i^T @ soft_i

Two implementations of one function:

- the composite (``affinity_attention_composite``): the (B, P, P) tensor
  in device memory, masked max and softmax in PyTorch, autograd's
  backward (which splits the gradient of a tied max);
- the kernel path (``AffinityAttention``): T = gru_i @ M by torch.matmul,
  then K7 and K8 of ops/attention_cuda.py, which never store A and keep
  each max's first argmax; the backward routes each max's gradient to that
  one position (``_argmax_routed_bwd``, attention_pallas.py:225-276) in
  plain PyTorch.

In bf16 the kernel path is the JAX package's function: its Pallas
kernels (B9 ``_tiled_fwd_impl``, B10 ``_prep``, attention_pallas.py:195-216,
:455-501) widen gru_u, gru_i and M to f32, form T and run the whole
forward and backward in f32, and round the four outputs and the three
gradients to the inputs' types.  So ``AffinityAttention`` widens on entry
and its counterpart is the f32 K7/K8: there is no bf16 K7/K8, because the
JAX package has no bf16 form of these kernels to port.

``affinity_attention`` takes the kernel path where the JAX package takes a
Pallas kernel: above TILED_BYTES_THRESHOLD bytes of (B, P, P) f32 (its
column-tiled B9) and, with ``use_pallas``, when D % 128 == 0 and P fits the
whole-tile B10.  It raises where the JAX package raises (its tiled kernel's
P ceiling), so both packages accept the same configs.  On the CPU the
kernel path runs the kernels' plain versions.

The kernel-free model of export (``use_kernels`` False) takes the same
kernels above the threshold, as the JAX package's ``use_pallas=False``
model takes B9 there, but through ``affinity_attention_ops``: the forward
alone, through K7/K8's ``torch.library`` custom ops, which
``torch.export`` traces into the artifact (a ctypes call takes a data
pointer, which a traced tensor does not have).  Below the threshold that
model takes the composite, and its artifact holds no kernel.
"""

from __future__ import annotations

import torch

from umpr_tpu_torch.ops import attention_cuda
from umpr_tpu_torch.ops.masking import masked_max, masked_softmax

# above this (B, P, P) f32 byte count the kernel path is taken (read at
# call time); the JAX package's threshold
TILED_BYTES_THRESHOLD = 4 << 30
MAX_KERNEL_P = 1024  # B10's largest padded P (attention_pallas.max_kernel_p)


def max_tiled_p(D):
    """The largest P the JAX package's tiled kernel accepts at width D
    (umpr_tpu/ops/attention.py:45-46: two (P, D) blocks and eight (P, 128)
    temporaries in 90 MB of VMEM, D and P in 128-lane multiples)."""
    Dp = -(-D // 128) * 128
    return (90 << 20) // (4 * (2 * Dp + 8 * 128)) // 128 * 128


def affinity_attention(gru_u, gru_i, M, exists, use_pallas=False, use_kernels=True):
    """gru_u/gru_i: (B, P, D); M: (D, D); exists: (P,) bool; use_kernels
    False: the kernel-free model's routes (no backward above the
    threshold).

    Returns soft_u, soft_i (B, P) and atte_u, atte_i (B, D)."""
    B, P, D = gru_u.shape
    if B * P * P * 4 > TILED_BYTES_THRESHOLD:
        if P > max_tiled_p(D):
            raise NotImplementedError(
                f"affinity attention: P={P} exceeds the ceiling of the JAX "
                f"package's tiled kernel (~{max_tiled_p(D)} at D={D}), which "
                "the port keeps so that both accept the same configs; reduce "
                "max_sent_count/max_sent_length")
        if not use_kernels:
            return affinity_attention_ops(gru_u, gru_i, M, exists)
        return AffinityAttention.apply(gru_u, gru_i, M, exists)
    if use_pallas and D % 128 == 0 and -(-P // 128) * 128 <= MAX_KERNEL_P:
        return AffinityAttention.apply(gru_u, gru_i, M, exists)
    return affinity_attention_composite(gru_u, gru_i, M, exists)


def affinity_attention_composite(gru_u, gru_i, M, exists):
    """The composite body, un-routed."""
    A = torch.tanh((gru_i @ M) @ gru_u.transpose(1, 2))
    soft_u = masked_softmax(masked_max(A, exists[None, :, None], dim=-2),
                            exists[None, :], dim=-1)
    soft_i = masked_softmax(masked_max(A, exists[None, None, :], dim=-1),
                            exists[None, :], dim=-1)
    atte_u = torch.einsum("bpe,bp->be", gru_u, soft_u)
    atte_i = torch.einsum("bpe,bp->be", gru_i, soft_i)
    return soft_u, soft_i, atte_u, atte_i


def affinity_attention_ops(gru_u, gru_i, M, exists):
    """The kernel path's forward through K7/K8's custom ops, for
    ``torch.export``: AffinityAttention.forward's function (widened to f32,
    T = gru_i @ M, the four outputs rounded to the inputs' dtype), and no
    backward.  Nothing (B, P, P)-shaped is formed."""
    dtype = gru_u.dtype
    U, I, M = (t.float().contiguous() for t in (gru_u, gru_i, M))
    T = torch.matmul(I, M)
    col_val, col_idx, rowmax, _ = torch.ops.umpr_tpu_torch.affinity_tiles(T, U, exists)
    soft_u, soft_i, atte_u, atte_i, _, _ = torch.ops.umpr_tpu_torch.affinity_finish(
        col_val, col_idx, rowmax, exists, U, I)
    return tuple(t.to(dtype) for t in (soft_u, soft_i, atte_u, atte_i))


def _softmax_vjp(soft, dsoft):
    return soft * (dsoft - (dsoft * soft).sum(1, keepdim=True))


def argmax_routed_backward(U, I, M, T, res, grads):
    """The backward of the kernel path (``_argmax_routed_bwd``,
    attention_pallas.py:225-276): no (P, P)-shaped work.  res = (soft_u,
    soft_i, colmax, rowmax, amax_u, amax_i), grads = the cotangents of
    (soft_u, soft_i, atte_u, atte_i) -> (dU, dI, dM).

    Each max's gradient lands at its saved argmax: a gather and an
    accumulating index_put_ per half.  index_put_ with accumulate=True adds
    duplicates in a fixed order on CUDA (a sort, no atomics), so the
    gradient is the same bits on every run."""
    soft_u, soft_i, colmax, rowmax, amax_u, amax_i = res
    dsu, dsi, dau, dai = grads
    B, P, D = U.shape
    # atte_u = soft_u @ U, atte_i = soft_i @ I
    dsu = dsu + torch.einsum("bd,bpd->bp", dau, U)
    dsi = dsi + torch.einsum("bd,bpd->bp", dai, I)
    val_u = _softmax_vjp(soft_u, dsu) * (1.0 - colmax * colmax)  # tanh' at the max
    val_i = _softmax_vjp(soft_i, dsi) * (1.0 - rowmax * rowmax)
    # clipped as attention_pallas.py:243-244 clips a fully masked index
    au = amax_u.long().clamp(max=P - 1)
    ai = amax_i.long().clamp(max=P - 1)
    b = torch.arange(B, device=U.device)[:, None].expand(B, P)
    # u-half: colmax[q] = A[au[q], q];  i-half: rowmax[p] = A[p, ai[p]]
    dU = soft_u[..., None] * dau[:, None, :] + val_u[..., None] * T[b, au]
    dT = val_i[..., None] * U[b, ai]
    dT.index_put_((b, au), val_u[..., None] * U, accumulate=True)
    dU.index_put_((b, ai), val_i[..., None] * T, accumulate=True)
    # T = I @ M.  dM: one (D, D) product per sample, summed over samples in
    # order, rather than one product with a B*P-deep contraction, which
    # has a (D, D) output to spread over the card
    dI = soft_i[..., None] * dai[:, None, :] + dT @ M.t()
    dM = torch.bmm(I.transpose(1, 2), dT).sum(0)
    return dU, dI, dM


class AffinityAttention(torch.autograd.Function):
    """The kernel path as one autograd node: forward T = gru_i @ M, K7, K8
    on detached tensors; backward ``argmax_routed_backward``.  The max
    gradient goes to the first argmax, as torch.max's does; the composite's
    amax splits it among exact ties (saturated tanh), where both are
    subgradients.  Inputs of another type (bf16) are widened to f32 on
    entry: T and every saved tensor are f32, and the outputs and gradients
    are rounded to the inputs' types, as the JAX kernels' wrappers do."""

    @staticmethod
    def forward(ctx, gru_u, gru_i, M, exists):
        ctx.dtypes = (gru_u.dtype, gru_i.dtype, M.dtype)
        U, I, M = (t.detach().float().contiguous() for t in (gru_u, gru_i, M))
        B, P, D = U.shape
        T = (I.view(B * P, D) @ M).view(B, P, D)
        col_val, col_idx, rowmax, amax_i = attention_cuda.affinity_tiles(T, U, exists)
        soft_u, soft_i, atte_u, atte_i, colmax, amax_u = attention_cuda.affinity_finish(
            col_val, col_idx, rowmax, exists, U, I)
        ctx.save_for_backward(U, I, M, T, soft_u, soft_i, colmax, rowmax, amax_u, amax_i)
        du = ctx.dtypes[0]
        return soft_u.to(du), soft_i.to(du), atte_u.to(du), atte_i.to(du)

    @staticmethod
    def backward(ctx, dsu, dsi, dau, dai):
        # soft_u, soft_i are outputs of this node: saved, they come back
        # requiring grad
        U, I, M, T, *res = (t.detach() for t in ctx.saved_tensors)
        grads = argmax_routed_backward(U, I, M, T, res,
                                       tuple(g.float() for g in (dsu, dsi, dau, dai)))
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None)
