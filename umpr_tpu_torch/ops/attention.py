"""R-Net affinity attention (paper eq. 3-4), the composite path of
umpr_tpu/ops/attention.py:80-90 in plain PyTorch.

    A      = tanh(gru_i @ M @ gru_u^T)            (B, P, P), P = S*L
    soft_u = softmax_q( max_p A[p, q] )           over existing positions
    soft_i = softmax_p( max_q A[p, q] )
    atte_u = gru_u^T @ soft_u,  atte_i = gru_i^T @ soft_i

The JAX package hands (B, P, P) tensors above 4 GiB to a flash-style tiled
kernel (B9, umpr_tpu/ops/attention_pallas.py); that kernel is not ported
yet, so such shapes raise here.
"""

from __future__ import annotations

import torch

from umpr_tpu_torch.ops.masking import masked_max, masked_softmax

TILED_BYTES_THRESHOLD = 4 << 30


def affinity_attention(gru_u, gru_i, M, exists):
    """gru_u/gru_i: (B, P, D); M: (D, D); exists: (P,) bool.

    Returns soft_u, soft_i (B, P) and atte_u, atte_i (B, D)."""
    B, P, _ = gru_u.shape
    if B * P * P * 4 > TILED_BYTES_THRESHOLD:
        raise NotImplementedError(
            f"affinity attention at B={B}, P={P} needs the tiled kernel B9 "
            "(umpr_tpu/ops/attention_pallas.py), which is not ported yet "
            "(ROADMAP queue B)")
    A = torch.tanh((gru_i @ M) @ gru_u.transpose(1, 2))
    soft_u = masked_softmax(masked_max(A, exists[None, :, None], dim=-2),
                            exists[None, :], dim=-1)
    soft_i = masked_softmax(masked_max(A, exists[None, None, :], dim=-1),
                            exists[None, :], dim=-1)
    atte_u = torch.einsum("bpe,bp->be", gru_u, soft_u)
    atte_i = torch.einsum("bpe,bp->be", gru_i, soft_i)
    return soft_u, soft_i, atte_u, atte_i
