"""Runtime "exists" masks: static shapes with per-batch dynamic-padding
numerics (port of umpr_tpu/ops/masking.py).

Arrays are padded to the config maxima (S, L); positions beyond the batch's
runtime maxima would not exist in the reference's dynamically padded batch
and are kept out of every max and softmax.  Masking is a select, never a
multiply: eager PyTorch gives 0 * NaN = NaN.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # saturating mask value


def exists_mask(max_count, max_len, S, L, device):
    """(S, L) bool: does (sentence s, token t) exist in the reference's
    dynamically padded batch?  max_count/max_len: ints or 0-d tensors."""
    s_ok = torch.arange(S, device=device) < max_count
    t_ok = torch.arange(L, device=device) < max_len
    return s_ok[:, None] & t_ok[None, :]


def masked_max(x, mask, dim):
    """max over `dim` counting only positions where mask is True."""
    return torch.where(mask, x, NEG_INF).amax(dim=dim)


def masked_softmax(scores, mask, dim=-1):
    """softmax over `dim` restricted to mask == True (zeros elsewhere)."""
    scores = torch.where(mask, scores, NEG_INF)
    scores = scores - scores.amax(dim=dim, keepdim=True)
    e = torch.where(mask, torch.exp(scores), 0.0)
    return e / e.sum(dim=dim, keepdim=True)
