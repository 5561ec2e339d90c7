"""UMPR-R: embedding -> ReviewNet -> ReLU head (port of the
``review_net_only`` branch of umpr_tpu/models/umpr.py).

- The GloVe table is frozen and is a checkpoint leaf.
- Runtime batch maxima give the exists masks, so a statically padded batch
  scores like the reference's dynamically padded one; ``pad_maxima`` in the
  batch pins them instead (serving pins them to the full padding).
- The MSE is a mask-weighted mean over real samples.  Dead rows are dropped
  with a select: eager PyTorch gives 0 * NaN = NaN.

Full UMPR (ControlNet, VisualNet, loss_v) is ROADMAP A3.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from umpr_tpu_torch.models.layers import linear
from umpr_tpu_torch.models.review_net import ReviewNet
from umpr_tpu_torch.ops import masking


@dataclass(frozen=True)
class ModelDims:
    """Static model configuration."""
    gru_size: int = 64
    self_atte_size: int = 64

    @classmethod
    def from_config(cls, config):
        return cls(gru_size=config.gru_size,
                   self_atte_size=config.self_atte_size)


class UMPR(nn.Module):
    """UMPR-R.  Built on the CPU from `generator`; move it with .to()."""

    def __init__(self, dims: ModelDims, word_emb, generator=None):
        super().__init__()
        word_emb = torch.as_tensor(word_emb, dtype=torch.float32)
        self.embedding = nn.Embedding.from_pretrained(word_emb, freeze=True)
        emb_size = word_emb.shape[1]
        self.review_net = ReviewNet(emb_size, dims.gru_size,
                                    dims.self_atte_size, generator)
        self.linear_fusion = linear(2 * dims.gru_size, 1, generator=generator)

    def forward(self, batch):
        """batch: dict of tensors from data.loader (u_/i_ tokens, lengths,
        counts, ratings, optional sample_mask and pad_maxima).

        Returns (prediction (B,), loss, {"loss_r": loss})."""
        u_tok, i_tok = batch["u_tokens"], batch["i_tokens"]
        u_len, i_len = batch["u_lengths"], batch["i_lengths"]
        labels = batch["ratings"]
        mask = batch.get("sample_mask")
        if mask is None:
            mask = torch.ones_like(labels)
        B, S, L = u_tok.shape

        pm = batch.get("pad_maxima")
        if pm is None:
            # user and item share one maximum (the reference pads them jointly)
            Sb = torch.maximum(batch["u_counts"].max(), batch["i_counts"].max())
            Lb = torch.maximum(u_len.max(), i_len.max())
        else:
            Sb, Lb = pm[0], pm[1]
        exists = masking.exists_mask(Sb, Lb, S, L, u_tok.device)

        # one gather for user + item histories
        both_emb = self.embedding(torch.cat([u_tok, i_tok]).long())  # (2B, S, L, E)
        rn = self.review_net(both_emb, u_len, i_len, exists)
        prediction = F.relu(self.linear_fusion(rn))[:, 0]
        loss = masked_sq_sum(prediction, labels, mask) / mask.sum().clamp(min=1.0)
        return prediction, loss, {"loss_r": loss}


def masked_sq_sum(pred, labels, mask):
    """Sum of squared errors over real samples (mask > 0), a select so a
    dead row's NaN cannot reach the sum."""
    return torch.where(mask > 0, (pred - labels) ** 2, 0.0).sum()
