"""Control network: C-Net view classifier, SS-Net sentiment scorer and the
preference routing (port of umpr_tpu/models/control_net.py, paper eqs.
14-18), with the reference's quirks (src/model.py:84-143, 172-198):

- view probabilities below `threshold` (0.35) are zeroed (eq. 15);
- eq. 18 divides by sum(view_p^2) + 1e-4;
- at a view score of exactly 0.5, q_pos and q_neg both survive their
  masks with value 0 and q_p is 0.

C-Net's bi-GRU runs through ``bigru_split`` (the kernels K1-K4) and uses
its per-sentence layout y_sent.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from umpr_tpu_torch.models.layers import Conv1dSame, linear
from umpr_tpu_torch.models.review_net import SNet, snet
from umpr_tpu_torch.ops.gru import BiGRU, bigru_split
from umpr_tpu_torch.ops.masking import masked_max


class CNet(nn.Module):
    def __init__(self, emb_size, gru_size, kernel_count, kernel_size, view_size,
                 generator=None):
        super().__init__()
        self.gru = BiGRU(emb_size, gru_size, generator)
        self.conv = Conv1dSame(2 * gru_size, kernel_count, kernel_size, generator)
        self.linear = linear(kernel_count, view_size, generator=generator)

    def forward(self, review_emb, lengths, exists, threshold):
        """review_emb (B, S, L, E); lengths (B, S); exists (S, L) runtime
        mask.  Returns gru_repr (B*S, L, 2u), view_p (B, S, V) and
        final_repr (B, V) (eq. 14-16)."""
        B, S, L, E = review_emb.shape
        _, gru_repr = bigru_split(self.gru, review_emb.reshape(B * S, L, E),
                                  lengths.reshape(-1), S)
        conv_out = F.relu(self.conv(gru_repr))  # (B*S, L_out, kernel_count)
        # max over the positions the reference's dynamically padded batch
        # has: its output length is Lb + 2*pad - k + 1 for batch max Lb
        k = self.conv.kernel_size[0]
        pad = (k - 1) // 2
        Lb = exists[0].sum()
        out_exists = torch.arange(conv_out.shape[1], device=conv_out.device) < (
            Lb + 2 * pad - k + 1)
        pooled = masked_max(conv_out, out_exists[None, :, None], dim=1)
        view_p = torch.sigmoid(self.linear(pooled)).reshape(B, S, -1)  # eq. 14
        view_p = torch.where(view_p < threshold, 0.0, view_p)  # eq. 15
        # sentences beyond the batch maximum contribute nothing
        view_p = torch.where(exists[:, 0][None, :, None], view_p, 0.0)
        return gru_repr, view_p, (view_p ** 2).sum(dim=-2)  # eq. 16


class SSNet(nn.Module):
    def __init__(self, input_size, generator=None):
        super().__init__()
        self.linear = linear(input_size, 1, generator=generator)

    def forward(self, sentiment_emb):
        """Per-sentence sentiment score in (0, 1) (eq. 17)."""
        return torch.sigmoid(self.linear(sentiment_emb))


class ControlNet(nn.Module):
    def __init__(self, emb_size, gru_size, kernel_count, kernel_size, view_size,
                 atte_size, generator=None):
        super().__init__()
        self.cnet = CNet(emb_size, gru_size, kernel_count, kernel_size, view_size,
                         generator)
        self.snet = SNet(atte_size, 2 * gru_size, generator)
        self.ssnet = SSNet(2 * gru_size, generator)

    def forward(self, both_emb, ui_emb, u_lengths, i_lengths, ui_lengths, exists,
                ui_exists, threshold):
        """both_emb (2B, S, L, E): user histories stacked over item
        histories; ui_emb (B, S_ui, L, E); exists (S, L) and ui_exists
        (S_ui, L) runtime masks.  Returns c_u, c_i, prefer_pos, prefer_neg,
        each (B, V) (eq. 17-18)."""
        B, S_ui = ui_emb.shape[:2]
        gru_repr, view_p, c_net_out = self.cnet(ui_emb, ui_lengths, ui_exists, threshold)
        # one C-Net call for the user and item histories (shared weights)
        _, _, c_both = self.cnet(both_emb, torch.cat([u_lengths, i_lengths]), exists,
                                 threshold)
        c_u, c_i = c_both[:B], c_both[B:]

        # S-Net over the ui review, view_p as each sentence's weight mass
        s, _ = snet(self.snet, gru_repr, view_p, S_ui, ui_exists[0])
        senti = self.ssnet(s)  # (B, S_ui, 1), broadcast over the views
        vp2 = view_p ** 2
        view_score = (senti * vp2).sum(dim=-2) / (vp2.sum(dim=-2) + 1e-4)  # eq. 18
        q_p = (view_score > 0.5).to(view_score.dtype)
        q_pos = torch.where(view_score < 0.5, 0.0, 4.0 * (view_score - 0.5) ** 2)
        q_neg = torch.where(view_score > 0.5, 0.0, 4.0 * (0.5 - view_score) ** 2)
        return c_u, c_i, c_net_out * q_p * q_pos, c_net_out * (1.0 - q_p) * q_neg
