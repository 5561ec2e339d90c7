"""Review network: R-Net word-level cross attention + S-Net sentence
sentiment + textual matching fusion (port of umpr_tpu/models/review_net.py,
paper eqs. 3-8), over static shapes with runtime exists masks.
"""

from __future__ import annotations

import torch
from torch import nn

from umpr_tpu_torch.models.layers import linear, randn
from umpr_tpu_torch.ops.attention import affinity_attention
from umpr_tpu_torch.ops.gru import BiGRU, bigru_split
from umpr_tpu_torch.ops.masking import masked_softmax


class RNet(nn.Module):
    def __init__(self, emb_size, gru_size, generator=None):
        super().__init__()
        self.gru = BiGRU(emb_size, gru_size, generator)
        # learned affinity bilinear form M (2u, 2u), torch.randn init
        self.M = nn.Parameter(randn((2 * gru_size, 2 * gru_size), generator))

    def forward(self, both_emb, u_lengths, i_lengths, exists):
        """both_emb: (2B, S, L, E), user histories stacked over item
        histories; *_lengths: (B, S) int32; exists: (S, L) bool.

        Returns y_sent (2*B*S, L, 2u), soft_u, soft_i (B, S*L) and
        atte_u, atte_i (B, 2u).  Eq. 3-4."""
        B2, S, L, E = both_emb.shape
        B = B2 // 2
        both_len = torch.cat([u_lengths.reshape(-1), i_lengths.reshape(-1)])
        y_pos, y_sent = bigru_split(self.gru, both_emb.reshape(B2 * S, L, E),
                                    both_len, S)
        soft_u, soft_i, atte_u, atte_i = affinity_attention(
            y_pos[:B], y_pos[B:], self.M, exists.reshape(S * L))
        return y_sent, soft_u, soft_i, atte_u, atte_i


class SNet(nn.Module):
    def __init__(self, self_atte_size, repr_size, generator=None):
        super().__init__()
        # torch.randn parameters (reference model.py:63-64)
        self.Ms = nn.Parameter(randn((self_atte_size, repr_size), generator))
        self.Ws = nn.Parameter(randn((1, self_atte_size), generator))


def snet_pair(snet_u, snet_i, y_sent, soft_u, soft_i, S, t_exists):
    """Both S-Nets (eq. 5-6) in one batched pass over the (2*B*S, L, 2u)
    GRU output, a 2-valued group axis carrying the user/item parameters.

    Returns sentiment_u, sentiment_i (B, 2u)."""
    BS2, L, D = y_sent.shape
    B = BS2 // (2 * S)
    Hg = y_sent.reshape(2, BS2 // 2, L, D)
    Ms = torch.stack([snet_u.Ms, snet_i.Ms])          # (2, a, D)
    Ws = torch.stack([snet_u.Ws, snet_i.Ws])          # (2, 1, a)
    inner = torch.einsum("gae,gnle->gnla", Ms, Hg)
    scores = torch.einsum("goa,gnla->gnl", Ws, torch.tanh(inner))
    sent_soft = masked_softmax(scores, t_exists[None, None, :], dim=-1)
    self_atte = torch.einsum("gnle,gnl->gne", Hg, sent_soft)  # (2, B*S, D)
    mass = torch.stack([soft_u, soft_i]).reshape(2, B * S, -1).sum(dim=-1)
    sentiment = (mass[..., None] * self_atte).reshape(2, B, S, D).sum(dim=2)
    return sentiment[0], sentiment[1]


class ReviewNet(nn.Module):
    def __init__(self, emb_size, gru_size, atte_size, generator=None):
        super().__init__()
        self.rnet = RNet(emb_size, gru_size, generator)
        self.snet_u = SNet(atte_size, 2 * gru_size, generator)
        self.snet_i = SNet(atte_size, 2 * gru_size, generator)
        self.linear_u = linear(4 * gru_size, 2 * gru_size, bias=False,
                               generator=generator)
        self.linear_i = linear(4 * gru_size, 2 * gru_size, bias=False,
                               generator=generator)

    def forward(self, both_emb, u_lengths, i_lengths, exists):
        """both_emb: (2B, S, L, E) user histories stacked over item
        histories -> (B, 2u) textual-matching representation (eq. 7-8)."""
        S = both_emb.shape[1]
        y_sent, soft_u, soft_i, atte_u, atte_i = self.rnet(
            both_emb, u_lengths, i_lengths, exists)
        # token mask of row 0 == that of any existing sentence row
        sent_u, sent_i = snet_pair(self.snet_u, self.snet_i, y_sent,
                                   soft_u, soft_i, S, exists[0])
        repr_u = torch.cat([atte_u, sent_u], dim=-1)  # eq. 7
        repr_i = torch.cat([atte_i, sent_i], dim=-1)
        return torch.tanh(self.linear_u(repr_u) + self.linear_i(repr_i))  # eq. 8
