"""UMPR: embedding -> ReviewNet [-> ControlNet + VisualNet] -> ReLU head
(port of umpr_tpu/models/umpr.py).  ``review_net_only`` gives UMPR-R.

- The GloVe table is frozen and is a checkpoint leaf.
- Runtime batch maxima give the exists masks, so a statically padded batch
  scores like the reference's dynamically padded one; ``pad_maxima`` in the
  batch pins them instead (serving pins them to the full padding; a rank's
  row block of a global batch takes the global batch's, parallel/).
- The MSE is a mask-weighted mean over real samples (over the global
  batch's ``sample_count`` where the batch carries one).  Full UMPR adds
  ``loss_v_rate * loss_v``, loss_v the mean of the cross-batch (V, V)
  product prefer^T @ match (reference model.py:276).
- Dead rows are dropped with selects before every product they reach:
  eager PyTorch gives 0 * NaN = NaN, in the forward and in a matmul's
  weight gradient alike.
- ``compute_dtype="bfloat16"`` is the JAX package's mixed precision
  (umpr.py:142-150): every floating parameter, the frozen GloVe table
  included, is cast to bf16 once per forward inside autograd (so the f32
  masters get the gradients through the cast), the activations stay bf16
  (the bi-GRU's kernels keep f32 state and accumulation), and the
  prediction is cast to f32 before the losses, whose operands are f32.
  Not ``torch.autocast``: its per-op policy runs softmax and reductions
  in f32 where the JAX package runs them in bf16, and casts matmul
  operands at other points.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from umpr_tpu_torch.models.control_net import ControlNet
from umpr_tpu_torch.models.layers import linear
from umpr_tpu_torch.models.review_net import ReviewNet, RNet
from umpr_tpu_torch.models.visual_net import VisualNet
from umpr_tpu_torch.ops import masking
from umpr_tpu_torch.ops.gru import BiGRU


@dataclass(frozen=True)
class ModelDims:
    """Static model configuration.  Unlike the JAX package's, it defaults
    to UMPR-R (``review_net_only=True``)."""
    gru_size: int = 64
    self_atte_size: int = 64
    review_net_only: bool = True
    kernel_count: int = 120
    kernel_size: int = 3
    threshold: float = 0.35
    view_size: int = 1
    loss_v_rate: float = 0.1
    photo_size: int = 224
    vgg_fused_pool: bool = False
    remat_vgg: bool = False
    # the JAX package's width-folded VGG block 1 computes the same function
    # as the unfolded one; the port takes the flag and never folds
    vgg_fold_w: bool = True
    compute_dtype: str = "float32"  # or "bfloat16"
    # False: the kernel-free model of export, the JAX package's
    # from_config(config, use_pallas=False): bigru_scan for the bi-GRU,
    # the composite pool (vgg_fused_pool ignored) and, below the
    # long-history threshold, the composite attention; above it K7/K8's
    # custom ops, forward only (ops/attention.py affinity_attention_ops)
    use_kernels: bool = True

    @classmethod
    def from_config(cls, config, use_kernels=True):
        return cls(gru_size=config.gru_size,
                   self_atte_size=config.self_atte_size,
                   review_net_only=config.review_net_only,
                   kernel_count=config.kernel_count,
                   kernel_size=config.kernel_size,
                   threshold=config.threshold,
                   view_size=len(config.views),
                   loss_v_rate=config.loss_v_rate,
                   photo_size=config.photo_size,
                   vgg_fused_pool=config.vgg_fused_pool,
                   remat_vgg=config.remat_vgg,
                   vgg_fold_w=config.vgg_fold_w,
                   compute_dtype=config.compute_dtype,
                   use_kernels=use_kernels)


class UMPR(nn.Module):
    """UMPR, or UMPR-R with ``dims.review_net_only``.  Built on the CPU
    from `generator`; move it with .to()."""

    def __init__(self, dims: ModelDims, word_emb, generator=None):
        super().__init__()
        self.dims = dims
        word_emb = torch.as_tensor(word_emb, dtype=torch.float32)
        self.embedding = nn.Embedding.from_pretrained(word_emb, freeze=True)
        emb_size = word_emb.shape[1]
        self.review_net = ReviewNet(emb_size, dims.gru_size,
                                    dims.self_atte_size, generator)
        fusion_in = 2 * dims.gru_size
        if not dims.review_net_only:
            self.control_net = ControlNet(
                emb_size, dims.gru_size, dims.kernel_count, dims.kernel_size,
                dims.view_size, dims.self_atte_size, generator)
            self.visual_net = VisualNet(dims.view_size, dims.photo_size,
                                        dims.vgg_fused_pool and dims.use_kernels, generator,
                                        dims.remat_vgg)
            fusion_in += 2 * dims.view_size
        self.linear_fusion = linear(fusion_in, 1, generator=generator)
        for m in self.modules():
            if isinstance(m, (BiGRU, RNet)):
                m.use_kernels = dims.use_kernels

    def dropout_shapes(self, batch):
        """The shapes of the dropout calls of a train forward of `batch`
        (VGG16's classifier; none for UMPR-R), in order."""
        if self.dims.review_net_only:
            return []
        B, V, P = batch["photos"].shape[:3]
        return self.visual_net.vgg16.dropout_shapes(B * V * P)

    def forward(self, batch, drop=None, _cast=True):
        """batch: dict of tensors from data.loader (u_/i_/ui_ tokens,
        lengths, counts, ratings, photos for full UMPR, optional
        sample_mask and pad_maxima).  drop: the VGG classifier's dropout
        masks: None (eval) turns dropout off; a torch.Generator on the
        model's device draws them; or they come pre-drawn
        (``visual_net.keep_masks`` of ``dropout_shapes(batch)``).

        Returns (prediction (B,), loss, {"loss_r": ..., ["loss_v": ...]}),
        all f32."""
        if _cast and self.dims.compute_dtype != "float32":
            dtype = getattr(torch, self.dims.compute_dtype)
            params = {n: p.to(dtype) if p.is_floating_point() else p
                      for n, p in self.named_parameters()}
            return torch.func.functional_call(self, params, (batch, drop),
                                              {"_cast": False})
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
        if self.dims.review_net_only:
            prediction = _widen(F.relu(self.linear_fusion(rn))[:, 0])
            loss = masked_sq_sum(prediction, labels, mask) / _sample_count(batch, mask)
            return prediction, loss, {"loss_r": loss}

        ui_tok, ui_len = batch["ui_tokens"], batch["ui_lengths"]
        if pm is None:
            Sb_ui, Lb_ui = batch["ui_counts"].max(), ui_len.max()
        else:
            Sb_ui, Lb_ui = pm[2], pm[3]
        ui_exists = masking.exists_mask(Sb_ui, Lb_ui, ui_tok.shape[1], L, u_tok.device)
        ui_emb = self.embedding(ui_tok.long())  # (B, S_ui, L, E)
        c_u, c_i, prefer_pos, prefer_neg = self.control_net(
            both_emb, ui_emb, u_len, i_len, ui_len, exists, ui_exists,
            self.dims.threshold)
        pos_match, neg_match, final_pos, final_neg = self.visual_net(
            batch["photos"], c_u, c_i, drop)

        alive = mask[:, None] > 0
        fused = torch.where(alive, torch.cat([rn, final_pos, final_neg], dim=-1), 0.0)
        prediction = _widen(F.relu(self.linear_fusion(fused))[:, 0])
        loss_r = masked_sq_sum(prediction, labels, mask) / _sample_count(batch, mask)
        # cross-batch (V, B) @ (B, V) in f32: dead rows selected out of both
        # operands
        prefer_pos, prefer_neg, pos_match, neg_match = (
            torch.where(alive, _widen(t), 0.0)
            for t in (prefer_pos, prefer_neg, pos_match, neg_match))
        loss_v = (prefer_pos.t() @ pos_match + prefer_neg.t() @ neg_match).mean()
        loss = loss_r + self.dims.loss_v_rate * loss_v
        return prediction, loss, {"loss_r": loss_r, "loss_v": loss_v}


def _sample_count(batch, mask):
    """The MSE's normaliser: the batch's count of real samples or, for a
    rank's row block, the global batch's (``sample_count``).  loss_v needs
    none: its product sums over the rows, so the ranks' terms add up."""
    n = batch.get("sample_count")
    return (mask.sum() if n is None else n).clamp(min=1.0)


def _widen(t):
    """bf16 activations to f32 for the losses (the JAX package's astype);
    f32 and f64 as they are."""
    return t.float() if t.dtype == torch.bfloat16 else t


def masked_sq_sum(pred, labels, mask):
    """Sum of squared errors over real samples (mask > 0).  The select
    comes before the square, so a dead row's NaN reaches neither the sum
    nor its gradient: the square's backward sees the selected 0, where a
    select after the square would multiply its zero cotangent by NaN."""
    err = torch.where(mask > 0, pred - labels, 0.0)
    return (err * err).sum()
