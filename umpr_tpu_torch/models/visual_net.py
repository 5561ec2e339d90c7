"""Visual network: VGG16 feature extractor + per-view positive/negative
matching (port of umpr_tpu/models/visual_net.py, paper eqs. 10-11).

As in the reference (src/model.py:201-229): torchvision's VGG16 with its
1000-logit classifier, fed RGB /255 without ImageNet mean/std
normalisation, trainable, with dropout 0.5 in the classifier while
training.  VGG16 is written out here (no torchvision):

- photos arrive as uint8 and become float /255 on the device, in the
  parameters' type;
- convs run in ``torch.channels_last``, so a conv output's
  ``.permute(0, 2, 3, 1)`` is a free NHWC view;
- fc1 takes the true conv output, 512 * (photo_size / 32)^2 features,
  flattened in (C, H, W) order so torchvision weights load as they are;
- init without pretrained weights follows torchvision's
  _initialize_weights: kaiming-normal (fan_out) convs, N(0, 0.01)
  linears, zero biases;
- dropout draws its masks from an explicit ``torch.Generator`` (None: no
  dropout), or takes them pre-drawn from that generator by the same calls
  (``keep_masks``): a CUDA graph of train steps cannot seed a generator
  inside the graph, so the step's masks are drawn before each replay into
  buffers the graph reads (train/step.py).

With ``fused_pool`` a block whose last conv output is at least 56 high
and of even height (blocks 1-3 at 224 px, block 1 at 64 px) closes with
the conv WITHOUT bias, then ``fused_bias_relu_pool`` (K5/K6,
ops/pool.py), under the JAX package's gate (``visual_net.py:228-231``);
every other conv is conv + bias -> ReLU, and every other pool PyTorch's
2x2 max-pool.  The JAX package's
width-folded block 1 (``vgg_fold_w``) is a TPU lane-layout trick that
computes the same function; the port never folds.

With ``remat`` (``--remat_vgg``, the JAX package's ``jax.checkpoint`` of
each block) a forward that records gradients keeps only each block's
pooled output and runs the block again in the backward
(``torch.utils.checkpoint``): the same bits for about one more forward's
convs, and a fused block's K5 launches twice per train step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from umpr_tpu_torch.models.layers import linear, randn
from umpr_tpu_torch.ops.pool import fused_bias_relu_pool

# VGG16 ("configuration D"): conv widths, 'M' = 2x2/2 max-pool
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
VGG_OUT = 1000
FUSED_POOL_MIN_H = 56


def vgg_blocks():
    """VGG16_CFG split at its pools: the conv widths of each block."""
    blocks, cur = [], []
    for v in VGG16_CFG:
        if v == "M":
            blocks.append(tuple(cur))
            cur = []
        else:
            cur.append(v)
    return tuple(blocks)


def keep_mask(shape, generator, device):
    """One dropout call's keep mask: each element kept with probability
    0.5, drawn from `generator` on `device`."""
    return torch.rand(shape, generator=generator, device=device) < 0.5


def keep_masks(shapes, generator, device):
    """The keep masks of a forward's dropout calls (``dropout_shapes``),
    drawn by the calls the forward would make, in its order: the same bits
    as drawing them during the forward."""
    return [keep_mask(s, generator, device) for s in shapes]


def dropout(x, keep):
    """Keep each element where `keep` is True and scale it by 2; `keep` is
    a bool mask of x's shape, or a generator on x's device to draw it from."""
    if isinstance(keep, torch.Generator):
        keep = keep_mask(x.shape, keep, x.device)
    return torch.where(keep, x / 0.5, 0.0)


class VGG16(nn.Module):
    def __init__(self, num_classes=VGG_OUT, img_size=224, fused_pool=False,
                 generator=None, remat=False):
        super().__init__()
        if img_size <= 0 or img_size % 32:
            raise ValueError(f"photo size {img_size} must be a positive multiple "
                             "of 32 (five 2x2 pools)")
        self.fused_pool = fused_pool
        self.remat = remat
        self.features = nn.ModuleList()
        in_ch = 3
        for v in (v for v in VGG16_CFG if v != "M"):
            conv = nn.Conv2d(in_ch, v, 3, padding=1)
            with torch.no_grad():
                conv.weight.copy_(randn(conv.weight.shape, generator)
                                  * math.sqrt(2.0 / (v * 3 * 3)))
                conv.bias.zero_()
            self.features.append(conv)
            in_ch = v
        spatial = img_size // 32
        self.classifier = nn.ModuleList()
        for d_in, d_out in ((512 * spatial * spatial, 4096), (4096, 4096),
                            (4096, num_classes)):
            fc = nn.Linear(d_in, d_out)
            with torch.no_grad():
                fc.weight.copy_(randn((d_out, d_in), generator) * 0.01)
                fc.bias.zero_()
            self.classifier.append(fc)

    def dropout_shapes(self, n_images):
        """The shapes of the forward's dropout calls, in order."""
        return [(n_images, fc.out_features) for fc in self.classifier[:2]]

    def _block(self, x, first, widths):
        """One conv block (convs ``features[first:]`` of `widths`) and the
        pool that closes it, NCHW in channels_last -> the pooled output."""
        for j in range(len(widths)):
            conv = self.features[first + j]
            H = x.shape[2]
            if (self.fused_pool and j == len(widths) - 1
                    and H >= FUSED_POOL_MIN_H and H % 2 == 0):
                y = F.conv2d(x, conv.weight, None, padding=1)
                return fused_bias_relu_pool(y.permute(0, 2, 3, 1), conv.bias).permute(0, 3, 1, 2)
            x = F.relu(conv(x))
        return F.max_pool2d(x, 2)

    def forward(self, images, drop=None):
        """images (N, H, W, 3) float NHWC -> (N, num_classes) logits.
        drop: None (no dropout), a torch.Generator on the images' device,
        or the keep masks of ``dropout_shapes(N)``, pre-drawn."""
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        first = 0
        for widths in vgg_blocks():
            if self.remat and torch.is_grad_enabled():
                # the blocks draw no random numbers, and saving the CUDA
                # generator's state would fail under a graph's capture
                x = checkpoint(self._block, x, first, widths, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._block(x, first, widths)
            first += len(widths)
        x = x.reshape(x.shape[0], -1)  # (C, H, W) order, as torchvision's
        for i, fc in enumerate(self.classifier):
            x = fc(x)
            if i < 2:
                x = F.relu(x)
                if drop is not None:
                    x = dropout(x, drop if isinstance(drop, torch.Generator) else drop[i])
        return x


class VisualNet(nn.Module):
    def __init__(self, view_size, img_size=224, fused_pool=False, generator=None,
                 remat=False):
        super().__init__()
        self.vgg16 = VGG16(VGG_OUT, img_size, fused_pool, generator, remat)
        # torch.randn view embeddings (reference model.py:208)
        self.pos_v_emb = nn.Parameter(randn((view_size, VGG_OUT), generator))
        self.neg_v_emb = nn.Parameter(randn((view_size, VGG_OUT), generator))
        self.linear = linear(VGG_OUT, 1, generator=generator)

    def forward(self, photos, c_u, c_i, drop=None):
        """photos (B, V, P, H, W, 3) uint8; c_u, c_i (B, V).  Returns
        pos_match, neg_match, final_pos, final_neg, each (B, V) (eq.
        10-11).  drop: as VGG16.forward's."""
        B, V, P = photos.shape[:3]
        images = photos.reshape((B * V * P,) + photos.shape[3:])
        images = images.to(self.linear.weight.dtype) / 255.0  # the parameters' type
        img_repr = self.vgg16(images, drop)
        img_repr = img_repr.reshape(B, V, P, -1).mean(dim=2)  # eq. 10
        img_emb = self.linear(img_repr)[..., 0]                # (B, V)
        pos_emb = self.linear(self.pos_v_emb)[..., 0]          # (V,)
        neg_emb = self.linear(self.neg_v_emb)[..., 0]
        pos_match = torch.tanh(torch.abs(pos_emb - img_emb))  # eq. 11
        neg_match = torch.tanh(torch.abs(neg_emb - img_emb))
        return (pos_match, neg_match, c_u * c_i * (1.0 - pos_match),
                c_u * c_i * (1.0 - neg_match))
