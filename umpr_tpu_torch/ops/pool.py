"""Fused bias + ReLU + 2x2/2 max-pool for the VGG16 pool boundaries (port
of umpr_tpu/ops/pool_pallas.py).

``fused_bias_relu_pool(x, b)`` takes a conv's raw (bias-free) output in
NHWC and returns the pooled relu(x + b) in one pass over x.  Its autograd
node ``FusedBiasReluPool`` runs K5 forward and K6 backward
(ops/pool_cuda.py; their plain versions on CPU tensors) and saves only
the pooled output and the window argmax: neither x nor the full-size
post-bias tensor is kept for the backward.  Gradient ties go to the first
corner of the window, and windows whose pooled value is not > 0 get no
gradient (the ReLU mask).

``reference_bias_relu_pool`` is the composite the kernels replace: ReLU,
then PyTorch's max-pool on the NCHW view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from umpr_tpu_torch.ops import pool_cuda


class FusedBiasReluPool(torch.autograd.Function):
    """relu(x + b) -> 2x2/2 max-pool as one autograd node over x (N, H, W,
    C) and b (C,): K5 forward, K6 backward, on detached tensors."""

    @staticmethod
    def forward(ctx, x, b):
        yp, idx = pool_cuda.bias_relu_pool(x.detach(), b.detach())
        ctx.save_for_backward(yp, idx)
        return yp

    @staticmethod
    def backward(ctx, dyp):
        # yp is an output of this node: saved, it comes back requiring grad
        yp, idx = (t.detach() for t in ctx.saved_tensors)
        return pool_cuda.bias_relu_pool_bwd(dyp.contiguous(), idx, yp)


def fused_bias_relu_pool(x, b):
    """x: (N, H, W, C) raw conv output (pre-bias), H and W even; b: (C,).
    Returns (N, H/2, W/2, C)."""
    return FusedBiasReluPool.apply(x, b)


def reference_bias_relu_pool(x, b):
    """The composite: relu(x + b), then max_pool2d over the NCHW view."""
    y = F.relu(x + b)
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
