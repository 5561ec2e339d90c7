"""Optimizer with the reference's semantics (port of umpr_tpu/train/optim.py).

Reference (main.py:22-26): torch.optim.Adam with weight_decay=l2 for every
parameter whose name does NOT contain 'bias', weight_decay=0 for biases,
plus ExponentialLR stepped once per epoch.  torch Adam's weight decay is
L2 added to the gradient before the moment updates (not AdamW), which is
what the JAX package's add_decayed_weights -> scale_by_adam chain
computes.  The frozen GloVe embedding has ``requires_grad=False`` and never
reaches the optimizer, so no moments are allocated for it.

The optimizer is PyTorch's own (the JAX package's is optax, not a Pallas
kernel); convert.adam_to_jax / adam_from_jax map its state to and from
optax's ``ScaleByAdamState`` for ``last/`` checkpoints.  Only the float32
moments of the reference are ported; ``--adam_moment_dtype bfloat16`` and
``--adam_factored_nu`` raise (ROADMAP A4).
"""

from __future__ import annotations

import torch


def param_groups(model, l2_regularization):
    """Two Adam groups over the trainable parameters: weight_decay=l2 for
    names without 'bias', 0 for the rest."""
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (no_decay if "bias" in name else decay).append(p)
    return [{"params": decay, "weight_decay": l2_regularization},
            {"params": no_decay, "weight_decay": 0.0}]


def make_optimizer(model, l2_regularization, lr):
    return torch.optim.Adam(param_groups(model, l2_regularization), lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def lr_at_epoch(base_lr, decay, epoch):
    """ExponentialLR stepped per epoch (reference main.py:26,54)."""
    return base_lr * (decay ** epoch)
