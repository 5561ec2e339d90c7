"""Optimizer with the reference's semantics (port of umpr_tpu/train/optim.py).

Reference (main.py:22-26): torch.optim.Adam with weight_decay=l2 for every
parameter whose name does NOT contain 'bias', weight_decay=0 for biases,
plus ExponentialLR stepped once per epoch.  torch Adam's weight decay is
L2 added to the gradient before the moment updates (not AdamW), which is
what the JAX package's add_decayed_weights -> scale_by_adam chain
computes.  The frozen GloVe embedding has ``requires_grad=False`` and never
reaches the optimizer, so no moments are allocated for it.

``Adam`` is the port's own (the JAX package's is optax, not a Pallas
kernel), in three modes, each the arithmetic of its optax counterpart:

- float32 moments (``optax.scale_by_adam``, torch's defaults);
- ``--adam_moment_dtype bfloat16``: mu stored bf16, rounded to nearest
  even as JAX's ``astype`` rounds, nu f32, and the update computed from
  the ROUNDED mu, so that a resumed run takes the uninterrupted run's path
  (``_scale_by_adam_bf16_moments``);
- ``--adam_factored_nu``, alone or with bf16 mu: an Adafactor-style
  row/column nu for parameters that are 2-D or more in the JAX package's
  layout (``_scale_by_adam_factored_nu``).  The factoring is defined on
  that layout: a torch Linear weight (out, in) is JAX's (in, out), a conv
  weight (co, ci, kh, kw) JAX's (kh, kw, ci, co), and a 1-output head,
  JAX (in, 1), is not factored.  Each parameter's transposition comes from
  ``convert._jax_path``, and the factored state is kept in JAX's shapes.

It is capturable by design, for the CUDA graphs of ``--steps_per_dispatch``
(train/step.py): the step count and the learning rate are device tensors
(``set_lr`` fills the rate, once an epoch), every state tensor is created
here and updated in place, and a step reads nothing back to the host.
``convert.adam_to_jax`` / ``adam_from_jax`` map the state to and from
optax's ``ScaleByAdamState`` for ``last/`` checkpoints.
"""

from __future__ import annotations

import torch

from umpr_tpu_torch.convert import _jax_path, from_jax_view, to_jax_view

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8  # torch's defaults, as the reference runs
MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def weight_decay(name, l2_regularization):
    """The reference's grouping: l2 for names without 'bias', 0 for the rest."""
    return 0.0 if "bias" in name else l2_regularization


def param_groups(model, l2_regularization):
    """The two weight-decay groups over the trainable parameters (decay,
    no decay), as the reference hands them to torch's Adam."""
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (decay if weight_decay(name, 1.0) else no_decay).append(p)
    return [{"params": decay, "weight_decay": l2_regularization},
            {"params": no_decay, "weight_decay": 0.0}]


def factored(jax_shape):
    """Does nu factor at this JAX-layout shape?  As ``_factored_shape``:
    2-D or more, the last dim and the product of the others above 1."""
    rows = 1
    for d in jax_shape[:-1]:
        rows *= d
    return len(jax_shape) >= 2 and jax_shape[-1] > 1 and rows > 1


class Adam:
    """Adam over (state-dict name, parameter) pairs; see the module
    docstring.  ``state[p]`` holds ``exp_avg`` (mu, in the moment dtype)
    and ``exp_avg_sq``: nu, a tensor, or for a factored parameter the
    (row, col) pair in JAX's layout."""

    def __init__(self, named_params, l2_regularization, lr, moment_dtype="float32",
                 factored_nu=False):
        if moment_dtype not in MOMENT_DTYPES:
            raise ValueError(f"adam_moment_dtype must be 'float32' or 'bfloat16', "
                             f"got {moment_dtype!r}")
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        device = self.params[0].device
        self.moment_dtype = moment_dtype
        self.factored_nu = factored_nu
        self.decays = [weight_decay(n, l2_regularization) for n in self.names]
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.lr = torch.tensor(float(lr), dtype=torch.float32, device=device)
        self.transposed = [_jax_path(n)[1] for n in self.names]
        self.state = {}
        for p, t in zip(self.params, self.transposed):
            shape = to_jax_view(p, t).shape
            nu = ((p.new_zeros(shape[:-1]), p.new_zeros(shape[-1:]))
                  if factored_nu and factored(shape) else torch.zeros_like(p))
            self.state[p] = {"exp_avg": torch.zeros_like(p, dtype=MOMENT_DTYPES[moment_dtype]),
                             "exp_avg_sq": nu}

    def set_lr(self, lr):
        """The learning rate of the steps from here on (a device write)."""
        self.lr.fill_(lr)

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        """One Adam step from the parameters' .grad (a missing one counts
        as zeros, as optax sees an unused leaf)."""
        params = self.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        # L2 added to the gradient (optax.add_decayed_weights, masked)
        g = [gr.add(p, alpha=wd) if wd else gr
             for gr, p, wd in zip(grads, params, self.decays)]
        self.count.add_(1)
        t = self.count.float()
        c1 = 1 - torch.pow(BETA1, t)
        c2 = 1 - torch.pow(BETA2, t)

        mu = [self.state[p]["exp_avg"] for p in params]
        if self.moment_dtype == "float32":
            torch._foreach_mul_(mu, BETA1)
            torch._foreach_add_(mu, g, alpha=1 - BETA1)
            mu32 = mu
        else:  # f32 moment math, bf16 storage: the rounded mu feeds the update
            m32 = [m.float() for m in mu]
            torch._foreach_mul_(m32, BETA1)
            torch._foreach_add_(m32, g, alpha=1 - BETA1)
            for m, x in zip(mu, m32):
                m.copy_(x)
            mu32 = [m.float() for m in mu]

        vhat = [None] * len(params)  # nu / c2, in torch's layout
        full = [i for i, p in enumerate(params)
                if torch.is_tensor(self.state[p]["exp_avg_sq"])]
        if full:
            nu = [self.state[params[i]]["exp_avg_sq"] for i in full]
            gf = [g[i] for i in full]
            torch._foreach_mul_(nu, BETA2)
            torch._foreach_addcmul_(nu, gf, gf, value=1 - BETA2)
            for i, v in zip(full, torch._foreach_div(nu, c2)):
                vhat[i] = v
        for i, p in enumerate(params):
            if vhat[i] is not None:
                continue
            row, col = self.state[p]["exp_avg_sq"]
            gj = to_jax_view(g[i], self.transposed[i])
            g2 = gj * gj
            row.mul_(BETA2).add_(g2.mean(dim=-1), alpha=1 - BETA2)
            col.mul_(BETA2).add_(g2.mean(dim=tuple(range(g2.dim() - 1))), alpha=1 - BETA2)
            # outer(row, col) / mean(row): the guard only matters while every
            # gradient seen was exactly zero (the update is 0 then anyway)
            denom = row.mean().clamp(min=1e-30)
            vhat[i] = from_jax_view(row[..., None] * col / denom / c2, self.transposed[i])

        update = torch._foreach_div(mu32, c1)
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, EPS)
        torch._foreach_div_(update, vhat)
        torch._foreach_mul_(update, self.lr)
        torch._foreach_sub_(params, update)


def make_optimizer(model, l2_regularization, lr, moment_dtype="float32", factored_nu=False):
    """The port's Adam over `model`'s trainable parameters."""
    return Adam([(n, p) for n, p in model.named_parameters() if p.requires_grad],
                l2_regularization, lr, moment_dtype, factored_nu)


def lr_at_epoch(base_lr, decay, epoch):
    """ExponentialLR stepped per epoch (reference main.py:26,54)."""
    return base_lr * (decay ** epoch)
