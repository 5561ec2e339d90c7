"""Masked bidirectional GRU over variable-length sentence rows (port of
umpr_tpu/ops/gru.py).

Semantics, as in the JAX package:

- PyTorch's gate math, gate order [r | z | n], b_hn inside the reset gate;
- outputs at t >= length are exactly zero and the state is frozen there;
- the backward direction starts at each row's own last token (t=len-1);
- lengths are >= 1; rows stay in their order (the reference's
  double-unsort quirk is not reproduced).

Parameters are held in ``torch.nn.GRU``'s state-dict layout (weight_ih_l0
is (3H, E)).  ``bigru_split`` runs the CUDA kernels of ops/gru_cuda.py
(their plain versions for CPU tensors) inside ``BiGRUSplit``, forward
and backward.  ``bigru_scan`` is the port of the JAX package's
``bigru_scan`` (umpr_tpu/ops/gru.py:70-119, an XLA loop, no kernel):
plain PyTorch in x's type, differentiable by autograd.  It is the
function the JAX package runs where its kernels do not: bf16 with H %
64 != 0, whose state is bf16 (the kernels keep it f32), and the
kernel-free model of export (``BiGRU.use_kernels`` False).  In f32 it is
the kernels' function, and the tests hold the kernels' plain versions
against it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from umpr_tpu_torch.ops import gru_cuda


class BiGRU(nn.Module):
    """One bidirectional GRU layer.  Init as torch.nn.GRU: every tensor
    ~ U(-k, k), k = 1/sqrt(hidden), drawn from `generator` in the order of
    umpr_tpu's init_bigru (fwd w_ih, w_hh, bias_ih, bias_hh, then bwd)."""

    def __init__(self, in_size, hidden, generator=None):
        super().__init__()
        self.hidden = hidden
        self.use_kernels = True  # False: bigru_split runs bigru_scan (export)
        k = 1.0 / math.sqrt(hidden)
        for suffix in ("", "_reverse"):  # fwd, bwd as nn.GRU names them
            for name, shape in (("weight_ih_l0", (3 * hidden, in_size)),
                                ("weight_hh_l0", (3 * hidden, hidden)),
                                ("bias_ih_l0", (3 * hidden,)),
                                ("bias_hh_l0", (3 * hidden,))):
                p = torch.empty(shape).uniform_(-k, k, generator=generator)
                self.register_parameter(name + suffix, nn.Parameter(p))
        self._packed = None  # (parameters, their versions, operands)

    def kernel_operands(self):
        """(w_ih (E, 6H), b_ih (6H,), w_hh (2, H, 3H), b_hh (2, 3H)), both
        directions side by side in "x @ W" orientation.

        Without autograd (serving) they are packed once and kept until a
        parameter is replaced (.to(), assignment) or changed in place
        (load_state_dict, an optimizer step), which bumps its version.
        Inference tensors carry no version, so they are never cached.
        Nor is a pack made while a CUDA graph captures (train/step.py's
        DispatchGraph): the graph must pack the live parameters at every
        replay, where a cached pack would keep those of the capture."""
        params = tuple(self.parameters())
        if (torch.is_grad_enabled() or any(p.is_inference() for p in params)
                or (params[0].is_cuda and torch.cuda.is_current_stream_capturing())):
            return self._pack()
        versions = tuple(p._version for p in params)
        cached = self._packed
        if (cached is None or versions != cached[1]
                or any(a is not b for a, b in zip(params, cached[0]))):
            self._packed = cached = (params, versions, self._pack())
        return cached[2]

    def _pack(self):
        w_ih = torch.cat([self.weight_ih_l0.t(), self.weight_ih_l0_reverse.t()], 1)
        b_ih = torch.cat([self.bias_ih_l0, self.bias_ih_l0_reverse])
        w_hh = torch.stack([self.weight_hh_l0.t(), self.weight_hh_l0_reverse.t()])
        b_hh = torch.stack([self.bias_hh_l0, self.bias_hh_l0_reverse])
        return w_ih.contiguous(), b_ih, w_hh.contiguous(), b_hh


def bigru_scan(gru, x, lengths):
    """x (N, L, E), lengths (N,) -> (N, L, 2H) [fwd | bwd] in x's type.

    The JAX package's scan: one projection of both directions, then per
    direction a loop over time of ``_gru_cell`` with h0 zeros in x's type,
    the state frozen past each length and the output zero there, both by
    selects.  Every op rounds to x's type, the state included, as XLA's
    bf16 ops do (the same bits as the JAX scan on the CPU).  A loop of
    ATen ops with no host sync, so a CUDA graph captures it."""
    N, L, E = x.shape
    # packed afresh at every call: no cache, so torch.export traces it
    w_ih, b_ih, w_hh, b_hh = (t.to(x.dtype) for t in gru._pack())
    H = w_hh.shape[1]
    xg = (x.reshape(N * L, E) @ w_ih + b_ih).view(N, L, 6 * H)
    ys = []
    for d, steps in ((0, range(L)), (1, range(L - 1, -1, -1))):
        h = x.new_zeros(N, H)
        out = [None] * L
        for t in steps:
            xt = xg[:, t, 3 * H * d:3 * H * (d + 1)]
            hg = h @ w_hh[d] + b_hh[d]
            r = _sigmoid(xt[:, :H] + hg[:, :H])
            z = _sigmoid(xt[:, H:2 * H] + hg[:, H:2 * H])
            n = torch.tanh(xt[:, 2 * H:] + r * hg[:, 2 * H:])
            h_new = (1.0 - z) * n + z * h
            valid = (t < lengths)[:, None]
            h = torch.where(valid, h_new, h)
            out[t] = torch.where(valid, h_new, 0.0)
        ys.append(torch.stack(out, 1))
    return torch.cat(ys, -1)


def _sigmoid(v):
    """jax.nn.sigmoid as XLA lowers it, 1 / (1 + exp(-v)), one op at a
    time: in bf16 each op rounds, where torch.sigmoid rounds once (they
    differ in a third of bf16 inputs).  In f32 it is torch.sigmoid, as in
    the kernels' plain versions (within an f32 ulp of XLA's)."""
    if v.dtype == torch.float32:
        return torch.sigmoid(v)
    return 1.0 / (1.0 + torch.exp(-v))


class BiGRUSplit(torch.autograd.Function):
    """The bi-GRU as one autograd node over the packed kernel operands
    (port of ``_make_bigru_pallas_split``, umpr_tpu/ops/gru_pallas.py:952).

    forward: K1 then K2 on detached tensors, returning (y_pos, y_sent), y_pos
    a view of y_sent's memory.  backward: K3 sums the two cotangents (B7)
    and runs the reverse sweep (B2), K4 gives dW_ih and db_ih (B4), and K9
    the input gradient dx (B4's dxc) only when x requires grad: the
    PyTorch form of the JAX package's need_dx.  It returns the grads of
    (x, w_ih, b_ih, w_hh, b_hh); the cat/transpose of
    ``BiGRU.kernel_operands`` carries the weights' back to the
    nn.GRU-layout parameters.  On the CPU every step runs the kernels'
    plain versions."""

    @staticmethod
    def forward(ctx, x, lengths, S, w_ih, b_ih, w_hh, b_hh):
        N, L, E = x.shape
        x2 = x.detach().reshape(N * L, E)
        w_ih, b_ih, w_hh, b_hh = (t.detach() for t in (w_ih, b_ih, w_hh, b_hh))
        xg = gru_cuda.gru_input_proj(x2, w_ih, b_ih)
        y = gru_cuda.bigru_recurrence(xg.view(N, L, -1), lengths, w_hh, b_hh)
        ctx.save_for_backward(x2, xg, y, lengths, w_ih, w_hh, b_hh)
        return y.view(N // S, S * L, y.shape[-1]), y

    @staticmethod
    def backward(ctx, dy_pos, dy_sent):
        # y is an output of this node: saved, it comes back requiring grad
        x2, xg, y, lengths, w_ih, w_hh, b_hh = (t.detach() for t in ctx.saved_tensors)
        N, L, _ = y.shape
        dxg, dw_hh, db_hh = gru_cuda.bigru_backward(
            xg.view(N, L, -1), y, dy_sent.contiguous(), dy_pos.contiguous(),
            lengths, w_hh, b_hh)
        dxg = dxg.view(N * L, -1)
        dw_ih, db_ih = gru_cuda.gru_input_proj_bwd(x2, dxg)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = gru_cuda.gru_input_proj_dx(dxg, w_ih).view(N, L, -1)
        # f32 sums, cast once to the parameters' type (gru_pallas.py:839)
        return dx, None, None, *(g.to(w_ih.dtype) for g in (dw_ih, db_ih, dw_hh, db_hh))


def bigru_split(gru, x, lengths, S):
    """Bi-GRU returning both true-time consumer layouts:
      y_pos  (N/S, S*L, 2H) -- the affinity-attention positions layout;
      y_sent (N, L, 2H)     -- the per-sentence S-Net layout.
    y_pos is a view of y_sent's memory.  Differentiable in the GRU's
    parameters and in x when x requires grad.

    Routed as umpr_tpu/ops/gru.py:130-134 and :149-155 route: through
    BiGRUSplit (the kernels) unless the JAX package takes its scan there,
    that is for a bfloat16 x at H % 64 != 0 (the scan's state is bf16, the
    kernels' f32), or when ``gru.use_kernels`` is off (the kernel-free
    model of export); an f32 x takes the kernels at every H, where the
    scan computes the same function.  A bfloat16 x runs the kernels' bf16
    IO, with the packed weights cast to it (as gru_pallas.py:780 casts the
    parameters to x's type).

    x: (N, L, E) sentence rows, a free view of the (B, S, L, E) embedding
    lookup (the frozen embedding in every UMPR config); lengths: (N,)
    int32."""
    N, L, _ = x.shape
    if not gru.use_kernels or (x.dtype == torch.bfloat16 and gru.hidden % 64):
        y = bigru_scan(gru, x, lengths)
        return y.view(N // S, S * L, y.shape[-1]), y
    ops = gru.kernel_operands()
    if x.dtype != ops[0].dtype:
        ops = tuple(t.to(x.dtype) for t in ops)
    return BiGRUSplit.apply(x, lengths, S, *ops)
