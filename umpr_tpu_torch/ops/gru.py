"""Masked bidirectional GRU over variable-length sentence rows (port of
umpr_tpu/ops/gru.py).

Semantics, as in the JAX package:

- PyTorch's gate math, gate order [r | z | n], b_hn inside the reset gate;
- outputs at t >= length are exactly zero and the state is frozen there;
- the backward direction starts at each row's own last token (t=len-1);
- lengths are >= 1; rows stay in their order (the reference's
  double-unsort quirk is not reproduced).

Parameters are held in ``torch.nn.GRU``'s state-dict layout (weight_ih_l0
is (3H, E)).  ``bigru_split`` runs the two CUDA kernels of
ops/gru_cuda.py (their plain versions for CPU tensors); ``bigru_scan`` is
the plain reference the tests hold it against.
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
        Inference tensors carry no version, so they are never cached."""
        params = tuple(self.parameters())
        if torch.is_grad_enabled() or any(p.is_inference() for p in params):
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
    """Plain reference: x (N, L, E), lengths (N,) -> (N, L, 2H)."""
    N, L, E = x.shape
    w_ih, b_ih, w_hh, b_hh = gru.kernel_operands()
    xg = gru_cuda.gru_input_proj_ref(x.reshape(N * L, E), w_ih, b_ih)
    return gru_cuda.bigru_recurrence_ref(xg.view(N, L, -1), lengths, w_hh, b_hh)


def bigru_split(gru, x, lengths, S):
    """Bi-GRU returning both true-time consumer layouts:
      y_pos  (N/S, S*L, 2H) -- the affinity-attention positions layout;
      y_sent (N, L, 2H)     -- the per-sentence S-Net layout.
    y_pos is a view of y_sent.

    x: (N, L, E) sentence rows, a free view of the (B, S, L, E) embedding
    lookup; lengths: (N,) int32."""
    N, L, E = x.shape
    w_ih, b_ih, w_hh, b_hh = gru.kernel_operands()
    xg = gru_cuda.gru_input_proj(x.reshape(N * L, E), w_ih, b_ih)
    y = gru_cuda.bigru_recurrence(xg.view(N, L, -1), lengths, w_hh, b_hh)
    return y.view(N // S, S * L, y.shape[-1]), y
