"""Layer primitives with the reference's PyTorch-default init, drawn from an
explicit torch.Generator (port of umpr_tpu/models/layers.py).

nn.Linear's default init is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight
and bias; a bare nn.Parameter(torch.randn(...)) is N(0, 1).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def uniform_fan_in(fan_in, shape, generator=None):
    k = 1.0 / math.sqrt(fan_in)
    return torch.empty(shape).uniform_(-k, k, generator=generator)


def randn(shape, generator=None):
    return torch.randn(shape, generator=generator)


def linear(in_size, out_size, bias=True, generator=None):
    """nn.Linear (weight (out, in)) with torch's default init from
    `generator`."""
    layer = nn.Linear(in_size, out_size, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(uniform_fan_in(in_size, (out_size, in_size), generator))
        if bias:
            layer.bias.copy_(uniform_fan_in(in_size, (out_size,), generator))
    return layer
