"""Layer primitives with the reference's PyTorch-default init, drawn from an
explicit torch.Generator (port of umpr_tpu/models/layers.py).

nn.Linear's default init is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight
and bias; a bare nn.Parameter(torch.randn(...)) is N(0, 1).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
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


class Conv1dSame(nn.Conv1d):
    """nn.Conv1d with torch padding (k-1)//2 over (N, L, C) rows -> (N,
    L_out, C_out): "same" for odd k, one shorter for even k (the
    reference's padding, umpr_tpu/models/layers.py:49-65).  Weight (out,
    in, k) and bias take nn.Conv1d's default init, U(+-1/sqrt(in*k)), from
    `generator`."""

    def __init__(self, in_ch, out_ch, kernel_size, generator=None):
        super().__init__(in_ch, out_ch, kernel_size, padding=(kernel_size - 1) // 2)
        fan_in = in_ch * kernel_size
        with torch.no_grad():
            self.weight.copy_(uniform_fan_in(fan_in, self.weight.shape, generator))
            self.bias.copy_(uniform_fan_in(fan_in, (out_ch,), generator))

    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class ShardedEmbedding(nn.Module):
    """A frozen embedding table split by rows over a process group
    (``--shard_embedding``; the JAX trainer's vocab-sharded table,
    trainer.py:173-195).  The table is padded with zero rows to a multiple
    of the group's size; shard i keeps rows [i*R, (i+1)*R) as ``weight``.

    A lookup gathers the token ids of every rank of the group, reads the
    rows in its own range, and sums the group's results, of which each
    rank keeps its own.  The sum runs on the values' bits as int32: every
    value comes from exactly one shard and the rest add 0, so the lookup
    gives the replicated table's bits, -0.0 and NaN included (a bf16
    table is widened to f32 for it and back, exactly).  The table is
    frozen: no backward runs through the collectives."""

    def __init__(self, table, group):
        super().__init__()
        self.group = group
        self.shards, self.shard = dist.get_world_size(group), dist.get_rank(group)
        vocab, dim = table.shape
        self.rows = -(-vocab // self.shards)
        block = table[self.shard * self.rows:(self.shard + 1) * self.rows]
        pad = block.new_zeros(self.rows - block.shape[0], dim)
        self.weight = nn.Parameter(torch.cat([block, pad]).clone(), requires_grad=False)

    def forward(self, ids):
        ids = ids.contiguous()
        parts = [torch.empty_like(ids) for _ in range(self.shards)]
        dist.all_gather(parts, ids, group=self.group)
        local = torch.stack(parts) - self.shard * self.rows
        own = (local >= 0) & (local < self.rows)
        rows = self.weight[torch.where(own, local, 0)].float()
        bits = torch.where(own[..., None], rows, 0.0).view(torch.int32)
        dist.all_reduce(bits, group=self.group)
        return bits[self.shard].view(torch.float32).to(self.weight.dtype)
