"""The ranks' layout (the port's counterpart of umpr_tpu/parallel/mesh.py:
``make_mesh`` and ``setup_runtime``).

The reference's only distribution is single-process ``DataParallel``,
whose shards each padded to their own maxima (its readme.md:154-160).  The
port runs one rank per device instead:

- parameters are replicated on every rank; the rank's row block of each
  global batch runs at the global batch's pad maxima and loss normaliser
  (``multihost.global_facts``), so the ranks' losses and gradients are
  partial sums of the global ones;
- after the backward one ``all_reduce(SUM)`` over the ``dp`` group adds
  them up (train/step.py), in one flat buffer in the optimizer's
  parameter order, and every rank takes the same Adam step.  Not DDP: its
  division by the world size is wrong for both loss terms, and its
  buckets would fix no order of their own.

``--mesh_shape`` lays the ranks out as JAX's row-major reshape lays out
devices (its mesh.py:34-36): rank r sits at ``np.unravel_index(r,
shape)``, the axes named ``dp``, ``mp``, ``pp`` leading first.  The batch
is split over ``dp``; ranks that differ only along the other axes hold the
same rows and replicate the work, but for ``--shard_embedding``, which
splits the frozen table over ``mp`` (over ``dp`` without an ``mp`` axis).
The JAX package also hands the ``dp`` extent to ``ModelDims`` for its VGG
width fold's gate (rows per device); the port never folds
(``ModelDims.vgg_fold_w``), so nothing of the mesh reaches the model.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from umpr_tpu_torch.parallel import multihost

AXES = ("dp", "mp", "pp")  # the leading axis is always data-parallel


def mesh_shape(shape, world):
    """``--mesh_shape`` (default: every rank on one ``dp`` axis), checked
    against the world's size."""
    shape = [int(d) for d in shape] if shape else [world]
    if len(shape) > len(AXES) or min(shape) < 1 or int(np.prod(shape)) != world:
        raise ValueError(f"--mesh_shape {shape} lays out {int(np.prod(shape))} ranks on "
                         f"{len(shape)} axes (at most {len(AXES)}), but the world has "
                         f"{world} rank(s)")
    return shape


def check_layout(shape, batch_size, world):
    """The mesh's shape; raises where it does not match the world or the
    batch does not split over its ``dp`` axis (JAX mesh.py:69-70)."""
    shape = mesh_shape(shape, world)
    if batch_size % shape[0]:
        raise ValueError(f"batch_size {batch_size} must divide over the {shape[0]} "
                         f"data-parallel ranks of a world of {world}")
    return shape


def rank_coords(rank, shape):
    """Rank -> its position on the mesh: the row-major layout of JAX's
    ``devices.reshape(shape)``, so (dp = r // mp, mp = r % mp) in 2-D."""
    return tuple(int(c) for c in np.unravel_index(rank, shape))


class Mesh:
    """This rank's place on the mesh and its process groups: ``dp_group``
    (the ranks that differ from it only in their ``dp`` position: the
    gradient sum) and ``mp_group`` (only in ``mp``; None without an ``mp``
    axis).  Every rank creates every group, in one order:
    ``dist.new_group`` is collective."""

    def __init__(self, shape, rank, backend, device):
        self.shape = tuple(shape)
        self.axis_names = AXES[:len(shape)]
        self.world = int(np.prod(shape))
        self.rank, self.backend = rank, backend
        self.coords = rank_coords(rank, shape)
        self.dp, self.dp_index = shape[0], self.coords[0]
        self.dp_group = self._line_group(0)
        self.mp_group = self._line_group(1) if len(shape) > 1 else None
        if backend == "nccl":
            # NCCL forms a communicator at a group's first collective, which
            # must not fall inside a CUDA graph's capture
            for group in filter(None, (self.dp_group, self.mp_group)):
                dist.all_reduce(torch.zeros(1, device=device), group=group)

    def _line_group(self, axis):
        ranks = np.moveaxis(np.arange(self.world).reshape(self.shape), axis, -1)
        mine = None
        for line in ranks.reshape(-1, self.shape[axis]).tolist():
            group = dist.new_group(ranks=line, backend=self.backend)
            if self.rank in line:
                mine = group
        return mine

    def rows(self, batch_size):
        """This rank's row block of a global batch, or None where the
        ``dp`` axis has one rank (every rank takes the whole batch)."""
        if self.dp == 1:
            return None
        return multihost.local_rows(batch_size, self.dp, self.dp_index)

    def table_group(self):
        """The group that splits the frozen table (``--shard_embedding``):
        ``mp`` where the mesh has that axis, else ``dp`` (JAX trainer.py
        :188-191)."""
        return self.mp_group if self.mp_group is not None else self.dp_group

    def __str__(self):
        return (f"mesh {dict(zip(self.axis_names, self.shape))}, rank {self.rank} at "
                f"{dict(zip(self.axis_names, self.coords))}, collectives on {self.backend}")


def setup_runtime(config):
    """The Trainer's layout from a Config, after ``multihost.initialize``:
    a Mesh, or None where no process group was formed (a world of 1 calls
    no collective).  Raises ValueError for a ``--mesh_shape`` that does not
    match the world or a batch that does not split over ``dp``."""
    world = multihost.world_size()
    shape = check_layout(config.mesh_shape, config.batch_size, world)
    if not dist.is_initialized():
        return None
    return Mesh(shape, multihost.rank(), multihost.collective_backend(),
                config.torch_device)
