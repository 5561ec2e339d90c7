"""Multi-process training on ``torch.distributed`` (the port's own copy of
umpr_tpu/parallel/multihost.py).

Each rank is one process on one device.  ``initialize`` joins the ranks
into one world over TCP (``--coordinator_address host:port``; rank 0
listens there).  The world's default group runs gloo and carries the host
traffic: barriers, and the broadcasts of strings and checkpoint arrays.
The tensor collectives of the train and eval steps (the gradient
all-reduce, the sharded table's lookup) run in the groups of
``parallel.mesh`` under ``collective_backend()``:

- NCCL where every rank has a card of its own;
- gloo on the CPU;
- gloo where two ranks share one card: NCCL refuses two ranks on one
  device (its communicator fails to form, "Duplicate GPU detected").

The host data pipeline is the JAX package's: every rank builds the same
deterministic loader (corpus, seed, order) and keeps its own row block of
each global batch (``local_rows``, ``put_global``), so no rank decodes or
ships rows it does not own.  Each rank still sees the whole global batch
on the host, so the global pad maxima and sample count come without a
collective.

A run with no coordinator and one process forms no group: every helper
here is then a no-op, and the steps call no collective.
"""

from __future__ import annotations

import atexit
import datetime
import socket

import numpy as np
import torch
import torch.distributed as dist

from umpr_tpu_torch.data.loader import to_device

_STATE = {"backend": None}
TIMEOUT_S = 1800  # a collective that waits longer raises (a rank has died)


def local_cards(device, multi_gpu):
    """The cards this process drives, one rank each: every visible card
    under ``--multi_gpu True`` on a CUDA device, else 1."""
    if multi_gpu and torch.device(device).type == "cuda" and torch.cuda.is_available():
        return max(torch.cuda.device_count(), 1)
    return 1


def planned_world(num_processes, cards=1):
    """The world a run's flags ask for: processes x cards per process."""
    return max(int(num_processes or 0), 1) * cards


def initialize(coordinator_address="", num_processes=0, process_id=-1, local_rank=0,
               cards=1, device=None):
    """Join (or form) the world of ``num_processes`` processes of ``cards``
    ranks each; this rank is ``process_id * cards + local_rank``.  A no-op
    (returns False) without a coordinator address in a world of 1.  An
    explicit address with ``--num_processes 1`` forms a world of 1, whose
    collectives run (a sum over one rank).  `device`: this rank's
    ``torch.device``, which picks the collective backend."""
    if dist.is_initialized():
        return True
    world = planned_world(num_processes, cards)
    if not coordinator_address and world == 1:
        return False
    if not coordinator_address:
        raise ValueError(f"a world of {world} ranks needs --coordinator_address host:port")
    if int(num_processes or 0) > 1 and process_id < 0:
        raise ValueError(f"--num_processes {num_processes} needs --process_id")
    rank = max(int(process_id), 0) * cards + local_rank
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    # a group left to the interpreter's teardown can abort the process
    # ("terminate called without an active exception") as its threads die
    atexit.register(shutdown)
    _STATE["backend"] = _collective_backend(device)
    return True


def _collective_backend(device):
    """NCCL where the ranks' cards are all distinct, else gloo."""
    if device is None or torch.device(device).type != "cuda":
        return "gloo"
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    props = torch.cuda.get_device_properties(index)
    card = f"{socket.gethostname()}/{getattr(props, 'uuid', index)}"
    cards = [None] * world_size()
    dist.all_gather_object(cards, card)
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


def collective_backend():
    """The backend of the steps' collectives ("nccl" or "gloo"), None
    without a process group."""
    return _STATE["backend"] if dist.is_initialized() else None


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE["backend"] = None


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary():
    """True on the rank that writes checkpoints and metrics."""
    return rank() == 0


def local_rows(global_batch_size, parts=None, index=None):
    """Block `index` of `parts` contiguous row blocks of a global batch
    (default: this rank's of the world's): rows [i*B/p, (i+1)*B/p)."""
    parts = world_size() if parts is None else parts
    index = rank() if index is None else index
    if global_batch_size % parts:
        raise ValueError(f"global batch {global_batch_size} must divide over {parts} "
                         "ranks")
    per = global_batch_size // parts
    return slice(index * per, (index + 1) * per)


def barrier(name):
    """Every rank waits here for the others (no-op without a group).  The
    ranks exchange `name`: ranks that meet at different barriers raise
    instead of pairing the wrong collectives."""
    if not dist.is_initialized():
        return
    names = [None] * world_size()
    dist.all_gather_object(names, name)
    if len(set(names)) != 1:
        raise RuntimeError(f"the ranks met at different barriers: {names}")


def broadcast_str(s):
    """The primary's string on every rank (run stamps, error texts, the
    primary's decisions)."""
    if not dist.is_initialized():
        return s
    box = [s]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class _Leaf:
    def __init__(self, i):
        self.i = i


def _split(node, arrays):
    if isinstance(node, dict):
        return {k: _split(v, arrays) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_split(v, arrays) for v in node)
    if isinstance(node, (np.ndarray, torch.Tensor)):
        arrays.append(np.asarray(node))
        return _Leaf(len(arrays) - 1)
    return node


def _join(node, arrays):
    if isinstance(node, _Leaf):
        return arrays[node.i]
    if isinstance(node, dict):
        return {k: _join(v, arrays) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_join(v, arrays) for v in node)
    return node


def broadcast_tree(tree):
    """The primary's tree (nested dicts, lists and tuples of numpy arrays
    and plain values) on every rank, its arrays as numpy.  Only the
    primary's argument is read: the checkpoint restores and the photo bank
    are read on the primary alone (ranks need not share its filesystem).
    The structure goes as one object, each array as one tensor broadcast."""
    if not dist.is_initialized():
        return tree
    arrays = []
    box = [_split(tree, arrays) if is_primary() else None]
    box.append([(a.shape, a.dtype.str) for a in arrays] if is_primary() else None)
    dist.broadcast_object_list(box, src=0)
    skeleton, specs = box
    out = []
    for i, (shape, dtype) in enumerate(specs):
        buf = (np.ascontiguousarray(arrays[i]) if is_primary()
               else np.empty(shape, np.dtype(dtype)))
        t = torch.from_numpy(buf.reshape(-1))
        dist.broadcast(t, src=0)
        out.append(t.numpy().reshape(shape))
    return _join(skeleton, out)


def global_facts(batch):
    """What every rank needs of a global host batch beside its own rows:
    ``pad_maxima`` (the largest user/item sentence count and length, the
    largest u->i count and length: the exists masks of the whole batch,
    models/umpr.py) and ``sample_count``, its count of real samples (the
    MSE's normaliser)."""
    return {"pad_maxima": np.array(
                [max(batch["u_counts"].max(), batch["i_counts"].max()),
                 max(batch["u_lengths"].max(), batch["i_lengths"].max()),
                 batch["ui_counts"].max(), batch["ui_lengths"].max()], np.int32),
            "sample_count": np.asarray(batch["sample_mask"].sum(), np.float32)}


def put_global(batch, rows):
    """This rank's row block `rows` of a global host batch (numpy), with
    its global facts: what the rank ships to its device."""
    return {**{k: v[rows] for k, v in batch.items()}, **global_facts(batch)}


def put_replicated(arr, device):
    """A whole copy of a host array on this rank's device (every rank
    passes the same content: the deterministic builds, or a broadcast)."""
    # a cached split's arrays are read-only memmaps: copy them first
    arr = np.ascontiguousarray(arr) if arr.flags.writeable else np.array(arr)
    return torch.from_numpy(arr).to(device)


def put_local(batch, device, rows=None):
    """A host batch on `device`: whole, or this rank's rows of it with the
    global facts."""
    return to_device(batch if rows is None else put_global(batch, rows), device)
