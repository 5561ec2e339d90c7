"""Checkpoints in umpr_tpu's path-keyed npz format, read and written
without JAX (port of umpr_tpu/train/checkpoint.py, npz backend).

A checkpoint directory holds ``arrays.npz`` (``leaf_00000`` ...) and
``structure.json`` (``version`` 1, ``keys``, ``dtypes``, ``n``).  Keys are
JAX ``keystr`` strings of the leaf's path, e.g.
``['review_net']['rnet']['gru']['fwd']['w_ih']``, for a list position
``['visual_net']['vgg16']['features'][0]['kernel']``, and for a field of
optax's Adam state ``['opt_state'][1].mu['linear_fusion']['bias']``.
Restore matches leaves by key and checks shapes and dtypes, as umpr_tpu's
``restore_pytree`` does for version >= 1, so either package reads the
other's checkpoints.  Layout under a run directory:

- ``best/``: the parameters at the best validation MSE (what test()
  loads), the frozen embedding included;
- ``last/``: ``{"trainable": ..., "opt_state": ...}`` and ``meta.json``
  (``epoch``, ``batch_counter``, ``best_loss``, ``batch_in_epoch``), what
  ``--resume_path`` reads.  ``trainable`` is every parameter but the
  frozen embedding; ``opt_state`` is the JAX optimizer's state, a chain of
  the masked weight decay (no leaves) and optax's
  ``ScaleByAdamState(count, mu, nu)`` at position 1 (train/optim.py): a
  bfloat16 mu is written widened to float32 and recorded as "bfloat16",
  and a factored nu is optax's tuple over the leaves, ``.nu[i][0]`` /
  ``.nu[i][1]`` (row, col) or ``.nu[i][0]`` (full).

Every file is written to a temporary name and swapped in; ``last/``
writes its arrays before its meta.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from umpr_tpu_torch.convert import (leaves_with_path, listify, params_from_jax,
                                    params_to_jax)

FORMAT_VERSION = 1
ADAM_STATE = 1  # position of ScaleByAdamState in the JAX optimizer's chain


class Attr(str):
    """A named-tuple field in a leaf's path: keystr writes it ``.name``."""


def keystr(path):
    """('a', 0, Attr('mu'), 'b') -> "['a'][0].mu['b']", as
    jax.tree_util.keystr writes dict keys, list positions and named-tuple
    fields."""
    return "".join(f".{k}" if isinstance(k, Attr) else f"[{k!r}]" for k in path)


def save_items(path, items, dtypes=None):
    """(path tuple, array) pairs -> a path-keyed npz checkpoint at `path`.
    dtypes: the leaves' logical dtype names, where an array holds a leaf
    widened (a bfloat16 Adam mu is written as float32 and recorded as
    "bfloat16", as the JAX package writes it); default the arrays' own."""
    os.makedirs(path, exist_ok=True)
    arrays = {f"leaf_{i:05d}": np.asarray(a) for i, (_, a) in enumerate(items)}
    meta = {"version": FORMAT_VERSION,
            "keys": [keystr(p) for p, _ in items],
            "dtypes": dtypes or [str(a.dtype) for a in arrays.values()],
            "fingerprint": None, "n": len(items)}
    np.savez(os.path.join(path, "arrays.tmp.npz"), **arrays)
    os.replace(os.path.join(path, "arrays.tmp.npz"),
               os.path.join(path, "arrays.npz"))
    _write_json(path, "structure.json", meta)


def _write_json(path, name, obj):
    tmp = os.path.join(path, name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, os.path.join(path, name))


def restore_items(path, like_items, dtypes=None):
    """The arrays at `path` for (path tuple, like array) pairs, in their
    order and dtypes; missing or extra keys, shapes and dtypes are checked,
    the dtypes against `dtypes` where given (logical names, as
    save_items records them)."""
    meta_path = os.path.join(path, "structure.json")
    if not os.path.exists(meta_path):
        if os.path.isdir(os.path.join(path, "orbax")):
            raise NotImplementedError(
                f"{path} is an orbax checkpoint; the port reads npz only "
                "(ROADMAP A4)")
        raise FileNotFoundError(f"no checkpoint at {path}")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("version", 0) < 1:
        raise ValueError(f"{path} is a legacy order-based (v0) checkpoint; "
                         "re-save it with umpr_tpu to get the path-keyed format")
    keys = [keystr(p) for p, _ in like_items]
    index = {k: i for i, k in enumerate(meta["keys"])}
    missing = [k for k in keys if k not in index]
    extra = [k for k in meta["keys"] if k not in set(keys)]
    if missing or extra:
        raise ValueError(
            f"checkpoint at {path} does not match the model structure: "
            f"missing keys {missing[:5]}, unexpected keys {extra[:5]}")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, ((_, old), k) in enumerate(zip(like_items, keys)):
            new = z[f"leaf_{index[k]:05d}"]
            dtype = np.asarray(old).dtype
            if tuple(np.shape(old)) != new.shape:
                raise ValueError(f"checkpoint at {path}: leaf {k} has shape "
                                 f"{new.shape}, expected {np.shape(old)}")
            saved = meta["dtypes"][index[k]] if meta.get("dtypes") else None
            want = dtypes[i] if dtypes else str(dtype)
            if saved is not None and saved != want:
                raise ValueError(f"checkpoint at {path}: leaf {k} was saved as "
                                 f"{saved}, the model expects {want} (resuming "
                                 "across --adam_moment_dtype settings?)")
            out.append(new.astype(dtype))
    return out


def nest(items):
    """(path tuple, leaf) pairs -> nested dicts, int-keyed ones as lists."""
    tree = {}
    for p, leaf in items:
        node = tree
        for part in p[:-1]:
            node = node.setdefault(part, {})
        node[p[-1]] = leaf
    return listify(tree)


def save_pytree(path, tree):
    """Nested dict/list of arrays -> path-keyed npz checkpoint."""
    save_items(path, list(leaves_with_path(tree)))


def restore_pytree(path, like):
    """Restore into the structure of `like` (nested dict/list of arrays)."""
    like_items = list(leaves_with_path(like))
    arrays = restore_items(path, like_items)
    return nest([(p, a) for (p, _), a in zip(like_items, arrays)])


def has_best(root):
    return os.path.exists(os.path.join(root, "best", "structure.json"))


def save_best(root, model):
    save_pytree(os.path.join(root, "best"), params_to_jax(model.state_dict()))


def restore_best(root, model):
    """Load ``<root>/best`` (written by either package) into `model`."""
    restore_module(os.path.join(root, "best"), model)


def restore_module(path, module):
    """Load the checkpoint at `path` into `module`: a whole model, or a
    submodule for a checkpoint of that subtree (``--vgg16_weights``)."""
    tree = restore_pytree(path, params_to_jax(module.state_dict()))
    module.load_state_dict(params_from_jax(tree))


def _last_items(trainable, opt_state, moment_dtype="float32"):
    """(items, logical dtype names) of ``last/``.  opt_state is (count, mu,
    nu): nu a tree like mu, or with factored nu a list over the leaves of
    [row, col] or [full], keyed ``.nu[i][j]`` as optax's tuple of tuples."""
    count, mu, nu = opt_state
    adam = ("opt_state", ADAM_STATE)
    items = [(("trainable",) + p, a) for p, a in leaves_with_path(trainable)]
    dtypes = ["float32"] * len(items) + ["int32"]
    items.append((adam + (Attr("count"),), np.asarray(count, np.int32)))
    for field, tree, dtype in (("mu", mu, moment_dtype), ("nu", nu, "float32")):
        leaves = [(adam + (Attr(field),) + p, a) for p, a in leaves_with_path(tree)]
        items += leaves
        dtypes += [dtype] * len(leaves)
    return items, dtypes


def save_last(root, trainable, opt_state, moment_dtype="float32", **meta):
    """``<root>/last``: `trainable` (JAX-layout tree without the embedding)
    and `opt_state` (count, mu, nu; see _last_items) in the JAX package's
    layout, mu recorded as `moment_dtype`, then ``meta.json``.  A crash
    between the two pairs new arrays with the previous counters, so a
    resume trains those batches again."""
    path = os.path.join(root, "last")
    save_items(path, *_last_items(trainable, opt_state, moment_dtype))
    _write_json(path, "meta.json", meta)


def restore_last(root, like_trainable, like_opt_state=None, moment_dtype="float32"):
    """``<root>/last`` (written by either package) -> (trainable, (count,
    mu, nu), meta), each in the structure of its like (the optimizer's
    state: float32 moments shaped as the parameters by default), mu
    checked to be saved as `moment_dtype`.  Arrays come back in float32."""
    path = os.path.join(root, "last")
    if like_opt_state is None:
        like_opt_state = (0, like_trainable, like_trainable)
    like, dtypes = _last_items(like_trainable, like_opt_state, moment_dtype)
    arrays = restore_items(path, like, dtypes)
    n = len(list(leaves_with_path(like_trainable)))
    n_mu = len(list(leaves_with_path(like_opt_state[1])))
    strip = lambda items, k: nest([(p[k:], a) for (p, _), a in items])
    pairs = list(zip(like, arrays))
    trainable = strip(pairs[:n], 1)
    count = int(pairs[n][1])
    mu = strip(pairs[n + 1:n + 1 + n_mu], 3)
    nu = strip(pairs[n + 1 + n_mu:], 3)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return trainable, (count, mu, nu), meta


class AsyncSaver:
    """Checkpoint writes on a worker thread, one in flight at a time.

    The caller copies what it saves to the host on the main thread, before
    the next train step changes the parameters, and submits only the
    write.  submit() first joins the previous write, so writes keep their
    order; a failed write raises at the next submit() or wait().  Every
    reader of the checkpoint files waits first."""

    def __init__(self):
        self._pending = None
        self._executor = None

    def submit(self, fn, *args, **kwargs):
        self.wait()
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="ckpt-save")
        self._pending = self._executor.submit(fn, *args, **kwargs)

    def wait(self):
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()  # re-raises a failed write
