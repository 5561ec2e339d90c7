"""Checkpoints in umpr_tpu's path-keyed npz format, read and written
without JAX (port of umpr_tpu/train/checkpoint.py:113-262, npz backend).

A checkpoint directory holds ``arrays.npz`` (``leaf_00000`` ...) and
``structure.json`` (``version`` 1, ``keys``, ``dtypes``, ``n``).  Keys are
JAX ``keystr`` strings of the parameter path, e.g.
``['review_net']['rnet']['gru']['fwd']['w_ih']`` or, for a list position,
``['visual_net']['vgg16']['features'][0]['kernel']``, in JAX's leaf order
(dict keys sorted, lists in order).  Restore matches leaves by key and
checks shapes and dtypes, as umpr_tpu's ``restore_pytree`` does for
version >= 1, so either package reads the other's checkpoints.  Layout under a run directory: ``best/``
holds the parameters at the best validation MSE.
"""

from __future__ import annotations

import json
import os

import numpy as np

from umpr_tpu_torch.convert import (leaves_with_path, listify, params_from_jax,
                                    params_to_jax)

FORMAT_VERSION = 1


def keystr(path):
    """('a', 0, 'b') -> "['a'][0]['b']", as jax.tree_util.keystr writes
    dict keys and list positions."""
    return "".join(f"[{k!r}]" for k in path)


def save_pytree(path, tree):
    """Nested dict of arrays -> path-keyed npz checkpoint (atomic swaps)."""
    os.makedirs(path, exist_ok=True)
    items = list(leaves_with_path(tree))
    arrays = {f"leaf_{i:05d}": np.asarray(a) for i, (_, a) in enumerate(items)}
    meta = {"version": FORMAT_VERSION,
            "keys": [keystr(p) for p, _ in items],
            "dtypes": [str(a.dtype) for a in arrays.values()],
            "fingerprint": None, "n": len(items)}
    np.savez(os.path.join(path, "arrays.tmp.npz"), **arrays)
    os.replace(os.path.join(path, "arrays.tmp.npz"),
               os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "structure.json.tmp"), "w") as f:
        json.dump(meta, f)
    os.replace(os.path.join(path, "structure.json.tmp"),
               os.path.join(path, "structure.json"))


def restore_pytree(path, like):
    """Restore into the structure of `like` (nested dict/list of arrays):
    leaves matched by key; missing or extra keys, shapes and dtypes are
    checked."""
    meta_path = os.path.join(path, "structure.json")
    if not os.path.exists(meta_path):
        if os.path.isdir(os.path.join(path, "orbax")):
            raise NotImplementedError(
                f"{path} is an orbax checkpoint; the port reads npz only "
                "(ROADMAP A2)")
        raise FileNotFoundError(f"no checkpoint at {path}")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("version", 0) < 1:
        raise ValueError(f"{path} is a legacy order-based (v0) checkpoint; "
                         "re-save it with umpr_tpu to get the path-keyed format")
    like_items = list(leaves_with_path(like))
    keys = [keystr(p) for p, _ in like_items]
    index = {k: i for i, k in enumerate(meta["keys"])}
    missing = [k for k in keys if k not in index]
    extra = [k for k in meta["keys"] if k not in set(keys)]
    if missing or extra:
        raise ValueError(
            f"checkpoint at {path} does not match the model structure: "
            f"missing keys {missing[:5]}, unexpected keys {extra[:5]}")
    tree = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for (p, old), k in zip(like_items, keys):
            new = z[f"leaf_{index[k]:05d}"]
            if tuple(np.shape(old)) != new.shape:
                raise ValueError(f"checkpoint at {path}: leaf {k} has shape "
                                 f"{new.shape}, expected {np.shape(old)}")
            saved = meta["dtypes"][index[k]] if meta.get("dtypes") else None
            if saved is not None and saved != str(np.asarray(old).dtype):
                raise ValueError(f"checkpoint at {path}: leaf {k} was saved as "
                                 f"{saved}, the model expects "
                                 f"{np.asarray(old).dtype}")
            node = tree
            for part in p[:-1]:
                node = node.setdefault(part, {})
            node[p[-1]] = new.astype(np.asarray(old).dtype)
    return listify(tree)


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
