"""The JAX package's parameter pytree <-> this package's state dict.

umpr_tpu keeps parameters as a nested dict (``init_umpr`` layout) with
"x @ W" weights; this package keeps torch's layouts.  The mapping, by
parameter path:

- ``embedding``                        -> ``embedding.weight``
- ``...gru.fwd|bwd.w_ih|w_hh``  (E|H, 3H) -> ``...gru.weight_ih_l0|weight_hh_l0[_reverse]`` (3H, E|H), transposed
- ``...gru.fwd|bwd.bias_ih|bias_hh``    -> ``...gru.bias_ih_l0|bias_hh_l0[_reverse]``
- ``...<linear>.kernel`` (in, out)      -> ``...<linear>.weight`` (out, in), transposed
- every other leaf (``M``, ``Ms``, ``Ws``, ``bias``) keeps its path.

Gate order [r | z | n] is the same on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

_GRU_KEYS = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0",
             "bias_ih": "bias_ih_l0", "bias_hh": "bias_hh_l0"}
_GRU_NAMES = {v: k for k, v in _GRU_KEYS.items()}
_GRU_DIRS = {"fwd": "", "bwd": "_reverse"}


def _torch_name(path):
    """JAX path tuple -> (state-dict name, transposed?)."""
    if path == ("embedding",):
        return "embedding.weight", False
    if len(path) >= 3 and path[-3] == "gru":
        name = _GRU_KEYS[path[-1]] + _GRU_DIRS[path[-2]]
        return ".".join(path[:-2] + (name,)), path[-1].startswith("w_")
    if path[-1] == "kernel":
        return ".".join(path[:-1] + ("weight",)), True
    return ".".join(path), False


def leaves_with_path(tree, prefix=()):
    """(path tuple, leaf) of a nested dict, in JAX's sorted-key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves_with_path(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def params_from_jax(tree):
    """JAX param pytree (nested dict of numpy arrays) -> state dict of f32
    CPU tensors for ``UMPR.load_state_dict``."""
    out = {}
    for path, leaf in leaves_with_path(tree):
        name, transpose = _torch_name(path)
        a = np.asarray(leaf, dtype=np.float32)
        out[name] = torch.tensor(a.T if transpose else a)
    return out


def _jax_path(name):
    """state-dict name -> (JAX path tuple, transposed?); inverse of
    _torch_name."""
    parts = tuple(name.split("."))
    if name == "embedding.weight":
        return ("embedding",), False
    if len(parts) >= 2 and parts[-2] == "gru":
        base = parts[-1]
        direction = "bwd" if base.endswith("_reverse") else "fwd"
        key = _GRU_NAMES[base.removesuffix("_reverse")]
        return parts[:-1] + (direction, key), key.startswith("w_")
    if parts[-1] == "weight":
        return parts[:-1] + ("kernel",), True
    return parts, False


def params_to_jax(state_dict):
    """Inverse of params_from_jax: state dict -> nested dict of numpy
    arrays in umpr_tpu's init_umpr layout."""
    tree = {}
    for name, t in state_dict.items():
        path, transpose = _jax_path(name)
        a = t.detach().cpu().numpy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(a.T if transpose else a)
    return tree
