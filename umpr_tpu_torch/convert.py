"""The JAX package's parameter pytree <-> this package's state dict.

umpr_tpu keeps parameters as a nested dict (``init_umpr`` layout) with
"x @ W" weights; VGG16's ``features`` and ``classifier`` are lists, keyed
by int position (``keystr`` ``['features'][0]``).  This package keeps
torch's layouts; a list position is a state-dict name part ("0", "12").
The mapping, by parameter path:

- ``embedding``                        -> ``embedding.weight``
- ``...gru.fwd|bwd.w_ih|w_hh``  (E|H, 3H) -> ``...gru.weight_ih_l0|weight_hh_l0[_reverse]`` (3H, E|H), transposed
- ``...gru.fwd|bwd.bias_ih|bias_hh``    -> ``...gru.bias_ih_l0|bias_hh_l0[_reverse]``
- ``...<linear>.kernel`` (in, out)      -> ``...<linear>.weight`` (out, in), transposed
- ``...<conv1d>.kernel`` (k, in, out)   -> ``...<conv1d>.weight`` (out, in, k), transposed
- ``...<conv2d>.kernel`` HWIO (3, 3, in, out) -> ``...<conv2d>.weight`` OIHW,
  ``permute(3, 2, 0, 1)``: NOT a transpose, which would swap each 3x3
  filter's rows and columns without changing the shape
- every other leaf (``M``, ``Ms``, ``Ws``, ``bias``, ``pos_v_emb``) keeps its path.

Gate order [r | z | n] is the same on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

_GRU_KEYS = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0",
             "bias_ih": "bias_ih_l0", "bias_hh": "bias_hh_l0"}
_GRU_NAMES = {v: k for k, v in _GRU_KEYS.items()}
_GRU_DIRS = {"fwd": "", "bwd": "_reverse"}


def _from_jax_layout(a, transpose):
    """A JAX leaf -> torch's layout (a kernel by its rank)."""
    if not transpose:
        return a
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


def _to_jax_layout(a, transpose):
    if not transpose:
        return a
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T


def _torch_name(path):
    """JAX path tuple -> (state-dict name, transposed?)."""
    path = tuple(str(k) for k in path)
    if path == ("embedding",):
        return "embedding.weight", False
    if len(path) >= 3 and path[-3] == "gru":
        name = _GRU_KEYS[path[-1]] + _GRU_DIRS[path[-2]]
        return ".".join(path[:-2] + (name,)), path[-1].startswith("w_")
    if path[-1] == "kernel":
        return ".".join(path[:-1] + ("weight",)), True
    return ".".join(path), False


def leaves_with_path(tree, prefix=()):
    """(path tuple, leaf) of a nested dict/list, in JAX's leaf order:
    dict keys sorted, list items in order (their path part an int)."""
    items = enumerate(tree) if isinstance(tree, list) else (
        (k, tree[k]) for k in sorted(tree))
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from leaves_with_path(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree):
    """JAX param pytree (nested dict/list of numpy arrays) -> state dict of
    f32 CPU tensors for ``load_state_dict``."""
    out = {}
    for path, leaf in leaves_with_path(tree):
        name, transpose = _torch_name(path)
        a = np.asarray(leaf, dtype=np.float32)
        out[name] = torch.tensor(np.ascontiguousarray(_from_jax_layout(a, transpose)))
    return out


def _jax_path(name):
    """state-dict name -> (JAX path tuple, transposed?); inverse of
    _torch_name.  Digit parts become int list positions."""
    parts = tuple(int(p) if p.isdigit() else p for p in name.split("."))
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


def listify(node):
    """Dicts keyed by ints 0..n-1 -> lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"list positions {sorted(node)} are not 0..{len(node) - 1}")
        return [node[i] for i in range(len(node))]
    return node


def params_to_jax(state_dict):
    """Inverse of params_from_jax: state dict -> nested dict/list of numpy
    arrays in umpr_tpu's init_umpr layout."""
    tree = {}
    for name, t in state_dict.items():
        path, transpose = _jax_path(name)
        a = t.detach().cpu().numpy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(_to_jax_layout(a, transpose))
    return listify(tree)
