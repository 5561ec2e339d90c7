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

Adam's state maps the same way (``adam_to_jax`` / ``adam_from_jax``): the
port's Adam (train/optim.py) keeps ``exp_avg`` and ``exp_avg_sq`` per
parameter and one device step count, optax one ``ScaleByAdamState(count,
mu, nu)`` whose mu and nu are trees of the parameters' layout and whose
count is one int32 for all.  With ``--adam_factored_nu`` optax's nu is a
tuple over the leaves in JAX leaf order, each ``(row, col)`` or
``(full,)``; the port keeps the factored pairs in JAX's shapes.
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


def _by_jax_path(named, leaf):
    """{state-dict name: value} -> the nested dict/list at the names' JAX
    paths, each leaf ``leaf(value, transposed?)``."""
    tree = {}
    for name, v in named.items():
        path, transposed = _jax_path(name)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf(v, transposed)
    return listify(tree)


def params_to_jax(state_dict):
    """Inverse of params_from_jax: state dict -> nested dict/list of numpy
    arrays in umpr_tpu's init_umpr layout."""
    return _by_jax_path(state_dict, lambda t, transposed: np.ascontiguousarray(
        _to_jax_layout(t.detach().cpu().numpy(), transposed)))


def to_jax_view(t, transposed):
    """A torch-layout tensor as a view in the JAX package's layout: the
    torch counterpart of _to_jax_layout (``.T`` reverses every dim)."""
    if not transposed:
        return t
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t.permute(*reversed(range(t.dim())))


def from_jax_view(t, transposed):
    """Inverse of to_jax_view."""
    if not transposed:
        return t
    return t.permute(3, 2, 0, 1) if t.dim() == 4 else t.permute(*reversed(range(t.dim())))


def jax_leaf_order(names):
    """The state-dict names in JAX leaf order (``leaves_with_path`` of
    their tree): the order of optax's factored nu, a tuple over the
    leaves."""
    tree = _by_jax_path(dict(zip(names, names)), lambda name, _: name)
    return [name for _, name in leaves_with_path(tree)]


def _host(t):
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def shape_only(t):
    return np.empty(t.shape, np.float32)


def adam_to_jax(model, opt, leaf=_host):
    """The port's Adam state (train/optim.py) -> optax's (count, mu, nu) in
    the JAX layout of the trainable parameters: host copies in f32 (a bf16
    mu widened exactly, as the JAX package writes it); with `leaf`
    ``shape_only``, arrays of the right shapes for restore_last to match
    against.  mu is a tree; nu a tree too, or with factored nu a list over
    the JAX leaves of [row, col] or [full] (optax's tuple of tuples)."""
    state = {n: opt.state[p] for n, p in zip(opt.names, opt.params)}
    tree = lambda key: _by_jax_path({n: s[key] for n, s in state.items()},
                                    lambda t, transposed: leaf(to_jax_view(t, transposed)))
    mu = tree("exp_avg")
    if not opt.factored_nu:
        nu = tree("exp_avg_sq")
    else:
        nu = []
        for n in jax_leaf_order(opt.names):
            v = state[n]["exp_avg_sq"]
            nu.append([leaf(x) for x in v] if isinstance(v, tuple)
                      else [leaf(to_jax_view(v, _jax_path(n)[1]))])
    count = np.int32(0) if leaf is shape_only else np.int32(opt.count.item())
    return count, mu, nu


def adam_from_jax(model, opt, count, mu, nu):
    """Load optax's (count, mu, nu) into the port's Adam `opt`, in place
    (CUDA graphs captured on its tensors stay valid): the inverse of
    adam_to_jax.  A bf16 mu is rounded back exactly."""
    state = {n: opt.state[p] for n, p in zip(opt.names, opt.params)}
    for name, t in params_from_jax(mu).items():
        state[name]["exp_avg"].copy_(t)
    if not opt.factored_nu:
        for name, t in params_from_jax(nu).items():
            state[name]["exp_avg_sq"].copy_(t)
    else:
        for name, leaves in zip(jax_leaf_order(opt.names), nu):
            v = state[name]["exp_avg_sq"]
            if isinstance(v, tuple):
                for dst, src in zip(v, leaves):
                    dst.copy_(torch.from_numpy(np.asarray(src, np.float32)))
            else:
                src = torch.from_numpy(np.asarray(leaves[0], np.float32))
                to_jax_view(v, _jax_path(name)[1]).copy_(src)
    opt.count.fill_(int(count))
