"""Checkpoints across the two packages: a JAX-written npz checkpoint loads
into the port, and a port-written one loads into JAX's restore_pytree,
with equal arrays both ways."""

import os

import jax
import numpy as np
import pytest

from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr
from umpr_tpu.train import checkpoint as jckpt
from umpr_tpu_torch.convert import params_to_jax
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.train import checkpoint as ckpt


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_params(seed=0, vocab=30, emb=8):
    e = np.random.default_rng(seed).standard_normal((vocab, emb)).astype(np.float32)
    dims = JaxDims(review_net_only=True, gru_size=64)
    return jax.tree.map(np.asarray, init_umpr(jax.random.PRNGKey(seed), dims, e)), e


def test_jax_written_checkpoint_loads_into_port(tmp_path):
    jparams, emb = _jax_params(1)
    root = str(tmp_path / "run")
    jckpt.save_best(root, jparams)
    model = UMPR(ModelDims(), np.zeros_like(emb))
    ckpt.restore_best(root, model)
    a, b = _flat(jparams), _flat(params_to_jax(model.state_dict()))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_written_checkpoint_loads_into_jax(tmp_path):
    import torch
    jparams, emb = _jax_params(2)
    model = UMPR(ModelDims(), emb, torch.Generator().manual_seed(3))
    root = str(tmp_path / "run")
    ckpt.save_best(root, model)
    restored = jckpt.restore_best(root, jparams)  # keys, shapes, dtypes checked
    a, b = _flat(params_to_jax(model.state_dict())), _flat(restored)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_keystr_matches_jax():
    tree = {"review_net": {"rnet": {"gru": {"fwd": {"w_ih": 1}}}}, "M": 2}
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(k.key for k in path)
        assert ckpt.keystr(names) == jax.tree_util.keystr(path)


def test_restore_rejects_mismatched_structure(tmp_path):
    jparams, emb = _jax_params(3)
    root = str(tmp_path / "run")
    jckpt.save_best(root, jparams)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_best(root, UMPR(ModelDims(), np.zeros((31, 8), np.float32)))
    os.remove(os.path.join(root, "best", "structure.json"))
    os.makedirs(os.path.join(root, "best", "orbax"))
    with pytest.raises(NotImplementedError, match="A4"):
        ckpt.restore_best(root, UMPR(ModelDims(), emb))
