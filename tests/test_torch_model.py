"""The port's UMPR-R forward against the JAX package's
``umpr_forward(train=False)`` with ``use_pallas=True`` (the Pallas GRU
kernels, interpreted on the CPU) on the same weights, carried over by
``params_from_jax``.  Tolerance ~1e-4 (PARITY.md, full forward)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.ref_oracle import random_batch
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr, umpr_forward
from umpr_tpu_torch.convert import params_from_jax, params_to_jax
from umpr_tpu_torch.data.loader import to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims

TOL = dict(rtol=1e-4, atol=1e-4)
VOCAB, EMB = 40, 16


def _models(seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((VOCAB, EMB)).astype(np.float32)
    jdims = JaxDims(review_net_only=True, use_pallas=True, gru_size=64,
                    self_atte_size=16)
    jparams = jax.tree.map(np.asarray,
                           init_umpr(jax.random.PRNGKey(seed), jdims, emb))
    model = UMPR(ModelDims(gru_size=64, self_atte_size=16), emb)
    model.load_state_dict(params_from_jax(jparams))
    return jparams, jdims, model.eval()


def _kill_rows(batch, n_dead):
    """Dead padding rows as BatchLoader makes them."""
    b = {k: v.copy() for k, v in batch.items()}
    b["sample_mask"][-n_dead:] = 0
    for k in ("u_counts", "i_counts", "ui_counts"):
        b[k][-n_dead:] = 0
    for k in ("u_lengths", "i_lengths", "ui_lengths"):
        b[k][-n_dead:] = 1
    return b


@pytest.mark.parametrize("case", ["runtime_maxima", "full_pad", "dead_rows"])
def test_umpr_r_forward_matches_jax(case):
    jparams, jdims, model = _models(seed=4)
    rng = np.random.default_rng(7)
    batch = random_batch(rng, B=4, S=3, L=8, S_ui=2, vocab=VOCAB, emb=EMB,
                         max_count=2, max_len=7)
    if case == "full_pad":
        batch["pad_maxima"] = (3, 8, 2, 8)
    if case == "dead_rows":
        batch = _kill_rows(batch, 2)

    jbatch = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in batch.items()}
    jpred, jloss, _ = umpr_forward(jparams, jbatch, jdims, train=False)

    pm = batch.pop("pad_maxima", None)
    tbatch = to_device(batch, "cpu")
    if pm is not None:
        tbatch["pad_maxima"] = pm
    with torch.no_grad():
        pred, loss, aux = model(tbatch)
    alive = batch["sample_mask"] > 0
    np.testing.assert_allclose(pred.numpy()[alive], np.asarray(jpred)[alive], **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert np.isfinite(float(loss)) and float(aux["loss_r"]) == float(loss)


def test_params_to_jax_inverts_params_from_jax():
    jparams, _, model = _models(seed=5)
    back = params_to_jax(model.state_dict())
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(jparams), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
