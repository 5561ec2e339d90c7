"""``--grad_accum_steps k`` in the port on the CPU:

- ``step.train_step_accum`` at k = 4 against ``train_step`` on one batch
  of B = 8 whose last 3 rows are dead (so the last micro-batch is wholly
  dead), dropout off, UMPR-R and full UMPR (32 px, in f64 as
  tests/test_torch_full.py's train step: in f32 the visual linear's bias,
  whose gradient cancels to rounding noise in eq. 11, takes an Adam step
  of either sign): the loss within 1e-5 relative, the parameters after
  the Adam step within rtol 2e-5, atol 2e-6 (the JAX package's
  tests/test_optim.py), the same aux terms;
- the accumulated step against ``make_train_step_accum`` on the same
  weights (1e-5);
- the Trainer at k = 2 against k = 1 over an epoch (rtol 1e-4, atol
  1e-5, as tests/test_e2e_train.py);
- with dropout on the loss is finite, and the guards on ``batch_size %
  k``.

The CPU's thread count is fixed, so that oneDNN's reductions keep one
order."""

import copy
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.ref_oracle import random_batch
from tests.test_device_dataset import packed_dataset
from tests.test_torch_train import _jax_and_port_models
from tests.test_torch_train_flags import _W2v
from umpr_tpu.train.optim import make_optimizer as jax_make_optimizer
from umpr_tpu.train.optim import merge_params, split_frozen
from umpr_tpu.train.step import make_train_step_accum
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import params_to_jax
from umpr_tpu_torch.data.loader import to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.train.optim import make_optimizer
from umpr_tpu_torch.train.step import train_step, train_step_accum
from umpr_tpu_torch.train.trainer import Trainer

K = 4


@pytest.fixture(autouse=True)
def fixed_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _batch(full):
    """B = 8, the last 3 rows dead as the loader pads them (the k = 4
    micro-batch of rows 6-7 wholly dead)."""
    b = random_batch(np.random.default_rng(11), B=8, S=5, L=10, S_ui=2, with_photos=full,
                     img=32)
    b["sample_mask"][-3:] = 0
    for key in ("u_counts", "i_counts", "ui_counts"):
        b[key][-3:] = 0
    for key in ("u_lengths", "i_lengths", "ui_lengths"):
        b[key][-3:] = 1
    if full:
        b["photos"][-3:] = 0
    return to_device(b, "cpu")


@pytest.mark.parametrize("full", [False, True])
def test_four_micro_batches_equal_the_single_step(full):
    emb = np.random.default_rng(0).standard_normal((40, 16)).astype(np.float32)
    dims = ModelDims(review_net_only=not full, kernel_count=8, photo_size=32,
                     vgg_fused_pool=full)
    one = UMPR(dims, emb, torch.Generator().manual_seed(2))
    if full:
        one = one.double()
    four, head = copy.deepcopy(one), one.linear_fusion.weight.detach().clone()
    batch = _batch(full)
    _, _, want_aux = one(batch)
    loss1, n1 = train_step(one, make_optimizer(one, 1e-3, 1e-3), batch)
    loss4, n4, aux4 = train_step_accum(four, make_optimizer(four, 1e-3, 1e-3), batch, K)
    assert float(n1) == float(n4) == 5
    assert abs(float(loss4) - float(loss1)) <= 1e-5 * max(1.0, abs(float(loss1)))
    assert aux4.keys() == want_aux.keys()
    for key, v in want_aux.items():
        np.testing.assert_allclose(float(aux4[key]), v.item(), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    a, b = one.state_dict(), four.state_dict()
    for key in a:
        np.testing.assert_allclose(b[key].numpy(), a[key].numpy(), rtol=2e-5, atol=2e-6,
                                   err_msg=key)
    assert not torch.equal(a["linear_fusion.weight"], head)  # the step moved the head


def test_accumulated_step_matches_make_train_step_accum():
    jparams, jdims, model = _jax_and_port_models(seed=3)
    # the JAX package's plain GRU (its Pallas kernels are held against it in
    # tests/test_gru_pallas.py)
    jdims = dataclasses.replace(jdims, use_pallas=False)
    batch = _batch(False)  # random_batch's 40-word, 16-d table, as the models'
    l2, lr = 1e-3, 1e-4  # lr as tests/test_torch_device_dataset.py's resident step
    tx = jax_make_optimizer(l2)
    trainable, frozen = split_frozen(jparams)
    jtrained, _, jloss, jaux = make_train_step_accum(jdims, K, tx, donate=False)(
        trainable, frozen, tx.init(trainable), {k: jnp.asarray(v.numpy())
                                                for k, v in batch.items()}, lr, None)
    loss, n, aux = train_step_accum(model, make_optimizer(model, l2, lr), batch, K)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux["loss_r"]), float(jaux["loss_r"]), rtol=1e-5,
                               atol=1e-5)
    assert float(n) == float(jaux["n_real"]) == 5
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(merge_params(jtrained, frozen))[0]}
    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(params_to_jax(model.state_dict()))[0]}
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)


BASE = ["--device", "cpu", "--review_net_only", "True", "--batch_size", "8",
        "--train_epochs", "1", "--eval_every", "8", "--learning_rate", "0.01",
        "--min_sent_count", "1", "--seed", "2"]


def test_trainer_at_two_micro_batches_tracks_the_single_step(tmp_path):
    train, valid = packed_dataset(44, seed=0), packed_dataset(8, seed=1)  # 6 steps
    runs = {}
    for k in (1, 2):
        t = Trainer(Config(BASE + ["--grad_accum_steps", str(k)]),
                    logging.getLogger(f"accum-{k}"), _W2v())
        t.fit(train, valid, str(tmp_path / f"k{k}"))
        runs[k] = t
    assert runs[1].batch_counter == runs[2].batch_counter == 6
    assert not runs[2]._resident  # auto streams under accumulation
    a, b = runs[1].model.state_dict(), runs[2].model.state_dict()
    for key in a:
        np.testing.assert_allclose(b[key].numpy(), a[key].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_dropout_on_gives_a_finite_loss_and_the_guards_hold():
    emb = np.random.default_rng(0).standard_normal((40, 16)).astype(np.float32)
    model = UMPR(ModelDims(review_net_only=False, kernel_count=8, photo_size=32), emb,
                 torch.Generator().manual_seed(2))
    batch = _batch(True)
    loss, n, aux = train_step_accum(model, make_optimizer(model, 1e-3, 1e-3), batch, 2,
                                    drop=torch.Generator().manual_seed(5))
    assert torch.isfinite(loss) and all(torch.isfinite(v) for v in aux.values())
    with pytest.raises(ValueError, match="not divisible"):
        train_step_accum(model, make_optimizer(model, 1e-3, 1e-3), batch, 3)
    with pytest.raises(ValueError, match="divide --batch_size"):
        Trainer(Config(BASE + ["--grad_accum_steps", "3"]), logging.getLogger("accum-3"),
                _W2v())
