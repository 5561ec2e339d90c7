"""Full UMPR (ReviewNet + ControlNet + VisualNet, loss_v) in the port
against the JAX package on the same weights, at small shapes (B=4, 64 px
photos: VGG block 1 takes the fused pool).

- The forward against ``umpr_forward(train=False)`` with the Pallas GRU
  and pool kernels (interpreted): 1e-4 (PARITY.md, full forward).
- One train step against ``make_train_step`` with dropout off, in f64 on
  both sides: gradients within 1e-3 relative, parameters after one Adam
  step within 1e-5.  In f32 a ReLU or max-pool decision of VGG16 that
  flips on a value within rounding of its threshold moves whole gradient
  terms (test_torch_visual.py); f64 takes the rounding out.
- Dead rows: NaN on them reaches no gradient; checkpoints with VGG16's
  list-indexed keys, both ways; the trainer's dropout generator and
  ``--vgg16_weights``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.ref_oracle import random_batch
from tests.test_torch_model import _kill_rows
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr, umpr_forward
from umpr_tpu.train import checkpoint as jckpt
from umpr_tpu.train.optim import make_optimizer as jax_make_optimizer
from umpr_tpu.train.optim import merge_params, split_frozen
from umpr_tpu.train.step import make_train_step
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import params_from_jax, params_to_jax
from umpr_tpu_torch.data.loader import to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.models.visual_net import VGG16
from umpr_tpu_torch.train import checkpoint as ckpt
from umpr_tpu_torch.train.optim import make_optimizer
from umpr_tpu_torch.train.step import train_step
from umpr_tpu_torch.train.trainer import Trainer

VOCAB, EMB, PX = 40, 16, 64
DIMS = dict(gru_size=64, self_atte_size=16, kernel_count=8, kernel_size=3,
            photo_size=PX)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _model(seed, fused=True):
    """A port model from `seed`, its weights as a JAX tree, and the GloVe
    table.  The head's bias is raised so that the ReLU head's predictions
    are > 0 and the comparisons see them."""
    emb = np.random.default_rng(seed).standard_normal((VOCAB, EMB)).astype(np.float32)
    model = UMPR(ModelDims(review_net_only=False, vgg_fused_pool=fused, **DIMS), emb,
                 torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.linear_fusion.bias.fill_(3.0)
    return model, params_to_jax(model.state_dict()), emb


def _jdims(**kw):
    return JaxDims(review_net_only=False, view_size=1, **DIMS, **kw)


def _batch(seed, dead):
    rng = np.random.default_rng(seed)
    b = random_batch(rng, B=4, S=3, L=8, S_ui=2, vocab=VOCAB, emb=EMB,
                     with_photos=True, img=PX, max_count=2, max_len=7)
    if dead:
        b = _kill_rows(b, dead)
        b["photos"][-dead:] = 0  # the loader's '' path
    return b


@pytest.mark.parametrize("dead,fold_w", [(1, False), (0, True)])
def test_full_forward_matches_jax(dead, fold_w):
    model, jp, _ = _model(1)
    batch = _batch(2, dead)
    jdims = _jdims(use_pallas=True, vgg_fused_pool=True, vgg_fold_w=fold_w)
    jpred, jloss, jaux = jax.jit(lambda p, b: umpr_forward(p, b, jdims, train=False))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        pred, loss, aux = model(to_device(batch, "cpu"))
    alive = batch["sample_mask"] > 0
    assert (pred.numpy()[alive] > 0).all()  # the head is not clamped
    np.testing.assert_allclose(pred.numpy()[alive], np.asarray(jpred)[alive],
                               rtol=1e-4, atol=1e-4)
    for got, want in ((loss, jloss), (aux["loss_r"], jaux["loss_r"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux["loss_v"]), float(jaux["loss_v"]), rtol=1e-4)
    assert float(aux["loss_v"]) != 0.0


def test_train_step_matches_jax_make_train_step_in_f64():
    model, jp, _ = _model(3)
    model = model.double()
    batch = _batch(4, dead=1)
    lr, l2 = 1e-3, 1e-3
    opt = make_optimizer(model, l2, lr)
    loss, n_real = train_step(model, opt, to_device(batch, "cpu"), lr)
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert all(torch.isfinite(g).all() for g in grads.values())

    jdims = _jdims(use_pallas=False, vgg_fold_w=False)
    with jax.enable_x64(True):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        trainable, frozen = split_frozen(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp))
        jgrads = jax.jit(jax.grad(lambda t: umpr_forward(
            merge_params(t, frozen), jbatch, jdims, train=True)[1]))(trainable)
        tx = jax_make_optimizer(l2)
        jtrained, _, jloss, jaux = make_train_step(jdims, tx, donate=False)(
            trainable, frozen, tx.init(trainable), jbatch, lr, None)
        jgrads, jtrained = _flat(jgrads), _flat(merge_params(jtrained, frozen))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(n_real) == float(jaux["n_real"]) == 3

    got = _flat(params_to_jax(grads))
    assert got.keys() == jgrads.keys()
    for k, want in jgrads.items():
        assert want.dtype == np.float64
        # + 1e-12: the visual linear's bias cancels in eq. 11, so its
        # gradient is 0 up to f64 rounding on both sides
        err = np.abs(got[k] - want).max()
        assert err <= 1e-3 * np.abs(want).max() + 1e-12, (k, err, np.abs(want).max())
    after = _flat(params_to_jax(model.state_dict()))
    assert after.keys() == jtrained.keys()
    for k, want in jtrained.items():
        np.testing.assert_allclose(after[k], want, rtol=1e-5, atol=1e-5, err_msg=k)
    moved = _flat(jp)
    assert all(not np.array_equal(after[k], moved[k]) for k in after
               if "features'][0]" in k or "cnet']['gru" in k)


def test_nan_on_dead_rows_reaches_no_gradient():
    model, _, _ = _model(5)
    batch = to_device(_batch(6, dead=1), "cpu")
    dead = (batch["sample_mask"] == 0)[:, None]
    # the visual net's four outputs carry NaN on the dead row
    model.visual_net.register_forward_hook(
        lambda mod, args, out: tuple(torch.where(dead, float("nan"), t) for t in out))
    _, loss, aux = model(batch)
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(aux["loss_v"])
    for n, p in model.named_parameters():
        if p.requires_grad:
            assert torch.isfinite(p.grad).all(), n
    # the failure the selects prevent: a matmul's weight gradient multiplies
    # the NaN row by its zero cotangent
    x = torch.tensor([[1.0, 2.0], [float("nan"), 1.0]])
    w = torch.ones(1, 2, requires_grad=True)
    torch.where(torch.tensor([[True], [False]]), F.linear(x, w), 0.0).sum().backward()
    assert torch.isnan(w.grad).any()


def test_checkpoint_keys_and_layouts_equal_the_jax_package(tmp_path):
    model, jp, emb = _model(7)
    shapes = jax.eval_shape(lambda k: init_umpr(k, _jdims(), emb), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): v.shape
            for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: v.shape for k, v in _flat(jp).items()} == want
    assert "['visual_net']['vgg16']['features'][12]['kernel']" in want
    assert want["['visual_net']['vgg16']['features'][0]['kernel']"] == (3, 3, 3, 64)

    # port-written -> JAX restore_pytree; JAX-written -> port
    ckpt.save_best(str(tmp_path / "port"), model)
    restored = _flat(jckpt.restore_best(str(tmp_path / "port"), jp))
    for k, v in _flat(jp).items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    other, jother, _ = _model(8)
    jckpt.save_best(str(tmp_path / "jax"), jax.tree.map(jnp.asarray, jother))
    ckpt.restore_best(str(tmp_path / "jax"), model)
    for k, v in other.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_an_asymmetric_3x3_filter_keeps_its_orientation():
    vgg = VGG16(img_size=32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        vgg.features[0].weight.zero_()
        vgg.features[0].weight[5, 2] = torch.arange(9.0).reshape(3, 3)
    tree = params_to_jax(vgg.state_dict())
    kernel = tree["features"][0]["kernel"]  # HWIO
    np.testing.assert_array_equal(kernel[:, :, 2, 5], np.arange(9.0).reshape(3, 3))
    x = np.random.default_rng(0).standard_normal((1, 6, 7, 3)).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), kernel, (1, 1), [(1, 1), (1, 1)],
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), vgg.features[0].weight,
                   padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    back = params_from_jax(tree)
    for k, v in vgg.state_dict().items():
        assert torch.equal(back[k], v), k


class _W2v:
    def __init__(self, emb):
        self.embedding = emb


def _trainer(tmp_path, *flags):
    emb = np.random.default_rng(0).standard_normal((VOCAB, EMB)).astype(np.float32)
    cfg = Config(["--device", "cpu", "--review_net_only", "False", "--photo_size", "32",
                  "--gru_size", "64", "--seed", "3", *flags])
    return Trainer(cfg, logging.getLogger("port-full"), _W2v(emb))


def test_dropout_generator_is_seeded_by_seed_and_step(tmp_path):
    trainer = _trainer(tmp_path)
    draw = lambda k: torch.rand(1000, generator=trainer.dropout_generator(k))
    assert torch.equal(draw(5), draw(5)) and not torch.equal(draw(5), draw(6))
    other = _trainer(tmp_path, "--seed", "4")
    assert not torch.equal(draw(5), torch.rand(1000, generator=other.dropout_generator(5)))
    cfg = Config(["--device", "cpu", "--review_net_only", "True"])
    assert Trainer(cfg, logging.getLogger("port-r"), _W2v(np.zeros((5, 4), np.float32))
                   ).dropout_generator(0) is None  # UMPR-R has no dropout


def test_vgg16_weights_are_loaded_or_the_failure_logged(tmp_path, caplog):
    vgg = VGG16(img_size=32, generator=torch.Generator().manual_seed(9))
    ckpt.save_pytree(str(tmp_path / "vgg"), params_to_jax(vgg.state_dict()))
    with caplog.at_level(logging.INFO, logger="port-full"):
        trainer = _trainer(tmp_path, "--vgg16_weights", str(tmp_path / "vgg"))
        missing = _trainer(tmp_path, "--vgg16_weights", str(tmp_path / "nothing"))
    for k, v in vgg.state_dict().items():
        assert torch.equal(trainer.model.visual_net.vgg16.state_dict()[k], v), k
    assert "Loaded VGG16 pretrained weights" in caplog.text
    assert "Failed to load VGG16 weights" in caplog.text
    assert not torch.equal(missing.model.visual_net.vgg16.features[0].weight,
                           vgg.features[0].weight)
