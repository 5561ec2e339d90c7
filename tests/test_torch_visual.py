"""The port's VGG16 and visual head (models/visual_net.py) against the JAX
package's ``vgg16`` / ``visual_net`` on the same weights, at 64 px, B=2:
block 1 (H=64) takes the fused pool, block 2 (H=32) the composite.  The
JAX side runs unfolded and width-folded (the same function).  Forward at
1e-5 in f32; gradients at 1e-5 in f64 on both sides: in f32, XLA's and
oneDNN's convs round differently, and a ReLU or max-pool decision that
flips on a value within that rounding of 0 or of its window's max moves
whole gradient terms (a flip at 64 px, B=2 moved one conv's weight
gradient by 7% at its largest entry).  The dropout draw is checked for
its determinism and its rate."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umpr_tpu.models.visual_net import vgg16, visual_net
from umpr_tpu_torch.convert import params_from_jax, params_to_jax
from umpr_tpu_torch.models.visual_net import VGG16, VisualNet, dropout
from umpr_tpu_torch.ops import pool_cuda

PX, B = 64, 2


@pytest.fixture(scope="module")
def nets():
    """Port VGG16s without and with the fused pool, on one set of weights,
    and that set as a JAX tree."""
    plain = VGG16(img_size=PX, generator=torch.Generator().manual_seed(0))
    fused = VGG16(img_size=PX, fused_pool=True)
    fused.load_state_dict(plain.state_dict())
    return {False: plain, True: fused}, params_to_jax(plain.state_dict())


def _images(seed):
    return np.random.default_rng(seed).uniform(0, 1, (B, PX, PX, 3)).astype(np.float32)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("fold_w", [False, True])
def test_vgg16_forward_and_grads_match_jax(nets, fused, fold_w):
    models, jp = nets
    img = _images(1)
    jout = jax.jit(lambda p, x: vgg16(p, x, fold_w=fold_w, fused_pool=fused))(jp, img)
    with torch.no_grad():
        out = models[fused](torch.from_numpy(img))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    if fused != fold_w:
        return  # gradients: the unfused pair, and the port's fused pool
                # against the JAX package's folded block 1

    model = copy.deepcopy(models[fused]).double()
    out = model(torch.from_numpy(img).double())
    (out ** 2).sum().backward()
    got = _flat(params_to_jax({n: p.grad for n, p in model.named_parameters()}))
    with jax.enable_x64(True):
        jp64 = jax.tree.map(lambda a: np.asarray(a, np.float64), jp)
        want = _flat(jax.jit(jax.grad(
            lambda p, x: jnp.sum(vgg16(p, x, fold_w=fold_w, fused_pool=fused) ** 2)))(
                jp64, img.astype(np.float64)))
    assert want.keys() == got.keys() and len(got) == 32
    for k in want:
        assert want[k].dtype == np.float64
        assert _rel(got[k], want[k]) <= 1e-5, (k, _rel(got[k], want[k]))


def test_fused_pool_runs_block_1_only_at_64_px(nets, monkeypatch):
    models, _ = nets
    calls = []
    real = pool_cuda.bias_relu_pool

    def spy(x, b):
        calls.append(tuple(x.shape))
        return real(x, b)

    monkeypatch.setattr(pool_cuda, "bias_relu_pool", spy)
    with torch.no_grad():
        models[True](torch.from_numpy(_images(2)))
        models[False](torch.from_numpy(_images(2)))
    assert calls == [(B, PX, PX, 64)]


def test_visual_net_matches_jax(nets):
    models, jp = nets
    V, P = 2, 1
    net = VisualNet(V, img_size=PX, fused_pool=True,
                    generator=torch.Generator().manual_seed(1))
    net.vgg16.load_state_dict(models[False].state_dict())
    jnet = params_to_jax(net.state_dict())
    rng = np.random.default_rng(3)
    photos = rng.integers(0, 256, (B, V, P, PX, PX, 3)).astype(np.uint8)
    c_u, c_i = (rng.uniform(0, 2, (B, V)).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda p, *a: visual_net(p, *a, fold_w=False, fused_pool=True))(
        jnet, photos, c_u, c_i)
    with torch.no_grad():
        got = net(torch.from_numpy(photos), torch.from_numpy(c_u), torch.from_numpy(c_i))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert all(np.isfinite(g.numpy()).all() for g in got)


def test_dropout_is_seeded_keeps_half_and_scales_by_two():
    x = torch.rand(64, 4096) + 0.5
    a = dropout(x, torch.Generator().manual_seed(7))
    b = dropout(x, torch.Generator().manual_seed(7))
    c = dropout(x, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.01
    assert torch.equal(a[kept], x[kept] * 2)


def test_vgg16_dropout_only_with_a_generator(nets):
    models, _ = nets
    img = torch.from_numpy(_images(4))
    with torch.no_grad():
        off = models[False](img)
        assert torch.equal(off, models[False](img))
        on = [models[False](img, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(on[0], on[1]) and not torch.equal(on[0], on[2])
    assert not torch.equal(on[0], off)


def test_photo_size_must_be_a_multiple_of_32():
    with pytest.raises(ValueError, match="multiple of 32"):
        VGG16(img_size=100)
    assert params_from_jax(params_to_jax(VGG16(img_size=32).state_dict()))[
        "classifier.0.weight"].shape == (4096, 512)
