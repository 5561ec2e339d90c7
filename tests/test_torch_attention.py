"""The port's affinity attention (umpr_tpu_torch.ops.attention and
attention_cuda) against the JAX package on the CPU, where the port's kernel
path runs the plain versions of K7/K8 and the JAX Pallas kernels B9
(column-tiled) and B10 (whole-tile) run interpreted.

Tolerances: soft_u/soft_i 2e-5 and atte_u/atte_i 1e-3 against the tiled
kernel forced to several column tiles (its online softmax reassociates
the f32 sums, as tests/test_attention_pallas.py allows); 1e-5 against the
whole-tile kernel and for the max residuals; argmax indices exactly;
gradients 1e-3; one train step 1e-5, served predictions 1e-4 (PARITY.md).
Inputs are made with numpy from a seed and scaled so that tanh stays off
saturation (no exact ties), except in the saturated case, where every max
is an exact tie at +-1 and the first index must win in all three."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.ref_oracle import random_batch
from tests.test_torch_model import _models
from tests.test_torch_serve import FakeW2v
from tests.test_checkpoint_loader import small_dataset
from tests.test_torch_train import _flat, _jax_and_port_models
from umpr_tpu.config import Config as JaxConfig
from umpr_tpu.models.review_net import review_net as jax_review_net
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr
from umpr_tpu.ops import attention as jattention
from umpr_tpu.ops import attention_pallas as ap
from umpr_tpu.serve import Predictor as JaxPredictor
from umpr_tpu.train import checkpoint as jckpt
from umpr_tpu.train.optim import make_optimizer as jax_make_optimizer
from umpr_tpu.train.optim import merge_params, split_frozen
from umpr_tpu.train.step import make_train_step
from umpr_tpu_torch import serve
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import params_to_jax
from umpr_tpu_torch.data.loader import to_device
from umpr_tpu_torch.ops import attention, attention_cuda
from umpr_tpu_torch.train.optim import make_optimizer
from umpr_tpu_torch.train.step import train_step

NAMES = ("su", "si", "au", "ai")


def _case(seed, B, P, D=128, frac=0.9, scale=0.005):
    """gru_u, gru_i (B, P, D), M (D, D), exists (P,) bool as numpy; T . U
    has a standard deviation of about 128 * scale * sqrt(D / 128)."""
    rng = np.random.default_rng(seed)
    gu = rng.standard_normal((B, P, D)).astype(np.float32)
    gi = rng.standard_normal((B, P, D)).astype(np.float32)
    M = (rng.standard_normal((D, D)) * scale).astype(np.float32)
    return gu, gi, M, np.arange(P) < int(P * frac)


def _jax(gu, gi, M, e):
    return jnp.asarray(gu), jnp.asarray(gi), jnp.asarray(M), jnp.asarray(e, jnp.float32)


def _torch(gu, gi, M, e):
    return (torch.from_numpy(gu), torch.from_numpy(gi), torch.from_numpy(M),
            torch.from_numpy(e))


def _port_forward(gu, gi, M, e):
    """The kernel path's outputs and residuals (colmax, rowmax, amax_u,
    amax_i), through the wrappers (plain versions on the CPU)."""
    U, I, Mt, et = _torch(gu, gi, M, e)
    B, P, D = U.shape
    T = (I.view(B * P, D) @ Mt).view(B, P, D)
    col_val, col_idx, rowmax, amax_i = attention_cuda.affinity_tiles(T, U, et)
    su, si, au, ai, colmax, amax_u = attention_cuda.affinity_finish(
        col_val, col_idx, rowmax, et, U, I)
    return (su, si, au, ai), (colmax, rowmax, amax_u, amax_i)


def _jax_residuals(res, B, P):
    """(colmax, rowmax, amax_u, amax_i) of a JAX kernel's residual tuple,
    its padding cut."""
    _, _, _, _, _, _, cmu, cmi, amu, ami = res
    return tuple(np.asarray(a)[:B, 0, :P] if a.shape[1] == 1 else np.asarray(a)[:B, :P, 0]
                 for a in (cmu, cmi, amu, ami))


def _check_against(out, res, jout, jres, tols):
    for o, j, name in zip(out, jout, NAMES):
        np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=tols[name],
                                   atol=tols[name], err_msg=name)
    for o, j, name in zip(res[:2], jres[:2], ("colmax", "rowmax")):
        np.testing.assert_allclose(o.numpy(), j, rtol=1e-5, atol=1e-5, err_msg=name)
    for o, j, name in zip(res[2:], jres[2:], ("amax_u", "amax_i")):
        np.testing.assert_array_equal(o.numpy(), j, err_msg=name)


@pytest.mark.parametrize("seed", [7, 8])
def test_kernel_path_matches_jax_tiled_kernel_over_three_column_tiles(monkeypatch, seed):
    monkeypatch.setattr(ap, "_tile_q", lambda P: 512)
    args = _case(seed, B=3, P=1100)
    assert ap._tiled_dims(1100) == (1536, 512)  # really three column tiles
    jout, jres = ap._tiled_fwd_impl(*_jax(*args))
    out, res = _port_forward(*args)
    _check_against(out, res, jout, _jax_residuals(jres, 3, 1100),
                   {"su": 2e-5, "si": 2e-5, "au": 1e-3, "ai": 1e-3})
    # the public router takes the same path above the byte threshold
    monkeypatch.setattr(attention, "TILED_BYTES_THRESHOLD", 1)
    routed = attention.affinity_attention(*_torch(*args))
    for a, b in zip(routed, out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,B,P,frac", [(1, 3, 300, 0.9), (2, 5, 128, 1.0)])
def test_kernel_path_matches_jax_whole_tile_kernel(seed, B, P, frac):
    args = _case(seed, B, P, frac=frac)
    jout, jres = ap._fwd_impl(*_jax(*args))
    out, res = _port_forward(*args)
    _check_against(out, res, jout, _jax_residuals(jres, B, P),
                   dict.fromkeys(NAMES, 1e-5))


def _loss_torch(out):
    su, si, au, ai = out
    return ((au ** 2).sum() + (ai ** 2).sum()
            + (su * torch.arange(su.shape[-1])).sum() + (si ** 2).sum())


def _loss_jax(out):
    su, si, au, ai = out
    return (jnp.sum(au ** 2) + jnp.sum(ai ** 2)
            + jnp.sum(su * jnp.arange(su.shape[-1])) + jnp.sum(si ** 2))


def _port_grads(args, use_pallas=False):
    gu, gi, M, e = (t.clone().requires_grad_(t.dtype == torch.float32)
                    for t in _torch(*args))
    _loss_torch(attention.affinity_attention(gu, gi, M, e, use_pallas)).backward()
    return gu.grad, gi.grad, M.grad


@pytest.mark.parametrize("route", ["tiled", "whole_tile"])
def test_kernel_path_gradients_match_jax_grad(monkeypatch, route):
    if route == "tiled":
        monkeypatch.setattr(ap, "_tile_q", lambda P: 128)
        monkeypatch.setattr(attention, "TILED_BYTES_THRESHOLD", 1)
        args = _case(3, B=2, P=300)  # three column tiles
        fn = ap.affinity_attention_tiled
    else:
        args = _case(4, B=2, P=130)
        fn = ap.affinity_attention_pallas
    gu, gi, M, e = _jax(*args)
    want = jax.grad(lambda *a: _loss_jax(fn(*a, e)), argnums=(0, 1, 2))(gu, gi, M)
    calls = []
    real = attention_cuda.affinity_tiles
    monkeypatch.setattr(attention_cuda, "affinity_tiles",
                        lambda *a: calls.append(1) or real(*a))
    got = _port_grads(args, use_pallas=route == "whole_tile")
    assert calls == [1]
    for g, w, name in zip(got, want, ("dgu", "dgi", "dM")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-3,
                                   err_msg=name)


def test_kernel_path_matches_the_composite_in_value_and_gradient():
    """Off saturation the two paths are one function: values at f32
    rounding, gradients (first-argmax routing against amax's) at 1e-4."""
    args = _case(5, B=2, P=150, D=32, frac=0.8, scale=0.02)
    with torch.no_grad():
        a = attention.AffinityAttention.apply(*_torch(*args))
        b = attention.affinity_attention_composite(*_torch(*args))
    for x, y, name in zip(a, b, NAMES):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6, msg=name)
    got = _port_grads(args, use_pallas=False)  # D=32: the composite
    gu, gi, M, e = (t.clone().requires_grad_(t.dtype == torch.float32)
                    for t in _torch(*args))
    _loss_torch(attention.AffinityAttention.apply(gu, gi, M, e)).backward()
    for x, y, name in zip((gu.grad, gi.grad, M.grad), got, ("dgu", "dgi", "dM")):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4, msg=name)


def test_saturated_ties_take_the_first_index_in_all_three(monkeypatch):
    """M scaled so that tanh is exactly +-1 almost everywhere: every max is
    a tie, and the port, B10 and B9 (over three tiles) all keep the first
    existing index reaching it."""
    B, P = 2, 300
    args = _case(6, B, P, frac=0.9, scale=10.0)
    out, res = _port_forward(*args)
    colmax, rowmax, amax_u, amax_i = res
    assert (colmax == 1.0).float().mean() > 0.99 and (rowmax == 1.0).float().mean() > 0.99
    # the first existing index at +1, from the plain A
    U, I, Mt, e = _torch(*args)
    A = torch.tanh((I @ Mt) @ U.transpose(1, 2))
    first_u = torch.where(e[None, :, None] & (A == 1.0), torch.arange(P)[None, :, None],
                          P).amin(1)
    first_i = torch.where(e[None, None, :] & (A == 1.0), torch.arange(P)[None, None, :],
                          P).amin(2)
    assert torch.equal(amax_u.long(), first_u) and torch.equal(amax_i.long(), first_i)
    jout, jres = ap._fwd_impl(*_jax(*args))
    _check_against(out, res, jout, _jax_residuals(jres, B, P), dict.fromkeys(NAMES, 1e-5))
    monkeypatch.setattr(ap, "_tile_q", lambda P: 128)
    jout, jres = ap._tiled_fwd_impl(*_jax(*args))
    _check_against(out, res, jout, _jax_residuals(jres, B, P),
                   {"su": 2e-5, "si": 2e-5, "au": 1e-3, "ai": 1e-3})


def test_threshold_routes_both_packages_to_their_kernels(monkeypatch):
    seen = []
    real_tiled = ap.affinity_attention_tiled
    monkeypatch.setattr(ap, "affinity_attention_tiled",
                        lambda *a: seen.append("jax") or real_tiled(*a))
    real_tiles = attention_cuda.affinity_tiles
    monkeypatch.setattr(attention_cuda, "affinity_tiles",
                        lambda *a: seen.append("port") or real_tiles(*a))
    monkeypatch.setattr(jattention, "TILED_BYTES_THRESHOLD", 1)
    monkeypatch.setattr(attention, "TILED_BYTES_THRESHOLD", 1)
    args = _case(9, B=2, P=200, frac=0.75)
    jout = jattention.affinity_attention(*_jax(*args))
    out = attention.affinity_attention(*_torch(*args))
    assert seen == ["jax", "port"]
    for o, j, name in zip(out, jout, NAMES):
        np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("B,P,D", [(2, 50, 16), (2, 300, 100), (1, 1100, 128)])
def test_use_pallas_takes_the_composite_where_the_jax_package_does(monkeypatch, B, P, D):
    """D % 128 != 0, or P past B10's 1024: both packages take the composite."""
    seen = []
    monkeypatch.setattr(ap, "affinity_attention_pallas",
                        lambda *a: seen.append("jax") or None)
    monkeypatch.setattr(attention, "AffinityAttention",
                        type("Spy", (), {"apply": staticmethod(
                            lambda *a: seen.append("port"))}))
    args = _case(10, B, P, D=D)
    jout = jattention.affinity_attention(*_jax(*args), use_pallas=True)
    out = attention.affinity_attention(*_torch(*args), use_pallas=True)
    assert not seen
    ref = attention.affinity_attention_composite(*_torch(*args))
    for o, r, j in zip(out, ref, jout):
        assert torch.equal(o, r)
        np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [100, 128, 256])
def test_p_ceiling_raises_in_both_packages_before_any_work(monkeypatch, D):
    """Past the JAX tiled kernel's ceiling both packages raise, the port
    before it computes or allocates anything (meta tensors, and neither
    path is entered); at the ceiling the port goes on to the kernels."""
    ceiling, B = attention.max_tiled_p(D), 8  # B * P^2 * 4 > 4 GiB
    with pytest.raises(NotImplementedError, match="ceiling") as err:
        jattention.affinity_attention(jnp.zeros((B, ceiling + 128, D)),
                                      jnp.zeros((B, ceiling + 128, D)),
                                      jnp.zeros((D, D)), jnp.ones((ceiling + 128,)))
    assert int(re.search(r"~(\d+)", str(err.value)).group(1)) == ceiling

    def boom(*a):
        raise AssertionError("entered a path")
    monkeypatch.setattr(attention, "AffinityAttention", type("Spy", (), {"apply": boom}))
    monkeypatch.setattr(attention, "affinity_attention_composite", boom)
    meta = dict(device="meta")
    for P in (ceiling + 128, 40960):
        with pytest.raises(NotImplementedError, match="ceiling"):
            attention.affinity_attention(torch.empty(B, P, D, **meta),
                                         torch.empty(B, P, D, **meta),
                                         torch.empty(D, D, **meta),
                                         torch.ones(P, dtype=torch.bool, **meta))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="unsupported device"):
        attention.affinity_attention(torch.empty(B, ceiling, D, **meta),
                                     torch.empty(B, ceiling, D, **meta),
                                     torch.empty(D, D, **meta),
                                     torch.ones(ceiling, dtype=torch.bool, **meta))


def test_review_net_attention_pallas_matches_jax(monkeypatch):
    """ReviewNet(attention_pallas=True) reaches the kernel path on B10's
    shapes, as the JAX review_net reaches B10; UMPR.forward passes none."""
    jparams, jdims, model = _models(seed=6)
    batch = random_batch(np.random.default_rng(8), B=3, S=3, L=8, S_ui=2,
                         vocab=40, emb=16, max_count=2, max_len=7)
    emb = np.asarray(jparams["embedding"])
    both = np.concatenate([batch["u_tokens"], batch["i_tokens"]])
    exists = np.zeros((3, 8), bool)
    exists[:2, :7] = True
    calls = []
    real = attention_cuda.affinity_tiles
    monkeypatch.setattr(attention_cuda, "affinity_tiles",
                        lambda *a: calls.append(1) or real(*a))
    want = jax_review_net(jparams["review_net"], jnp.asarray(emb[both]),
                          jnp.asarray(batch["u_lengths"]), jnp.asarray(batch["i_lengths"]),
                          jnp.asarray(exists), use_pallas=False, attention_pallas=True)
    args = (torch.from_numpy(emb[both]), torch.from_numpy(batch["u_lengths"]),
            torch.from_numpy(batch["i_lengths"]), torch.from_numpy(exists))
    with torch.no_grad():
        got = model.review_net(*args, attention_pallas=True)
        assert calls == [1]
        plain = model.review_net(*args)
        model(to_device(batch, "cpu"))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


def test_train_step_on_the_tiled_route_matches_jax(monkeypatch):
    """Both thresholds at 1: the JAX train step runs B9 and its
    argmax-routed backward, the port K7/K8's plain versions and its own."""
    monkeypatch.setattr(jattention, "TILED_BYTES_THRESHOLD", 1)
    monkeypatch.setattr(attention, "TILED_BYTES_THRESHOLD", 1)
    calls = []
    real = attention_cuda.affinity_tiles
    monkeypatch.setattr(attention_cuda, "affinity_tiles",
                        lambda *a: calls.append(1) or real(*a))
    jparams, jdims, model = _jax_and_port_models(seed=4)
    batch = random_batch(np.random.default_rng(12), B=2, S=3, L=7, S_ui=2,
                         vocab=40, emb=16, max_len=7)
    tx = jax_make_optimizer(1e-3)
    trainable, frozen = split_frozen(jparams)
    jtrained, _, jloss, _ = make_train_step(jdims, tx, donate=False)(
        trainable, frozen, tx.init(trainable),
        {k: jnp.asarray(v) for k, v in batch.items()}, 1e-3, None)
    loss, _ = train_step(model, make_optimizer(model, 1e-3, 1e-3),
                         to_device(batch, "cpu"), 1e-3)
    assert calls == [1]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    want = _flat(merge_params(jax.device_get(jtrained), frozen))
    got = _flat(params_to_jax(model.state_dict()))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_predictor_on_the_tiled_route_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(jattention, "TILED_BYTES_THRESHOLD", 1)
    monkeypatch.setattr(attention, "TILED_BYTES_THRESHOLD", 1)
    calls = []
    real = attention_cuda.affinity_tiles
    monkeypatch.setattr(attention_cuda, "affinity_tiles",
                        lambda *a: calls.append(1) or real(*a))
    flags = ["--device", "cpu", "--review_net_only", "True", "--batch_size", "8",
             "--gru_size", "8", "--self_atte_size", "8"]
    emb = np.random.default_rng(0).standard_normal((25, 8)).astype(np.float32)
    jcfg = JaxConfig(argv=flags)
    root = str(tmp_path / "m")
    jckpt.save_best(root, init_umpr(jax.random.PRNGKey(3), JaxDims.from_config(jcfg), emb))
    ds = small_dataset(n=10)
    jpreds, jrows = JaxPredictor(jcfg, FakeW2v(emb), root).predict_dataset(ds)
    preds, rows = serve.Predictor(Config(flags), FakeW2v(np.zeros_like(emb)),
                                  root).predict_dataset(ds)
    assert len(calls) == 2  # two B=8 batches
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_allclose(preds, jpreds, rtol=1e-4, atol=1e-4)
