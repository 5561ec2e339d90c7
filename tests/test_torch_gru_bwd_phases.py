"""K3's three parts on the CPU: the plain versions of its hg pass, sweep
and dW pass (``bigru_backward_hg_ref``, ``bigru_backward_sweep_ref``,
``bigru_backward_dw_ref``) composed, against the one-loop plain version
``bigru_backward_ref`` and against the JAX package's backward (its Pallas
GRU at H = 64, run interpreted as tests/test_torch_gru.py runs it; its
scan route at the other H).  Widths 8, 32, 64 and 100; lengths mixed, all
1 and all L; N not a multiple of K3's 16-row tiles.  Tolerance 1e-5
(PARITY.md: masked GRU, its gradients).

The bf16 sweep up to H = 128 has no hg pass: its plain version is the
sweep's ``z=None`` form, hg computed in the step from y's bf16 value.
That form and the dW pass, in f32 and in bf16 (widths 8, 64, 100), against
``bigru_backward_ref`` and against the JAX package's backward (f32 as
above; bf16 its Pallas GRU, ``bigru_pallas_split_nodx``, interpreted at
every width).  bf16 tolerances are tests/test_torch_bf16.py's: dxg
l2-relative 1e-2, dW_hh and db_hh 1e-4 against the plain backward;
gradients against JAX l2-relative 5e-2 per leaf whose norm exceeds
1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umpr_tpu.ops.gru import bigru_split as jax_bigru_split
from umpr_tpu.ops.gru import init_bigru
from umpr_tpu.ops.gru_pallas import bigru_pallas_split_nodx
from umpr_tpu_torch.convert import params_from_jax, params_to_jax
from umpr_tpu_torch.ops import gru_cuda
from umpr_tpu_torch.ops.gru import BiGRU, BiGRUSplit, bigru_split

TOL = dict(rtol=1e-5, atol=1e-5)
WIDTHS = (8, 32, 64, 100)
KINDS = ("mixed", "all_1", "all_L")
FUSED_WIDTHS = (8, 64, 100)
DTYPES = ("float32", "bfloat16")
BF16 = torch.bfloat16


def _lengths(rng, N, L, kind):
    lengths = rng.integers(1, L + 1, size=N).astype(np.int32)
    if kind == "all_1":
        lengths[:] = 1
    elif kind == "all_L":
        lengths[:] = L
    else:
        lengths[0], lengths[1], lengths[-1] = L, L, 1  # adjacent full rows
    return lengths


def _operands(H, kind, N=21, L=7, E=5, seed=0):
    """K3's inputs from the plain forward: N = 21 sentence rows (one full
    16-row tile and a ragged one), seeded with numpy."""
    rng = np.random.default_rng(seed + H)
    t = lambda *shape, s=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(shape) * s).astype(np.float32))
    lengths = torch.from_numpy(_lengths(rng, N, L, kind))
    w_ih, b_ih = t(E, 6 * H, s=H ** -0.5), t(6 * H, s=H ** -0.5)
    w_hh, b_hh = t(2, H, 3 * H, s=H ** -0.5), t(2, 3 * H, s=H ** -0.5)
    xg = gru_cuda.gru_input_proj_ref(t(N * L, E), w_ih, b_ih).view(N, L, 6 * H)
    y = gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh)
    return xg, y, t(N, L, 2 * H), t(N, L, 2 * H), lengths, w_hh, b_hh


def _composed(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh):
    """K3 as its three parts run it: Z, then the sweep, then dW."""
    z = gru_cuda.bigru_backward_hg_ref(y, w_hh)
    dxg, ghn = gru_cuda.bigru_backward_sweep_ref(xg, y, z, dy_sent, dy_pos, lengths,
                                                 w_hh, b_hh)
    dw_hh, db_hh = gru_cuda.bigru_backward_dw_ref(y, dxg, ghn)
    return dxg, dw_hh, db_hh, ghn


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("H", WIDTHS)
def test_parts_compose_to_the_plain_backward(H, kind):
    xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh = _operands(H, kind)
    dxg, dw_hh, db_hh, ghn = _composed(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    want = gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    torch.testing.assert_close(dxg, want[0], **TOL)
    torch.testing.assert_close(dw_hh, want[1], **TOL)
    torch.testing.assert_close(db_hh, want[2], **TOL)
    L = xg.shape[1]
    past = torch.arange(L)[None, :] >= lengths[:, None]
    assert (dxg[past] == 0).all() and (ghn[past] == 0).all()
    # the hg pass: each direction's half of y through its own W_hh
    z = gru_cuda.bigru_backward_hg_ref(y, w_hh)
    torch.testing.assert_close(z[..., 3 * H:], y[..., H:] @ w_hh[1], **TOL)
    torch.testing.assert_close(z[..., :3 * H], y[..., :H] @ w_hh[0], **TOL)


@pytest.mark.parametrize("H", WIDTHS)
def test_dw_pass_masks_h_prev_at_each_directions_first_step(H):
    """Rows 0 and 1 both have length L: the fwd's shifted h_prev of row 1's
    t = 0 would be row 0's y_f[L-1], and the bwd's of row 0's t = L-1 row
    1's y_b[0], both nonzero.  The dW pass masks them; unmasked, its sums
    would miss the plain version by far more than the tolerance."""
    xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh = _operands(H, "mixed")
    N, L, _ = xg.shape
    assert lengths[0] == lengths[1] == L
    _, dw_hh, db_hh, ghn = _composed(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    want = gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    torch.testing.assert_close(dw_hh, want[1], **TOL)
    torch.testing.assert_close(db_hh, want[2], **TOL)
    dxg = want[0]
    # what the masked rows would add: fwd (row n, t = 0) meets y_f of row
    # n - 1 at t = L - 1; bwd (row n, t = L - 1) meets y_b of row n + 1 at 0
    ghh_f = torch.cat([dxg[1:, 0, :2 * H], ghn[1:, 0, :H]], 1)
    ghh_b = torch.cat([dxg[:-1, L - 1, 3 * H:5 * H], ghn[:-1, L - 1, H:]], 1)
    leak_f = y[:-1, L - 1, :H].t() @ ghh_f
    leak_b = y[1:, 0, H:].t() @ ghh_b
    scale = want[1].abs().max()
    assert leak_f.abs().max() > 100 * TOL["atol"] * scale
    assert leak_b.abs().max() > 100 * TOL["atol"] * scale


def _jax_setup(H, kind, B=3, S=7, L=5, E=6):
    rng = np.random.default_rng(H + len(kind))
    N = B * S  # 21 rows: not a multiple of 16
    x = rng.standard_normal((N, L, E)).astype(np.float32)
    lengths = _lengths(rng, N, L, kind)
    jparams = jax.tree.map(np.asarray, init_bigru(jax.random.PRNGKey(H), E, H))
    gru = BiGRU(E, H)
    gru.load_state_dict({k[len("gru."):]: v
                         for k, v in params_from_jax({"gru": jparams}).items()})
    c_pos = rng.standard_normal((N // S, S * L, 2 * H)).astype(np.float32)
    c_sent = rng.standard_normal((N, L, 2 * H)).astype(np.float32)
    return jparams, gru, x, lengths, S, c_pos, c_sent


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("H", WIDTHS)
def test_parts_in_bigru_split_match_jax_grad(H, kind, monkeypatch):
    """``bigru_split``'s backward with K3 replaced by its three parts gives
    the JAX package's gradients of every weight and of x."""
    jparams, gru, x, lengths, S, c_pos, c_sent = _jax_setup(H, kind)

    def loss(p, xj):
        pos, sent = jax_bigru_split(p, xj, jnp.asarray(lengths), S,
                                    use_pallas=True, need_dx=True)
        return jnp.sum(pos * c_pos) + jnp.sum(sent * c_sent)

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
    monkeypatch.setattr(gru_cuda, "bigru_backward", lambda *a: _composed(*a)[:3])
    xt = torch.from_numpy(x).requires_grad_()
    pos, sent = bigru_split(gru, xt, torch.from_numpy(lengths), S)
    ((pos * torch.from_numpy(c_pos)).sum()
     + (sent * torch.from_numpy(c_sent)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL)
    got = params_to_jax({f"gru.{n}": p.grad for n, p in gru.named_parameters()})["gru"]
    for d in ("fwd", "bwd"):
        for k in ("w_ih", "w_hh", "bias_ih", "bias_hh"):
            np.testing.assert_allclose(got[d][k], np.asarray(want_p[d][k]), **TOL,
                                       err_msg=f"{d}.{k}")


# ---- the bf16 sweep's form without Z (hg in the step)

def _fused(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh):
    """K3 as its bf16 route up to H = 128 runs it: the sweep computing hg
    in the step (``z=None``), then the dW pass on its unrounded f32
    outputs; dxg rounded to the IO type on store."""
    dxg, ghn = gru_cuda.bigru_backward_sweep_ref(xg, y, None, dy_sent, dy_pos, lengths,
                                                 w_hh, b_hh)
    dw_hh, db_hh = gru_cuda.bigru_backward_dw_ref(y, dxg, ghn)
    return dxg.to(xg.dtype), dw_hh, db_hh, ghn


def _l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("H", FUSED_WIDTHS)
def test_fused_sweep_composes_to_the_plain_backward(H, kind, dtype):
    xg, _, dy_sent, dy_pos, lengths, w_hh, b_hh = _operands(H, kind)
    if dtype == "bfloat16":
        xg, dy_sent, dy_pos, w_hh, b_hh = (t.to(BF16) for t in (xg, dy_sent, dy_pos, w_hh, b_hh))
    y = gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh)
    dxg, dw_hh, db_hh, ghn = _fused(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    want = gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    assert dxg.dtype == want[0].dtype == xg.dtype
    if dtype == "float32":
        torch.testing.assert_close(dxg, want[0], **TOL)
        torch.testing.assert_close(dw_hh, want[1], **TOL)
        torch.testing.assert_close(db_hh, want[2], **TOL)
    else:
        assert _l2(dxg.float(), want[0].float()) <= 1e-2
        torch.testing.assert_close(dw_hh, want[1], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(db_hh, want[2], rtol=1e-4, atol=1e-4)
    past = torch.arange(xg.shape[1])[None, :] >= lengths[:, None]
    assert (dxg[past] == 0).all() and (ghn[past] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("H", FUSED_WIDTHS)
def test_fused_sweep_in_bigru_split_matches_jax_grad(H, kind, dtype, monkeypatch):
    """The GRU node's backward with K3 replaced by the sweep without Z and
    the dW pass gives the JAX package's gradients: in f32 those of
    ``bigru_split`` (and of x), at 1e-5; in bf16 those of its Pallas GRU
    (bf16 x and operands, f32 parameters), through the kernels' node
    ``BiGRUSplit`` at every H (``bigru_split`` takes the scan at H % 64 !=
    0 in bf16, where no K3 runs)."""
    jparams, gru, x, lengths, S, c_pos, c_sent = _jax_setup(H, kind)
    monkeypatch.setattr(gru_cuda, "bigru_backward", lambda *a: _fused(*a)[:3])
    if dtype == "float32":
        def loss(p, xj):
            pos, sent = jax_bigru_split(p, xj, jnp.asarray(lengths), S,
                                        use_pallas=True, need_dx=True)
            return jnp.sum(pos * c_pos) + jnp.sum(sent * c_sent)

        want_p, want_x = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        pos, sent = bigru_split(gru, xt, torch.from_numpy(lengths), S)
    else:
        xb = jnp.asarray(x, jnp.bfloat16)

        def loss(p):
            pos, sent = bigru_pallas_split_nodx(p, xb, jnp.asarray(lengths), S)
            return (jnp.sum(pos.astype(jnp.float32) * c_pos)
                    + jnp.sum(sent.astype(jnp.float32) * c_sent))

        want_p = jax.grad(loss)(jparams)
        xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(BF16)
        ops = tuple(t.to(BF16) for t in gru.kernel_operands())
        pos, sent = BiGRUSplit.apply(xt, torch.from_numpy(lengths), S, *ops)
    ((pos.float() * torch.from_numpy(c_pos)).sum()
     + (sent.float() * torch.from_numpy(c_sent)).sum()).backward()
    got = params_to_jax({f"gru.{n}": p.grad for n, p in gru.named_parameters()})["gru"]
    checked = 0
    for d in ("fwd", "bwd"):
        for k in ("w_ih", "w_hh", "bias_ih", "bias_hh"):
            want = np.asarray(want_p[d][k])
            if dtype == "float32":
                np.testing.assert_allclose(got[d][k], want, **TOL, err_msg=f"{d}.{k}")
            elif np.linalg.norm(want) > 1e-3:
                assert _l2(got[d][k], want) <= 5e-2, (d, k, _l2(got[d][k], want))
                checked += 1
    if dtype == "float32":
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL)
    else:
        assert checked
