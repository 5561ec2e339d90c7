"""The orders of work of K8 ``affinity_finish`` and K2 ``bigru_recurrence``
on the CPU, through their plain versions, against the one-pass plain
versions and the JAX package.

- K8 splits a sample's P positions over a cluster of blocks; its plain
  version ``affinity_finish_cluster_ref`` takes C chunks, folds the
  chunks' maxima, sums and column sums in chunk order.  At C = 1, 3 and 8
  (the kernel's), P = 1, 5 and 300 (chunks with no position at P < C), on
  random, all-masked, saturated (exact ties) and NaN inputs, it is held
  against ``affinity_finish_ref`` and the JAX column-tiled kernel B9
  (interpreted, as tests/test_torch_attention.py runs it): soft and atte
  within 1e-5 of each output's largest entry (f32 sums in another order),
  NaN at the same places, amax_u exactly (where every position is masked
  the JAX kernel marks it with a sentinel, the port with torch.argmax's
  index 0; on saturated inputs it is held to the first row reaching the
  maximum in the port's own A, as torch's and XLA's tanh may round an
  entry at the saturation edge differently).
- K2 walks 16-row tiles of the rows ordered by length; its plain versions
  ``bigru_row_order_ref`` and ``bigru_recurrence_tiles_ref`` (each tile's
  loop to its longest row) are held against ``bigru_recurrence_ref`` and
  the JAX package's ``bigru_split`` forward (its Pallas GRU interpreted at
  H = 64, its scan at the other widths) at H = 8, 64 and 100, within
  1e-5 (PARITY.md, masked GRU), for the sorted order and for other orders
  within each length, as the kernel's atomics give them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_attention import _jax_residuals
from umpr_tpu.ops import attention_pallas as ap
from umpr_tpu.ops.gru import bigru_split as jax_bigru_split
from umpr_tpu.ops.gru import init_bigru
from umpr_tpu_torch.convert import params_from_jax
from umpr_tpu_torch.ops import attention_cuda, gru_cuda
from umpr_tpu_torch.ops.gru import BiGRU

TOL = 1e-5

# ---- K8: the cluster's chunks


def _attention_case(P, kind, B=2, D=16):
    """gru_u, gru_i (B, P, D), M (D, D), exists (P,) as numpy, seeded.
    kind: "rand" (90% existing), "none" (every position masked), "tie"
    (tanh exactly +-1 nearly everywhere), "nan" (a NaN in an existing row
    of I in a middle chunk, one in a masked row of U)."""
    rng = np.random.default_rng(P * 10 + len(kind))
    gu = rng.standard_normal((B, P, D)).astype(np.float32)
    gi = rng.standard_normal((B, P, D)).astype(np.float32)
    M = (rng.standard_normal((D, D)) * (100.0 if kind == "tie" else 0.05)).astype(np.float32)
    e = np.arange(P) < max(1, int(P * 0.9))
    if kind == "none":
        e[:] = False
    elif kind == "nan":
        gi[0, P // 2, 0] = np.nan
        gu[-1, P - 1, 0] = np.nan
        e[P - 1] = P == 1  # a masked row, unless it is the only one
    return gu, gi, M, e


@functools.lru_cache(maxsize=None)
def _jax_tiled(P, kind):
    """The JAX tiled kernel's (su, si, au, ai) and amax_u."""
    gu, gi, M, e = _attention_case(P, kind)
    out, res = ap._tiled_fwd_impl(jnp.asarray(gu), jnp.asarray(gi), jnp.asarray(M),
                                  jnp.asarray(e, jnp.float32))
    return tuple(np.asarray(o) for o in out), _jax_residuals(res, gu.shape[0], P)[2]


def _close_scaled(got, want, name):
    """Within TOL of the largest entry of `want`, NaN at the same places."""
    got, want = np.asarray(got), np.asarray(want)
    assert (np.isnan(got) == np.isnan(want)).all(), name
    scale = max(np.nanmax(np.abs(want), initial=0.0), 1e-30) if np.isfinite(want).any() else 1.0
    diff = np.abs(np.nan_to_num(got) - np.nan_to_num(want))
    assert diff.max(initial=0.0) <= TOL * scale, (name, diff.max())


@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("P", [1, 5, 300])
@pytest.mark.parametrize("kind", ["rand", "none", "tie", "nan"])
def test_affinity_finish_cluster_order_matches_plain_and_jax(kind, P, C):
    gu, gi, M, e = _attention_case(P, kind)
    U, I, Mt, et = (torch.from_numpy(a) for a in (gu, gi, M, e))
    T = I @ Mt
    col_val, col_idx, row_val, _ = attention_cuda.affinity_tiles_ref(T, U, et)
    got = attention_cuda.affinity_finish_cluster_ref(col_val, col_idx, row_val, et, U, I, C=C)
    want = attention_cuda.affinity_finish_ref(col_val, col_idx, row_val, et, U, I)
    jout, jamax_u = _jax_tiled(P, kind)
    for name, g, w, j in zip(("soft_u", "soft_i", "atte_u", "atte_i"), got, want, jout):
        _close_scaled(g, w, name)
        _close_scaled(g, j, name + " (JAX)")
    torch.testing.assert_close(got[4], want[4], rtol=0, atol=0, equal_nan=True)  # colmax
    assert torch.equal(got[5], want[5])
    if kind == "none":  # 0 / 0: every output NaN, as in both references
        assert all(g.isnan().all() for g in got[:4])
        assert (got[5] == 0).all()  # torch.argmax's first index (JAX: a sentinel)
    elif kind == "tie":
        # every max an exact tie at +-1: the first existing row reaching it
        # in A (where an entry lies at tanh's saturation edge, torch's and
        # XLA's tanh may round it to 1 or not, so A is the port's own)
        A = torch.where(et[None, :, None], torch.tanh(T @ U.transpose(1, 2)), -1e30)
        assert (got[4].abs() == 1.0).float().mean() > 0.9
        assert torch.equal(got[5], (A == got[4][:, None, :]).int().argmax(1).int())
    else:
        np.testing.assert_array_equal(got[5].numpy(), jamax_u)


# ---- K2: the rows by length, in 16-row tiles


def _lengths(rng, N, L, kind):
    lengths = rng.integers(1, L + 1, size=N).astype(np.int32)
    if kind == "all_1":
        lengths[:] = 1
    elif kind == "all_L":
        lengths[:] = L
    else:
        lengths[0], lengths[1], lengths[-1] = L, L, 1  # adjacent full rows
    return lengths


def _gru_setup(H, kind, B=5, S=7, L=6, E=6):
    """35 rows (two full 16-row tiles and a ragged one) of a seeded
    BiGRU, the JAX parameters and the port's, seeded with numpy."""
    rng = np.random.default_rng(H * 3 + len(kind))
    N = B * S
    x = rng.standard_normal((N, L, E)).astype(np.float32)
    lengths = _lengths(rng, N, L, kind)
    jparams = jax.tree.map(np.asarray, init_bigru(jax.random.PRNGKey(H), E, H))
    gru = BiGRU(E, H)
    gru.load_state_dict({k[len("gru."):]: v
                         for k, v in params_from_jax({"gru": jparams}).items()})
    w_ih, b_ih, w_hh, b_hh = (t.detach() for t in gru.kernel_operands())
    xg = gru_cuda.gru_input_proj_ref(torch.from_numpy(x).view(N * L, E), w_ih, b_ih)
    return jparams, x, torch.from_numpy(lengths), S, xg.view(N, L, 6 * H), w_hh, b_hh


def _shuffled_within_lengths(order, lengths, seed):
    """Another order the kernel's counting sort may give: the same lengths
    in the same places, the rows of each length permuted."""
    rng = np.random.default_rng(seed)
    order = order.numpy().copy()
    key = lengths.numpy()[order]
    for length in np.unique(key):
        at = np.flatnonzero(key == length)
        order[at] = rng.permutation(order[at])
    return torch.from_numpy(order)


@pytest.mark.parametrize("kind", ["mixed", "all_1", "all_L"])
def test_row_order_is_a_permutation_longest_first(kind):
    rng = np.random.default_rng(len(kind))
    L = 9
    lengths = torch.from_numpy(_lengths(rng, 53, L, kind))
    lengths[5] = L + 4  # clamped to L, as the kernels do
    order = gru_cuda.bigru_row_order_ref(lengths, L)
    assert order.dtype == torch.int32
    assert torch.equal(order.sort().values, torch.arange(53, dtype=torch.int32))
    key = lengths.clamp(0, L)[order.long()]
    assert (key[:-1] >= key[1:]).all()


@pytest.mark.parametrize("kind", ["mixed", "all_1", "all_L"])
@pytest.mark.parametrize("H", [8, 64, 100])
def test_tile_walk_matches_plain_and_jax(H, kind):
    jparams, x, lengths, S, xg, w_hh, b_hh = _gru_setup(H, kind)
    L = xg.shape[1]
    want = gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh)
    _, jsent = jax_bigru_split(jparams, jnp.asarray(x), jnp.asarray(lengths.numpy()), S,
                               use_pallas=True)
    order = gru_cuda.bigru_row_order_ref(lengths, L)
    for o in (order, _shuffled_within_lengths(order, lengths, H)):
        y = gru_cuda.bigru_recurrence_tiles_ref(xg, lengths, w_hh, b_hh, o)
        torch.testing.assert_close(y, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(jsent), rtol=TOL, atol=TOL)
        past = torch.arange(L)[None, :] >= lengths[:, None]
        assert (y[past] == 0).all()
