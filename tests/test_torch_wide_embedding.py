"""Wide embeddings (E > 64: GloVe 100/200/300-d, word2vec's 300) in the
port against the JAX package on the CPU, in f32 and bf16.

In f32 the JAX package takes ``_build_xg`` past E = 64 on both
``use_pallas`` routes (the Pallas recurrence or the scan after it), and
the port's K1 plain version (K1's yardstick on the card) is one f32
product plus the bias; the tests at E = 100, 200 and 300 hold the projection,
``bigru_split``'s outputs and its weight gradients to the JAX package
within 1e-5 (PARITY.md, masked GRU).

The JAX package projects x through its Pallas kernels only while 2E fits
one 128-lane tile (umpr_tpu/ops/gru_pallas.py:95, :132).  Past E = 64 its
bf16 xg comes from ``_build_xg`` (:556-573): bf16 x @ w rounded to bf16,
then the bias added and the sum rounded again.  The port's K1 plain
version (K1's yardstick on the card) rounds the same way on each side of
E = 64 (``gru_cuda.PROJ_ROUND_ONCE_MAX_E``).  The wide route's backward
(:893-897) rounds dx as K9 does: each direction's product, then a bf16
add.  Each test here that compares past E = 64 failed on the plain
version that rounded once at every E (27-29% of xg values differed, and
y by 2.4e-3 of its l2 norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16 import _l2, _projection_case, _within_one_ulp
from tests.test_torch_gru import TOL, _cotangents, _port_param_grads, _setup
from umpr_tpu.ops import gru_pallas as gp
from umpr_tpu.ops.gru import bigru_split as jax_bigru_split
from umpr_tpu.ops.gru import init_bigru
from umpr_tpu_torch.convert import params_from_jax
from umpr_tpu_torch.ops import gru_cuda
from umpr_tpu_torch.ops.gru import BiGRU, bigru_split

H = 64
BF16 = torch.bfloat16


F32_WIDE_E = [100, 200, 300]  # GloVe 100-d, GloVe 200-d, GloVe / word2vec 300-d


@pytest.mark.parametrize("E", F32_WIDE_E)
def test_f32_projection_plain_version_matches_build_xg(E):
    """gru_input_proj_ref in f32 against the JAX package's _build_xg on the
    same x and weights (de-interleaved, the bwd half flipped back to true
    time): one f32 product plus the bias on each side, within 1e-5."""
    jparams, gru, x, _, _ = _setup(0, E=E)
    N, L, _ = x.shape
    w_ih, b_ih, _, _ = (t.detach() for t in gru.kernel_operands())
    got = gru_cuda.gru_input_proj_ref(torch.from_numpy(x).reshape(N * L, E), w_ih, b_ih)
    assert got.dtype == torch.float32
    f, b = gp._deinterleave(gp._build_xg(jparams, jnp.asarray(x), H).reshape(N, L, 6 * H), H)
    want = np.concatenate([np.asarray(f), np.asarray(b)[:, ::-1]], -1)
    np.testing.assert_allclose(got.numpy().reshape(N, L, 6 * H), want, **TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("E", F32_WIDE_E)
def test_f32_bigru_split_at_wide_e_matches_jax(E, use_pallas):
    """bigru_split in f32 (K1-K4's plain versions) against the JAX
    bigru_split on either route: y_pos and y_sent, then the gradients of
    sum(y_pos * c_pos) + sum(y_sent * c_sent) with respect to every GRU
    weight, within 1e-5."""
    jparams, gru, x, lengths, S = _setup(E, E=E)
    c_pos, c_sent = _cotangents(E, *x.shape[:2], S)
    jpos, jsent = jax_bigru_split(jparams, jnp.asarray(x), jnp.asarray(lengths), S,
                                  use_pallas=use_pallas)
    with torch.no_grad():
        pos, sent = bigru_split(gru, torch.from_numpy(x), torch.from_numpy(lengths), S)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), **TOL)
    np.testing.assert_allclose(sent.numpy(), np.asarray(jsent), **TOL)

    def loss(p):
        pos, sent = jax_bigru_split(p, jnp.asarray(x), jnp.asarray(lengths), S,
                                    use_pallas=use_pallas)
        return jnp.sum(pos * c_pos) + jnp.sum(sent * c_sent)

    want = jax.grad(loss)(jparams)
    got = _port_param_grads(gru, x, lengths, S, c_pos, c_sent)
    for d in ("fwd", "bwd"):
        for k in ("w_ih", "w_hh", "bias_ih", "bias_hh"):
            np.testing.assert_allclose(got[d][k], np.asarray(want[d][k]), **TOL,
                                       err_msg=f"{d}.{k}")


def _ulp(v):
    """One bf16 ulp of each |value| (f32 array)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -120))) - 7)


def _bf16_np(t):
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jax.Array) else t.float().numpy()


@pytest.mark.parametrize("E", [65, 100, 300])
def test_bf16_projection_plain_version_matches_build_xg(E):
    """gru_input_proj_ref in bf16 past E = 64 against the JAX package's
    _build_xg on the same bf16 x and weights (de-interleaved, the bwd half
    flipped back to true time).  Both round the f32 product, add the bias
    and round again; the products' f32 sums may run in another order, so
    each value is held within one ulp of the rounded product plus one ulp
    of the result, and at most 1% of the values may differ at all (on the
    CPU where this was written the two agreed bit for bit)."""
    _, x, p, xt, w_ih, b_ih = _projection_case(0, N=6, PL=5, PE=E)
    N, PL, _ = x.shape
    got = gru_cuda.gru_input_proj_ref(xt, w_ih, b_ih)
    assert got.dtype == BF16
    got = got.float().numpy().reshape(N, PL, 6 * H)
    f, b = gp._deinterleave(gp._build_xg(p, x, H).reshape(N, PL, 6 * H).astype(jnp.float32), H)
    want = np.concatenate([np.asarray(f), np.asarray(b)[:, ::-1]], -1)
    product = (xt.float() @ w_ih.float()).to(BF16).float().numpy().reshape(N, PL, 6 * H)
    err = np.abs(got - want)
    assert (err <= _ulp(product) + _ulp(want)).all(), err.max()
    assert (err > 0).mean() <= 0.01, (err > 0).mean()


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_projection_plain_version_at_e64_matches_the_jax_kernels(seed):
    """At E = 64, the widest embedding the JAX Pallas projection takes
    (2E = 128 lanes), the plain version still rounds once, as the kernels
    B5 _pallas_stack_pad + B3 _pallas_project_fwd do: within one bf16
    ulp of their xg (summed in another order)."""
    _, x, p, xt, w_ih, b_ih = _projection_case(seed, N=6, PL=5, PE=64)
    N, PL, PE = x.shape
    assert gp._proj_mode(PE) == "fused"
    got = gru_cuda.gru_input_proj_ref(xt, w_ih, b_ih).float().numpy().reshape(N, PL, 6 * H)
    wih, bih = gp._proj_weights(p, H, PE)
    kernel = gp._pallas_project_fwd(gp._pallas_stack_pad(x, N, PL, PE), wih, bih, H, N, PL)
    f, b = gp._deinterleave(kernel.astype(jnp.float32).reshape(N, PL, 6 * H), H)
    _within_one_ulp(got[..., :3 * H], np.asarray(f))
    _within_one_ulp(got[..., 3 * H:], np.asarray(b)[:, ::-1])


def test_bf16_bigru_split_forward_at_e100_matches_jax():
    """bigru_split in bf16 at E = 100 (K1 then K2, plain versions) against
    the JAX bigru_split(use_pallas=True), which takes _build_xg and the
    Pallas recurrence there: y_sent and y_pos within 1e-4 of their l2
    norms, and at most a 1e-3 share of their values differing (the
    recurrence's f32 sums may run in another order; on the CPU where this
    was written the two agreed bit for bit)."""
    N, L, E, S = 24, 10, 100, 3
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, L, E)).astype(np.float32)
    lengths = rng.integers(1, L + 1, size=N).astype(np.int32)
    lengths[0], lengths[1] = L, 1
    jparams = jax.tree.map(np.asarray, init_bigru(jax.random.PRNGKey(5), E, H))
    gru = BiGRU(E, H)
    gru.load_state_dict({k[len("gru."):]: v
                         for k, v in params_from_jax({"gru": jparams}).items()})
    jpos, jsent = jax_bigru_split(jparams, jnp.asarray(x, jnp.bfloat16), jnp.asarray(lengths), S,
                                  use_pallas=True)
    with torch.no_grad():
        pos, sent = bigru_split(gru, torch.from_numpy(x).to(BF16), torch.from_numpy(lengths), S)
    assert sent.dtype == pos.dtype == BF16
    for got, want in ((sent, jsent), (pos, jpos)):
        got, want = _bf16_np(got), _bf16_np(want)
        assert got.shape == want.shape
        assert _l2(got, want) <= 1e-4, _l2(got, want)
        assert (got != want).mean() <= 1e-3, (got != want).mean()


def _dx_case(seed, E, N=6, PL=5):
    """_projection_case at E with a seeded bf16 dxg (N*PL, 6H) in the
    port's layout (true time, [fwd | bwd]) and JAX's (combined time,
    interleaved gates)."""
    rng, x, p, xt, w_ih, _ = _projection_case(seed, N=N, PL=PL, PE=E)
    dxg = torch.from_numpy(rng.standard_normal((N * PL, 6 * H)).astype(np.float32)).to(BF16)
    d = jnp.asarray(dxg.float().numpy().reshape(N, PL, 6 * H)).astype(jnp.bfloat16)
    dxg_cat = gp._interleave_gates(d[..., :3 * H], d[:, ::-1, 3 * H:], H)
    return x, p, w_ih, dxg, dxg_cat


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_input_grad_plain_version_matches_the_jax_kernel(seed):
    """gru_input_proj_dx_ref in bf16 (K9's yardstick on the card) against
    the JAX kernel it replaces, B4 _pallas_project_bwd(..., emit_dxc=True)
    at E = 16: dxc's two column blocks (each direction's product rounded
    to bf16), the bwd block un-flipped and added in bf16 as
    gru_pallas.py:822-826 does.  Within one bf16 ulp: the same rounding
    points, the f32 sums taken in another order."""
    x, p, w_ih, dxg, dxg_cat = _dx_case(seed, 16)
    N, PL, PE = x.shape
    got = gru_cuda.gru_input_proj_dx_ref(dxg, w_ih)
    assert got.dtype == BF16
    wih, _ = gp._proj_weights(p, H, PE)
    dxc_cat, _, _ = gp._pallas_project_bwd(dxg_cat.reshape(N, -1), gp._pallas_stack_pad(
        x, N, PL, PE), wih, H, N, PL, emit_dxc=True)
    assert dxc_cat.dtype == jnp.bfloat16
    dxc = dxc_cat.reshape(N, PL, gp._PROJ_C)
    want = dxc[..., :PE] + dxc[..., PE:2 * PE][:, ::-1]
    _within_one_ulp(got.float().numpy().reshape(N, PL, PE), _bf16_np(want))


def test_bf16_input_grad_plain_version_matches_the_wide_route():
    """gru_input_proj_dx_ref in bf16 at E = 100 against the JAX wide
    route's dx (gru_pallas.py:893-897): dxg de-interleaved, each
    direction's bf16 product, the bwd one flipped back to true time, added
    in bf16.  Within one bf16 ulp."""
    x, p, w_ih, dxg, dxg_cat = _dx_case(2, 100)
    N, PL, PE = x.shape
    dxg_f, dxg_b = gp._deinterleave(dxg_cat, H)
    want = (dxg_f @ p["fwd"]["w_ih"].T + (dxg_b @ p["bwd"]["w_ih"].T)[:, ::-1])
    assert want.dtype == jnp.bfloat16
    got = gru_cuda.gru_input_proj_dx_ref(dxg, w_ih)
    _within_one_ulp(got.float().numpy().reshape(N, PL, PE), _bf16_np(want))
