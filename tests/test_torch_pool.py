"""The port's fused bias + ReLU + 2x2 max-pool (ops/pool.py, the plain
versions of K5/K6 in ops/pool_cuda.py) against the JAX package's Pallas
kernel (umpr_tpu/ops/pool_pallas.py, interpreted on the CPU) and its
composite.  Forward, argmax and dx exactly; db at 1e-5 (f32 sums in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umpr_tpu.ops import pool_pallas
from umpr_tpu_torch.ops import pool_cuda
from umpr_tpu_torch.ops.pool import (FusedBiasReluPool, fused_bias_relu_pool,
                                     reference_bias_relu_pool)

SHAPES = [(2, 16, 16, 64), (1, 28, 8, 128), (3, 8, 12, 256), (2, 4, 6, 3)]


def _inputs(shape, seed, grid=None):
    """x, b, and a cotangent of the pooled output; with `grid`, values on a
    coarse grid so that ties and all-negative windows occur."""
    rng = np.random.default_rng(seed)
    N, H, W, C = shape
    x = rng.standard_normal(shape).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    g = rng.standard_normal((N, H // 2, W // 2, C)).astype(np.float32)
    if grid:
        x, b = np.round(x * grid) / grid, np.round(b * grid) / grid
    return x, b, g


def _jax_grads(fn, x, b, g):
    return jax.grad(lambda x_, b_: jnp.sum(fn(x_, b_) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(b))


def _port_grads(fn, x, b, g):
    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    (fn(xt, bt) * torch.from_numpy(g)).sum().backward()
    return xt.grad.numpy(), bt.grad.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_argmax_equal_jax_kernel_and_composite(shape):
    x, b, _ = _inputs(shape, seed=0)
    yp, idx = pool_cuda.bias_relu_pool(torch.from_numpy(x), torch.from_numpy(b))
    jyp, jidx = pool_pallas._forward(jnp.asarray(x), jnp.asarray(b))
    np.testing.assert_array_equal(yp.numpy(), np.asarray(jyp))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx, np.float32))
    assert idx.dtype == torch.uint8
    want = np.asarray(pool_pallas.reference_bias_relu_pool(jnp.asarray(x), jnp.asarray(b)))
    for fn in (fused_bias_relu_pool, reference_bias_relu_pool):
        np.testing.assert_array_equal(
            fn(torch.from_numpy(x), torch.from_numpy(b)).numpy(), want)


@pytest.mark.parametrize("shape,grid", [(SHAPES[0], None), (SHAPES[1], 2),
                                        (SHAPES[2], None), (SHAPES[3], 2)])
def test_grads_equal_jax_kernel_and_composite(shape, grid):
    x, b, g = _inputs(shape, seed=1, grid=grid)
    dx, db = _port_grads(fused_bias_relu_pool, x, b, g)
    for fn in (pool_pallas.fused_bias_relu_pool, pool_pallas.reference_bias_relu_pool):
        jdx, jdb = _jax_grads(fn, x, b, g)
        np.testing.assert_array_equal(dx, np.asarray(jdx))
        np.testing.assert_allclose(db, np.asarray(jdb), rtol=1e-5, atol=1e-5)
    rdx, rdb = _port_grads(reference_bias_relu_pool, x, b, g)
    np.testing.assert_array_equal(dx, rdx)
    np.testing.assert_allclose(db, rdb, rtol=1e-5, atol=1e-5)
    if grid:  # the grid made ties: each went to one corner only
        assert (np.count_nonzero(dx.reshape(shape[0], shape[1] // 2, 2, shape[2] // 2,
                                            2, shape[3]), axis=(2, 4)) <= 1).all()


def test_ties_go_to_the_first_corner_and_dead_windows_get_no_gradient():
    # (1, 4, 4, 2): four windows per channel
    x = np.zeros((1, 4, 4, 2), np.float32)
    x[0, :2, :2, 0] = 1.0                    # all four corners tie
    x[0, :2, 2:, 0] = [[0.5, 2.0], [1.0, 2.0]]  # corners 1 and 3 tie
    x[0, 2:, :2, 0] = -1.0                   # all negative: pooled 0
    x[0, 2:, 2:, 0] = [[0.0, 0.0], [3.0, 0.0]]  # corner 2
    x[..., 1] = -x[..., 0]
    b = np.zeros(2, np.float32)
    g = np.ones((1, 2, 2, 2), np.float32)
    yp, idx = pool_cuda.bias_relu_pool(torch.from_numpy(x), torch.from_numpy(b))
    assert idx[0, :, :, 0].tolist() == [[0, 1], [0, 2]]
    dx, db = _port_grads(fused_bias_relu_pool, x, b, g)
    hot = np.zeros((4, 4), np.float32)
    hot[0, 0] = hot[0, 3] = hot[3, 2] = 1.0  # the all-negative window gets none
    np.testing.assert_array_equal(dx[0, :, :, 0], hot)
    assert db[0] == 3.0
    # channel 1 is negated: only window (1, 0) is positive, a four-way tie
    assert yp[0, :, :, 1].tolist() == [[0.0, 0.0], [1.0, 0.0]]
    hot[:] = 0.0
    hot[2, 0] = 1.0
    np.testing.assert_array_equal(dx[0, :, :, 1], hot)
    jdx, jdb = _jax_grads(pool_pallas.fused_bias_relu_pool, x, b, g)
    np.testing.assert_array_equal(dx, np.asarray(jdx))
    np.testing.assert_array_equal(db, np.asarray(jdb))


def test_nan_propagates_like_the_jax_kernel():
    x, b, g = _inputs((1, 4, 4, 3), seed=2)
    x[0, 1, 0, 1] = np.nan  # window (0, 0), corner 2, channel 1
    yp, idx = pool_cuda.bias_relu_pool(torch.from_numpy(x), torch.from_numpy(b))
    jyp, jidx = pool_pallas._forward(jnp.asarray(x), jnp.asarray(b))
    np.testing.assert_array_equal(yp.numpy(), np.asarray(jyp))  # NaN == NaN here
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx, np.float32))
    assert torch.isnan(yp[0, 0, 0, 1]) and idx[0, 0, 0, 1] == 3
    dx, db = pool_cuda.bias_relu_pool_bwd(torch.from_numpy(g), idx, yp)
    assert (dx[0, :2, :2, 1] == 0).all() and torch.isfinite(db).all()


def test_autograd_node_saves_only_the_pooled_output_and_argmax():
    x, b, g = _inputs(SHAPES[0], seed=3)
    saved = []
    xt = torch.from_numpy(x).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: (saved.append((tuple(t.shape), t.dtype)), t)[1], lambda t: t):
        yp = FusedBiasReluPool.apply(xt, torch.from_numpy(b).requires_grad_())
    pooled = (2, 8, 8, 64)
    assert sorted(saved, key=str) == [(pooled, torch.float32), (pooled, torch.uint8)]
    (yp * torch.from_numpy(g)).sum().backward()
    assert xt.grad.shape == x.shape


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="even"):
        pool_cuda.bias_relu_pool(torch.zeros(1, 3, 4, 2), torch.zeros(2))
    before = (pool_cuda.bias_relu_pool.launches, pool_cuda.bias_relu_pool_bwd.launches)
    yp, idx = pool_cuda.bias_relu_pool(torch.zeros(1, 2, 2, 2), torch.zeros(2))
    pool_cuda.bias_relu_pool_bwd(yp, idx, yp)
    assert (pool_cuda.bias_relu_pool.launches,
            pool_cuda.bias_relu_pool_bwd.launches) == before  # plain versions
    meta = dict(device="meta")
    x, b = torch.zeros(1, 2, 2, 4, **meta), torch.zeros(4, **meta)
    with pytest.raises(RuntimeError, match="FusedBiasReluPool"):
        pool_cuda.bias_relu_pool(x.requires_grad_(), b)
    with pytest.raises(RuntimeError, match="FusedBiasReluPool"):
        pool_cuda.bias_relu_pool_bwd(torch.zeros(1, 1, 1, 4, **meta),
                                     torch.zeros(1, 1, 1, 4, dtype=torch.uint8, **meta),
                                     torch.zeros(1, 1, 1, 4, **meta, requires_grad=True))
    with pytest.raises(ValueError, match="unsupported device"):
        pool_cuda.bias_relu_pool(torch.zeros(1, 2, 2, 4, **meta), b)
