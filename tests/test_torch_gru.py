"""The port's masked bi-GRU (umpr_tpu_torch.ops.gru / gru_cuda) against the
JAX package on the CPU, where the wrappers run their plain versions and the
JAX Pallas kernels run interpreted.  Tolerance 1e-5 (PARITY.md, masked
GRU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umpr_tpu.ops.gru import _direction_scan, bigru_scan, init_bigru
from umpr_tpu.ops.gru_pallas import bigru_pallas_split_nodx
from umpr_tpu_torch.convert import params_from_jax
from umpr_tpu_torch.ops import gru_cuda
from umpr_tpu_torch.ops.gru import BiGRU, bigru_split
from umpr_tpu_torch.ops.gru import bigru_scan as port_bigru_scan

TOL = dict(rtol=1e-5, atol=1e-5)
H = 64  # the JAX kernel path needs H % 64 == 0


def _setup(seed, B=2, S=3, L=7, E=12):
    rng = np.random.default_rng(seed)
    N = B * S
    x = rng.standard_normal((N, L, E)).astype(np.float32)
    lengths = rng.integers(1, L + 1, size=N).astype(np.int32)
    lengths[0], lengths[1] = L, 1
    jparams = jax.tree.map(np.asarray, init_bigru(jax.random.PRNGKey(seed), E, H))
    gru = BiGRU(E, H)
    sd = {k[len("gru."):]: v for k, v in params_from_jax({"gru": jparams}).items()}
    gru.load_state_dict(sd)
    return jparams, gru, x, lengths, S


@pytest.mark.parametrize("seed", [0, 1])
def test_bigru_split_matches_jax_kernel_and_scan(seed):
    jparams, gru, x, lengths, S = _setup(seed)
    jpos, jsent = bigru_pallas_split_nodx(jparams, jnp.asarray(x),
                                          jnp.asarray(lengths), S)
    jscan = bigru_scan(jparams, jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        pos, sent = bigru_split(gru, torch.from_numpy(x),
                                torch.from_numpy(lengths), S)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), **TOL)
    np.testing.assert_allclose(sent.numpy(), np.asarray(jsent), **TOL)
    np.testing.assert_allclose(sent.numpy(), np.asarray(jscan), **TOL)
    # exact zeros past each length, in both directions' halves
    t = np.arange(x.shape[1])[None, :]
    assert (sent.numpy()[t >= lengths[:, None]] == 0).all()


def test_bigru_split_on_cpu_equals_port_bigru_scan():
    _, gru, x, lengths, S = _setup(2)
    with torch.no_grad():
        pos, sent = bigru_split(gru, torch.from_numpy(x),
                                torch.from_numpy(lengths), S)
        ref = port_bigru_scan(gru, torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(sent.numpy(), ref.numpy())
    assert pos.data_ptr() == sent.data_ptr()  # y_pos is a view of y_sent


def test_plain_versions_match_jax_projection_and_recurrence():
    jparams, gru, x, lengths, _ = _setup(3)
    N, L, E = x.shape
    w_ih, b_ih, w_hh, b_hh = (t.detach() for t in gru.kernel_operands())
    xg = gru_cuda.gru_input_proj_ref(torch.from_numpy(x).reshape(N * L, E),
                                     w_ih, b_ih).reshape(N, L, 6 * H)
    w_cat = jnp.concatenate([jparams["fwd"]["w_ih"], jparams["bwd"]["w_ih"]], 1)
    b_cat = jnp.concatenate([jparams["fwd"]["bias_ih"], jparams["bwd"]["bias_ih"]])
    jxg = np.asarray(jnp.asarray(x) @ w_cat + b_cat)
    np.testing.assert_allclose(xg.numpy(), jxg, **TOL)

    # the recurrence alone, fed the same projection
    y = gru_cuda.bigru_recurrence_ref(torch.tensor(jxg),
                                      torch.from_numpy(lengths), w_hh, b_hh)
    xg_tm = jnp.swapaxes(jnp.asarray(jxg), 0, 1)
    jl = jnp.asarray(lengths)
    jf = _direction_scan(xg_tm[..., :3 * H], jl, jparams["fwd"]["w_hh"],
                         jparams["fwd"]["bias_hh"], H, reverse=False)
    jb = _direction_scan(xg_tm[..., 3 * H:], jl, jparams["bwd"]["w_hh"],
                         jparams["bwd"]["bias_hh"], H, reverse=True)
    jy = np.swapaxes(np.concatenate([np.asarray(jf), np.asarray(jb)], -1), 0, 1)
    np.testing.assert_allclose(y.numpy(), jy, **TOL)


def test_wrappers_count_no_launch_on_cpu_and_raise_elsewhere():
    gru_cuda.reset_launches()
    x = torch.zeros(4, 3)
    gru_cuda.gru_input_proj(x, torch.zeros(3, 6 * 2), torch.zeros(12))
    assert gru_cuda.gru_input_proj.launches == 0
    # a CUDA-side check is reached only for CUDA tensors; the meta device
    # stands in for "not the CPU" and must raise, never fall back
    with pytest.raises(ValueError):
        gru_cuda.gru_input_proj(x.to("meta"), torch.zeros(3, 12, device="meta"),
                                torch.zeros(12, device="meta"))


def test_kernel_operands_are_cached_without_autograd_and_follow_updates():
    _, gru, _, _, _ = _setup(4)
    with torch.no_grad():
        first = gru.kernel_operands()
        assert all(a is b for a, b in zip(first, gru.kernel_operands()))
        gru.weight_hh_l0_reverse.mul_(2.0)  # in place: the version moves
        again = gru.kernel_operands()
    assert again[2] is not first[2]
    torch.testing.assert_close(again[2][1], 2.0 * first[2][1], rtol=0, atol=0)
    torch.testing.assert_close(again[2][0], first[2][0], rtol=0, atol=0)
    with torch.inference_mode():
        assert gru.kernel_operands()[0] is again[0]
    gru.weight_ih_l0 = torch.nn.Parameter(torch.zeros_like(gru.weight_ih_l0))
    with torch.no_grad():
        assert (gru.kernel_operands()[0][:, :3 * H] == 0).all()
    # with autograd the operands are packed anew and carry the graph
    w_ih = gru.kernel_operands()[0]
    assert w_ih.requires_grad and w_ih is not again[0]
