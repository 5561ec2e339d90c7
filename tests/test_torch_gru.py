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
from umpr_tpu.ops.gru import bigru_split as jax_bigru_split
from umpr_tpu.ops.gru_pallas import bigru_pallas_split_nodx
from umpr_tpu_torch.convert import params_from_jax, params_to_jax
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


def _cotangents(seed, N, L, S):
    rng = np.random.default_rng(seed + 100)
    return (rng.standard_normal((N // S, S * L, 2 * H)).astype(np.float32),
            rng.standard_normal((N, L, 2 * H)).astype(np.float32))


def _port_param_grads(gru, x, lengths, S, c_pos, c_sent):
    """{JAX key: grad} of sum(y_pos*c_pos) + sum(y_sent*c_sent) through
    bigru_split, mapped to the JAX parameter layout."""
    gru.zero_grad()
    pos, sent = bigru_split(gru, torch.from_numpy(x), torch.from_numpy(lengths), S)
    loss = 0.0
    if c_pos is not None:
        loss = loss + (pos * torch.from_numpy(c_pos)).sum()
    if c_sent is not None:
        loss = loss + (sent * torch.from_numpy(c_sent)).sum()
    loss.backward()
    grads = {f"gru.{n}": p.grad for n, p in gru.named_parameters()}
    return params_to_jax(grads)["gru"]


@pytest.mark.parametrize("seed", [0, 1])
def test_bigru_split_param_grads_match_jax_grad_of_kernel(seed):
    jparams, gru, x, lengths, S = _setup(seed)
    c_pos, c_sent = _cotangents(seed, *x.shape[:2], S)

    def loss(p):
        pos, sent = bigru_pallas_split_nodx(p, jnp.asarray(x), jnp.asarray(lengths), S)
        return jnp.sum(pos * c_pos) + jnp.sum(sent * c_sent)

    want = jax.grad(loss)(jparams)
    got = _port_param_grads(gru, x, lengths, S, c_pos, c_sent)
    for d in ("fwd", "bwd"):
        for k in ("w_ih", "w_hh", "bias_ih", "bias_hh"):
            np.testing.assert_allclose(got[d][k], np.asarray(want[d][k]), **TOL,
                                       err_msg=f"{d}.{k}")


def test_each_output_alone_reaches_every_gru_weight():
    _, gru, x, lengths, S = _setup(5)
    c_pos, c_sent = _cotangents(5, *x.shape[:2], S)
    for only in ((c_pos, None), (None, c_sent)):
        grads = _port_param_grads(gru, x, lengths, S, *only)
        for d in ("fwd", "bwd"):
            for k, g in grads[d].items():
                assert np.abs(g).max() > 1e-3, (only[0] is None, d, k)


@pytest.mark.parametrize("kind", ["mixed", "all_1", "all_L"])
def test_backward_plain_versions_match_autograd_through_bigru_scan(kind):
    _, gru, x, lengths, S = _setup(6)
    N, L, E = x.shape
    if kind != "mixed":
        lengths[:] = 1 if kind == "all_1" else L
    lengths_t = torch.from_numpy(lengths)
    w_ih, b_ih, w_hh, b_hh = (t.detach().requires_grad_()
                              for t in gru.kernel_operands())
    x2 = torch.from_numpy(x).reshape(N * L, E)
    xg = gru_cuda.gru_input_proj_ref(x2, w_ih, b_ih)
    xg3 = xg.detach().view(N, L, -1).requires_grad_()
    y = gru_cuda.bigru_recurrence_ref(xg3, lengths_t, w_hh, b_hh)
    c_pos, c_sent = (torch.from_numpy(c) for c in _cotangents(6, N, L, S))
    ((y.view(N // S, S * L, -1) * c_pos).sum() + (y * c_sent).sum()).backward()

    dxg, dw_hh, db_hh = gru_cuda.bigru_backward_ref(
        xg3.detach(), y.detach(), c_sent, c_pos, lengths_t, w_hh.detach(),
        b_hh.detach())
    torch.testing.assert_close(dxg, xg3.grad, **TOL)
    torch.testing.assert_close(dw_hh, w_hh.grad, **TOL)
    torch.testing.assert_close(db_hh, b_hh.grad, **TOL)
    past = torch.arange(L)[None, :] >= lengths_t[:, None]
    assert (dxg[past] == 0).all()

    xg.backward(dxg.view(N * L, -1))
    dw_ih, db_ih = gru_cuda.gru_input_proj_bwd_ref(x2, dxg.view(N * L, -1))
    torch.testing.assert_close(dw_ih, w_ih.grad, **TOL)
    torch.testing.assert_close(db_ih, b_ih.grad, **TOL)


@pytest.mark.parametrize("kind", ["mixed", "all_1", "all_L"])
def test_y_gives_the_state_before_every_valid_step(kind):
    """K3 reads h_prev from y: at every valid step it is the state an
    independent nn.GRUCell trace holds before the step, including each
    row's first step (zeros)."""
    _, gru, x, lengths, _ = _setup(8)
    N, L, E = x.shape
    if kind != "mixed":
        lengths[:] = 1 if kind == "all_1" else L
    lengths_t = torch.from_numpy(lengths)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y = port_bigru_scan(gru, xt, lengths_t)
        for d, suffix, steps in ((0, "", range(L)),
                                 (1, "_reverse", range(L - 1, -1, -1))):
            cell = torch.nn.GRUCell(E, H)
            cell.load_state_dict({n: getattr(gru, f"{n}_l0{suffix}") for n in
                                  ("weight_ih", "weight_hh", "bias_ih", "bias_hh")})
            h = torch.zeros(N, H)
            for t in steps:
                valid = t < lengths_t
                torch.testing.assert_close(gru_cuda.h_prev_from_y(y, t, d)[valid],
                                           h[valid], **TOL)
                h = torch.where(valid[:, None], cell(xt[:, t], h), h)


def test_bigru_split_raises_when_x_requires_grad():
    """x requiring grad no longer raises (the name is from before B4-dx
    was ported): bigru_split gives dx as jax.grad does."""
    _check_input_grad_against_jax(9)


def test_bigru_split_input_grad_matches_jax_grad():
    _check_input_grad_against_jax(10)


def _check_input_grad_against_jax(seed):
    """dx of bigru_split (K9, the emit_dxc branch of B4) and the weights'
    grads against jax.grad of the JAX package's bigru_split with
    use_pallas and need_dx."""
    jparams, gru, x, lengths, S = _setup(seed)
    c_pos, c_sent = _cotangents(seed, *x.shape[:2], S)

    def loss(p, xj):
        pos, sent = jax_bigru_split(p, xj, jnp.asarray(lengths), S,
                                    use_pallas=True, need_dx=True)
        return jnp.sum(pos * c_pos) + jnp.sum(sent * c_sent)

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    pos, sent = bigru_split(gru, xt, torch.from_numpy(lengths), S)
    ((pos * torch.from_numpy(c_pos)).sum() + (sent * torch.from_numpy(c_sent)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL)
    got = params_to_jax({f"gru.{n}": p.grad for n, p in gru.named_parameters()})["gru"]
    for d in ("fwd", "bwd"):
        for k in ("w_ih", "w_hh", "bias_ih", "bias_hh"):
            np.testing.assert_allclose(got[d][k], np.asarray(want_p[d][k]), **TOL,
                                       err_msg=f"{d}.{k}")


@pytest.mark.parametrize("kind", ["mixed", "all_1", "all_L"])
def test_input_grad_plain_version_matches_autograd_through_bigru_scan(kind):
    """K9's plain version on the plain backward's dxg is autograd's x.grad
    through the port's bigru_scan."""
    _, gru, x, lengths, S = _setup(11)
    N, L, E = x.shape
    if kind != "mixed":
        lengths[:] = 1 if kind == "all_1" else L
    lengths_t = torch.from_numpy(lengths)
    xt = torch.from_numpy(x).requires_grad_()
    c_pos, c_sent = (torch.from_numpy(c) for c in _cotangents(11, N, L, S))
    y = port_bigru_scan(gru, xt, lengths_t)
    ((y.view(N // S, S * L, -1) * c_pos).sum() + (y * c_sent).sum()).backward()
    w_ih, b_ih, w_hh, b_hh = (t.detach() for t in gru.kernel_operands())
    xg = gru_cuda.gru_input_proj_ref(xt.detach().reshape(N * L, E), w_ih, b_ih)
    dxg, _, _ = gru_cuda.bigru_backward_ref(xg.view(N, L, -1), y.detach(), c_sent,
                                            c_pos, lengths_t, w_hh, b_hh)
    dx = gru_cuda.gru_input_proj_dx_ref(dxg.view(N * L, -1), w_ih).view(N, L, E)
    torch.testing.assert_close(dx, xt.grad, **TOL)
    # past each length nothing reaches x
    past = torch.arange(L)[None, :] >= lengths_t[:, None]
    assert (dx[past] == 0).all()


def test_frozen_input_launches_no_input_gradient(monkeypatch):
    """x without grad (the frozen embedding) never reaches K9."""
    _, gru, x, lengths, S = _setup(12)
    calls = []
    monkeypatch.setattr(gru_cuda, "gru_input_proj_dx",
                        lambda *a: calls.append(1) or gru_cuda.gru_input_proj_dx_ref(*a))
    pos, sent = bigru_split(gru, torch.from_numpy(x), torch.from_numpy(lengths), S)
    (pos.sum() + sent.sum()).backward()
    assert not calls and gru.weight_ih_l0.grad is not None
    xt = torch.from_numpy(x).requires_grad_()
    pos, sent = bigru_split(gru, xt, torch.from_numpy(lengths), S)
    (pos.sum() + sent.sum()).backward()
    assert calls == [1] and xt.grad.shape == xt.shape


def test_kernel_wrappers_raise_on_non_cpu_inputs_that_require_grad():
    """A kernel's output carries no graph: off the CPU, an input that
    requires grad must raise, not silently cut the GRU from the loss."""
    meta = dict(device="meta")
    N, L, E = 4, 3, 5
    w = torch.zeros(E, 6 * H, **meta, requires_grad=True)
    b = torch.zeros(6 * H, **meta)
    xg = torch.zeros(N, L, 6 * H, **meta)
    lengths = torch.ones(N, dtype=torch.int32, **meta)
    w_hh = torch.zeros(2, H, 3 * H, **meta, requires_grad=True)
    b_hh = torch.zeros(2, 3 * H, **meta)
    y = torch.zeros(N, L, 2 * H, **meta, requires_grad=True)
    calls = [
        lambda: gru_cuda.gru_input_proj(torch.zeros(N * L, E, **meta), w, b),
        lambda: gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh),
        lambda: gru_cuda.bigru_backward(xg, y, y.detach(), y.detach(), lengths,
                                        w_hh.detach(), b_hh),
        lambda: gru_cuda.gru_input_proj_bwd(torch.zeros(N * L, E, **meta),
                                            xg.view(N * L, -1).requires_grad_()),
        lambda: gru_cuda.gru_input_proj_dx(xg.view(N * L, -1), w.t()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="BiGRUSplit"):
            call()
    # without grad, a non-CUDA device is refused as before
    with pytest.raises(ValueError, match="unsupported device"):
        gru_cuda.bigru_backward(xg, y.detach(), y.detach(), y.detach(), lengths,
                                w_hh.detach(), b_hh)


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


@pytest.mark.parametrize("M", [0, 1, 31, 32, 33, 5000, 51200, 107008, 107009, 1048576,
                               4198343])
def test_proj_bwd_chunks_depend_on_m_alone_and_cover_every_row_once(M):
    """K4's split-K chunks: rows per chunk a multiple of the stage, at most
    PROJ_BWD_MAX_ROWS; the chunks [c * rows, (c + 1) * rows) cut [0, M) into
    disjoint pieces, none empty; nothing but M goes in (the bits of the
    fixed-order sum must not depend on the card)."""
    _check_chunks(gru_cuda.proj_bwd_chunks, gru_cuda.PROJ_BWD_STEP, gru_cuda.PROJ_BWD_MAX_ROWS,
                  M)


@pytest.mark.parametrize("M", [0, 1, 63, 64, 65, 5000, 51200, 107008, 107009, 1048576,
                               4198343])
def test_proj_bwd_bf16_chunks_depend_on_m_alone_and_cover_every_row_once(M):
    """The same for K4's bf16 kernel: stages of 64 rows, chunks of at most
    PROJ_BWD_BF16_MAX_ROWS."""
    _check_chunks(gru_cuda.proj_bwd_bf16_chunks, gru_cuda.PROJ_BWD_BF16_STEP,
                  gru_cuda.PROJ_BWD_BF16_MAX_ROWS, M)


def _check_chunks(fn, step, cap, M):
    import inspect
    assert list(inspect.signature(fn).parameters) == ["M"]
    rows, chunks = fn(M)
    assert fn(M) == (rows, chunks)
    assert rows % step == 0
    assert 0 < rows <= cap
    assert chunks >= 1
    if M == 0:
        assert chunks == 1  # one block writes the zero partial
        return
    assert (chunks - 1) * rows < M <= chunks * rows  # the last chunk is not empty
    covered = np.zeros(M, dtype=np.int64)
    for c in range(chunks):
        covered[c * rows:min(M, (c + 1) * rows)] += 1
    assert (covered == 1).all()


def test_proj_bwd_chunks_fill_the_card_and_bound_the_partials():
    """At the UMPR-R shapes (M = 51,200, E = 50, 6H = 384: 3 column tiles
    of 128) K4's grid fills an H100's 132 SMs, at most 2 blocks each; at
    the long-history 1,048,576 rows the partials stay under 10% of dxg's
    bytes."""
    E, G = 50, 384
    col_tiles = -(-G // 128)
    _, chunks = gru_cuda.proj_bwd_chunks(51200)
    assert 132 <= chunks * col_tiles <= 2 * 132
    _, chunks = gru_cuda.proj_bwd_chunks(1_048_576)
    assert chunks * E * G <= 0.10 * 1_048_576 * G


def test_proj_bwd_bf16_chunks_fill_the_card_and_bound_the_partials():
    """K4's bf16 chunks at the UMPR-R shapes: the grid fills an H100's 132
    SMs in one wave of at most 2 blocks each (3 column tiles of 128); a
    chain at the cap is no more k16 steps than f32's k8 chain at its cap;
    at 1,048,576 rows the partials stay under 5% of the bf16 dxg's bytes."""
    E, G = 50, 384
    col_tiles = -(-G // 128)
    _, chunks = gru_cuda.proj_bwd_bf16_chunks(51200)
    assert 132 <= chunks * col_tiles <= 2 * 132
    assert gru_cuda.PROJ_BWD_BF16_MAX_ROWS // 16 <= gru_cuda.PROJ_BWD_MAX_ROWS // 8
    _, chunks = gru_cuda.proj_bwd_bf16_chunks(1_048_576)
    assert chunks * E * G * 4 <= 0.05 * 1_048_576 * G * 2
