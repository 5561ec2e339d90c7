"""The port at ``--gru_size 100`` against the JAX package on the CPU.  There
the JAX package takes ``bigru_scan`` (its Pallas GRU needs H % 64 == 0)
and the composite attention (D = 200), while the port runs ``bigru_split``
through its kernels' plain versions, as on the card at any H.  Tolerance
1e-5 (PARITY.md: masked GRU, one train step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.ref_oracle import random_batch
from tests.test_torch_train import _flat
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr
from umpr_tpu.ops.gru import bigru_split as jax_bigru_split
from umpr_tpu.ops.gru import init_bigru
from umpr_tpu.train.optim import make_optimizer as jax_make_optimizer
from umpr_tpu.train.optim import merge_params, split_frozen
from umpr_tpu.train.step import make_train_step
from umpr_tpu_torch.convert import params_from_jax, params_to_jax
from umpr_tpu_torch.data.loader import to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.ops import gru_cuda
from umpr_tpu_torch.ops.gru import BiGRU, bigru_split
from umpr_tpu_torch.train.optim import make_optimizer
from umpr_tpu_torch.train.step import train_step

TOL = dict(rtol=1e-5, atol=1e-5)
H = 100  # not a multiple of 64: the JAX package's scan route


def _setup(seed, B=2, S=3, L=7, E=12):
    rng = np.random.default_rng(seed)
    N = B * S
    x = rng.standard_normal((N, L, E)).astype(np.float32)
    lengths = rng.integers(1, L + 1, size=N).astype(np.int32)
    lengths[0], lengths[1] = L, 1
    jparams = jax.tree.map(np.asarray, init_bigru(jax.random.PRNGKey(seed), E, H))
    gru = BiGRU(E, H)
    gru.load_state_dict({k[len("gru."):]: v
                         for k, v in params_from_jax({"gru": jparams}).items()})
    c_pos = rng.standard_normal((N // S, S * L, 2 * H)).astype(np.float32)
    c_sent = rng.standard_normal((N, L, 2 * H)).astype(np.float32)
    return jparams, gru, x, lengths, S, c_pos, c_sent


@pytest.mark.parametrize("seed", [0, 1])
def test_bigru_split_matches_the_jax_scan_route(seed):
    jparams, gru, x, lengths, S, _, _ = _setup(seed)
    jpos, jsent = jax_bigru_split(jparams, jnp.asarray(x), jnp.asarray(lengths), S,
                                  use_pallas=True, need_dx=False)
    with torch.no_grad():
        pos, sent = bigru_split(gru, torch.from_numpy(x), torch.from_numpy(lengths), S)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), **TOL)
    np.testing.assert_allclose(sent.numpy(), np.asarray(jsent), **TOL)
    t = np.arange(x.shape[1])[None, :]
    assert (sent.numpy()[t >= lengths[:, None]] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_bigru_split_grads_match_jax_grad_of_the_scan_route(seed):
    """dx and every weight's gradient: K3's wide route, K4 and K9 at H =
    100 on the card; their plain versions here."""
    jparams, gru, x, lengths, S, c_pos, c_sent = _setup(seed)

    def loss(p, xj):
        pos, sent = jax_bigru_split(p, xj, jnp.asarray(lengths), S,
                                    use_pallas=True, need_dx=True)
        return jnp.sum(pos * c_pos) + jnp.sum(sent * c_sent)

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
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


@pytest.mark.parametrize("seed", [2, 5])
def test_umpr_r_train_step_at_gru_size_100_matches_jax(seed):
    vocab, emb_size = 40, 16
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((vocab, emb_size)).astype(np.float32)
    jdims = JaxDims(review_net_only=True, use_pallas=True, gru_size=H, self_atte_size=16)
    jparams = jax.tree.map(np.asarray, init_umpr(jax.random.PRNGKey(seed), jdims, emb))
    model = UMPR(ModelDims(gru_size=H, self_atte_size=16), emb)
    model.load_state_dict(params_from_jax(jparams))
    batch = random_batch(np.random.default_rng(seed + 10), B=2, S=3, L=7, S_ui=2,
                         vocab=vocab, emb=emb_size, max_len=7)
    l2, lr = 1e-3, 1e-3

    tx = jax_make_optimizer(l2)
    trainable, frozen = split_frozen(jparams)
    step = make_train_step(jdims, tx, donate=False)
    jtrained, _, jloss, _ = step(trainable, frozen, tx.init(trainable),
                                 {k: jnp.asarray(v) for k, v in batch.items()}, lr, None)
    loss, _ = train_step(model, make_optimizer(model, l2, lr), to_device(batch, "cpu"), lr)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    want = _flat(merge_params(jax.device_get(jtrained), frozen))
    got = _flat(params_to_jax(model.state_dict()))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


@pytest.mark.parametrize("M", [1, 1023, 1024, 1025, 2600, 51200, 131072, 131073, 1048576])
def test_bwd_chunks_depend_on_m_alone_and_cover_every_row_once(M):
    """K3's wide route splits the N*L rows into chunks that depend on M
    alone (the same partials, so the same bits, on every card), at most
    BWD_MAX_CHUNKS of at least BWD_MIN_ROWS rows."""
    rows, chunks = gru_cuda.bwd_chunks(M)
    assert (rows, chunks) == gru_cuda.bwd_chunks(M)
    assert (chunks - 1) * rows < M <= chunks * rows
    assert rows >= gru_cuda.BWD_MIN_ROWS and chunks <= gru_cuda.BWD_MAX_CHUNKS
