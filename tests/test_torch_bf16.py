"""--compute_dtype bfloat16 in the port against the JAX package's bf16 path
on the CPU (the wrappers run their plain versions, the JAX Pallas GRU
kernels run interpreted), at B = 4, S = 5, L = 10, E = 16, H = 64 and
32 px photos.  Each module's JAX side is computed once.

Tolerances (bf16 keeps 8 significant bits, so two implementations that
round at the same points still differ by an ulp where f32 sums run in
another order, and the recurrence carries such a flip along):
- bi-GRU outputs: l2-relative 1e-2;
- predictions: 2e-2 absolute; losses: rtol 1e-2;
- gradients: l2-relative 5e-2, per leaf whose norm exceeds 1e-3;
- and the port's predictions lie at most half as far from JAX's bf16 ones
  as JAX's bf16 ones lie from JAX's f32 ones: a rounding point put in the
  wrong place moves them by a bf16-sized step, which this catches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.ref_oracle import random_batch
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import umpr_forward
from umpr_tpu.ops.gru import init_bigru
from umpr_tpu.ops.gru_pallas import bigru_pallas_split_nodx
from umpr_tpu.train.optim import merge_params, split_frozen
from umpr_tpu_torch import serve
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import params_from_jax, params_to_jax
from umpr_tpu_torch.data.loader import to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.ops import gru_cuda
from umpr_tpu_torch.ops.gru import BiGRU, bigru_split
from umpr_tpu_torch.train import checkpoint as ckpt
from umpr_tpu_torch.train.optim import make_optimizer
from umpr_tpu_torch.train.step import train_step

B, S, L, E, H, PX, VOCAB = 4, 5, 10, 16, 64, 32, 40
BF16 = torch.bfloat16


def _l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _grads_close(got, want):
    """{key: array} pairs: l2-relative 5e-2 per leaf whose norm > 1e-3."""
    checked = 0
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        if np.linalg.norm(w) <= 1e-3:
            continue
        assert _l2(got[k], w) <= 5e-2, (k, _l2(got[k], w))
        checked += 1
    assert checked


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---- the bi-GRU op: bigru_split against bigru_pallas_split_nodx in bf16

@pytest.fixture(scope="module")
def gru_case():
    rng = np.random.default_rng(0)
    N = B * S
    x = jnp.asarray(rng.standard_normal((N, L, E)), jnp.bfloat16)
    lengths = rng.integers(1, L + 1, size=N).astype(np.int32)
    lengths[0], lengths[1] = L, 1
    jparams = jax.tree.map(np.asarray, init_bigru(jax.random.PRNGKey(0), E, H))
    c_pos = rng.standard_normal((B, S * L, 2 * H)).astype(np.float32)
    c_sent = rng.standard_normal((N, L, 2 * H)).astype(np.float32)

    def loss(p):
        pos, sent = bigru_pallas_split_nodx(p, x, jnp.asarray(lengths), S)
        return (jnp.sum(pos.astype(jnp.float32) * c_pos)
                + jnp.sum(sent.astype(jnp.float32) * c_sent)), (pos, sent)

    (_, (jpos, jsent)), jgrads = jax.value_and_grad(loss, has_aux=True)(jparams)
    return dict(x=np.asarray(x.astype(jnp.float32)), lengths=lengths, jparams=jparams,
                c_pos=c_pos, c_sent=c_sent, jpos=np.asarray(jpos.astype(jnp.float32)),
                jsent=np.asarray(jsent.astype(jnp.float32)), jgrads=jgrads)


def _port_gru(jparams):
    gru = BiGRU(E, H)
    gru.load_state_dict({k[len("gru."):]: v
                         for k, v in params_from_jax({"gru": jparams}).items()})
    return gru


def test_bigru_split_bf16_forward_and_backward_match_jax(gru_case):
    c = gru_case
    gru = _port_gru(c["jparams"])
    x = torch.from_numpy(c["x"]).to(BF16)
    pos, sent = bigru_split(gru, x, torch.from_numpy(c["lengths"]), S)
    assert pos.dtype == sent.dtype == BF16
    assert _l2(pos.float().detach(), c["jpos"]) <= 1e-2
    assert _l2(sent.float().detach(), c["jsent"]) <= 1e-2
    t = np.arange(L)[None, :]
    assert (sent.detach().float().numpy()[t >= c["lengths"][:, None]] == 0).all()
    ((pos.float() * torch.from_numpy(c["c_pos"])).sum()
     + (sent.float() * torch.from_numpy(c["c_sent"])).sum()).backward()
    got = params_to_jax({f"gru.{n}": p.grad for n, p in gru.named_parameters()})["gru"]
    assert all(p.grad.dtype == torch.float32 for p in gru.parameters())  # f32 masters
    _grads_close({f"{d}.{k}": got[d][k] for d in ("fwd", "bwd") for k in got[d]},
                 {f"{d}.{k}": c["jgrads"][d][k] for d in ("fwd", "bwd")
                  for k in c["jgrads"][d]})


def _y_against_jax_hs(N, L):
    """The plain bf16 K2's y against the bf16 hs of the JAX kernel
    (interpreted _pallas_forward with emit_hs), at every valid step of N
    rows of length up to L (the first of length L)."""
    from umpr_tpu.ops import gru_pallas as gp

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((N, L, E)), jnp.bfloat16)
    lengths = rng.integers(1, L + 1, size=N).astype(np.int32)
    lengths[0] = L
    jparams = jax.tree.map(np.asarray, init_bigru(jax.random.PRNGKey(1), E, H))
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    xc = gp._pallas_stack_pad(x, N, L, E)
    wih, bih = gp._proj_weights(p, H, E)
    xg_cat = gp._pallas_project_fwd(xc, wih, bih, H, N, L)
    _, hs_cat = gp._pallas_forward(p, xg_cat, jnp.asarray(lengths), N, L, H, True)
    hs = np.asarray(hs_cat.astype(jnp.float32)).reshape(N, L, 2 * H)

    gru = _port_gru(jparams)
    w_ih, b_ih, w_hh, b_hh = (t.detach().to(BF16) for t in gru.kernel_operands())
    xg = gru_cuda.gru_input_proj_ref(torch.from_numpy(np.asarray(
        x.astype(jnp.float32))).to(BF16).reshape(N * L, E), w_ih, b_ih)
    y = gru_cuda.bigru_recurrence_ref(xg.view(N, L, 6 * H), torch.from_numpy(lengths),
                                      w_hh, b_hh)
    assert y.dtype == BF16
    for d in (0, 1):
        for tau in range(L):
            true_t = tau if d == 0 else L - 1 - tau  # hs_cat's bwd lanes run reversed
            valid = true_t < lengths
            got = y[:, true_t, d * H:(d + 1) * H].float().numpy()[valid]
            want = hs[:, tau, d * H:(d + 1) * H][valid]
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -12)


def test_y_bf16_is_the_jax_kernels_bf16_hs():
    """K3 rebuilds h_prev from the bf16 y; the JAX backward reads the bf16
    hs its forward emits (emit_hs).  At every valid step y holds the same
    bf16 state as hs (combined time: fwd | bwd reversed), within an ulp
    where the two f32 orders round differently, so h_prev from y is the
    JAX kernel's h_prev."""
    _y_against_jax_hs(8, L)


def test_y_bf16_is_the_jax_kernels_bf16_hs_at_64_steps():
    """The same at L = 64, the bf16 long-history sentence length: the
    plain K2 that the card tests hold bf16 K2 to at (16,385, 64, 64)
    carries the JAX kernel's bf16 state over 64 steps, within the same
    tolerance."""
    _y_against_jax_hs(8, 64)


def test_bf16_plain_backward_parts_compose_to_the_whole():
    """K3's three passes' plain versions (hg, sweep, dW) in bf16 give
    bigru_backward_ref's dxg, dW_hh and db_hh: dxg rounded from the
    sweep's f32, dW from the rounded ghh, db from the unrounded."""
    g = torch.Generator().manual_seed(5)
    N = 12
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    xg = torch.randn(N, L, 6 * H, generator=g).to(BF16)
    w_hh = (torch.rand(2, H, 3 * H, generator=g) / H ** 0.5).to(BF16)
    b_hh = (torch.rand(2, 3 * H, generator=g) / H ** 0.5).to(BF16)
    y = gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh)
    dy_sent = torch.randn(N, L, 2 * H, generator=g).to(BF16)
    dy_pos = torch.randn(N // 2, 2 * L, 2 * H, generator=g).to(BF16)
    dxg, dw, db = gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    z = gru_cuda.bigru_backward_hg_ref(y, w_hh)
    dxg32, ghn = gru_cuda.bigru_backward_sweep_ref(xg, y, z, dy_sent, dy_pos, lengths,
                                                   w_hh, b_hh)
    pdw, pdb = gru_cuda.bigru_backward_dw_ref(y, dxg32, ghn)
    assert dxg.dtype == BF16 and dw.dtype == db.dtype == torch.float32
    assert _l2(dxg32.to(BF16).float(), dxg.float()) <= 1e-2
    torch.testing.assert_close(pdw, dw, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pdb, db, rtol=1e-4, atol=1e-4)


# ---- the card's yardsticks for K1 and K4 in bf16: their plain versions
# against the JAX Pallas projection kernels, interpreted

def _within_one_ulp(got, want):
    """bf16 arrays (as f32) within one bf16 ulp of the larger magnitude:
    both round an f32 sum of exact bf16 products, taken in another order."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -120))) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.max(np.abs(got - want) / ulp)


def _projection_case(seed, N=6, PL=5, PE=16):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((N, PL, PE)), jnp.bfloat16)
    jparams = jax.tree.map(np.asarray, init_bigru(jax.random.PRNGKey(seed), PE, H))
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    gru = BiGRU(PE, H)
    gru.load_state_dict({k[len("gru."):]: v
                         for k, v in params_from_jax({"gru": jparams}).items()})
    w_ih, b_ih, _, _ = (t.detach().to(BF16) for t in gru.kernel_operands())
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16).reshape(N * PL, PE)
    return rng, x, p, xt, w_ih, b_ih


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_projection_plain_version_matches_the_jax_kernels(seed):
    """gru_input_proj_ref in bf16 (K1's yardstick on the card) against the
    JAX package's bf16 xg from the Pallas stack-pad and projection kernels
    (B5 _pallas_stack_pad, B3 _pallas_project_fwd), in the kernels'
    combined time and interleaved gates, de-interleaved with _deinterleave
    and the bwd half flipped back to true time.  Within one bf16 ulp: both
    round the same f32 sum once, on store, summed in another order.
    (_build_xg, the XLA route the JAX package takes past E = 64, rounds
    twice: the product, then the bias add; the plain version does so past
    E = 64 too, tests/test_torch_wide_embedding.py.)"""
    from umpr_tpu.ops import gru_pallas as gp

    _, x, p, xt, w_ih, b_ih = _projection_case(seed)
    N, PL, PE = x.shape
    xg = gru_cuda.gru_input_proj_ref(xt, w_ih, b_ih)
    assert xg.dtype == BF16
    xg = xg.float().numpy().reshape(N, PL, 6 * H)
    wih, bih = gp._proj_weights(p, H, PE)
    kernel = gp._pallas_project_fwd(gp._pallas_stack_pad(x, N, PL, PE), wih, bih, H, N, PL)
    assert kernel.dtype == jnp.bfloat16
    f, b = gp._deinterleave(kernel.astype(jnp.float32).reshape(N, PL, 6 * H), H)
    _within_one_ulp(xg[..., :3 * H], np.asarray(f))
    _within_one_ulp(xg[..., 3 * H:], np.asarray(b)[:, ::-1])


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_projection_backward_plain_version_matches_the_jax_kernel(seed):
    """gru_input_proj_bwd_ref in bf16 (K4's yardstick on the card) against
    the JAX Pallas kernel B4, _pallas_project_bwd(..., emit_dxc=False): the
    same bf16 dxg (true time for the port; combined time and interleaved
    gates for JAX), dW_ih and db_ih taken from its block-diagonal
    accumulators as _bwd_fused_from_dycat takes them.  f32 sums of exact
    bf16 products in another order: within 1e-5 of the l2 norm."""
    from umpr_tpu.ops import gru_pallas as gp

    rng, x, p, xt, _, _ = _projection_case(seed)
    N, PL, PE = x.shape
    dxg = torch.from_numpy(rng.standard_normal((N * PL, 6 * H)).astype(np.float32)).to(BF16)
    dw, db = gru_cuda.gru_input_proj_bwd_ref(xt, dxg)
    assert dw.dtype == db.dtype == torch.float32
    d = jnp.asarray(dxg.float().numpy().reshape(N, PL, 6 * H)).astype(jnp.bfloat16)
    dxg_cat = gp._interleave_gates(d[..., :3 * H], d[:, ::-1, 3 * H:], H).reshape(N, -1)
    wih, _ = gp._proj_weights(p, H, PE)
    xc = gp._pallas_stack_pad(x, N, PL, PE)
    _, dw_blk, db_blk = gp._pallas_project_bwd(dxg_cat, xc, wih, H, N, PL, emit_dxc=False)
    jdw = np.concatenate(
        [np.concatenate([dw_blk[:PE, 2 * g * H:(2 * g + 1) * H] for g in range(3)], 1),
         np.concatenate([dw_blk[PE:2 * PE, (2 * g + 1) * H:(2 * g + 2) * H]
                         for g in range(3)], 1)], 1)
    jdb = np.concatenate([np.asarray(a) for a in gp._deinterleave(db_blk, H)])
    assert _l2(dw.numpy(), jdw) <= 1e-5
    assert _l2(db.numpy(), jdb) <= 1e-5


# ---- the model: umpr_forward(compute_dtype="bfloat16")

DIMS = dict(gru_size=H, self_atte_size=16, kernel_count=8, kernel_size=3, photo_size=PX)


def _batch(seed, full):
    rng = np.random.default_rng(seed)
    b = random_batch(rng, B=B, S=S, L=L, S_ui=2, vocab=VOCAB, emb=E,
                     with_photos=full, img=PX, max_count=4, max_len=9)
    b["sample_mask"][-1] = 0  # a dead row: NaN must reach nothing
    for k in ("u_counts", "i_counts", "ui_counts"):
        b[k][-1] = 0
    for k in ("u_lengths", "i_lengths", "ui_lengths"):
        b[k][-1] = 1
    if full:
        b["photos"][-1] = 0
    return b


def _jax_side(full, seed):
    """The JAX bf16 and f32 forwards and the bf16 gradients of the
    trainable leaves, once per model kind."""
    emb = np.random.default_rng(seed).standard_normal((VOCAB, E)).astype(np.float32)
    model = UMPR(ModelDims(review_net_only=not full, **DIMS), emb,
                 torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.linear_fusion.bias.fill_(3.0)  # predictions > 0: the ReLU head passes them
    jp = params_to_jax(model.state_dict())
    batch = _batch(seed + 1, full)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for dt in ("float32", "bfloat16"):
        jdims = JaxDims(review_net_only=not full, use_pallas=True, vgg_fused_pool=False,
                        vgg_fold_w=False, compute_dtype=dt, view_size=1, **DIMS)
        trainable, frozen = split_frozen(jax.tree.map(jnp.asarray, jp))

        def loss(t, jdims=jdims):
            pred, l, aux = umpr_forward(merge_params(t, frozen), jbatch, jdims, train=True)
            return l, (pred, aux)

        (l, (pred, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(trainable)
        out[dt] = dict(loss=float(l), pred=np.asarray(pred), grads=_flat(g),
                       aux={k: float(v) for k, v in aux.items()})
    return model.state_dict(), emb, batch, out


@pytest.fixture(scope="module")
def umpr_r():
    return _jax_side(False, 11)


@pytest.fixture(scope="module")
def umpr_full():
    return _jax_side(True, 21)


def _port_model(sd, emb, full, dtype="bfloat16"):
    model = UMPR(ModelDims(review_net_only=not full, compute_dtype=dtype, **DIMS), emb)
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("kind", ["umpr_r", "umpr_full"])
def test_umpr_bf16_forward_and_grads_match_jax(kind, request):
    sd, emb, batch, jx = request.getfixturevalue(kind)
    full = kind == "umpr_full"
    model = _port_model(sd, emb, full)
    pred, loss, aux = model(to_device(batch, "cpu"))
    assert pred.dtype == loss.dtype == torch.float32
    loss.backward()
    alive = batch["sample_mask"] > 0
    got = pred.detach().numpy()[alive]
    j16, j32 = jx["bfloat16"]["pred"][alive], jx["float32"]["pred"][alive]
    assert (j16 > 0).all()
    np.testing.assert_allclose(got, j16, rtol=0, atol=2e-2)
    np.testing.assert_allclose(float(loss), jx["bfloat16"]["loss"], rtol=1e-2)
    if full:
        np.testing.assert_allclose(float(aux["loss_v"]), jx["bfloat16"]["aux"]["loss_v"],
                                   rtol=1e-2, atol=1e-3)
    # a misplaced rounding point moves the port as far as bf16 moves JAX
    assert np.linalg.norm(got - j16) <= 0.5 * np.linalg.norm(j16 - j32), (
        np.linalg.norm(got - j16), np.linalg.norm(j16 - j32))
    grads = _flat(params_to_jax({n: p.grad for n, p in model.named_parameters()
                                 if p.grad is not None}))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(np.isfinite(v).all() for v in grads.values())
    _grads_close(grads, jx["bfloat16"]["grads"])


def test_bf16_train_step_matches_jax_loss_and_keeps_f32_masters(umpr_r):
    sd, emb, batch, jx = umpr_r
    model = _port_model(sd, emb, False)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(model, 1e-3, 1e-3)
    loss, n_real = train_step(model, opt, to_device(batch, "cpu"), 1e-3)
    np.testing.assert_allclose(float(loss), jx["bfloat16"]["loss"], rtol=1e-2)
    assert float(n_real) == B - 1
    moved = 0
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and torch.isfinite(p).all()
        moved += int(not torch.equal(p.detach(), before[n]))
    assert moved == sum(p.requires_grad for p in model.parameters())


class _W2v:
    def __init__(self, emb):
        self.embedding = emb
        self.vocab = ["<PAD>", "<UNK>", "<NUM>"] + [f"w{i}" for i in range(3, len(emb))]
        self.word2index = {w: i for i, w in enumerate(self.vocab)}


def test_predictor_bf16_serves_within_the_f32_bounds(umpr_r, tmp_path):
    """The Predictor under --compute_dtype bfloat16 against the same
    checkpoint served in f32: within the JAX package's bf16-vs-f32 bound
    (predictions 0.08), and equal to the bf16 model's own forward."""
    from tests.test_checkpoint_loader import small_dataset

    sd, emb, _, _ = umpr_r
    ckpt.save_best(str(tmp_path), _port_model(sd, emb, False, "float32"))
    flags = ["--device", "cpu", "--review_net_only", "True", "--batch_size", "4",
             "--max_sent_count", "6", "--max_sent_length", "10", "--self_atte_size", "16"]
    ds = small_dataset(n=5, S=6, L=10)
    preds = {}
    for dt in ("float32", "bfloat16"):
        predictor = serve.Predictor(Config(flags + ["--compute_dtype", dt]), _W2v(emb),
                                    str(tmp_path))
        preds[dt], rows = predictor.predict_dataset(ds)
    assert preds["bfloat16"].dtype == np.float32 and np.isfinite(preds["bfloat16"]).all()
    np.testing.assert_allclose(preds["bfloat16"], preds["float32"], rtol=0, atol=0.08)
    assert not np.array_equal(preds["bfloat16"], preds["float32"])


def test_bf16_training_resident_equals_streaming(tmp_path):
    """bf16 UMPR-R through main on the resident corpus (the default
    --device_dataset auto, as a graph path of 2 steps on the CPU) and
    streaming: the same parameters, bit for bit; the uint8/int32 corpus is
    cast inside the step."""
    from chip_smoke import write_splits
    from umpr_tpu_torch import main as port_main

    glove = write_splits(tmp_path, seed=3, shards=4, users=6, items=6, per_user=4,
                         vocab=300, dim=8)
    params = {}
    for mode in ("auto", "off"):
        trainer = port_main.main([
            "--device", "cpu", "--review_net_only", "True", "--compute_dtype", "bfloat16",
            "--data_dir", str(tmp_path), "--word2vec_file", str(glove), "--train_epochs", "1",
            "--batch_size", "8", "--max_sent_count", "6", "--max_sent_length", "10",
            "--min_sent_count", "3", "--self_atte_size", "16", "--cache_dataset", "False",
            "--device_dataset", mode, "--steps_per_dispatch", "2", "--eval_every", "2",
            "--model_path", str(tmp_path / mode), "--log_path", str(tmp_path / f"{mode}.txt")])
        assert trainer._resident == (mode == "auto")
        params[mode] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        assert all(p.dtype == torch.float32 for p in params[mode].values())
    for n, p in params["auto"].items():
        assert torch.equal(p, params["off"][n]), n
