"""The port's pretrainers (umpr_tpu_torch/pretrain) against the JAX
package's on the CPU: skip-gram vectors, ABAE, pair mining, the R-Net
pretrainer, the port's k-means against sklearn, the three CLIs, and the
checkpoints crossing between the packages.

torch cannot reproduce ``jax.random``, so every comparison starts both
packages from the same weights: the JAX functions' inits are replaced
inside the test by the port's weights (``convert.params_to_jax``); the
numpy ``default_rng`` draws (permutations, negatives, candidates) are the
same call for call.  The per-step losses of the JAX loops are read by
wrapping ``jax.jit`` inside the test.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.cluster import KMeans as SkKMeans

from chip_smoke import log_lines
from umpr_tpu.config import Config as JaxConfig
from umpr_tpu.models.review_net import init_rnet
from umpr_tpu.pretrain import abae as jabae
from umpr_tpu.pretrain import rnet as jrnet
from umpr_tpu.pretrain import word2vec_train as jw2v
from umpr_tpu.text.vocab import Word2vec as JaxWord2vec
from umpr_tpu.train import checkpoint as jckpt
from umpr_tpu.train.trainer import Trainer as JaxTrainer
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import params_from_jax, params_to_jax
from umpr_tpu_torch.pretrain import abae as pabae
from umpr_tpu_torch.pretrain import rnet as prnet
from umpr_tpu_torch.pretrain import word2vec_train as pw2v
from umpr_tpu_torch.pretrain.kmeans import KMeans
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train import checkpoint as ckpt
from umpr_tpu_torch.train.trainer import Trainer

E, H, K = 16, 8, 3  # word width, GRU width, aspects
RTOL = 1e-5
# Two ABAE leaves held at 1e-4 after training.  M's f32 gradient, a sum
# that cancels through the attention softmax, lies 4.4e-4 (JAX) and 2.3e-4
# (port) from float64 at the first step, every other leaf's under 2e-5
# (test_abae_gradient_rounding_is_largest_in_m); Adam carries the gap
# into M (2.6e-5 after 2 epochs at batch 64) and through it into fc.bias,
# which starts at 0 and stays small (l2 norm 0.0076 against 0.9-15 for
# the other leaves), so the same absolute gap is its largest relative one
# (4.5e-5).  Every other leaf after 2 epochs: under 4e-6.
ABAE_LEAF_RTOL = {"['M']": 1e-4, "['fc']['bias']": 1e-4}


def topic_corpus(n=300, seed=0):
    """Sentences of 4-9 words, each from one of 4 topics of 8 words: every
    word far above min_count 10."""
    rng = np.random.default_rng(seed)
    topics = [[f"t{t}w{i}" for i in range(8)] for t in range(4)]
    return [" ".join(rng.choice(topics[rng.integers(4)], size=rng.integers(4, 10)))
            for _ in range(n)]


CORPUS = topic_corpus()


@pytest.fixture(scope="module")
def vocabs():
    """(port Word2vec, JAX Word2vec) over the port's skip-gram vectors of
    CORPUS, the same table."""
    vocab, vecs, counts = pw2v.train_skipgram(CORPUS, emb_dim=E, epochs=3, batch_size=256,
                                              device="cpu")
    kw = dict(source="arrays", vocab=vocab, vectors=vecs, counts=counts, vocab_size=50)
    return Word2vec(**kw), JaxWord2vec(**kw)


def _jax_tree(module):
    return jax.tree.map(jnp.asarray, params_to_jax(module.state_dict()))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _l2_rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_trees_close(got, want, rtol=RTOL, per_leaf=None):
    """Each leaf within its tolerance in l2, relative; returns the gaps."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    gaps = {}
    for k in want:
        tol = (per_leaf or {}).get(k, rtol)
        assert got[k].shape == want[k].shape, k
        gaps[k] = _l2_rel(got[k], want[k])
        assert gaps[k] <= tol, (k, gaps[k])
    return gaps


@pytest.fixture
def jax_step_losses(monkeypatch):
    """The JAX train steps' losses, recorded by wrapping jax.jit: every
    jitted call that returns a (params, opt_state, loss) triple."""
    losses, jit = [], jax.jit

    def recording_jit(fn):
        jitted = jit(fn)

        def call(*args):
            out = jitted(*args)
            if isinstance(out, tuple) and len(out) == 3:
                losses.append(float(out[2]))
            return out
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    return losses


def _assert_losses_close(got, want):
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


# ---------------------------------------------------------------- skip-gram


def test_vocab_and_pair_streams_are_the_jax_code():
    assert pw2v.build_vocab(CORPUS, 10)[0] == jw2v.build_vocab(CORPUS, 10)[0]
    np.testing.assert_array_equal(pw2v.build_vocab(CORPUS, 10)[1], jw2v.build_vocab(CORPUS, 10)[1])
    word2id = {w: i for i, w in enumerate(pw2v.build_vocab(CORPUS, 10)[0])}
    ids, sent = pw2v._flat_ids(CORPUS, word2id)
    jids, jsent = jw2v._flat_ids(CORPUS, word2id)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(sent, jsent)
    got = list(pw2v._pair_batches(ids, sent, 5, 100, np.random.default_rng(3)))
    want = list(jw2v._pair_batches(jids, jsent, 5, 100, np.random.default_rng(3)))
    assert len(got) == len(want)
    for (c, o), (jc, jo) in zip(got, want):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(o, jo)


@pytest.mark.parametrize("batch_size", [256, 100000])
def test_skipgram_matches_jax(monkeypatch, jax_step_losses, batch_size):
    """From the same {in, out} and rng: each step's loss (and so each
    epoch's) within 1e-5, the vectors within 1e-5 in l2; 100000 pairs a
    batch is one short batch an epoch."""
    losses = []
    vocab, vecs, counts = pw2v.train_skipgram(CORPUS, emb_dim=E, epochs=2,
                                              batch_size=batch_size, seed=1, device="cpu",
                                              losses=losses)
    start = getattr(pw2v.SkipGram(len(vocab), E, torch.Generator().manual_seed(1)), "in")
    uniform = jax.random.uniform

    def port_init(key, shape, *args, **kw):
        assert tuple(shape) == tuple(start.shape)
        return jnp.asarray(start.detach().numpy())

    monkeypatch.setattr(jax.random, "uniform", port_init)
    jvocab, jvecs, jcounts = jw2v.train_skipgram(CORPUS, emb_dim=E, epochs=2,
                                                 batch_size=batch_size, seed=1)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    assert vocab == jvocab
    np.testing.assert_array_equal(counts, jcounts)
    _assert_losses_close(losses, jax_step_losses)
    assert _l2_rel(vecs, np.asarray(jvecs)) <= RTOL


# --------------------------------------------------------------------- ABAE


def _abae_start(w2v):
    """An ABAE whose aspects are the port's k-means over the words alone.

    Over the whole table the three reserved rows (all zeros) form a
    cluster of their own at this corpus size: an aspect row of exactly 0.
    There the JAX package's norm has a NaN gradient (sqrt at 0) and its
    ABAE step turns every leaf to NaN, where torch's (and the reference's,
    torch too) is finite; test_train_abae_trains_a_zero_aspect_row holds
    the port there."""
    model = pabae.init_abae(0, w2v.embedding, K, kmeans=False, device="cpu")
    km = KMeans(K, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.aspect.copy_(km.fit(torch.from_numpy(w2v.embedding[3:])).cluster_centers_)
    return model


@pytest.mark.parametrize("training", [False, True])
def test_abae_forward_matches_jax(vocabs, training):
    w2v, _ = vocabs
    model = _abae_start(w2v)
    rng = np.random.default_rng(2)
    pos = rng.integers(0, len(w2v), (6, 8))
    neg = rng.integers(0, len(w2v), (6, 3, 8)) if training else None
    with torch.no_grad():
        got = pabae.abae_forward(model, torch.from_numpy(pos),
                                 None if neg is None else torch.from_numpy(neg), 0.1)
    want = jabae.abae_forward(_jax_tree(model), jnp.asarray(pos),
                              None if neg is None else jnp.asarray(neg), 0.1)
    if not training:
        got, want = (got, None), (want, None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    if training:
        assert abs(float(got[1]) - float(want[1])) <= 1e-6


@pytest.mark.parametrize("batch_size", [64, 512])  # 512 > 300 sentences: one short batch
def test_train_abae_matches_jax(vocabs, monkeypatch, jax_step_losses, batch_size):
    w2v, jw2v_ = vocabs
    start = _abae_start(w2v)
    monkeypatch.setattr(pabae, "init_abae", lambda *a, **k: copy.deepcopy(start))
    monkeypatch.setattr(jabae, "init_abae", lambda *a, **k: _jax_tree(start))
    kw = dict(sent_len=8, neg_count=3, batch_size=batch_size, aspect_size=K,
              train_epochs=2, seed=3)
    losses = []
    model = pabae.train_abae(w2v, CORPUS, device="cpu", losses=losses, **kw)
    want = jabae.train_abae(jw2v_, CORPUS, **kw)
    _assert_losses_close(losses, jax_step_losses)
    gaps = _assert_trees_close(params_to_jax(model.state_dict()), want,
                               per_leaf=ABAE_LEAF_RTOL)
    norms = {k: float(np.linalg.norm(v)) for k, v in _leaves(want).items()}
    print(f"ABAE leaves after 2 epochs, port against JAX (l2, relative): {gaps}; "
          f"the JAX leaves' l2 norms {norms}")


def test_abae_gradient_rounding_is_largest_in_m(vocabs):
    """The cause of ABAE_LEAF_RTOL: at the first step M's f32 gradient,
    a sum that cancels through the attention softmax, is the one far from
    the float64 gradient (l2, relative), in both packages: more than 10x
    any other leaf's gap, all of them within 1e-3."""
    w2v, _ = vocabs
    model = _abae_start(w2v)
    data = pabae.sentences_to_ids(w2v, CORPUS[:64], 8)
    neg = data[np.random.default_rng(5).integers(0, 64, (64, 3))]

    def port_grads(m):
        m.zero_grad()
        pabae.abae_forward(m, torch.from_numpy(data).long(), torch.from_numpy(neg).long(),
                           0.1)[1].backward()
        return params_to_jax({n: p.grad.float() for n, p in m.named_parameters()})

    want = _leaves(port_grads(copy.deepcopy(model).double()))
    jax_grads = jax.grad(lambda p: jabae.abae_forward(p, jnp.asarray(data), jnp.asarray(neg),
                                                      0.1)[1])(_jax_tree(model))
    gaps = {}
    for side, grads in (("jax", _leaves(jax_grads)), ("port", _leaves(port_grads(model)))):
        gap = gaps[side] = {k: _l2_rel(grads[k], want[k]) for k in want}
        assert max(gap.values()) <= 1e-3, (side, gap)
        assert all(gap["['M']"] > 10 * v for k, v in gap.items() if k != "['M']"), (side, gap)
    print(f"ABAE first-step gradients against float64 (l2, relative): {gaps}")


def test_train_abae_trains_a_zero_aspect_row(vocabs):
    """The port's own init (k-means over the whole table) puts the three
    zero rows in an aspect of their own, an aspect row of exactly 0; the
    port trains it with finite values and moves it off 0, as torch's
    vector norm (the reference's) allows."""
    w2v, _ = vocabs
    start = pabae.init_abae(0, w2v.embedding, K, device="cpu")
    zero = (start.aspect.norm(dim=-1) == 0).nonzero().flatten().tolist()
    assert zero, "this corpus's k-means was expected to give a zero aspect row"
    model = pabae.train_abae(w2v, CORPUS, sent_len=8, neg_count=3, batch_size=64,
                             aspect_size=K, train_epochs=1, device="cpu")
    for name, p in model.state_dict().items():
        assert torch.isfinite(p).all(), name
    assert (model.aspect[zero].norm(dim=-1) > 0).all()


def test_sample_negatives_and_ids_are_the_jax_code(vocabs):
    w2v, jw = vocabs
    np.testing.assert_array_equal(pabae.sample_negatives(50, 7, np.random.default_rng(4)),
                                  jabae.sample_negatives(50, 7, np.random.default_rng(4)))
    np.testing.assert_array_equal(pabae.sentences_to_ids(w2v, CORPUS[:20], 6),
                                  jabae.sentences_to_ids(jw, CORPUS[:20], 6))


def test_aspect_words_and_evaluation_match_jax(vocabs):
    w2v, jw = vocabs
    model = _abae_start(w2v)
    params = _jax_tree(model)
    assert pabae.get_aspect_words(model, 5) == jabae.get_aspect_words(params, 5)
    labels = ["Food", "Staff"] * 10
    kw = dict(sent_len=8, batch_size=7, aspect_mapping=[0, 1, 0])
    assert (pabae.evaluate_aspects(model, w2v, CORPUS[:20], labels, **kw)
            == jabae.evaluate_aspects(params, jw, CORPUS[:20], labels, **kw))


# -------------------------------------------------------------- pair mining


@pytest.mark.parametrize("n,k,seed", [(400, 20, 0), (37, 20, 1), (5, 20, 2), (0, 20, 4)])
def test_mine_pairs_matches_jax(n, k, seed):
    rng = np.random.default_rng(seed)
    probs = np.abs(rng.standard_normal((n, 7))).astype(np.float32)
    if n >= 8:
        probs[n // 2] = probs[0]      # duplicate rows: exact cosine ties
        probs[n // 2 + 1] = 0.0       # a zero-norm row
    data = rng.integers(0, 50, size=(n, 9))
    got = prnet.mine_pairs(data, probs, np.random.default_rng(seed + 100), sample_k=k,
                           block_size=64)
    want = jrnet.mine_pairs(data, probs, np.random.default_rng(seed + 100), sample_k=k,
                            block_size=64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_cats", [1, 4])  # one category: no pairs
def test_mine_pairs_hard_matches_jax(n_cats):
    rng = np.random.default_rng(5)
    probs = rng.random((120, n_cats)).astype(np.float32)
    data = rng.integers(0, 50, size=(120, 9))
    got = prnet.mine_pairs_hard(data, probs, np.random.default_rng(6))
    want = jrnet.mine_pairs_hard(data, probs, np.random.default_rng(6))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- R-Net


@pytest.mark.parametrize("batch_size", [64, 1024])  # 1024 > 600 pairs: one short batch
def test_pretrain_r_net_matches_jax(vocabs, monkeypatch, jax_step_losses, tmp_path,
                                    batch_size):
    """2 epochs from the same weights: each step's loss and the saved
    R-Net within 1e-5.

    Both sides mine from the JAX package's ABAE probabilities.  The
    port's own are within 1e-6 of them, but this ABAE (untrained) gives
    every sentence nearly the same distribution, so the cosines of a
    sentence's candidates tie to within rounding and the strict running
    max / min of mine_pairs picks other partners on 1e-8 differences."""
    w2v, jw = vocabs
    abae = pabae.init_abae(0, w2v.embedding, K, device="cpu")
    data = pabae.sentences_to_ids(w2v, CORPUS, 10)
    probs = np.asarray(jabae.abae_predict(_jax_tree(abae), data))
    np.testing.assert_allclose(pabae.abae_predict(abae, data), probs, rtol=0, atol=1e-6)
    got_pairs = prnet.mine_pairs(data, probs, np.random.default_rng(0))
    for a, b in zip(got_pairs, jrnet.mine_pairs(data, probs, np.random.default_rng(0))):
        np.testing.assert_array_equal(a, b)
    assert len(got_pairs[0]) == 2 * len(CORPUS)
    monkeypatch.setattr(prnet, "abae_predict", lambda *a, **k: probs)
    monkeypatch.setattr(jrnet, "abae_predict", lambda *a, **k: probs)
    start = prnet.PretrainRNet(w2v.embedding, H, torch.Generator().manual_seed(0))
    monkeypatch.setattr(jrnet, "init_pretrain_rnet", lambda *a, **k: _jax_tree(start))

    kw = dict(gru_size=H, max_length=10, batch_size=batch_size, train_epochs=2)
    losses = []
    model = prnet.pretrain_r_net(w2v, CORPUS, abae, str(tmp_path / "port"), device="cpu",
                                 losses=losses, **kw)
    want = jrnet.pretrain_r_net(jw, CORPUS, None, str(tmp_path / "jax"), **kw)
    _assert_losses_close(losses, jax_step_losses)
    _assert_trees_close(params_to_jax(model.state_dict()), want)
    # each package's saved R-Net read by the other
    like = init_rnet(jax.random.PRNGKey(0), E, H)
    _assert_trees_close(jckpt.restore_pytree(str(tmp_path / "port"), like),
                        params_to_jax(model.rnet.state_dict()), rtol=0)
    rnet = prnet.PretrainRNet(w2v.embedding, H).rnet
    ckpt.restore_module(str(tmp_path / "jax"), rnet)
    _assert_trees_close(params_to_jax(rnet.state_dict()), want["rnet"], rtol=0)


def test_weight_decay_set_equals_jax_no_bias_mask(vocabs):
    from umpr_tpu.train.optim import _no_bias_mask
    from umpr_tpu_torch.train.optim import make_optimizer
    model = prnet.PretrainRNet(vocabs[0].embedding, H)
    opt = make_optimizer(model, 1e-3, 0.01)
    got = {k: bool(v) for k, v in _leaves(params_to_jax(
        {n: torch.tensor(float(d > 0)) for n, d in zip(opt.names, opt.decays)})).items()}
    trainable = {k: v for k, v in jrnet.init_pretrain_rnet(
        jax.random.PRNGKey(0), vocabs[0].embedding, H).items() if k != "embedding"}
    want = {k: bool(v) for k, v in _leaves(_no_bias_mask(trainable)).items()}
    assert got == want and any(want.values()) and not all(want.values())


# ------------------------------------------------------------------ k-means


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_matches_sklearn_from_the_same_centers(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((300, E)) + 2.0 * rng.integers(0, 4, (300, 1))).astype(np.float32)
    init = x[rng.choice(300, 5, replace=False)]
    want = SkKMeans(5, init=init, n_init=1, algorithm="lloyd").fit(x)
    got = KMeans(5, init=init).fit(torch.from_numpy(x))
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_,
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)
    assert got.n_iter_ == want.n_iter_


def test_kmeans_seeded_is_repeatable_and_keeps_its_best_run():
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((200, E))
                          + 3.0 * rng.integers(0, 5, (200, 1))).astype(np.float32))
    a = KMeans(5, generator=torch.Generator().manual_seed(3)).fit(x)
    b = KMeans(5, generator=torch.Generator().manual_seed(3)).fit(x)
    assert torch.equal(a.cluster_centers_, b.cluster_centers_)
    one = [KMeans(5, n_init=1, generator=torch.Generator().manual_seed(s)).fit(x).inertia_
           for s in range(4)]
    assert a.inertia_ <= min(one) * (1 + 1e-6)
    # within 1% of sklearn's best of 10 k-means++ runs on the same data
    assert a.inertia_ <= 1.01 * SkKMeans(5, n_init=10, random_state=0).fit(x.numpy()).inertia_


# --------------------------------------------------------------------- CLIs


def _write_csv(root, sentences, per_review=3):
    os.makedirs(root, exist_ok=True)
    rows = [{"userID": f"U{i % 7}", "itemID": f"I{i % 5}",
             "review": ". ".join(sentences[i:i + per_review]), "rating": float(i % 5 + 1)}
            for i in range(0, len(sentences), per_review)]
    pd.DataFrame(rows).to_csv(os.path.join(root, "train.csv"), index=False)


@pytest.mark.parametrize("module", ["umpr_tpu_torch.pretrain.abae",
                                    "umpr_tpu_torch.pretrain.rnet",
                                    "umpr_tpu_torch.train_embeddings"])
def test_clis_default_to_the_card_and_raise_without_one(tmp_path, module):
    import importlib
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        importlib.import_module(module).main(["--data_dir", str(tmp_path)])


def test_abae_cli_trains_and_saves_the_jax_layout(tmp_path):
    data = tmp_path / "data"
    os.makedirs(data)
    (data / "train.txt").write_text("\n".join(CORPUS))
    save = str(tmp_path / "abae")
    pabae.main(["--device", "cpu", "--data_dir", str(data), "--train_epochs", "2",
                "--batch_size", "64", "--vocab_size", "50", "--aspect_size", str(K),
                "--emb_dim", str(E), "--save_path", save])
    # 32 corpus words + the 3 reserved rows; both packages restore it
    like = jabae.init_abae(jax.random.PRNGKey(0), np.zeros((35, E), np.float32), K, kmeans=False)
    restored = jckpt.restore_pytree(save, like)
    model = pabae.init_abae(1, np.zeros((35, E), np.float32), K, kmeans=False, device="cpu")
    ckpt.restore_module(save, model)
    _assert_trees_close(params_to_jax(model.state_dict()), restored, rtol=0)
    assert np.isfinite(np.asarray(restored["aspect"])).all()


def test_rnet_cli_trains_restores_abae_and_warm_starts_both_trainers(tmp_path):
    """The R-Net CLI twice: the first run trains ABAE (15 epochs) and the
    R-Net, the second restores ABAE from a k-means-free template and
    trains the same R-Net again, bit for bit.  The saved R-Net loads
    through --rnet_pretrained of the port's Trainer and of the JAX
    package's to its own bits, and the JAX package's saved ABAE loads
    into the port."""
    data = tmp_path / "data"
    _write_csv(data, CORPUS)
    save_abae, save_rnet = str(tmp_path / "abae"), str(tmp_path / "rnet")
    argv = ["--device", "cpu", "--data_dir", str(data), "--train_epochs", "1",
            "--batch_size", "64", "--vocab_size", "50", "--aspect_size", str(K),
            "--gru_size", str(H), "--emb_dim", str(E), "--max_length", "10",
            "--save_ABAE", save_abae, "--save_rnet", save_rnet]
    prnet.main(argv)
    like = init_rnet(jax.random.PRNGKey(0), E, H)
    first = jckpt.restore_pytree(save_rnet, like)
    abae_mtime = os.path.getmtime(os.path.join(save_abae, "arrays.npz"))
    prnet.main(argv)
    assert os.path.getmtime(os.path.join(save_abae, "arrays.npz")) == abae_mtime
    _assert_trees_close(jckpt.restore_pytree(save_rnet, like), first, rtol=0)

    table = np.random.default_rng(1).standard_normal((30, E)).astype(np.float32)
    w2v = Word2vec(source="arrays", vocab=[f"x{i}" for i in range(27)], vectors=table[3:])
    flags = ["--review_net_only", "True", "--gru_size", str(H), "--self_atte_size", "8",
             "--rnet_pretrained", save_rnet]
    with log_lines("port-rnet-pretrained") as (lines, logger):
        trainer = Trainer(Config(flags + ["--device", "cpu"]), logger, w2v)
    assert any(f'Loaded R-Net pre-trained weights from "{save_rnet}"' in s for s in lines)
    _assert_trees_close(params_to_jax(trainer.model.review_net.rnet.state_dict()), first,
                        rtol=0)
    with log_lines("jax-rnet-pretrained") as (jlines, jlogger):
        jtrainer = JaxTrainer(JaxConfig(argv=flags + ["--multi_gpu", "False"]), jlogger, w2v)
    assert any(f'Loaded R-Net pre-trained weights from "{save_rnet}"' in s for s in jlines)
    _assert_trees_close(jax.device_get(jtrainer.trainable["review_net"]["rnet"]), first,
                        rtol=0)

    # the JAX package's ABAE checkpoint into the port
    jparams = jabae.init_abae(jax.random.PRNGKey(2), table, K, kmeans=False)
    jckpt.save_pytree(str(tmp_path / "jax_abae"), jparams)
    model = pabae.init_abae(0, table, K, kmeans=False, device="cpu")
    ckpt.restore_module(str(tmp_path / "jax_abae"), model)
    _assert_trees_close(params_to_jax(model.state_dict()), jparams, rtol=0)


def test_train_embeddings_cli_writes_the_jax_tools_file(tmp_path, monkeypatch):
    """From the same initial vectors, the port's CLI (--cpu, the alias of
    --device cpu) and tools/train_embeddings.py write the same words in
    the same order under the same header, values within 1e-5; the port
    reads its file back as those vectors."""
    from tools import train_embeddings as jtool
    data = tmp_path / "data"
    _write_csv(data, CORPUS)
    from umpr_tpu_torch import train_embeddings as tool
    from umpr_tpu_torch.pretrain import train_sentences
    sentences = train_sentences(str(data))
    vocab = pw2v.build_vocab(sentences, 10)[0]
    start = getattr(pw2v.SkipGram(len(vocab), E, torch.Generator().manual_seed(0)), "in")
    tool.main(["--data_dir", str(data), "--emb_dim", str(E), "--epochs", "2", "--cpu",
               "--out", str(tmp_path / "port.txt")])
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(start.detach().numpy()))
    jtool.main(["--data_dir", str(data), "--emb_dim", str(E), "--epochs", "2", "--cpu",
                "--out", str(tmp_path / "jax.txt")])
    got = (tmp_path / "port.txt").read_text().splitlines()
    want = (tmp_path / "jax.txt").read_text().splitlines()
    assert got[0] == want[0] == f"{len(vocab)} {E}"
    assert [s.split()[0] for s in got] == [s.split()[0] for s in want]
    vals = lambda lines: np.array([[float(v) for v in s.split()[1:]] for s in lines[1:]])
    np.testing.assert_allclose(vals(got), vals(want), rtol=0, atol=1e-5)
    w2v = Word2vec(str(tmp_path / "port.txt"))
    assert w2v.vocab[3:] == [s.split()[0] for s in got[1:]]
    np.testing.assert_array_equal(w2v.embedding[3:], vals(got).astype(np.float32))
