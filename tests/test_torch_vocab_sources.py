"""The port's ``Word2vec`` sources against the JAX package's: ``arrays``
(the pretrainers' skip-gram output) and ``gensim`` (a ``Word2Vec.save()``
file read without gensim, written here by tests/test_gensim_load.py's
wire-format writers), with ``vocab``, ``word2index`` and ``embedding``
compared exactly."""

import pickle

import numpy as np
import pytest

from tests.test_gensim_load import WORDS, _gensim_wire_modules, make_model_file
from umpr_tpu.text.vocab import Word2vec as JaxWord2vec
from umpr_tpu_torch.text.gensim_load import load_gensim_model
from umpr_tpu_torch.text.vocab import Word2vec


def _assert_same(ours, theirs):
    assert ours.vocab == theirs.vocab
    assert ours.word2index == theirs.word2index
    assert ours.embedding.dtype == theirs.embedding.dtype == np.float32
    np.testing.assert_array_equal(ours.embedding, theirs.embedding)
    assert len(ours) == len(theirs) and ours.word_dim == theirs.word_dim
    assert (ours.padding, ours.unknown, ours.number) == (theirs.padding, theirs.unknown,
                                                         theirs.number)
    for seq, n in (([5, 6], 4), ([1, 2, 3, 4, 5], 3), ([], 2)):
        assert ours.pad(seq, n) == theirs.pad(seq, n)
    for s in ("alpha beta 12 unknownword", "gamma. delta", ""):
        assert ours.sent2indices(s, 5) == theirs.sent2indices(s, 5)


def _arrays(duplicate=False):
    rng = np.random.default_rng(0)
    vocab = list(WORDS) + (["beta", "<UNK>"] if duplicate else [])
    vectors = rng.standard_normal((len(vocab), 4)).astype(np.float32)
    counts = rng.integers(1, 50, len(vocab))
    counts[2] = counts[5]  # a tie: the stable sort keeps the file order
    return vocab, vectors, counts


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("vocab_size", [0, 6, 50])
@pytest.mark.parametrize("duplicate", [False, True])
def test_arrays_source_matches_jax(with_counts, vocab_size, duplicate):
    vocab, vectors, counts = _arrays(duplicate)
    kw = dict(source="arrays", vocab_size=vocab_size, vocab=vocab, vectors=vectors,
              counts=counts if with_counts else None)
    _assert_same(Word2vec(**kw), JaxWord2vec(**kw))


@pytest.mark.parametrize("vocab_size", [0, 5, 8, 1000])
@pytest.mark.parametrize("sidecar", [False, True])
def test_gensim3_source_matches_jax(tmp_path, vocab_size, sidecar):
    path = str(tmp_path / "w2v.model")
    make_model_file(path, WORDS, sidecar=sidecar)
    ours = Word2vec(path, source="gensim", vocab_size=vocab_size)
    _assert_same(ours, JaxWord2vec(path, source="gensim", vocab_size=vocab_size))
    if 0 < vocab_size <= len(WORDS):
        # the reference's quirk: the loop stops once the table (3 reserved
        # rows counted) reaches vocab_size, so vocab_size - 3 words remain
        assert len(ours.vocab) == len(ours) == vocab_size


@pytest.mark.parametrize("vocab_size", [0, 5])
def test_gensim4_layout_matches_jax(tmp_path, vocab_size):
    path = str(tmp_path / "kv4.model")
    vectors = np.random.default_rng(1).standard_normal((4, 5)).astype(np.float32)
    with _gensim_wire_modules() as (_, kv_mod):
        kv = kv_mod.Word2VecKeyedVectors.__new__(kv_mod.Word2VecKeyedVectors)
        kv.__dict__.update(key_to_index={"w0": 0, "w1": 1, "w2": 2, "w3": 3},
                           index_to_key=["w0", "w1", "w2", "w3"], vectors=vectors,
                           expandos={"count": np.array([5, 9, 7, 3])})
        with open(path, "wb") as f:
            pickle.dump(kv, f, protocol=2)
    ours = Word2vec(path, source="gensim", vocab_size=vocab_size)
    _assert_same(ours, JaxWord2vec(path, source="gensim", vocab_size=vocab_size))
    assert ours.vocab[3:] == (["w0", "w1", "w2", "w3"] if vocab_size == 0 else ["w1", "w2"])


@pytest.mark.parametrize("source", ["glove", "gensim"])
def test_gensim_model_is_detected_on_the_glove_path(tmp_path, source):
    path = str(tmp_path / "w2v.model")
    expected = make_model_file(path, WORDS, sidecar=True)
    ours = Word2vec(path) if source == "glove" else Word2vec(path, source="gensim")
    _assert_same(ours, JaxWord2vec(path))
    assert ours.vocab[3:] == WORDS
    np.testing.assert_array_equal(ours.embedding[3 + WORDS.index("gamma")], expected["gamma"])


def test_word2vec_text_is_cut_at_vocab_size_as_jax(tmp_path):
    rng = np.random.default_rng(2)
    rows = [w + " " + " ".join(f"{x:.5f}" for x in rng.standard_normal(3)) for w in WORDS]
    path = tmp_path / "emb.txt"
    path.write_text(f"{len(WORDS)} 3\n" + "\n".join(rows) + "\n")
    for vocab_size in (0, 4):
        ours = Word2vec(str(path), vocab_size=vocab_size)
        _assert_same(ours, JaxWord2vec(str(path), vocab_size=vocab_size))
    assert ours.vocab[3:] == WORDS[:4]


@pytest.mark.parametrize("evil", [
    b"\x80\x02cos\nsystem\nq\x00.",            # GLOBAL os.system
    b"\x80\x02cbuiltins\neval\nq\x00.",        # a whitelisted module is not enough
    b"\x80\x02cbuiltins\ngetattr\nq\x00.",
    b"\x80\x02cnumpy\nload\nq\x00.",           # numpy callables beyond ndarray
])
def test_unpickler_rejects_arbitrary_globals(tmp_path, evil):
    path = tmp_path / "evil.model"
    path.write_bytes(evil)
    with pytest.raises(pickle.UnpicklingError):
        load_gensim_model(str(path))
    with pytest.raises(pickle.UnpicklingError):
        Word2vec(str(path))  # sniffed as a gensim model on the glove path


def test_unknown_source_raises():
    with pytest.raises(ValueError, match="source"):
        Word2vec("x", source="fasttext")
