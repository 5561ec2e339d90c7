"""The port's own native tokenizer and history builder
(umpr_tpu_torch/native) against the JAX package's native code and the
python path: the same token ids on the documents of tests/test_native.py,
the unicode "risky" ones included, and the same packed histories.  The
library is compiled by g++ at first use into build/native/."""

import logging

import numpy as np
import pandas as pd
import pytest

from tests.test_native import DOCS, WORDS, normalize, python_tokenize
from umpr_tpu import native as jax_native
from umpr_tpu_torch import native
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.data import dataset as d
from umpr_tpu_torch.text.vocab import Word2vec

RISKY = [
    "café naïve sound quality loved album extra",
    "’s curly “quote” sound quality loved album extra",
    "你好 世界 sound quality loved album extra mix",
    "emoji \U0001f60a doc sound quality loved album",
    "nbsp separated sound quality loved album extra",
    "ideographic　space sound quality loved album extra",
    "arabic ٣٤ digits sound quality loved album",
    "superscript ² sound quality loved album extra",
    "plain ascii sound quality loved album extra",
]


class FakeW2v(Word2vec):
    """The port's Word2vec over a word list, ids as the file loader gives
    them (a repeated word overwrites its id without advancing the count)."""

    def __init__(self, words):
        self.vocab = [self.PAD, self.UNK, self.NUM] + list(words)
        self.word2index = {self.PAD: 0, self.UNK: 1, self.NUM: 2}
        for w in words:
            self.word2index[w] = len(self.word2index)
        self.embedding = np.zeros((len(self.vocab), 4), np.float32)


def test_library_builds_under_build_native():
    assert native._load() is not None
    so = native._so_path()
    assert so.startswith(str(native.BUILD_DIR))
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert "umpr_tpu" not in so.replace("umpr_tpu_torch", "")  # not the JAX cache


@pytest.mark.parametrize("docs", ["docs", "risky"])
@pytest.mark.parametrize("sentence_level", [True, False])
@pytest.mark.parametrize("max_len", [20, 7])
def test_port_tokenizer_equals_jax_native_and_python(docs, sentence_level, max_len):
    docs = DOCS if docs == "docs" else RISKY
    w2v = FakeW2v(list(WORDS) + ["café", "naïve", "你好", "’s"])
    port = native.fast_tokenize_reviews(docs, w2v, max_len, sentence_level)
    jax_side = jax_native.fast_tokenize_reviews(docs, w2v, max_len, sentence_level)
    assert port is not None and jax_side is not None
    want = python_tokenize(docs, w2v, max_len, sentence_level)
    assert normalize(port) == want == normalize(jax_side)
    # the flat form splices the python-routed documents in at their place
    flat = native.tokenize_flat(docs, w2v, max_len, sentence_level)
    ref = native.flatten_tokenized(want)
    for a, b in zip(flat, ref):
        np.testing.assert_array_equal(a, b)


def test_duplicate_vocab_words_follow_the_python_ids():
    w2v = FakeW2v(["alpha", "beta", "alpha", "gamma", "delta"])
    assert [w2v.word2index[w] for w in ("alpha", "beta", "gamma", "delta")] == [5, 4, 5, 6]
    docs = ["alpha beta gamma delta alpha beta. delta gamma beta alpha zz 12"]
    assert (normalize(native.fast_tokenize_reviews(docs, w2v, 20, True))
            == python_tokenize(docs, w2v, 20, True))


def test_native_histories_equal_the_python_path():
    """build_histories_packed against the port's python builder: the same
    packed arrays and retain drops, a duplicated (user, item) pair and
    rows without sentences included."""
    rng = np.random.default_rng(3)
    n = 300
    users, items = rng.integers(0, 25, n), rng.integers(0, 12, n)
    users[10], items[10] = users[11], items[11]
    reviews = [[list(rng.integers(3, 50, int(rng.integers(6, 15))))
                for _ in range(int(rng.integers(0, 5)))] for _ in range(n)]
    df = pd.DataFrame({"user_num": users, "item_num": items})
    S, L, MIN = 6, 16, 3
    retain_py = [len(x) > 0 for x in reviews]
    uh = d._build_histories(df, reviews, retain_py, "user_num", "item_num", MIN, S)
    ih = d._build_histories(df, reviews, retain_py, "item_num", "user_num", MIN, S)
    keep = np.flatnonzero(retain_py)
    flat = native.flatten_tokenized(reviews)
    retain = np.asarray([len(x) > 0 for x in reviews], np.uint8)
    native.histories_retain_pass(users, items, flat[2], retain, MIN)
    native.histories_retain_pass(items, users, flat[2], retain, MIN)
    assert retain.astype(bool).tolist() == retain_py
    for lead, costar, hist in ((users, items, uh), (items, users, ih)):
        got = native.fast_build_histories(lead, costar, flat, retain, MIN, S, L, rows=keep)
        want = d._pack_reviews([hist[i] for i in keep], S, L)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_tokenizer_fallback_is_counted_and_logged(monkeypatch, caplog):
    """Without the library the build takes the python tokenizer, logs it
    at WARNING and counts it; the result is the same."""
    w2v = FakeW2v(WORDS)
    df = pd.DataFrame({"review": DOCS})
    cfg = Config(["--device", "cpu"])
    before = dict(d.PATHS)
    fast, flat = d._tokenize_reviews(df, w2v, cfg)
    assert d.PATHS["native_tokenizer"] == before["native_tokenizer"] + 1
    monkeypatch.setattr(native, "_load", lambda: None)
    with caplog.at_level(logging.WARNING, logger="umpr_tpu_torch.data"):
        slow, none = d._tokenize_reviews(df, w2v, cfg)
    assert none is None and "python path" in caplog.text
    assert d.PATHS["python_tokenizer"] == before["python_tokenizer"] + 1
    assert normalize(fast) == [[list(map(int, s)) for s in doc] for doc in slow]
