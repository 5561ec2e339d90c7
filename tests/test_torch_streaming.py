"""The port's streaming dataset build (--build_chunk_rows, the default
1,000,000) against its full-memory build and the JAX package's
build_dataset, array for array: chunk sizes 1, 7 and 1,000,000, rows
dropped by every filter (an empty review, an item without photos, short
histories), unicode documents and --review_level review.  The mmap_dir
build is a complete cache that main loads on the next run."""

import json
import logging
import random

import numpy as np
import pandas as pd
import pytest

from chip_smoke import write_splits
from tests.test_torch_native import FakeW2v
from umpr_tpu.config import Config as JaxConfig
from umpr_tpu.data.dataset import build_dataset as jax_build_dataset
from umpr_tpu_torch import main as port_main
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.data import dataset as d

WORDS = ("great sound quality album terrible loved fantastic song guitar "
         "drums vocals melody lyric beat bass mix production classic").split()
FIELDS = ("u_tokens", "u_lengths", "u_counts", "i_tokens", "i_lengths", "i_counts",
          "ui_tokens", "ui_lengths", "ui_counts", "ratings", "photo_paths", "source_rows")


def _make_corpus(tmp_path, n_rows=160, n_users=25, n_items=8):
    rng = random.Random(3)
    rows = []
    for _ in range(n_rows):
        u, it = rng.randrange(n_users), rng.randrange(n_items)
        sents = [" ".join(rng.choices(WORDS, k=rng.randint(3, 12)))
                 for _ in range(rng.randint(0, 4))]  # 0: an empty review
        if rng.random() < 0.1 and sents:  # python-routed unicode, spliced in
            sents[0] = "café　" + sents[0]
        rows.append({"userID": f"U{u}", "itemID": f"I{it}",
                     "review": ". ".join(sents) + ("." if sents else ""),
                     "rating": float(rng.randint(1, 5)), "user_num": u, "item_num": it})
    csv = tmp_path / "train.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    with open(tmp_path / "photos.json", "w") as f:
        for it in range(n_items - 1):  # the last item has no photo: dropped
            f.write(json.dumps({"business_id": f"I{it}", "photo_id": f"p{it}"}) + "\n")
    return str(csv), str(tmp_path / "photos.json"), str(tmp_path / "photos")


def _flags(chunk_rows, level):
    return ["--device", "cpu", "--min_sent_count", "3", "--max_sent_count", "6",
            "--max_sent_length", "12", "--build_chunk_rows", str(chunk_rows),
            "--review_level", level]


def _same(a, b):
    assert len(a) == len(b)
    for field in FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("level", ["sentence", "review"])
def test_streaming_equals_full_memory_and_jax(tmp_path, level):
    csv, pj, pdir = _make_corpus(tmp_path)
    w2v = FakeW2v(WORDS)
    full = d.build_dataset(csv, pj, pdir, w2v, Config(_flags(0, level)))
    jax_ds = jax_build_dataset(csv, pj, pdir, w2v, JaxConfig(_flags(0, level)))
    assert 0 < len(full) < 160
    _same(full, jax_ds)
    for chunk in (1, 7, 1000000):
        before = dict(d.PATHS)
        stream = d.build_dataset(csv, pj, pdir, w2v, Config(_flags(chunk, level)))
        assert d.PATHS["streaming"] == before["streaming"] + 1
        assert d.PATHS["full_memory"] == before["full_memory"]
        assert d.PATHS["native_tokenizer"] - before["native_tokenizer"] == -(-160 // chunk)
        _same(stream, full)


def test_every_filter_drops_rows(tmp_path):
    """The corpus reaches each filter: empty reviews, the item without a
    photo and short histories each drop rows the others keep."""
    csv, pj, pdir = _make_corpus(tmp_path)
    w2v = FakeW2v(WORDS)
    df = pd.read_csv(csv)
    ds = d.build_dataset(csv, pj, pdir, w2v, Config(_flags(7, "sentence")))
    kept = set(ds.source_rows.tolist())
    empty = set(np.flatnonzero(df["review"].isna()).tolist())
    no_photo = set(np.flatnonzero(df["item_num"] == 7).tolist())
    assert empty and no_photo and not (kept & (empty | no_photo))
    short = set(range(len(df))) - kept - empty - no_photo
    assert short  # dropped by the history filters alone


def test_streaming_fallback_is_logged_and_counted(tmp_path, monkeypatch, caplog):
    csv, pj, pdir = _make_corpus(tmp_path)
    w2v = FakeW2v(WORDS)
    full = d.build_dataset(csv, pj, pdir, w2v, Config(_flags(0, "sentence")))
    monkeypatch.setattr("umpr_tpu_torch.native.tokenize_flat", lambda *a, **k: None)
    before = dict(d.PATHS)
    with caplog.at_level(logging.WARNING, logger="umpr_tpu_torch.data"):
        ds = d.build_dataset(csv, pj, pdir, w2v, Config(_flags(7, "sentence")))
    assert "streaming dataset build failed" in caplog.text
    assert d.PATHS["full_memory"] == before["full_memory"] + 1
    assert d.PATHS["streaming"] == before["streaming"]
    _same(ds, full)


def test_mmap_dir_is_a_loadable_cache(tmp_path):
    csv, pj, pdir = _make_corpus(tmp_path)
    w2v = FakeW2v(WORDS)
    cache = tmp_path / "cache"
    ds = d.build_dataset(csv, pj, pdir, w2v, Config(_flags(7, "sentence")),
                         mmap_dir=str(cache))
    assert (cache / "complete.marker").exists()
    assert isinstance(ds.u_tokens, np.memmap)
    _same(d.UMPRDataset.load(str(cache)), ds)


def test_main_builds_into_the_cache_then_loads_it(tmp_path, caplog):
    """python -m umpr_tpu_torch.main --device cpu: the first run's streaming
    build writes dataset_<split>.cache as memmaps; the second run loads it."""
    glove = write_splits(tmp_path, seed=2, shards=4, users=6, items=6, per_user=4,
                         vocab=300, dim=8)
    argv = ["--device", "cpu", "--review_net_only", "True", "--data_dir", str(tmp_path),
            "--word2vec_file", str(glove), "--train_epochs", "1", "--batch_size", "8",
            "--max_sent_count", "6", "--max_sent_length", "10", "--min_sent_count", "3",
            "--model_path", str(tmp_path / "run"), "--log_path", str(tmp_path / "log.txt"),
            "--build_chunk_rows", "5"]
    before = dict(d.PATHS)
    port_main.main(argv)
    assert d.PATHS["streaming"] - before["streaming"] == 3
    assert d.PATHS["full_memory"] == before["full_memory"]
    for split in ("train", "valid", "test"):
        assert (tmp_path / f"dataset_{split}.cache" / "complete.marker").exists()
    built = d.UMPRDataset.load(str(tmp_path / "dataset_train.cache"))
    before = dict(d.PATHS)
    port_main.main(argv + ["--test_only", "True"])
    assert d.PATHS == before  # nothing built: the cache was loaded
    log = (tmp_path / "log.txt").read_text()
    assert "Loaded test dataset from" in log
    assert len(built) > 0
