"""The port's offline preprocessor (umpr_tpu_torch/text/preprocess.py)
against the JAX package's on seeded raw dumps: train/valid/test.csv and
photos.json byte for byte (the photo ids under one seeded uuid sequence
given to both), the same printed lines; its own split against sklearn's
train_test_split (the exact iloc order, the same ValueError) and its own
tokenizer against nltk's WordPunctTokenizer."""

import filecmp
import gzip
import json
import random
import shutil
import uuid
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
from nltk.tokenize import WordPunctTokenizer
from sklearn.model_selection import train_test_split

from umpr_tpu.text import preprocess as jpre
from umpr_tpu_torch.text import preprocess as pre

WORDS = ("great sound quality album terrible loved unicodeé énergie don't it's "
         "fantastic song guitar drums vocals melody beat 1999 2nd snake_case "
         "a-b x/y (live) \"quoted\" wow!!! hmm... ok? …ellipsis 日本語 naïve "
         "the and is not very").split()
SPLITS = ("train", "valid", "test")


def _review(rng):
    sents = [" ".join(rng.choices(WORDS, k=rng.randint(3, 12)))
             for _ in range(rng.randint(1, 4))]
    return ". ".join(sents) + "."


def write_dump(path, kind, seed, users=14, items=7, per_user=4, quirks=True):
    """A raw dump: Amazon python-literal dicts or Yelp JSON lines, plain or
    gzipped by the name; with `quirks` an empty and a None review (dropped
    before cleaning).  Amazon items are I0..I{items-1}."""
    rng = random.Random(seed)
    cols = pre.YELP_COLS if kind == "yelp" else pre.AMAZON_COLS
    rows = []
    for u in range(users):
        for it in rng.sample(range(items), per_user):
            rows.append([f"U{u}", f"I{it}", _review(rng), float(rng.randint(1, 5))])
    if quirks:
        rows += [["U0", "I0", "", 3.0], ["U1", "I1", None, 2.0]]
    rng.shuffle(rows)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt", encoding="utf-8") as f:
        for r in rows:
            item = dict(zip(cols, r))
            f.write((json.dumps(item) if kind == "yelp" else repr(item)) + "\n")
    return path


def write_meta(path, seed, items=7):
    """Amazon metadata: most items with an imUrl, some without, some not
    reviewed at all."""
    rng = random.Random(seed)
    with open(path, "w", encoding="utf-8") as f:
        for it in range(items + 3):
            item = {"asin": f"I{it}", "title": f"album {it}"}
            if rng.random() < 0.8:
                item["imUrl"] = f"http://example.invalid/{it}.jpg"
            f.write(repr(item) + "\n")
    return path


def _uuids(seed):
    rng = random.Random(seed)
    return SimpleNamespace(uuid4=lambda: uuid.UUID(int=rng.getrandbits(128), version=4))


def _run_both(monkeypatch, capsys, tmp_path, fn_jax, fn_port, uuid_seed=5):
    """Run the JAX package's function, then the port's, each under the
    same seeded uuid sequence; -> (jax stdout, port stdout)."""
    outs = []
    for mod, fn in ((jpre, fn_jax), (pre, fn_port)):
        monkeypatch.setattr(mod, "uuid", _uuids(uuid_seed))
        capsys.readouterr()
        fn()
        outs.append(capsys.readouterr().out)
    return outs


def _same_files(a, b, names):
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), f"{name} differs"


@pytest.mark.parametrize("kind,name,rate,meta", [
    ("amazon", "reviews.json", 0.8, True),
    ("amazon", "reviews.json.gz", 0.8, True),
    ("amazon", "reviews.json", 0.7, False),
    ("yelp", "review.json", 0.8, False),
    ("yelp", "review.json.gz", 0.7, False),
])
def test_process_dataset_byte_identical_to_jax(monkeypatch, capsys, tmp_path, kind, name,
                                               rate, meta):
    raw = write_dump(tmp_path / name, kind, seed=len(name) + int(rate * 10))
    meta_path = str(write_meta(tmp_path / "meta.json", seed=3)) if meta else \
        str(tmp_path / "no_meta.json")
    cols = pre.YELP_COLS if kind == "yelp" else pre.AMAZON_COLS
    j, p = tmp_path / "jax", tmp_path / "port"
    out_j, out_p = _run_both(
        monkeypatch, capsys, tmp_path,
        lambda: jpre.process_dataset(str(raw), meta_path, str(j), rate, cols),
        lambda: pre.process_dataset(str(raw), meta_path, str(p), rate, cols))
    assert out_p == out_j
    _same_files(j, p, [f"{s}.csv" for s in SPLITS] + (["photos.json"] if meta else []))
    if meta:
        photos = pd.read_json(p / "photos.json", orient="records", lines=True)
        assert len(photos) > 0 and photos["photo_id"].str.len().eq(16).all()
    else:  # the catch-all's line, and no manifest
        assert f"#### Failed to read {meta_path} or its content is damaged." in out_p
        assert not (p / "photos.json").exists()
    train = pd.read_csv(p / "train.csv")
    assert list(train.columns) == ["userID", "itemID", "review", "rating", "user_num",
                                   "item_num"]
    n = sum(len(pd.read_csv(p / f"{s}.csv")) for s in SPLITS)
    assert n == 14 * 4  # the two quirk rows dropped


def test_cli_matches_jax_main(monkeypatch, capsys, tmp_path):
    """main([...]) of both packages with the default --save_dir (the dump's
    directory) and --train_rate given as a string, as the CLI gets it."""
    data = tmp_path / "data"
    data.mkdir()
    raw = write_dump(data / "reviews.json.gz", "amazon", seed=21)
    meta = write_meta(data / "meta.json", seed=4)
    argv = ["--data_path", str(raw), "--meta_path", str(meta), "--train_rate", "0.7"]
    names = [f"{s}.csv" for s in SPLITS] + ["photos.json"]

    def stash():
        (tmp_path / "jax").mkdir()
        for n in names:
            shutil.move(data / n, tmp_path / "jax" / n)

    out_j, out_p = _run_both(monkeypatch, capsys, tmp_path,
                             lambda: (jpre.main(argv), stash()), lambda: pre.main(argv))
    drop_time = lambda out: [ln for ln in out.splitlines() if "Time used" not in ln]
    assert drop_time(out_p) == drop_time(out_j)
    assert "## preprocess: Data loading complete! Time used" in out_p
    _same_files(tmp_path / "jax", data, names)


def _index_order(parts):
    return [list(part.index) for part in parts]


@pytest.mark.parametrize("test_size", [1 - 0.8, 1 - 0.7, 1 - 0.9, 0.5])
def test_split_equals_sklearn(test_size):
    """The exact iloc order of both sides at n = 0..200 and a few large n,
    seeds 3 and 4, and a ValueError wherever sklearn raises one."""
    raised = 0
    for n in [*range(201), 1001, 4567, 65000]:
        df = pd.DataFrame({"x": np.arange(n)}, index=np.arange(n) * 7 + 1)
        for seed in (3, 4):
            try:
                want = train_test_split(df, test_size=test_size, random_state=seed)
            except ValueError:
                raised += 1
                with pytest.raises(ValueError):
                    pre._train_test_split(df, test_size, seed)
                continue
            got = pre._train_test_split(df, test_size, seed)
            assert _index_order(got) == _index_order(want), (n, seed)
    assert raised == 4  # n = 0 and 1, both seeds


def test_tokenizer_equals_nltk():
    rng = random.Random(0)
    alphabet = ("abcXYZ019_'’-.,;:!?…—–\"()[]/\\@#$%&*+= \t\n"
                "éüßçøÅ日本語한국어αβγ€£¥©®™½¹²😀")
    nltk = WordPunctTokenizer()
    cases = ["don't stop", "it's 1999's best", "snake_case__x", "a...b!!!c", "“quoted”",
             "naïve café", "日本語のテキスト。", "", "   ", "x’y", "¿qué?"]
    cases += ["".join(rng.choices(alphabet, k=rng.randint(0, 40))) for _ in range(2000)]
    for s in cases:
        assert pre._word_punct_tokenize(s) == nltk.tokenize(s), repr(s)


def test_clean_review_matches_jax():
    rng = random.Random(2)
    for _ in range(200):
        r = _review(rng).upper() if rng.random() < 0.3 else _review(rng)
        assert pre.clean_review(r) == jpre.clean_review(r)
