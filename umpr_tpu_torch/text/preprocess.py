"""Offline corpus preprocessor: raw Amazon/Yelp dumps -> train/valid/test
CSVs and photos.json (port of umpr_tpu/text/preprocess.py, the same files
byte for byte).

    python -m umpr_tpu_torch.text.preprocess --data_type amazon \\
        --data_path reviews.json.gz --meta_path meta.json.gz --save_dir data/music

As the reference preprocessor (data/data_process.py): the same column
mapping, the same review cleaning (lowercase, punctuation -> space keeping
'.', word/punctuation tokenizing, stop-word removal), the same seeded
80/10/10 split (random_state 3 then 4, data_process.py:52-53), the same
CSV layout, and the same photos.json manifest from Amazon metadata
(data_process.py:67-84).  Raw lines are parsed as JSON, then with
``ast.literal_eval`` (never ``eval``, which the reference uses).

The port depends on neither sklearn nor nltk, so it keeps its own copy of
the two pieces the JAX package takes from them:
- ``_train_test_split``: sklearn's ``train_test_split(df, test_size,
  random_state)`` on a DataFrame (its ShuffleSplit: ceil(test_size * n)
  test rows, one RandomState permutation, test rows first);
- ``_word_punct_tokenize``: nltk's ``WordPunctTokenizer().tokenize``,
  the regex ``\\w+|[^\\w\\s]+``.
This module is host code: it makes no device call.
"""

from __future__ import annotations

import argparse
import ast
import gzip
import json
import math
import os
import re
import time
import uuid

import numpy as np
import pandas as pd

from umpr_tpu_torch.text.stoplists import PUNCTUATIONS, STOP_WORDS

AMAZON_COLS = ["reviewerID", "asin", "reviewText", "overall"]
YELP_COLS = ["user_id", "business_id", "text", "stars"]

_WORD_PUNCT = re.compile(r"\w+|[^\w\s]+")


def _word_punct_tokenize(s):
    """Runs of word characters and runs of other non-space characters, in
    order (nltk's WordPunctTokenizer)."""
    return _WORD_PUNCT.findall(s)


def _train_test_split(df, test_size, random_state):
    """(train, test) rows of `df` as sklearn's train_test_split(df,
    test_size=test_size, random_state=random_state) gives them: n_test =
    ceil(test_size * n), n_train = n - n_test, one RandomState(random_state)
    permutation p, test = p[:n_test], train = p[n_test:n_test + n_train].
    Raises ValueError where sklearn does: a test_size outside (0, 1), or a
    split that leaves the train set empty (n = 0 or 1)."""
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n = len(df)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and train_size=None, the "
            "resulting train set will be empty. Adjust any of the aforementioned "
            "parameters.")
    perm = np.random.RandomState(random_state).permutation(n)
    return df.iloc[perm[n_test:n_test + n_train]], df.iloc[perm[:n_test]]


def _open_maybe_gz(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="UTF-8")
    return open(path, "r", encoding="UTF-8")


def _parse_line(line):
    """Amazon dumps are python-literal dicts; Yelp dumps are JSON."""
    try:
        return json.loads(line)
    except (json.JSONDecodeError, ValueError):
        return ast.literal_eval(line)


def clean_review(review, punctuations=None, stop_words=STOP_WORDS):
    """Lowercase, replace punctuation (except '.') with spaces, split into
    words and punctuation runs, drop stop words (reference:
    data_process.py:40-47)."""
    if punctuations is None:
        punctuations = PUNCTUATIONS - {"."}
    review = review.lower()
    for p in punctuations:
        review = review.replace(p, " ")
    return " ".join(w for w in _word_punct_tokenize(review) if w not in stop_words)


def process_dataset(reviews_path, meta_path, save_dir, train_rate, select_cols):
    os.makedirs(save_dir, exist_ok=True)

    print(f"#### Read {reviews_path}")
    data = []
    with _open_maybe_gz(reviews_path) as f:
        for line in f:
            item = _parse_line(line)
            data.append([item[c] for c in select_cols])
    df = pd.DataFrame(data, columns=["userID", "itemID", "review", "rating"])

    # dense integer ids per user/item: pandas ngroup, as the reference
    # (data_process.py:31-32)
    df["user_num"] = df.groupby(df["userID"]).ngroup()
    df["item_num"] = df.groupby(df["itemID"]).ngroup()

    # null reviews go BEFORE cleaning (reference order: data_process.py:49-50)
    df = df.drop(df[[not isinstance(x, str) or len(x) == 0 for x in df["review"]]].index)
    punct = PUNCTUATIONS - {"."}
    df["review"] = df["review"].apply(lambda r: clean_review(r, punct))

    # seeded two-stage split: the seeds ARE the dataset definition
    # (reference: data_process.py:52-53)
    train, valid = _train_test_split(df, test_size=1 - train_rate, random_state=3)
    valid, test = _train_test_split(valid, test_size=0.5, random_state=4)
    train.to_csv(os.path.join(save_dir, "train.csv"), index=False)
    valid.to_csv(os.path.join(save_dir, "valid.csv"), index=False)
    test.to_csv(os.path.join(save_dir, "test.csv"), index=False)
    print(
        f'#### Saved dataset({len(df)} reviews, {len(df["user_num"].drop_duplicates())} users, '
        f'{len(df["item_num"].drop_duplicates())} items): '
        f"train.csv({len(train)}), valid.csv({len(valid)}), test.csv({len(test)})"
    )

    # the photo manifest from Amazon metadata: business_id/photo_id/imUrl
    # rows with fresh uuid photo names (reference: data_process.py:67-84)
    try:
        print(f"#### Read {meta_path}")
        photos = []
        items_set = set(df["itemID"])
        with _open_maybe_gz(meta_path) as f:
            for line in f:
                item = _parse_line(line)
                if "imUrl" in item and item.get("asin") in items_set:
                    photos.append([item["asin"], uuid.uuid4().hex[:16], item["imUrl"]])
        photo_df = pd.DataFrame(photos, columns=["business_id", "photo_id", "imUrl"])
        photo_df.to_json(os.path.join(save_dir, "photos.json"), orient="records", lines=True)
        print(f"#### Saved photos.json({len(photos)} pictures).")
    except Exception:
        print(f"#### Failed to read {meta_path} or its content is damaged.")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_type", dest="data_type", default="amazon")
    parser.add_argument("--data_path", dest="data_path", required=True)
    parser.add_argument("--meta_path", dest="meta_path", default="")
    parser.add_argument("--save_dir", dest="save_dir", default=None)
    parser.add_argument("--train_rate", dest="train_rate", default=0.8)
    args = parser.parse_args(argv)

    col_name = YELP_COLS if args.data_type == "yelp" else AMAZON_COLS
    if args.save_dir is None:
        args.save_dir = os.path.dirname(args.data_path) if "/" in args.data_path else "./"
    os.makedirs(args.save_dir, exist_ok=True)

    start = time.perf_counter()
    process_dataset(args.data_path, args.meta_path, args.save_dir, float(args.train_rate),
                    col_name)
    print(f"## preprocess: Data loading complete! Time used "
          f"{time.perf_counter() - start:.0f} seconds.")


if __name__ == "__main__":
    main()
