"""Dataset construction: CSV rows -> filtered samples -> static-shape arrays.

Port of the full-memory python path of umpr_tpu/data/dataset.py.  Sample
selection follows the reference's order-dependent filters exactly:

1. tokenize each review into sentences of word ids, truncate each to
   max_sent_length and drop sentences of <= 5 tokens; a review with no
   sentence left drops its sample;
2. resolve per-view photo paths; an item lacking a photo in any view drops
   its samples;
3. user histories (the user's sentences from OTHER items): fewer than
   min_sent_count drops the sample, otherwise the longest max_sent_count
   are kept;
4. the same for item histories;
5. the u->i review keeps its longest max_ui_sent_count sentences.

A sample dropped by an earlier step is not examined by later ones.  The
result is packed into dense arrays: tokens (N, S, L), lengths (N, S) with
pad sentences of length 1, counts (N,).  The native C++ tokenizer and the
streaming build of the JAX package are ROADMAP A5; they give the same
arrays.

``UMPRDataset.save`` / ``load`` are the JAX package's split cache: a
directory of one ``.npy`` per field and a ``complete.marker``, loaded as
read-only memmaps, or a legacy ``.npz``; either package reads the
other's.
"""

from __future__ import annotations

import os
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import pandas as pd


@dataclass
class UMPRDataset:
    """Packed dataset. All arrays are static-shape numpy."""

    u_tokens: np.ndarray   # (N, S, L) int32 word ids of user-history sentences
    u_lengths: np.ndarray  # (N, S) int32 token counts, pad sentences -> 1
    u_counts: np.ndarray   # (N,) int32 real sentence count per sample
    i_tokens: np.ndarray   # (N, S, L)
    i_lengths: np.ndarray  # (N, S)
    i_counts: np.ndarray   # (N,)
    ui_tokens: np.ndarray  # (N, S_ui, L)
    ui_lengths: np.ndarray # (N, S_ui)
    ui_counts: np.ndarray  # (N,)
    ratings: np.ndarray    # (N,) float32
    photo_paths: np.ndarray  # (N, V, P) unicode paths; '' = no file
    source_rows: np.ndarray = None  # (N,) int64 input row of each sample

    def __post_init__(self):
        if self.source_rows is None:
            self.source_rows = np.arange(len(self.u_tokens), dtype=np.int64)

    def __len__(self):
        return self.u_tokens.shape[0]

    def save(self, path):
        """A directory: one .npy per field, then ``complete.marker``; a
        path ending in .npz: the legacy single file (uncompressed)."""
        if str(path).endswith(".npz"):
            np.savez(path, **{k: getattr(self, k) for k in self.__dataclass_fields__})
            return
        os.makedirs(path, exist_ok=True)
        for k in self.__dataclass_fields__:
            np.save(os.path.join(path, f"{k}.npy"), getattr(self, k))
        with open(os.path.join(path, "complete.marker"), "w") as f:
            f.write("1")

    @classmethod
    def load(cls, path):
        """A saved dataset; a directory's arrays are read-only memmaps.  A
        directory without its marker (a save cut short) raises
        FileNotFoundError, as does a missing path."""
        if os.path.isdir(path):
            if not os.path.exists(os.path.join(path, "complete.marker")):
                raise FileNotFoundError(f"incomplete dataset cache at {path}")
            fields = {}
            for k in cls.__dataclass_fields__:
                p = os.path.join(path, f"{k}.npy")
                if os.path.exists(p):
                    fields[k] = np.load(p, mmap_mode="r")
            return cls(**fields)
        with np.load(path, allow_pickle=False) as z:
            # older caches lack source_rows: it defaults
            return cls(**{k: z[k] for k in cls.__dataclass_fields__ if k in z})


def _tokenize_reviews(df, word2vec, config):
    """Per review: a list of sentences, each a list of word ids."""
    max_len = config.max_sent_length
    sentence_level = config.review_level == "sentence"

    def tok(x):
        text = str(x)
        parts = text.strip(". ").split(".") if sentence_level else [text]
        out = []
        for sent in parts:
            ids = word2vec.sent2indices(sent)[:max_len]
            if len(ids) > 5:
                out.append(ids)
        return out

    return [tok(x) for x in df["review"]]


def _resolve_photos(photo_json, photo_dir, item_ids, retain, views, photo_count):
    """Per-view photo paths per row, or None for a dropped row.  Mutates
    `retain` (a list of bools) in place."""
    photo_df = pd.read_json(photo_json, orient="records", lines=True)
    if "label" not in photo_df.columns:
        photo_df["label"] = views[0]  # amazon manifests carry no label

    groups = defaultdict(dict)
    view_set = set(views)
    for bid, pid, label in zip(photo_df["business_id"].tolist(),
                               photo_df["photo_id"].tolist(),
                               photo_df["label"].tolist()):
        if label in view_set:
            groups[bid].setdefault(label, []).append(pid)

    def resolve(bid):
        item_photos = []
        for label in views:
            pids = groups[bid].get(label, []) if bid in groups else []
            if not pids:
                return None
            sel = [os.path.join(photo_dir, pids[j] + ".jpg")
                   for j in range(min(len(pids), photo_count))]
            sel.extend([""] * (photo_count - len(sel)))  # zero-image slots
            item_photos.append(sel)
        return item_photos

    # resolve each unique id once; a missing id (NaN) factorizes to -1 and
    # drops its row
    codes, uniques = pd.factorize(np.asarray(item_ids, dtype=object))
    resolved = [resolve(bid) for bid in uniques]
    paths = []
    for i, c in enumerate(codes.tolist()):
        p = resolved[c] if (retain[i] and c >= 0) else None
        if p is None:
            retain[i] = False
        paths.append(p)
    return paths


def _build_histories(df, reviews, retain, lead, costar, min_count, max_count):
    """Histories grouped over ALL rows, dropped ones included (the
    reference builds its groups before filtering).  Mutates `retain`."""
    groups = defaultdict(list)
    for lead_id, costar_id, review in zip(df[lead], df[costar], reviews):
        groups[lead_id].append((costar_id, review))

    results = []
    for i, (lead_id, costar_id) in enumerate(zip(df[lead], df[costar])):
        if not retain[i]:
            results.append(None)
            continue
        sentences = [s for cid, r in groups[lead_id] if cid != costar_id for s in r]
        if len(sentences) < min_count:
            retain[i] = False
            results.append(None)
            continue
        if len(sentences) > max_count:
            # stable sort: the reference's list.sort(key=-len) tie-breaking
            sentences = sorted(sentences, key=lambda x: -len(x))[:max_count]
        results.append(sentences)
    return results


def _build_ui(reviews, retain, max_count):
    out = []
    for i, sentences in enumerate(reviews):
        if not retain[i]:
            out.append(None)
            continue
        if len(sentences) > max_count:
            sentences = sorted(sentences, key=lambda x: -len(x))[:max_count]
        out.append(sentences)
    return out


def _pack_reviews(review_lists, max_count, max_len):
    """Ragged [[ids...], ...] per sample -> (N, max_count, max_len) tokens,
    (N, max_count) lengths (pad sentences: one <PAD> token, the reference's
    max(1, len) clamp) and (N,) counts."""
    n = len(review_lists)
    tokens = np.zeros((n, max_count, max_len), dtype=np.int32)
    lengths = np.ones((n, max_count), dtype=np.int32)
    counts = np.fromiter((len(s) for s in review_lists), np.int32, n)
    for i, sents in enumerate(review_lists):
        for j, ids in enumerate(sents):
            ids = ids[:max_len]
            tokens[i, j, :len(ids)] = ids
            lengths[i, j] = max(len(ids), 1)
    return tokens, lengths, counts


def build_dataset(data_path, photo_json, photo_dir, word2vec, config,
                  df=None) -> UMPRDataset:
    """df: optional in-memory DataFrame used INSTEAD of reading data_path
    (the HTTP scorer: a CSV round trip would NA-coerce reviews like "NA")."""
    if df is None:
        df = pd.read_csv(data_path)
    reviews = _tokenize_reviews(df, word2vec, config)
    retain = [len(x) > 0 for x in reviews]

    # the reference resolves photos first, then user, item and ui reviews
    photos = _resolve_photos(photo_json, photo_dir, list(df["itemID"]), retain,
                             config.views, config.photo_count)
    user_hist = _build_histories(df, reviews, retain, "user_num", "item_num",
                                 config.min_sent_count, config.max_sent_count)
    item_hist = _build_histories(df, reviews, retain, "item_num", "user_num",
                                 config.min_sent_count, config.max_sent_count)
    ui = _build_ui(reviews, retain, config.max_ui_sent_count)

    keep = [i for i, r in enumerate(retain) if r]
    S, L, S_ui = config.max_sent_count, config.max_sent_length, config.max_ui_sent_count
    u_tok, u_len, u_cnt = _pack_reviews([user_hist[i] for i in keep], S, L)
    i_tok, i_len, i_cnt = _pack_reviews([item_hist[i] for i in keep], S, L)
    ui_tok, ui_len, ui_cnt = _pack_reviews([ui[i] for i in keep], S_ui, L)

    photos = [photos[i] for i in keep]
    photo_arr = np.asarray(photos, dtype=np.str_) if photos else \
        np.zeros((0, len(config.views), config.photo_count), dtype=np.str_)

    return UMPRDataset(
        u_tokens=u_tok, u_lengths=u_len, u_counts=u_cnt,
        i_tokens=i_tok, i_lengths=i_len, i_counts=i_cnt,
        ui_tokens=ui_tok, ui_lengths=ui_len, ui_counts=ui_cnt,
        ratings=df["rating"].to_numpy(np.float32)[keep],
        photo_paths=photo_arr,
        source_rows=np.asarray(keep, dtype=np.int64),
    )
