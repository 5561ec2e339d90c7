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
pad sentences of length 1, counts (N,).

Two builds give the same arrays, as in the JAX package.  With
``--build_chunk_rows`` > 0 (default 1,000,000) a CSV is built by
``_build_dataset_streaming``: chunked reads, the native C++ tokenizer's flat
output and the native history builder, optionally straight into ``.npy``
memmaps under ``mmap_dir``.  Otherwise, for in-memory ``df=`` inputs, or
when the streaming build fails, the full-memory build runs: the native
tokenizer and history builder where the library builds, the python path
where it does not.  ``PATHS`` counts which of them ran; every fallback is
logged at WARNING.

``UMPRDataset.save`` / ``load`` are the JAX package's split cache: a
directory of one ``.npy`` per field and a ``complete.marker``, loaded as
read-only memmaps, or a legacy ``.npz``; either package reads the
other's.
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import pandas as pd

from umpr_tpu_torch import native

_log = logging.getLogger("umpr_tpu_torch.data")

# the host paths the builds took, counted like the kernels' launches:
# tokenizer calls (one per chunk when streaming), history builds and builds
PATHS = dict(native_tokenizer=0, python_tokenizer=0, native_histories=0,
             python_histories=0, streaming=0, full_memory=0)


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
    """Per review: a list of sentences, each a list (or int32 array) of
    word ids; with the native tokenizer also its flat output, else None."""
    max_len = config.max_sent_length
    sentence_level = config.review_level == "sentence"

    try:
        fast = native.fast_tokenize_reviews(df["review"], word2vec, max_len,
                                            sentence_level, return_flat=True)
        if fast is not None:
            PATHS["native_tokenizer"] += 1
            return fast
        _log.warning("native tokenizer unavailable; using the python path "
                     "(large corpus builds will be much slower)")
    except Exception as e:
        _log.warning("native tokenizer failed (%s: %s); using the python path",
                     type(e).__name__, e)

    def tok(x):
        text = str(x)
        parts = text.strip(". ").split(".") if sentence_level else [text]
        out = []
        for sent in parts:
            ids = word2vec.sent2indices(sent)[:max_len]
            if len(ids) > 5:
                out.append(ids)
        return out

    PATHS["python_tokenizer"] += 1
    return [tok(x) for x in df["review"]], None


def _resolve_photos(photo_json, photo_dir, item_ids, retain, views, photo_count):
    """Per-view photo paths per row, or None for a dropped row.  Mutates
    `retain` (a list of bools or a uint8 array) in place."""
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
    entry = np.asarray(retain, dtype=bool)  # retain at entry
    paths = [resolved[c] if (r and c >= 0) else None
             for c, r in zip(codes.tolist(), entry.tolist())]
    row_ok = np.zeros(len(codes), dtype=bool)
    if len(codes):
        valid = codes >= 0
        ok = np.asarray([r is not None for r in resolved], dtype=bool)
        row_ok[valid] = ok[codes[valid]] if len(resolved) else False
    bad = entry & ~row_ok
    if isinstance(retain, np.ndarray):
        retain[bad] = 0
    else:
        for i in np.flatnonzero(bad):
            retain[i] = False
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


_PACK_CHUNK_BYTES = 2 << 30  # token-slab bytes per C++ fill call


def _flush_drop(arr):
    """Flush a memmap's dirty pages and drop them from memory (no-op for
    plain arrays): without it every written page stays resident until the
    host runs short."""
    if isinstance(arr, np.memmap):
        import mmap as _mmap
        arr.flush()
        try:
            arr._mmap.madvise(_mmap.MADV_DONTNEED)
        except (AttributeError, ValueError):
            pass


def _build_dataset_streaming(data_path, photo_json, photo_dir, word2vec,
                             config, chunk_rows, mmap_dir=None) -> UMPRDataset:
    """Corpus-scale build in bounded host memory: chunked CSV reads, the
    native tokenizer's flat output (no per-review python lists) and the
    native packers.  The same arrays as the full-memory build
    (tests/test_torch_streaming.py); peak memory is one CSV chunk plus the
    flat and packed arrays.

    With mmap_dir set, the packed arrays are written straight into .npy
    memmaps there in slabs (flushed and dropped from memory), so they never
    sit in memory whole, and the directory is a complete dataset cache."""
    S, L, S_ui = (config.max_sent_count, config.max_sent_length,
                  config.max_ui_sent_count)
    sentence_level = config.review_level == "sentence"

    id_parts, slen_parts, dcount_parts = [], [], []
    users_p, items_p, ratings_p, itemid_p = [], [], [], []
    usecols = ["itemID", "review", "rating", "user_num", "item_num"]
    for chunk in pd.read_csv(data_path, chunksize=chunk_rows, usecols=usecols):
        flat = native.tokenize_flat(chunk["review"], word2vec, L, sentence_level)
        if flat is None:
            raise RuntimeError("native tokenizer unavailable")
        PATHS["native_tokenizer"] += 1
        fids, sstarts, dss = flat
        id_parts.append(fids)
        slen_parts.append(np.diff(sstarts))
        dcount_parts.append(np.diff(dss))
        users_p.append(chunk["user_num"].to_numpy(np.int64))
        items_p.append(chunk["item_num"].to_numpy(np.int64))
        ratings_p.append(chunk["rating"].to_numpy(np.float32))
        itemid_p.append(chunk["itemID"].to_numpy())

    def cat(parts, dtype=None):
        return (np.concatenate(parts) if parts
                else np.zeros(0, dtype or np.int64))

    flat_ids = cat(id_parts, np.int32); del id_parts
    sent_lens = cat(slen_parts); del slen_parts
    doc_counts = cat(dcount_parts); del dcount_parts
    sent_starts = np.zeros(len(sent_lens) + 1, np.int64)
    np.cumsum(sent_lens, out=sent_starts[1:])
    doc_sent_start = np.zeros(len(doc_counts) + 1, np.int64)
    np.cumsum(doc_counts, out=doc_sent_start[1:])
    flat = (flat_ids, sent_starts, doc_sent_start)

    users, items = cat(users_p), cat(items_p)
    ratings = cat(ratings_p, np.float32)
    item_ids = cat(itemid_p, object)
    del users_p, items_p, ratings_p, itemid_p
    n = len(doc_counts)

    # the C++ count pass packs (lead, costar) into one 64-bit key; exact
    # only for non-negative ids < 2^31 (always true for ngroup ids)
    if n and not (users.min() >= 0 and items.min() >= 0
                  and users.max() < 2 ** 31 and items.max() < 2 ** 31):
        raise RuntimeError("group ids outside the composite-key range")

    # same filter order as the reference (dataset.py:29,31,50-73,75-85):
    # empty-review -> photos -> user histories -> item histories -> ui
    retain = (doc_counts > 0).astype(np.uint8)
    photos = _resolve_photos(photo_json, photo_dir, item_ids, retain,
                             config.views, config.photo_count)
    if not native.histories_retain_pass(users, items, doc_sent_start, retain,
                                        config.min_sent_count):
        raise RuntimeError("native history builder unavailable")
    native.histories_retain_pass(items, users, doc_sent_start, retain,
                                 config.min_sent_count)
    keep_arr = np.flatnonzero(retain)
    n_out = len(keep_arr)

    def alloc(field, shape):
        if mmap_dir is None:
            return np.zeros(shape, np.int32)
        return np.lib.format.open_memmap(
            os.path.join(mmap_dir, f"{field}.npy"), mode="w+",
            dtype=np.int32, shape=shape)

    # slab size: bound the dirty-page footprint of each C++ fill call
    # (max(1, ...) also keeps range()'s step nonzero when every row was
    # filtered out -- an empty split must build an empty dataset, not crash)
    step = max(1, n_out) if mmap_dir is None else max(
        1, _PACK_CHUNK_BYTES // (S * L * 4))

    def fill_histories(lead, costar, prefix):
        tok = alloc(f"{prefix}_tokens", (n_out, S, L))
        lng = alloc(f"{prefix}_lengths", (n_out, S))
        cnt = alloc(f"{prefix}_counts", (n_out,))
        index = native.group_index(lead)  # once per direction, not per slab
        for lo in range(0, n_out, step):
            hi = min(lo + step, n_out)
            lng[lo:hi] = 1
            r = native.fast_build_histories(
                lead, costar, flat, retain, config.min_sent_count, S, L,
                rows=keep_arr[lo:hi],
                out=(tok[lo:hi], lng[lo:hi], cnt[lo:hi]), index=index)
            if r is None:
                raise RuntimeError("native history builder unavailable")
            _flush_drop(tok)
            _flush_drop(lng)
        return tok, lng, cnt

    def fill_ui():
        tok = alloc("ui_tokens", (n_out, S_ui, L))
        lng = alloc("ui_lengths", (n_out, S_ui))
        cnt = alloc("ui_counts", (n_out,))
        ui_step = max(1, n_out) if mmap_dir is None else max(
            1, _PACK_CHUNK_BYTES // (S_ui * L * 4))
        for lo in range(0, n_out, ui_step):
            hi = min(lo + ui_step, n_out)
            lng[lo:hi] = 1
            r = native.fast_pack_ui(flat, keep_arr[lo:hi], S_ui, L,
                                    out=(tok[lo:hi], lng[lo:hi], cnt[lo:hi]))
            if r is None:
                raise RuntimeError("native ui packer unavailable")
            _flush_drop(tok)
            _flush_drop(lng)
        return tok, lng, cnt

    u_tok, u_len, u_cnt = fill_histories(users, items, "u")
    i_tok, i_len, i_cnt = fill_histories(items, users, "i")
    ui_tok, ui_len, ui_cnt = fill_ui()

    photos = [photos[i] for i in keep_arr]
    photo_arr = np.asarray(photos, dtype=np.str_) if photos else \
        np.zeros((0, len(config.views), config.photo_count), dtype=np.str_)
    ds = UMPRDataset(
        u_tokens=u_tok, u_lengths=u_len, u_counts=u_cnt,
        i_tokens=i_tok, i_lengths=i_len, i_counts=i_cnt,
        ui_tokens=ui_tok, ui_lengths=ui_len, ui_counts=ui_cnt,
        ratings=ratings[keep_arr], photo_paths=photo_arr,
        source_rows=keep_arr,
    )
    if mmap_dir is not None:
        # the token fields are already on disk; persist the small ones and
        # mark the cache complete so UMPRDataset.load(dir) accepts it
        for field in ("ratings", "photo_paths", "source_rows"):
            np.save(os.path.join(mmap_dir, f"{field}.npy"), getattr(ds, field))
        with open(os.path.join(mmap_dir, "complete.marker"), "w") as f:
            f.write("1")
    PATHS["streaming"] += 1
    return ds


def build_dataset(data_path, photo_json, photo_dir, word2vec, config,
                  mmap_dir=None, df=None) -> UMPRDataset:
    """mmap_dir: optional cache directory; the streaming build then writes
    the packed arrays straight into .npy memmaps there (the directory
    becomes a complete, loadable dataset cache).

    df: optional in-memory DataFrame used INSTEAD of reading data_path
    (the HTTP scorer: a CSV round trip would NA-coerce reviews like "NA").
    In-memory inputs take the full-memory path (they are request-sized)."""
    chunk_rows = config.build_chunk_rows
    if df is None and chunk_rows > 0:
        try:
            if mmap_dir is not None:
                os.makedirs(mmap_dir, exist_ok=True)
            return _build_dataset_streaming(
                data_path, photo_json, photo_dir, word2vec, config,
                chunk_rows, mmap_dir)
        except Exception as e:
            _log.warning("streaming dataset build failed (%s: %s); "
                         "using the full-memory path", type(e).__name__, e)

    PATHS["full_memory"] += 1
    if df is None:
        df = pd.read_csv(data_path)
    reviews, flat = _tokenize_reviews(df, word2vec, config)
    retain = [len(x) > 0 for x in reviews]

    # the reference resolves photos first, then user, item and ui reviews
    photos = _resolve_photos(photo_json, photo_dir, list(df["itemID"]), retain,
                             config.views, config.photo_count)
    S, L, S_ui = config.max_sent_count, config.max_sent_length, config.max_ui_sent_count
    packed = None
    try:
        # the native history builder: count-only retain passes settle the
        # sample set (the python path's order of drops), then the histories
        # of the kept rows are packed compactly
        if flat is None:
            flat = native.flatten_tokenized(reviews)
        retain_arr = np.asarray(retain, np.uint8)
        users = df["user_num"].to_numpy(np.int64)
        items = df["item_num"].to_numpy(np.int64)
        dss = flat[2]
        # the count pass packs (lead, costar) into one 64-bit key: exact
        # for non-negative ids < 2^31 only
        ids_ok = len(users) == 0 or (
            users.min() >= 0 and items.min() >= 0
            and users.max() < 2 ** 31 and items.max() < 2 ** 31)
        if not ids_ok:
            _log.warning("group ids outside the native builder's key range; "
                         "using the python history builder")
        elif native.histories_retain_pass(users, items, dss, retain_arr,
                                          config.min_sent_count):
            native.histories_retain_pass(items, users, dss, retain_arr,
                                         config.min_sent_count)
            keep_arr = np.flatnonzero(retain_arr)
            packed = tuple(native.fast_build_histories(
                lead, costar, flat, retain_arr, config.min_sent_count, S, L,
                rows=keep_arr) for lead, costar in ((users, items), (items, users)))
            retain = retain_arr.astype(bool).tolist()
        else:
            _log.warning("native history builder unavailable; using the "
                         "python path")
    except Exception as e:
        _log.warning("native history builder failed (%s: %s); using the "
                     "python path", type(e).__name__, e)
        packed = None

    if packed is None:
        PATHS["python_histories"] += 1
        user_hist = _build_histories(df, reviews, retain, "user_num", "item_num",
                                     config.min_sent_count, config.max_sent_count)
        item_hist = _build_histories(df, reviews, retain, "item_num", "user_num",
                                     config.min_sent_count, config.max_sent_count)
    else:
        PATHS["native_histories"] += 1
    ui = _build_ui(reviews, retain, config.max_ui_sent_count)

    keep = [i for i, r in enumerate(retain) if r]
    if packed is not None:
        (u_tok, u_len, u_cnt), (i_tok, i_len, i_cnt) = packed
    else:
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
