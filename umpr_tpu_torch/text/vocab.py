"""Vocabulary and word-embedding table (port of umpr_tpu/text/vocab.py).

- ids 0/1/2 are ``<PAD>``/``<UNK>``/``<NUM>`` and carry zero vectors;
- ``sent2indices`` treats '.' as whitespace, maps digit-only tokens to
  ``<NUM>`` and unknown tokens to ``<UNK>``;
- sources: ``glove`` (``word v1 .. vD`` per line); ``word2vec`` (the same
  rows under a ``<count> <dim>`` header, most frequent first, so
  ``vocab_size`` keeps the head); ``gensim`` (a ``gensim.models.Word2Vec
  .save()`` file read without gensim by ``text/gensim_load.py``: the
  reference's count sort and its break once ``len(embedding) >=
  vocab_size``, the 3 reserved rows counted, so it keeps ``vocab_size -
  3`` words); ``arrays`` (an in-memory ``vocab``/``vectors`` pair, the
  pretrainers' skip-gram output: with ``counts`` and ``vocab_size`` sorted
  by count, stably, and cut to ``vocab_size``).  On the glove path a
  pickle is read as a gensim model and a word2vec header as word2vec.

While serving, the embedding rows come from the checkpoint; the file
supplies the token -> id map.
"""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd

from umpr_tpu_torch.text.gensim_load import (extract_keyed_vectors, load_gensim_model,
                                             sniff_pickle)


class Word2vec:
    PAD = "<PAD>"
    UNK = "<UNK>"
    NUM = "<NUM>"

    def __init__(self, emb_path=None, source="glove", vocab_size=0, *,
                 vocab=None, vectors=None, counts=None):
        if source not in ("glove", "word2vec", "gensim", "arrays"):
            raise ValueError("Please set embedding source name correctly")
        self.padding = self.PAD
        self.unknown = self.UNK
        self.number = self.NUM
        self.vocab = [self.PAD, self.UNK, self.NUM]
        self.word2index = {self.PAD: 0, self.UNK: 1, self.NUM: 2}

        if source == "glove":
            if sniff_pickle(emb_path):
                source = "gensim"
            elif _has_word2vec_header(emb_path):
                source = "word2vec"
        if source == "gensim":
            words, vecs = _read_gensim(emb_path, vocab_size)
        elif source == "glove":
            words, vecs = _read_glove(emb_path)
        elif source == "word2vec":
            words, vecs = _read_word2vec_text(emb_path)
            if vocab_size > 0:
                words, vecs = words[:vocab_size], vecs[:vocab_size]
        else:  # arrays: the skip-gram pretrainer's (vocab, vectors, counts)
            words, vecs = list(vocab), np.asarray(vectors, dtype=np.float32)
            if counts is not None and vocab_size > 0:
                order = np.argsort(-np.asarray(counts), kind="stable")[:vocab_size]
                words = [words[i] for i in order]
                vecs = vecs[order]
            elif vocab_size > 0:
                words, vecs = words[:vocab_size], vecs[:vocab_size]

        # the reference's id assignment, quirk included: a duplicate word
        # overwrites its entry without advancing len(word2index), shifting
        # every later word's row by one
        before = len(self.word2index)
        for w in words:
            self.word2index[w] = len(self.word2index)
        self.vocab.extend(words)
        dupes = before + len(words) - len(self.word2index)
        if dupes:
            logging.getLogger().warning(
                f"word2vec file has {dupes} duplicate/reserved words; "
                "matching the reference, every word after the first "
                "duplicate maps to the WRONG embedding row -- deduplicate "
                "the file.")

        dim = vecs.shape[1] if len(vecs) else 0
        self.embedding = np.concatenate(
            [np.zeros((3, dim), dtype=np.float32), vecs.astype(np.float32)], axis=0)
        self.word_dim = dim

    def sent2indices(self, sentence, align_length=0):
        """Whitespace tokens -> ids; truncated and right-padded with <PAD>
        to ``align_length`` when it is > 0."""
        indices = []
        for w in sentence.replace(".", " ").strip().split():
            indices.append(2 if w.isdigit() else self.word2index.get(w, 1))
            if 0 < align_length <= len(indices):
                break
        if 0 < align_length and len(indices) < align_length:
            indices += [0] * (align_length - len(indices))
        return indices


    def pad(self, sequence, pad_length):
        if len(sequence) < pad_length:
            return list(sequence) + [0] * (pad_length - len(sequence))
        return list(sequence)[:pad_length]

    def __len__(self):
        return len(self.embedding)


def _read_gensim(path, vocab_size):
    """A gensim model's words and rows as the reference reads them
    (word2vec.py:54-64): every word in the model dict's stored order, or,
    at ``vocab_size > 0``, stably sorted by count and cut where the table
    (3 reserved rows counted) reaches ``vocab_size`` (at least 1 word)."""
    vocab_dict, vectors = extract_keyed_vectors(load_gensim_model(path))
    items = list(vocab_dict.items())
    if vocab_size > 0:
        items = sorted(items, key=lambda x: x[1].count, reverse=True)[:vocab_size]
    words, rows = [], []
    for w, entry in items:
        words.append(w)
        rows.append(np.asarray(vectors[entry.index], dtype=np.float32))
        if 0 < vocab_size <= 3 + len(rows):
            break
    vecs = (np.stack(rows) if rows
            else np.zeros((0, vectors.shape[1] if vectors.ndim == 2 else 0), np.float32))
    return words, vecs


def _has_word2vec_header(path):
    """True when the first line is exactly ``<count> <dim>``."""
    with open(path, encoding="utf-8") as f:
        tokens = f.readline().split()
    return len(tokens) == 2 and tokens[0].isdigit() and tokens[1].isdigit()


def _read_word2vec_text(path):
    with open(path, encoding="utf-8") as f:
        header = f.readline().split()
    count, dim = int(header[0]), int(header[1])
    words, vecs = _read_glove(path, skip_rows=1)
    if len(words) != count or (len(vecs) and vecs.shape[1] != dim):
        raise ValueError(
            f"word2vec file {path}: header says {count}x{dim}, "
            f"found {len(words)}x{vecs.shape[1] if len(vecs) else 0}")
    return words, vecs


def _read_glove(path, skip_rows=0):
    """``word v1 .. vD`` per line.  pandas' C parser first; irregular files
    (multi-token words, ragged lines) take the line loop."""
    try:
        df = pd.read_csv(path, sep=" ", header=None, quoting=3,
                         na_filter=False, dtype={0: str}, engine="c",
                         skiprows=skip_rows)
        words = df.iloc[:, 0].tolist()
        vecs = df.iloc[:, 1:].to_numpy(dtype=np.float32)
        if np.isfinite(vecs).all():
            return words, vecs
    except (ValueError, pd.errors.ParserError):
        pass
    words, rows = [], []
    dim = None
    deferred = []  # ragged lines seen before the width is known

    def absorb(tokens, d):
        # multi-token words ('. . .'): the vector is the last d fields
        if len(tokens) < d + 1:
            return
        try:
            row = np.asarray(tokens[-d:], dtype=np.float32)
        except ValueError:
            return
        words.append(" ".join(tokens[:-d]))
        rows.append(row)

    with open(path, encoding="utf-8") as f:
        for _ in range(skip_rows):
            f.readline()
        for line in f:
            tokens = line.split()
            if len(tokens) < 2:
                continue
            if dim is None:
                try:
                    row = np.asarray(tokens[1:], dtype=np.float32)
                except ValueError:
                    deferred.append(tokens)
                    continue
                dim = len(row)
                for t in deferred:
                    absorb(t, dim)
                deferred.clear()
                words.append(tokens[0])
                rows.append(row)
                continue
            absorb(tokens, dim)
    vecs = np.stack(rows) if rows else np.zeros((0, 0), np.float32)
    return words, vecs
