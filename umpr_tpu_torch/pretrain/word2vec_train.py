"""Corpus word vectors: skip-gram with negative sampling on the device
(port of umpr_tpu/pretrain/word2vec_train.py).

It stands in for the reference's gensim ``Word2Vec(size=emb_dim,
window=5, min_count=10)`` (pretrain_rnet.py:237-240, abae.py:221-224):
the same vocabulary policy (min_count, then the frequency sort and cut of
``Word2vec(source="arrays")``) and the SGNS objective gensim trains.

As in the JAX package: ``build_vocab``, ``_flat_ids`` and
``_pair_batches`` are numpy (copied as they are), the negatives are drawn
from the unigram^0.75 distribution by ``rng.choice`` once a batch, and a
batch under 16 pairs is skipped.  The step runs on the device: the
tables ``in`` (U(-0.5/D, 0.5/D), from a torch generator seeded by
``seed``) and ``out`` (zeros), optax.adam's arithmetic (the port's Adam
without weight decay: constant lr, b1 0.9, b2 0.999, eps 1e-8) on their
dense gradients.  The losses stay on the device until the epoch ends.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from umpr_tpu_torch.pretrain import pretrain_device, read_losses, running_sum
from umpr_tpu_torch.train.optim import Adam


def build_vocab(sentences, min_count=10):
    counts = Counter(w for s in sentences for w in s.split())
    vocab = [w for w, c in counts.items() if c >= min_count]
    return vocab, np.asarray([counts[w] for w in vocab], np.int64)


def _flat_ids(sentences, word2id):
    """Corpus as one flat int32 id stream + parallel sentence-id array
    (8 bytes/token total).  The previous design materialized every
    (center, context) pair as python int lists -- ~2*window pairs per token
    at ~30 bytes per list int, tens-to-hundreds of GB at the Yelp/CSJ
    corpus scale this module replaces gensim for."""
    chunk_ids, chunk_sent = [], []
    buf_ids, buf_sent = [], []
    for si, s in enumerate(sentences):
        toks = [word2id[w] for w in s.split() if w in word2id]
        buf_ids.extend(toks)
        buf_sent.extend([si] * len(toks))
        if len(buf_ids) >= (1 << 20):
            chunk_ids.append(np.asarray(buf_ids, np.int32))
            chunk_sent.append(np.asarray(buf_sent, np.int64))
            buf_ids, buf_sent = [], []
    chunk_ids.append(np.asarray(buf_ids, np.int32))
    chunk_sent.append(np.asarray(buf_sent, np.int64))
    return np.concatenate(chunk_ids), np.concatenate(chunk_sent)


_PAIR_CHUNK = 1 << 21  # positions per slab (tens of MB live at a time)


def _pair_batches(ids, sent, window, batch_size, rng):
    """Yield shuffled (centers, contexts) batches streamed from the flat id
    arrays: for offset d, the pairs are (ids[i], ids[i+d]) plus the flip,
    wherever both positions lie in one sentence.  Chunk order and intra-
    chunk order are shuffled; leftovers carry across chunks so every batch
    but the final one is exactly batch_size (one jit shape)."""
    T = len(ids)
    spans = [(d, lo) for d in range(1, window + 1)
             for lo in range(0, max(T - d, 0), _PAIR_CHUNK)]
    rng.shuffle(spans)
    rem_c = rem_o = np.zeros(0, np.int32)
    for d, lo in spans:
        hi = min(lo + _PAIR_CHUNK, T - d)
        a, b = ids[lo:hi], ids[lo + d:hi + d]
        ok = sent[lo:hi] == sent[lo + d:hi + d]
        a, b = a[ok], b[ok]
        c = np.concatenate([rem_c, a, b])
        o = np.concatenate([rem_o, b, a])
        perm = rng.permutation(len(c))
        c, o = c[perm], o[perm]
        end = len(c) - len(c) % batch_size
        for s in range(0, end, batch_size):
            yield c[s:s + batch_size], o[s:s + batch_size]
        rem_c, rem_o = c[end:], o[end:]
    if len(rem_c):
        yield rem_c, rem_o


class SkipGram(nn.Module):
    """The tables ``in`` (the word vectors) and ``out`` (the context
    vectors), (V, D) each; their state-dict names are the JAX tree's keys."""

    def __init__(self, vocab_size, emb_dim, generator=None):
        super().__init__()
        bound = 0.5 / emb_dim
        self.register_parameter("in", nn.Parameter(
            torch.empty(vocab_size, emb_dim).uniform_(-bound, bound, generator=generator)))
        self.register_parameter("out", nn.Parameter(torch.zeros(vocab_size, emb_dim)))

    def tables(self):
        return getattr(self, "in"), getattr(self, "out")


def skipgram_loss(model, centers, contexts, negs):
    """-mean(log s(v_c . u_o) + sum_n log s(-v_c . u_n)), word2vec_train.py:108-114."""
    w_in, w_out = model.tables()
    vc = F.embedding(centers, w_in)                      # (B, D)
    uo = F.embedding(contexts, w_out)                    # (B, D)
    un = F.embedding(negs, w_out)                        # (B, neg, D)
    pos = F.logsigmoid((vc * uo).sum(-1))
    negl = F.logsigmoid(-torch.einsum("bd,bnd->bn", vc, un)).sum(-1)
    return -(pos + negl).mean()


def skipgram_step(model, opt, centers, contexts, negs):
    """One Adam step on one batch of (center, context) pairs and their
    negatives (int64 device tensors); returns the loss on the device."""
    loss = skipgram_loss(model, centers, contexts, negs)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss.detach()


def train_skipgram(sentences, emb_dim=50, window=5, min_count=10, neg=5,
                   epochs=3, batch_size=8192, lr=2e-3, seed=0, logger=None,
                   device="cuda", losses=None):
    """sentences: list of whitespace-tokenized strings.
    Returns (vocab list, vectors (V, emb_dim) float32, counts (V,)).
    `losses`, a list, receives each step's loss."""
    device = pretrain_device(device)
    rng = np.random.default_rng(seed)
    vocab, counts = build_vocab(sentences, min_count)
    if len(vocab) == 0:
        return vocab, np.zeros((0, emb_dim), np.float32), counts
    word2id = {w: i for i, w in enumerate(vocab)}
    V = len(vocab)

    # unigram^0.75 negative-sampling distribution (standard SGNS)
    p_neg = counts.astype(np.float64) ** 0.75
    p_neg /= p_neg.sum()

    model = SkipGram(V, emb_dim, torch.Generator().manual_seed(seed)).to(device)
    opt = Adam(model.named_parameters(), 0.0, lr)

    def put(a):
        return torch.from_numpy(a).to(device, torch.int64)

    flat_ids, flat_sent = _flat_ids(sentences, word2id)
    for epoch in range(epochs):
        step_losses, n = [], 0
        for c, o in _pair_batches(flat_ids, flat_sent, window, batch_size, rng):
            n += len(c)
            if len(c) < 16:
                continue
            negs = rng.choice(V, size=(len(c), neg), p=p_neg).astype(np.int32)
            step_losses.append(skipgram_step(model, opt, put(c), put(o), put(negs)))
        values = read_losses(step_losses)
        if losses is not None:
            losses.extend(values)
        if logger:
            mean = running_sum(values) / max(len(values), 1)
            logger.info(f"skipgram epoch {epoch}: loss {mean:.4f} ({n} pairs, vocab {V})")
    return vocab, model.tables()[0].detach().cpu().numpy(), counts
