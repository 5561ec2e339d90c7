"""ABAE: unsupervised Attention-Based Aspect Extraction (He et al. 2017),
which warm-starts the R-Net (port of umpr_tpu/pretrain/abae.py).

The reference model's math (abae.py:42-102):
- attention a_i = softmax(e_i M (sum_j e_j));
- aspect bottleneck p_t = softmax(W z_s + b), reconstruction r_s = p_t A;
- the aspect matrix A initialised by k-means over the word table (the
  port's own ``kmeans.KMeans``, on the device; ``kmeans=False`` leaves it
  zeros, for a template that a checkpoint restore fills);
- the max-margin hinge loss against ``neg_count`` negative sentences plus
  reg * ||A_n A_n^T - I|| (eps 1e-6);
- the word table is TRAINABLE here, unlike in UMPR.

``ABAE``'s state-dict names are the JAX tree's ``{embedding, M, fc{kernel,
bias}, aspect}`` under ``convert``'s mapping: ``fc`` is a Linear (its
weight the kernel transposed), ``M`` is used as ``einsum("bld,de,be")``
and keeps its layout.  Training is the JAX loop's: per epoch a
permutation and the negatives from numpy's ``default_rng(seed)``, Adam
as ``optax.scale_by_adam`` (no weight decay) with the lr set once an
epoch, ``lr * lr_decay ** epoch``.  The ids, the permutation and the
negatives live on the device; the losses are read once an epoch.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from umpr_tpu_torch.convert import params_to_jax
from umpr_tpu_torch.pretrain import pretrain_device, read_losses, running_sum
from umpr_tpu_torch.pretrain.kmeans import KMeans
from umpr_tpu_torch.train.checkpoint import save_pytree
from umpr_tpu_torch.train.optim import Adam

EPS = 1e-6


class ABAE(nn.Module):
    def __init__(self, vocab_size, dim, aspect_size):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, dim)  # trainable
        self.M = nn.Parameter(torch.zeros(dim, dim))
        self.fc = nn.Linear(dim, aspect_size)
        self.aspect = nn.Parameter(torch.zeros(aspect_size, dim))


def init_abae(seed, word_emb, aspect_size, kmeans=True, device="cuda"):
    """word_emb: (V, D).  M ~ N(0, 1), fc's kernel ~ U(+-1/sqrt(D)) and a
    zero bias, drawn from a CPU generator seeded by `seed`; the aspects
    from k-means over the table (n_init 10, its generator seeded by
    `seed` too), or zeros with kmeans=False (a shape template)."""
    device = pretrain_device(device)
    word_emb = torch.as_tensor(np.asarray(word_emb, np.float32))
    V, d = word_emb.shape
    g = torch.Generator().manual_seed(seed)
    model = ABAE(V, d, aspect_size)
    with torch.no_grad():
        model.embedding.weight.copy_(word_emb)
        model.M.copy_(torch.randn((d, d), generator=g))
        bound = 1 / math.sqrt(d)
        model.fc.weight.copy_(torch.empty(d, aspect_size).uniform_(-bound, bound,
                                                                     generator=g).T)
        model.fc.bias.zero_()
    model = model.to(device)
    if kmeans:
        km = KMeans(aspect_size, n_init=10, generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            model.aspect.copy_(km.fit(word_emb.to(device)).cluster_centers_)
    return model


def _encode(model, ids):
    """ids: (B, L) -> (z_s (B, D), p_t (B, K))."""
    emb = model.embedding(ids)                          # (B, L, D)
    ys = emb.sum(-2)                                    # (B, D)
    di = torch.einsum("bld,bd->bl", emb, ys @ model.M.T)  # bld,de,be->bl
    ai = torch.softmax(di, -1)
    zs = torch.einsum("bl,bld->bd", ai, emb)
    pt = torch.softmax(model.fc(zs), -1)
    return zs, pt


def _normed(x):
    return x / (EPS + torch.linalg.vector_norm(x, dim=-1, keepdim=True))


def abae_forward(model, pos, neg=None, reg_rate=0.1):
    """pos: (B, L) ids; neg: (B, n_neg, L) ids or None (inference).
    Returns p_t or (p_t, loss).  Reference: abae.py:59-91."""
    zs, pt = _encode(model, pos)
    if neg is None:
        return pt
    rs = pt @ model.aspect                              # (B, D)
    neg_zs = model.embedding(neg).sum(-2)               # (B, n, D)
    nzs, nrs, nneg = _normed(zs), _normed(rs), _normed(neg_zs)
    hinge = (1.0 - (nrs * nzs).sum(-1, keepdim=True)
             + torch.einsum("bd,bnd->bn", nrs, nneg))
    loss = F.relu(hinge).mean()
    na = _normed(model.aspect)
    penalty = na @ na.T - torch.eye(na.shape[0], device=na.device)
    return pt, loss + reg_rate * torch.linalg.norm(penalty)


def abae_step(model, opt, pos, neg, reg_rate):
    """One Adam step on a batch of ids (device tensors); the loss on the
    device."""
    _, loss = abae_forward(model, pos, neg, reg_rate)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss.detach()


def get_aspect_words(model, top=10):
    """Top-k nearest vocabulary words per aspect (abae.py:93-102)."""
    emb = model.embedding.weight.detach().cpu().numpy()
    emb = emb / (EPS + np.linalg.norm(emb, axis=-1, keepdims=True))
    out = []
    for asp in model.aspect.detach().cpu().numpy():
        asp = asp / (EPS + np.linalg.norm(asp))
        out.append(list(np.argsort(-(emb @ asp))[:top]))
    return out


def sentences_to_ids(word2vec, sentences, max_length=20):
    return np.asarray(
        [word2vec.sent2indices(s, align_length=max_length) for s in sentences],
        np.int32)


def sample_negatives(n, n_neg, rng):
    """Per-sentence negative indices, excluding self (abae.py:29-33)."""
    negs = rng.integers(0, n, size=(n, n_neg))
    clash = negs == np.arange(n)[:, None]
    negs[clash] = (negs[clash] + 1) % n
    return negs.astype(np.int32)


def train_abae(word2vec, sentences, *, sent_len=20, neg_count=20, batch_size=512,
               aspect_size=14, abae_regular=0.1, learning_rate=1e-3,
               lr_decay=0.99, train_epochs=15, save_path=None, seed=0,
               logger=None, valid=None, device="cuda", losses=None):
    """Train ABAE on `sentences`; returns the model (on `device`), saved
    in the JAX layout to `save_path` if given.  `losses`, a list, receives
    each step's loss.  One batch of all sentences when there are fewer
    than `batch_size`, else n // batch_size full ones (the JAX policy)."""
    device = pretrain_device(device)
    data = sentences_to_ids(word2vec, sentences, sent_len)
    n = len(data)
    rng = np.random.default_rng(seed)
    model = init_abae(seed, word2vec.embedding, aspect_size, device=device)
    opt = Adam(model.named_parameters(), 0.0, learning_rate)
    data_d = torch.from_numpy(data).to(device, torch.int64)

    n_batches = n // batch_size if n >= batch_size else 0
    for epoch in range(train_epochs):
        opt.set_lr(learning_rate * (lr_decay ** epoch))
        order = torch.from_numpy(rng.permutation(n)).to(device)
        negs = torch.from_numpy(sample_negatives(n, neg_count, rng)).to(device, torch.int64)
        step_losses, sizes = [], []
        for bi in range(max(n_batches, 1)):
            idx = order[bi * batch_size:(bi + 1) * batch_size] if n >= batch_size else order
            step_losses.append(abae_step(model, opt, data_d[idx], data_d[negs[idx]],
                                         abae_regular))
            sizes.append(len(idx))
        values = read_losses(step_losses)
        if losses is not None:
            losses.extend(values)
        if logger:
            logger.info(f"Epoch {epoch:3d}; train loss "
                        f"{running_sum(values, sizes) / max(sum(sizes), 1):.6f}")

    if logger:
        for i, words in enumerate(get_aspect_words(model, 10)):
            logger.debug(f"Aspect: {i}: {[word2vec.vocab[k] for k in words]}")
    if save_path:
        save_pytree(save_path, params_to_jax(model.state_dict()))
        if logger:
            logger.info(f'Trained model "{save_path}" has been saved.')
    return model


def evaluate_aspects(model, word2vec, tests, test_labels, *, sent_len=20,
                     batch_size=1024, categories=None, aspect_mapping=None,
                     logger=None):
    """Aspect-classification accuracy against human labels (reference
    abae.py:166-188).  The reference asks a human to map each learned
    aspect to a category name via input(); `aspect_mapping` (a category
    index per aspect) runs it non-interactively."""
    categories = categories or ["Food", "Staff", "Ambience", "Price",
                                "Anecdotes", "Miscellaneous"]
    n_aspects = model.aspect.shape[0]
    if aspect_mapping is None:
        print("Please choose a category from following list for each aspect.")
        print(dict(enumerate(categories)))
        aspect_mapping = [int(input(f"Input index(0~{len(categories) - 1}) "
                                    f"to aspect {k}:")) for k in range(n_aspects)]
    aspect_words = [categories[i] for i in aspect_mapping]

    data = sentences_to_ids(word2vec, tests, sent_len)
    pred = abae_predict(model, data, batch_size).argmax(axis=-1)
    correct = sum(1 for truth, aid in zip(test_labels, pred)
                  if truth == aspect_words[aid])
    acc = correct / max(len(pred), 1)
    (logger.info if logger else print)(f"Accuracy: {acc:.6f}")
    return acc


@torch.no_grad()
def abae_predict(model, data, batch_size=1024):
    """Aspect distributions (N, K) float32 for an (N, L) id array, on the
    model's device."""
    device = model.aspect.device
    out = [abae_forward(model, torch.from_numpy(np.asarray(data[s:s + batch_size]))
                        .to(device, torch.int64)).cpu().numpy()
           for s in range(0, len(data), batch_size)]
    return np.concatenate(out) if out else np.zeros((0, model.aspect.shape[0]), np.float32)


def main(argv=None):
    """``python -m umpr_tpu_torch.pretrain.abae --data_dir <dir>``: skip-
    gram vectors of ``<dir>/train.txt`` (one sentence a line), then ABAE
    on its sentences, saved to ``--save_path``.  The JAX CLI's flags and
    defaults; ``--device`` defaults to cuda."""
    from umpr_tpu_torch.pretrain.word2vec_train import train_skipgram
    from umpr_tpu_torch.text.vocab import Word2vec
    from umpr_tpu_torch.utils.logging import get_logger

    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--train_epochs", type=int, default=15)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--abae_regular", type=float, default=0.1)
    parser.add_argument("--lr_decay", type=float, default=0.99)
    parser.add_argument("--data_dir", type=str, default="dataset/restaurant")
    parser.add_argument("--vocab_size", type=int, default=9000)
    parser.add_argument("--emb_dim", type=int, default=200)
    parser.add_argument("--max_length", type=int, default=20)
    parser.add_argument("--neg_count", type=int, default=20)
    parser.add_argument("--aspect_size", type=int, default=14)
    parser.add_argument("--save_path", type=str, default="pretrain/model/ABAE")
    args = parser.parse_args(argv)
    device = pretrain_device(args.device)
    logger = get_logger()

    with open(os.path.join(args.data_dir, "train.txt")) as f:
        trains = f.read().splitlines()
    logger.info(f"train sentences: {len(trains)}")

    vocab, vecs, counts = train_skipgram(trains, emb_dim=args.emb_dim, logger=logger,
                                         device=device)
    w2v = Word2vec(source="arrays", vocab=vocab, vectors=vecs, counts=counts,
                   vocab_size=args.vocab_size)
    logger.info(f"vocabulary size: {len(w2v)}")
    train_abae(w2v, trains, sent_len=args.max_length, neg_count=args.neg_count,
               batch_size=args.batch_size, aspect_size=args.aspect_size,
               abae_regular=args.abae_regular, learning_rate=args.learning_rate,
               lr_decay=args.lr_decay, train_epochs=args.train_epochs,
               save_path=args.save_path, logger=logger, device=device)


if __name__ == "__main__":
    main()
