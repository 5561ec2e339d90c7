"""R-Net pretrainer: sentence-pair matching supervised by ABAE's aspect
similarity (port of umpr_tpu/pretrain/rnet.py; reference
pretrain/pretrain_rnet.py).

The pipeline (pretrain_rnet.py:84-205):
- ABAE's aspect distribution for every training sentence (``abae_predict``);
- per sentence 20 candidates, the most / least cosine-similar kept as its
  positive / negative partner (early exit at > 0.8 / < 0.5):
  ``mine_pairs`` and ``mine_pairs_hard`` are the JAX package's numpy code,
  copied as they are, so a seed mines the same pairs;
- ``PretrainRNet``: the frozen word table, the SAME ``RNet`` UMPR runs
  (models/review_net.py: the bi-GRU through K1-K4 on the card, K9 never,
  the table being frozen) and sigmoid(Linear(4H -> 1)) with the clipped
  BCE loss (pretrain_rnet.py:144-169);
- Adam with weight decay on every weight but the biases and the lr set
  once an epoch (pretrain_rnet.py:181-185): the port's ``train.optim.Adam``,
  whose decayed set over ``{rnet, linear}`` is JAX's ``_no_bias_mask``'s;
- only the R-Net is saved, in the JAX layout (``{gru, M}``), which
  ``--rnet_pretrained`` of either package loads.

Kept deviations of the JAX package: each pair's GRU length is its TRUE
token count (``(ids != 0).sum()``, at least 1), where the reference feeds
the padded ``max_length`` (pretrain_rnet.py:107-116,136-141); and its
batch policy: ``n // batch_size`` full batches an epoch, one short batch
only when n < batch_size.

The pairs, their lengths and the labels are uploaded once; each epoch's
permutation once an epoch; the losses are read once an epoch.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch import nn

from umpr_tpu_torch.convert import params_to_jax
from umpr_tpu_torch.models.layers import linear
from umpr_tpu_torch.models.review_net import RNet
from umpr_tpu_torch.ops.masking import batch_max_length, exists_mask
from umpr_tpu_torch.pretrain import (pretrain_device, read_losses, running_sum,
                                     train_sentences)
from umpr_tpu_torch.pretrain.abae import abae_predict, sentences_to_ids
from umpr_tpu_torch.train.checkpoint import save_pytree
from umpr_tpu_torch.train.optim import make_optimizer


def mine_pairs(data, probs, rng, sample_k=20, hi=0.8, lo=0.5,
               block_size=8192):
    """For each sentence, find pos/neg partners by aspect-cosine
    (pretrain_rnet.py:98-127).  data: (N, L) ids; probs: (N, K).
    Returns s1, s2, labels arrays (2N, ...).

    Vectorized, blocked implementation of the reference's per-sentence
    scan (random.sample of 20 candidates, running strict max/min, early
    exit once max_cos > hi and min_cos < lo).  The candidate draws keep
    the per-sentence ``rng.choice`` call sequence, and the early-exit /
    first-occurrence-tie / skip-on-None semantics are reproduced with
    prefix scans, so the mined pairs match the straightforward loop for a
    fixed seed (tests/test_pretrain.py) while the cosine work runs as
    blocked einsums -- ~40x faster on corpus-scale inputs (the loop's
    ~190 us/sentence would be half an hour at Yelp sentence counts)."""
    probs = np.ascontiguousarray(probs)
    norms = np.linalg.norm(probs, axis=-1)
    n = len(data)
    if n == 0:
        return data[:0], data[:0], np.zeros(0, np.float32)
    k = min(sample_k, n)
    # same rng call sequence as the reference-shaped loop: one
    # choice(n, k, replace=False) per sentence, in sentence order
    cand = np.empty((n, k), np.int64)
    for i in range(n):
        cand[i] = rng.choice(n, size=k, replace=False)

    s1_idx, s2_idx, lab = [], [], []
    pos_col = np.arange(k)
    for lo_i in range(0, n, block_size):
        blk = slice(lo_i, min(lo_i + block_size, n))
        rows = np.arange(blk.start, blk.stop)
        cb = cand[blk]                                   # (B, k)
        # accumulate in the probs dtype (promoted to at least f32), exactly
        # like the loop's np.dot -- forcing f32 on f64 inputs could flip
        # strict > / < comparisons near the hi/lo thresholds
        cos = np.einsum("bkd,bd->bk", probs[cb], probs[blk],
                        dtype=np.result_type(probs.dtype, np.float32))
        cos = cos / (norms[blk][:, None] * norms[cb] + 1e-12)
        is_self = cb == rows[:, None]
        # running strict max/min over the candidate scan; self rows are
        # skipped exactly like the loop's `continue`
        run_max = np.maximum.accumulate(np.where(is_self, -np.inf, cos), 1)
        run_min = np.minimum.accumulate(np.where(is_self, np.inf, cos), 1)
        done = (run_max > hi) & (run_min < lo)
        # first index where the loop would break (inclusive: the breaking
        # candidate was processed); k-1 when it never breaks
        t_star = np.where(done.any(1), done.argmax(1), k - 1)
        in_prefix = (pos_col[None, :] <= t_star[:, None]) & ~is_self
        pm = np.where(in_prefix, cos, -np.inf)
        nm = np.where(in_prefix, cos, np.inf)
        best_pos, best_neg = pm.argmax(1), nm.argmin(1)
        # the loop only records a partner on a STRICT improvement over the
        # initial sentinels (-1.0 / 1.0); otherwise the sentence is skipped
        ok = (pm[np.arange(len(rows)), best_pos] > -1.0) & \
             (nm[np.arange(len(rows)), best_neg] < 1.0)
        for r in np.nonzero(ok)[0]:
            i = rows[r]
            s1_idx += [i, i]
            s2_idx += [cb[r, best_pos[r]], cb[r, best_neg[r]]]
            lab += [1.0, 0.0]
    return data[s1_idx], data[s2_idx], np.asarray(lab, np.float32)


def mine_pairs_hard(data, probs, rng, min_category=5):
    """Hard-label variant (reference PretrainRNetDataset_bak,
    pretrain_rnet.py:29-81): bucket sentences by argmax aspect, sample a
    positive from the same bucket and a negative from another bucket."""
    labels_by_cat = {}
    assign = probs.argmax(axis=-1)
    for i, c in enumerate(assign):
        labels_by_cat.setdefault(int(c), []).append(i)
    labels_by_cat = {c: v for c, v in labels_by_cat.items() if len(v) >= min_category}
    cats = list(labels_by_cat)
    s1, s2, y = [], [], []
    if len(cats) < 2:
        return data[s1], data[s2], np.asarray(y, np.float32)
    for c, members in labels_by_cat.items():
        for i in members:
            pos = i
            while pos == i:
                pos = members[rng.integers(len(members))]
            other = c
            while other == c:
                other = cats[rng.integers(len(cats))]
            neg = labels_by_cat[other][rng.integers(len(labels_by_cat[other]))]
            s1 += [i, i]; s2 += [pos, neg]; y += [1.0, 0.0]
    return data[s1], data[s2], np.asarray(y, np.float32)


class PretrainRNet(nn.Module):
    """The frozen word table, UMPR's RNet and a Linear(4H -> 1) head; the
    state-dict names are the JAX tree's ``{embedding, rnet, linear}``.
    Weights from `generator` (RNet's, then the head's)."""

    def __init__(self, word_emb, gru_size, generator=None):
        super().__init__()
        word_emb = torch.as_tensor(np.asarray(word_emb, np.float32))
        self.embedding = nn.Embedding.from_pretrained(word_emb, freeze=True)
        self.rnet = RNet(word_emb.shape[1], gru_size, generator)
        self.linear = linear(4 * gru_size, 1, generator=generator)

    def forward(self, u_ids, u_len, i_ids, i_len, labels):
        """Single-sentence pairs viewed as (B, 1, L) reviews through RNet
        (pretrain_rnet.py:155-169).  ids (B, L), lengths (B,) int32,
        labels (B,) float.  Returns (prob, loss)."""
        L = u_ids.shape[1]
        both = self.embedding(torch.cat([u_ids, i_ids]).long())[:, None]  # (2B, 1, L, E)
        exists = exists_mask(1, batch_max_length(u_len, i_len), 1, L, u_ids.device)
        _, _, _, att_u, att_i = self.rnet(both, u_len[:, None], i_len[:, None], exists)
        att = torch.cat([att_u, att_i], dim=-1)
        prob = torch.sigmoid(self.linear(att))[:, 0].clamp(1e-7, 1 - 1e-7)
        loss = -(labels * torch.log(prob) + (1 - labels) * torch.log(1 - prob)).mean()
        return prob, loss


def rnet_step(model, opt, batch):
    """One Adam step on a batch of pairs (device tensors s1, l1, s2, l2,
    y); the loss on the device."""
    _, loss = model(batch["s1"], batch["l1"], batch["s2"], batch["l2"], batch["y"])
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss.detach()


def sentence_lengths(ids):
    """Each row's true token count, at least 1 (the kept deviation)."""
    return np.maximum((ids != 0).sum(-1), 1).astype(np.int32)


def train_pairs(word_emb, s1, s2, labels, rng, *, gru_size=64, batch_size=1024,
                learning_rate=0.01, lr_decay=0.99, l2_regularization=1e-3,
                train_epochs=10, seed=0, logger=None, device="cuda", losses=None):
    """PretrainRNet trained on mined pairs: the epochs of ``pretrain_r_net``
    after the mining, the permutations drawn from `rng` (the mining's,
    continued).  Returns the model on `device`; `losses`, a list, receives
    each step's loss."""
    device = pretrain_device(device)
    model = PretrainRNet(word_emb, gru_size, torch.Generator().manual_seed(seed)).to(device)
    opt = make_optimizer(model, l2_regularization, learning_rate)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    pairs = {"s1": put(s1), "l1": put(sentence_lengths(s1)), "s2": put(s2),
             "l2": put(sentence_lengths(s2)), "y": put(labels)}

    n = len(s1)
    nb = max(n // batch_size, 1) if n else 0
    if logger:
        logger.info(f"Start to train R net. ({n} pairs)")
    for epoch in range(train_epochs):
        opt.set_lr(learning_rate * (lr_decay ** epoch))
        order = put(rng.permutation(n))
        step_losses, sizes = [], []
        for bi in range(nb):
            idx = order[bi * batch_size:(bi + 1) * batch_size]
            if len(idx) == 0:
                continue
            step_losses.append(rnet_step(model, opt, {k: v[idx] for k, v in pairs.items()}))
            sizes.append(len(idx))
        values = read_losses(step_losses)
        if losses is not None:
            losses.extend(values)
        if logger:
            logger.info(f"Epoch {epoch:3d}; train loss "
                        f"{running_sum(values, sizes) / max(sum(sizes), 1):.6f}")
    return model


def pretrain_r_net(word2vec, sentences, abae, save_path, *, gru_size=64, max_length=20,
                   batch_size=1024, learning_rate=0.01, lr_decay=0.99,
                   l2_regularization=1e-3, train_epochs=10, seed=0, logger=None,
                   device="cuda", losses=None):
    """Mine pairs by `abae`'s aspects, train PretrainRNet on them, save its
    R-Net to `save_path`; returns the model."""
    data = sentences_to_ids(word2vec, sentences, max_length)
    probs = abae_predict(abae, data)
    rng = np.random.default_rng(seed)
    s1, s2, labels = mine_pairs(data, probs, rng)
    model = train_pairs(word2vec.embedding, s1, s2, labels, rng, gru_size=gru_size,
                        batch_size=batch_size, learning_rate=learning_rate,
                        lr_decay=lr_decay, l2_regularization=l2_regularization,
                        train_epochs=train_epochs, seed=seed, logger=logger,
                        device=device, losses=losses)
    # only the R-Net, in the JAX layout: what --rnet_pretrained loads
    save_pytree(save_path, params_to_jax(model.rnet.state_dict()))
    if logger:
        logger.info(f"End of Training. Saving R-Net to {save_path}.")
    return model


def main(argv=None):
    """``python -m umpr_tpu_torch.pretrain.rnet --data_dir <dir>``: skip-gram
    vectors of the sentences of ``<dir>/train.csv``, ABAE (trained for 15
    epochs and saved to ``--save_ABAE``, or restored from there), then the
    R-Net, saved to ``--save_rnet``.  The JAX CLI's flags and defaults;
    ``--device`` defaults to cuda."""
    from umpr_tpu_torch.pretrain.abae import init_abae, train_abae
    from umpr_tpu_torch.pretrain.word2vec_train import train_skipgram
    from umpr_tpu_torch.text.vocab import Word2vec
    from umpr_tpu_torch.train.checkpoint import restore_module
    from umpr_tpu_torch.utils.logging import get_logger

    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--train_epochs", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=1024)
    parser.add_argument("--learning_rate", type=float, default=0.01)
    parser.add_argument("--lr_decay", type=float, default=0.99)
    parser.add_argument("--l2_regularization", type=float, default=1e-3)
    parser.add_argument("--vocab_size", type=int, default=9000)
    parser.add_argument("--emb_dim", type=int, default=50)
    parser.add_argument("--max_length", type=int, default=20)
    parser.add_argument("--aspect_size", type=int, default=14)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--gru_size", type=int, default=64)
    parser.add_argument("--save_ABAE", type=str, default="pretrain/model/trained_ABAE_rnet")
    parser.add_argument("--save_rnet", type=str, default="pretrain/model/pretraining_rnet")
    args = parser.parse_args(argv)
    device = pretrain_device(args.device)
    logger = get_logger()

    trains = train_sentences(args.data_dir)
    vocab, vecs, counts = train_skipgram(trains, emb_dim=args.emb_dim, logger=logger,
                                         device=device)
    w2v = Word2vec(source="arrays", vocab=vocab, vectors=vecs, counts=counts,
                   vocab_size=args.vocab_size)

    if not os.path.exists(os.path.join(args.save_ABAE, "arrays.npz")):
        logger.info(f'Start to train ABAE! No such file "{args.save_ABAE}".')
        abae = train_abae(
            w2v, trains, sent_len=20, neg_count=20, batch_size=512,
            aspect_size=args.aspect_size, abae_regular=0.1, learning_rate=1e-3,
            lr_decay=0.99, train_epochs=15, save_path=args.save_ABAE, logger=logger,
            device=device)
    else:
        # a shape template (no k-means) that the restore fills
        abae = init_abae(0, w2v.embedding, args.aspect_size, kmeans=False, device=device)
        restore_module(args.save_ABAE, abae)

    pretrain_r_net(w2v, trains, abae, args.save_rnet,
                   gru_size=args.gru_size, max_length=args.max_length,
                   batch_size=args.batch_size, learning_rate=args.learning_rate,
                   lr_decay=args.lr_decay, l2_regularization=args.l2_regularization,
                   train_epochs=args.train_epochs, logger=logger, device=device)


if __name__ == "__main__":
    main()
