"""Train corpus word vectors (skip-gram with negative sampling, on the
device) and write them as a word2vec text file for ``--word2vec_file``
(port of tools/train_embeddings.py).

The pretrainers train their own skip-gram vectors, as the reference trains
gensim's in place (pretrain/pretrain_rnet.py:237-240).  For a warm-started
R-Net to carry over, UMPR must embed words with the vectors the
pretrainers trained against: this runs that skip-gram pass on the
sentences of ``<data_dir>/train.csv`` (cut at '.', longer than 10
characters, as the pretrainers cut them) and writes the vectors most
frequent first under a ``<count> <dim>`` header, which ``Word2vec``
reads with the reference's sort-by-frequency and cut::

    python -m umpr_tpu_torch.train_embeddings --data_dir data/music \
        [--out data/music/glove.txt] [--emb_dim 50] [--min_count 10]

It runs on ``--device`` (default cuda; ``--device cpu``, or ``--cpu``,
runs on the CPU).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from umpr_tpu_torch.pretrain import pretrain_device, train_sentences
from umpr_tpu_torch.pretrain.word2vec_train import train_skipgram
from umpr_tpu_torch.utils.logging import get_logger


def write_word2vec(path, vocab, vecs, counts):
    """The vectors most frequent first (a stable sort) under a word2vec
    header, six decimals a value."""
    order = np.argsort(-np.asarray(counts), kind="stable")
    with open(path, "w") as f:
        f.write(f"{len(order)} {vecs.shape[1]}\n")
        for i in order:
            f.write(vocab[i] + " " + " ".join(f"{x:.6f}" for x in vecs[i]) + "\n")
    return len(order)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True,
                    help="directory holding train.csv (the preprocessor's output); the "
                         "vectors are trained on its sentences")
    ap.add_argument("--out", default=None, help="output path (default <data_dir>/glove.txt)")
    ap.add_argument("--emb_dim", type=int, default=50)
    ap.add_argument("--min_count", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:<n> or cpu")
    ap.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                    help="the same as --device cpu")
    args = ap.parse_args(argv)
    device = pretrain_device(args.device)

    logger = get_logger(logger_name="train-embeddings")
    vocab, vecs, counts = train_skipgram(train_sentences(args.data_dir), emb_dim=args.emb_dim,
                                         min_count=args.min_count, epochs=args.epochs,
                                         logger=logger, device=device)
    out = args.out or os.path.join(args.data_dir, "glove.txt")
    n = write_word2vec(out, vocab, vecs, counts)
    print(f"Wrote {n} x {args.emb_dim} embeddings to {out}")


if __name__ == "__main__":
    main()
