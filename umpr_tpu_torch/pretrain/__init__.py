"""Pretraining (port of umpr_tpu/pretrain): skip-gram word vectors
(``word2vec_train``), ABAE aspect extraction (``abae``, with the port's
own ``kmeans``) and the R-Net warm start (``rnet``), whose saved R-Net
``--rnet_pretrained`` loads.

The trainers run on ``device`` (default ``cuda``: a missing card raises,
``cpu`` is the only way onto the CPU) and draw their weights from torch
generators seeded by ``seed``; their data sampling draws from numpy's
``default_rng(seed)`` in the JAX package's call order, so both packages
see the same batches.
"""

from __future__ import annotations

import os

import pandas as pd
import torch

from umpr_tpu_torch.config import resolve_device
from umpr_tpu_torch.serve import set_f32_parity


def pretrain_device(name):
    """``device`` -> torch.device (config.resolve_device: a CUDA device
    must exist), with f32 products kept f32 on a card (no TF32), as the
    Trainer and the Predictor set it."""
    device = resolve_device(str(name))
    if device.type == "cuda":
        set_f32_parity()
    return device


def read_losses(step_losses):
    """An epoch's device losses as Python floats, in one read."""
    return torch.stack(step_losses).tolist() if step_losses else []


def running_sum(values, weights=None):
    """sum(v * w) added left to right from 0.0, as the JAX loops add
    ``float(loss) * len(idx)`` (the builtin sum compensates since Python
    3.12, which the logged values would show)."""
    total = 0.0
    for i, v in enumerate(values):
        total += v if weights is None else v * weights[i]
    return total


def train_sentences(data_dir):
    """The sentences of ``<data_dir>/train.csv``'s reviews as the R-Net
    pretrainer and train_embeddings read them: cut at '.', stripped, those
    longer than 10 characters."""
    reviews = pd.read_csv(os.path.join(data_dir, "train.csv"))["review"].to_list()
    return [s.strip() for review in reviews for s in str(review).split(".") if len(s) > 10]
