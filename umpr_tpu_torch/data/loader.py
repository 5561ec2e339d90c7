"""Batch loader: packed dataset -> static-shape batches -> device tensors.

Port of umpr_tpu/data/loader.py without photos.  Every batch has the same
shape: the final partial batch is padded with dead samples
(``sample_mask`` 0, counts 0, lengths 1), which never raise the runtime
batch maxima, so the last batch scores like the reference's smaller one.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

FIELDS = ("u_tokens", "u_lengths", "u_counts", "i_tokens", "i_lengths",
          "i_counts", "ui_tokens", "ui_lengths", "ui_counts", "ratings")


class BatchLoader:
    """Batches of `batch_size` samples over a packed dataset, in order or,
    with `shuffle`, in one permutation of the samples drawn per iteration
    from ``np.random.default_rng(seed)`` (the JAX loader's order for the
    same seed).  `start_batch` skips that many batches of the order."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0, start_batch=0):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.start_batch = start_batch
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return -(-len(self.ds) // self.batch_size)

    def _make_batch(self, idx):
        n_real, b = len(idx), self.batch_size
        if n_real < b:
            # dead padding: sample 0 repeated, then neutralized below
            idx = np.concatenate([idx, np.zeros(b - n_real, dtype=idx.dtype)])
        batch = {k: getattr(self.ds, k)[idx] for k in FIELDS}
        batch["sample_mask"] = np.ones(b, dtype=np.float32)
        if n_real < b:
            batch["sample_mask"][n_real:] = 0.0
            for k in ("u_counts", "i_counts", "ui_counts"):
                batch[k][n_real:] = 0  # fancy indexing made private copies
            for k in ("u_lengths", "i_lengths", "ui_lengths"):
                batch[k][n_real:] = 1
        return batch

    def __iter__(self):
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(self.start_batch * self.batch_size, n, self.batch_size):
            yield self._make_batch(order[start:start + self.batch_size])


def to_device(batch, device):
    """numpy batch -> dict of tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def prefetch_iter(iterator, depth=2):
    """Run `iterator` in a background thread, `depth` items ahead.

    When the consumer stops early, the worker sees the stop flag at its
    next bounded put and exits, releasing the queued items."""
    q = queue.Queue(maxsize=depth)
    sentinel = object()
    err = []
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # re-raised in the consumer
            err.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
