"""Batch loader: packed dataset -> static-shape batches -> device tensors.

Port of umpr_tpu/data/loader.py (the single-host path).  Every batch has
the same shape: the final partial batch is padded with dead samples
(``sample_mask`` 0, counts 0, lengths 1, photo paths ''), which never
raise the runtime batch maxima, so the last batch scores like the
reference's smaller one.  Unless ``ignore_photos``, each batch carries
``photos`` (B, V, P, H, W, 3) uint8, decoded on the host (by a pool of
``workers`` threads, through a shared ``photo_cache`` when given).
``with_photo_idx`` gives in-order batches the rows of a photo bank in
their place (serving's decode-once bank).  ``chunk_stream`` stacks runs of
k batches for ``--steps_per_dispatch k``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from umpr_tpu_torch.data.images import load_photo_batch

FIELDS = ("u_tokens", "u_lengths", "u_counts", "i_tokens", "i_lengths",
          "i_counts", "ui_tokens", "ui_lengths", "ui_counts", "ratings")


class BatchLoader:
    """Batches of `batch_size` samples over a packed dataset, in order or,
    with `shuffle`, in one permutation of the samples drawn per iteration
    from ``np.random.default_rng(seed)`` (the JAX loader's order for the
    same seed).  `start_batch` skips that many batches of the order.
    `resize` is the photos' (width, height).  `photo_rows` (a slice of
    the batch: a rank's row block, parallel/) decodes only those rows'
    photos; the others stay zeros, which that rank never reads."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0, start_batch=0,
                 ignore_photos=True, resize=(224, 224), workers=0, photo_cache=None,
                 photo_rows=None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.start_batch = start_batch
        self.photo_rows = photo_rows
        self.ignore_photos = ignore_photos
        self.resize = resize
        self.photo_cache = photo_cache
        self._rng = np.random.default_rng(seed)
        self._executor = ThreadPoolExecutor(max_workers=workers) if workers > 0 else None

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
        if not self.ignore_photos:
            paths = self.ds.photo_paths[idx]  # a private copy (fancy indexing)
            paths[n_real:] = ""
            if self.photo_rows is not None:
                keep = np.zeros(b, dtype=bool)
                keep[self.photo_rows] = True
                paths[~keep] = ""
            batch["photos"] = load_photo_batch(paths, self.resize, self._executor,
                                               self.photo_cache)
        return batch

    def __iter__(self):
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(self.start_batch * self.batch_size, n, self.batch_size):
            yield self._make_batch(order[start:start + self.batch_size])


def with_photo_idx(batches, photo_idx):
    """Batches of an in-order BatchLoader (no shuffle, no start_batch) ->
    the same batches with ``photo_idx`` (B, V, P) int32: the bank rows of
    their samples' photos, from `photo_idx` (N, V, P) over the dataset.
    Batch i covers dataset rows [off, off + n_real); dead-padded rows take
    bank row 0, the zeros the streaming loader ships for them."""
    off = 0
    for b in batches:
        n_real = int(b["sample_mask"].sum())
        rows = np.zeros((len(b["sample_mask"]),) + photo_idx.shape[1:], np.int32)
        rows[:n_real] = photo_idx[off:off + n_real]
        off += n_real
        yield dict(b, photo_idx=rows)


def to_device(batch, device):
    """numpy batch -> dict of tensors on `device` (0-d arrays stay 0-d)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).reshape(np.shape(v)).to(device)
            for k, v in batch.items()}


def chunk_stream(loader, k, put_chunk, put_single, depth=2, extract=lambda hb: hb):
    """Runs of `k` host batches stacked on a NEW leading axis, each shipped
    in one transfer: the multi-step dispatch protocol of the trainer's
    train and eval passes and the Predictor (``--steps_per_dispatch``).
    Batches left over that cannot fill a chunk ship one by one.  Yields
    prefetched (device payload, [extract(host batch) per batch in it],
    chunked?) triples; `put_chunk` / `put_single` make the transfer.
    `extract` picks what of each host batch survives the prefetch queue
    (which holds up to depth * k of them): keep only what is read back."""
    def gen():
        buf = []
        for hb in iter(loader):
            buf.append(hb)
            if len(buf) == k:
                stacked = {key: np.stack([b[key] for b in buf]) for key in buf[0]}
                yield put_chunk(stacked), [extract(b) for b in buf], True
                buf = []
        for hb in buf:
            yield put_single(hb), [extract(hb)], False

    return prefetch_iter(gen(), depth=depth)


def prefetch_iter(iterator, depth=2):
    """Run `iterator` in a background thread, `depth` items ahead.

    When the consumer stops early, the worker sees the stop flag at its
    next bounded put and exits, releasing the queued items; closing the
    generator waits for that.  A thread still running at the
    interpreter's exit can abort the process (a daemon thread stopped
    inside a torch call)."""
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
        if t is not threading.current_thread():  # a collector may run this anywhere
            t.join()
