"""Batch serving of rating predictions from a checkpoint (port of
umpr_tpu/serve.py): UMPR-R (``--review_net_only True``) and full UMPR
(``--review_net_only False``, photos through VGG16).

CSV mode:

    python -m umpr_tpu_torch.serve --review_net_only False \
        --data_dir data/music --word2vec_file embedding/glove.6B.50d.txt \
        --model_path model/<run-dir> --input data/music/test.csv \
        --output predictions.csv

The input CSV has the training-CSV schema; ``rating`` is optional.  Output
columns: userID, itemID, prediction.  Rows that the reference's sample
filters drop (too little history) get an empty prediction.

HTTP mode (``--server --port N``) runs a JSON scorer on the same Predictor:

    POST /predict  {"rows": [{"userID": ..., "itemID": ..., "review": ...,
                              ("rating": ...)}, ...]}
      -> {"predictions": [float | null, ...]}   (null = unscorable row)
    GET /health    -> {"status": "ok"}

Histories are built from the rows of the request itself, as for a CSV.

Every dispatch computes at the full static padding (``pad_maxima`` pinned
to the packed arrays' dims), so a row scores the same alone, in a batch or
merged with other requests by the Coalescer.  The model runs on
``--device`` (default cuda); on a card the bi-GRU goes through the CUDA
kernels of ops/gru_cuda.py, and with ``--vgg_fused_pool True`` VGG16's
blocks 1-3 close with K5 (ops/pool_cuda.py).

Full UMPR: photos are decoded on the host (``--data_workers`` threads)
through one LRU ``PhotoCache`` per Predictor (``--photo_cache_mb``).
Unless ``--device_dataset off``, each distinct photo is decoded once per
Predictor into a resident uint8 photo bank on the device, and batches
carry (B, V, P) int32 bank rows in place of pixels; ``bank[photo_idx]``
then gathers the same bytes the streaming loader would ship, so the two
give the same predictions.  The bank's capacity is a power of two, and
``--device_dataset_mb`` caps the bytes it holds, growth included (the old
and the new bank side by side); past the cap the Predictor logs once and
streams photos from then on.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import pandas as pd
import torch

from umpr_tpu_torch.config import Config
from umpr_tpu_torch.data.dataset import build_dataset
from umpr_tpu_torch.data.images import PhotoCache, load_photo_batch
from umpr_tpu_torch.data.loader import (FIELDS, BatchLoader, prefetch_iter, to_device,
                                        with_photo_idx)
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train import checkpoint as ckpt


def set_f32_parity():
    """f32 parity with the JAX package: no TF32 in matmuls, nor in cuDNN
    (whose PyTorch default is TF32 on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Predictor:
    def __init__(self, config, word2vec, model_path):
        self.config = config
        self.device = config.torch_device
        if self.device.type == "cuda":
            set_f32_parity()
        model = UMPR(ModelDims.from_config(config), word2vec.embedding,
                     torch.Generator().manual_seed(config.seed))
        ckpt.restore_best(model_path, model)  # the embedding included
        self.model = model.to(self.device).eval()
        photos = not config.review_net_only
        # one decoded-photo cache for the Predictor's life: a cache per
        # request would decode every JPEG again on every request
        self._photo_cache = (PhotoCache(config.photo_cache_mb << 20)
                             if photos and config.photo_cache_mb > 0 else None)
        self._bank_enabled = photos and config.device_dataset != "off"
        if self._bank_enabled:
            H = config.photo_size
            self._bank_rows = {"": 0}  # path -> bank row; row 0 is zeros
            self._bank = torch.zeros((1, H, H, 3), dtype=torch.uint8,
                                     device=self.device)

    def predict_dataset(self, dataset):
        """-> (predictions (N,), source_rows (N,)) over retained samples."""
        return self._predict_packed(dataset), np.asarray(dataset.source_rows)

    def _bank_idx(self, dataset):
        """Decode the dataset's photos that the bank does not hold yet into
        it, once each, and return the (N, V, P) int32 bank rows of its
        samples; None where the bank is off or has outgrown
        --device_dataset_mb (then photos stream, logged once)."""
        if not self._bank_enabled:
            return None
        cfg = self.config
        new = [p for p in np.unique(dataset.photo_paths.ravel())
               if p not in self._bank_rows]
        if new:
            held, need = len(self._bank_rows), len(self._bank_rows) + len(new)
            old_cap = cap = self._bank.shape[0]
            while cap < need:
                cap *= 2
            # a hard cap on the bytes held, growth included: the old bank
            # lives until the new one has taken its rows
            row_bytes = cfg.photo_size * cfg.photo_size * 3
            peak = (cap + (old_cap if cap > old_cap else 0)) * row_bytes
            if peak > cfg.device_dataset_mb << 20:
                print(f"serve: the resident photo bank would hold {peak} bytes "
                      f"(capacity {cap} rows) past device_dataset_mb="
                      f"{cfg.device_dataset_mb} at {need} photos; streaming "
                      "photos from here on.")
                self._bank_enabled = False
                self._bank = None
                return None
            size = (cfg.photo_size, cfg.photo_size)
            imgs = load_photo_batch(np.asarray(new, dtype=np.str_).reshape(-1, 1, 1),
                                    size, None, self._photo_cache)[:, 0, 0]
            if cap > old_cap:
                grown = torch.zeros((cap,) + self._bank.shape[1:], dtype=torch.uint8,
                                    device=self.device)
                grown[:held] = self._bank[:held]
                self._bank = grown
            self._bank[held:need] = torch.from_numpy(imgs).to(self.device)
            for p in new:
                self._bank_rows[p] = len(self._bank_rows)
        lut = self._bank_rows
        flat = dataset.photo_paths.ravel()
        return np.fromiter((lut[p] for p in flat), np.int32,
                           len(flat)).reshape(dataset.photo_paths.shape)

    @torch.inference_mode()
    def _predict_packed(self, dataset):
        """Predictions (N,) over a packed dataset's samples, in order."""
        cfg = self.config
        photo_idx = self._bank_idx(dataset)
        loader = BatchLoader(dataset, cfg.batch_size,
                             ignore_photos=cfg.review_net_only or photo_idx is not None,
                             resize=(cfg.photo_size, cfg.photo_size),
                             workers=cfg.data_workers, photo_cache=self._photo_cache)
        batches = iter(loader) if photo_idx is None else with_photo_idx(loader, photo_idx)
        host_to_device = ((b["sample_mask"] > 0, to_device(b, self.device))
                          for b in batches)
        outs = []  # read back after the last dispatch
        for alive, batch in prefetch_iter(host_to_device, depth=cfg.prefetch_depth):
            if photo_idx is not None:
                batch["photos"] = self._bank[batch.pop("photo_idx").long()]
            # full static padding: the same row scores the same in any batch
            batch["pad_maxima"] = (batch["u_tokens"].shape[1],
                                   batch["u_tokens"].shape[2],
                                   batch["ui_tokens"].shape[1],
                                   batch["ui_tokens"].shape[2])
            pred, _, _ = self.model(batch)
            outs.append((pred, alive))
        preds = [pred.cpu().numpy()[alive] for pred, alive in outs]
        return np.concatenate(preds) if preds else np.zeros(0, np.float32)


class _ConcatDatasets:
    """Read-only concatenation of packed datasets along the sample axis:
    the loader-facing fields, the photo paths and __len__."""

    def __init__(self, parts):
        for f in FIELDS + ("photo_paths",):
            setattr(self, f, np.concatenate([getattr(p, f) for p in parts]))

    def __len__(self):
        return self.u_tokens.shape[0]


class Coalescer:
    """Requests submitted within `window_s` of each other are merged into
    one dispatch (their samples concatenated, up to one batch).  One daemon
    thread owns the device.  Each request gets back exactly what its solo
    predict_dataset would return."""

    def __init__(self, predictor, window_s):
        import queue
        import threading
        self._p = predictor
        self._window = window_s
        self._q = queue.Queue()
        threading.Thread(target=self._run, daemon=True,
                         name="serve-coalescer").start()

    def predict(self, dataset, timeout=None):
        """Blocking: -> (predictions (N,), source_rows (N,))."""
        from concurrent.futures import Future
        fut = Future()
        self._q.put((dataset, fut))
        return fut.result(timeout=timeout), np.asarray(dataset.source_rows)

    def _run(self):
        import queue
        while True:
            pending = [self._q.get()]
            deadline = time.monotonic() + self._window
            cap = self._p.config.batch_size
            total = len(pending[0][0])
            while total < cap:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                pending.append(item)
                total += len(item[0])
            try:
                merged = (_ConcatDatasets([ds for ds, _ in pending])
                          if len(pending) > 1 else pending[0][0])
                preds = self._p._predict_packed(merged)
                off = 0
                for ds, fut in pending:
                    fut.set_result(preds[off:off + len(ds)])
                    off += len(ds)
            except Exception as e:  # hand the failure to every waiter
                for _, fut in pending:
                    if not fut.done():
                        fut.set_exception(e)


def make_http_server(predictor, config, word2vec, port, host="127.0.0.1"):
    """JSON-over-HTTP scorer around a Predictor.  Returns the (not yet
    serving) ThreadingHTTPServer.  Dataset builds (host) and predictions
    (device) hold separate locks, so one request's build overlaps
    another's device time."""
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    photo_json = os.path.join(config.data_dir, "photos.json")
    photo_dir = os.path.join(config.data_dir, "photos")
    build_lock = threading.Lock()
    device_lock = threading.Lock()
    coalesce_ms = max(0, config.serve_coalesce_ms)
    coalescer = (Coalescer(predictor, coalesce_ms / 1000.0)
                 if coalesce_ms > 0 else None)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass  # quiet: the application logger owns stdout

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {"status": "ok"})
            return self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                df = pd.DataFrame(req["rows"])
                for col in ("userID", "itemID", "review"):
                    if col not in df.columns:
                        raise ValueError(f"rows are missing column {col!r}")
                    if df[col].isna().any():
                        raise ValueError(f"column {col!r} contains null values")
                if "rating" not in df.columns:
                    df["rating"] = 0.0
                # histories key on integer ids; request-local ids are
                # equivalent because histories are request-local
                for col, src in (("user_num", "userID"), ("item_num", "itemID")):
                    if col not in df.columns:
                        df[col] = pd.factorize(df[src])[0]
            except Exception as e:
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            try:
                with build_lock:
                    df["review"] = df["review"].astype(str)
                    ds = build_dataset(None, photo_json, photo_dir,
                                       word2vec, config, df=df)
                if coalescer is not None:
                    preds, rows = coalescer.predict(ds)
                else:
                    with device_lock:
                        preds, rows = predictor.predict_dataset(ds)
                out = [None] * len(df)
                for p, r in zip(preds.tolist(), rows.tolist()):
                    # a bare NaN is not valid JSON
                    out[r] = p if math.isfinite(p) else None
                return self._json(200, {"predictions": out})
            except Exception as e:
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--input", default=None, help="CSV of pairs to score")
    parser.add_argument("--output", default="predictions.csv")
    parser.add_argument("--server", action="store_true",
                        help="serve POST /predict over HTTP instead of a "
                             "one-shot CSV pass")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--host", default="127.0.0.1")
    args, rest = parser.parse_known_args(argv)
    config = Config(rest)
    if not config.model_path:
        raise ValueError("--model_path is required for serving")

    w2v = Word2vec(config.word2vec_file)
    if args.server:
        server = make_http_server(Predictor(config, w2v, config.model_path),
                                  config, w2v, args.port, args.host)
        print(f"Serving on http://{args.host}:{server.server_address[1]} "
              f"(POST /predict, GET /health)")
        server.serve_forever()
        return

    if not args.input:
        raise ValueError("--input is required (or pass --server)")
    df = pd.read_csv(args.input)
    build_df = None
    if "rating" not in df.columns:
        df = df.copy()
        df["rating"] = 0.0
        build_df = df
    photo_json = os.path.join(config.data_dir, "photos.json")
    photo_dir = os.path.join(config.data_dir, "photos")
    ds = build_dataset(args.input, photo_json, photo_dir, w2v, config, df=build_df)

    preds, rows = Predictor(config, w2v, config.model_path).predict_dataset(ds)
    out = df[["userID", "itemID"]].copy()
    out["prediction"] = np.nan
    out.loc[out.index[rows], "prediction"] = preds
    out.to_csv(args.output, index=False)
    print(f"Wrote {len(preds)} predictions ({len(out) - len(preds)} rows "
          f"unscorable by the model's sample filters) to {args.output}")


if __name__ == "__main__":
    main()
