"""Training / evaluation loop (port of umpr_tpu/train/trainer.py: the
single-host path with the host loader).

The observable surface is the JAX trainer's: the same log lines at the
same cadence (initial validation MSE; train loss and validation MSE
whenever the batch counter crosses a multiple of ``eval_every``; the
epoch summary; the wall-clock summary), the same ``--metrics_jsonl``
events, ``best/`` saved on every improvement, the ``max_batches`` cap
checked at epoch end, and a final evaluation and save when no ``best/``
exists yet.  Each epoch shuffles the training set with seed ``seed +
epoch``, the JAX loader's order.

Checkpoints and resume (train/checkpoint.py, the JAX package's layout,
so either package resumes from the other's ``last/``): ``last/`` is
written at the end of every ``--save_last_every_epochs``-th epoch, of
the final epoch and of a stop at ``max_batches``, and, with
``--save_every_batches N``, whenever the batch counter crosses a
multiple of N, with the batch's offset in its epoch.  ``--resume_path``
restores the parameters, Adam's state, the counters and ``best_loss``,
and fast-forwards the first epoch's order to the saved offset
(``BatchLoader(start_batch=)``), so a resumed run takes the steps an
uninterrupted one would.  With ``--async_checkpoint`` (the default) the
host copies are taken on the main thread and the file writes run on a
worker thread; every reader of the files waits for it first.  On a card
cuDNN is pinned to deterministic algorithms (``cudnn.deterministic``,
no ``cudnn.benchmark``), so a run and its resumed twin give the same
bits.

Full UMPR: the train and eval loaders decode photos through one shared
``PhotoCache`` (``--photo_cache_mb``) with ``--data_workers`` threads;
``--vgg16_weights`` loads a checkpoint of the VGG16 subtree (a failure is
logged and training goes on, as in the JAX trainer).  Train step k draws
its dropout masks from a generator seeded by (``seed``, k): the JAX
trainer's fold_in(PRNGKey(seed), k) gives other bits, but the same
determinism.

``--steps_per_dispatch k``: the train, validation and test passes take
chunks of k batches (``data.loader.chunk_stream``) through
``step.MultiTrainStep`` / ``MultiEvalStep``, CUDA graphs on a card, and
the batches left at an epoch's end as single steps.  Evaluation,
``--save_every_batches`` and the profiler fire where the batch counter
crosses a multiple, as in the JAX trainer; ``eval_every`` must be a
multiple of k.  Every run, k = 1 included, trains with the port's own Adam
(train/optim.py): float32 moments, or ``--adam_moment_dtype bfloat16``
and ``--adam_factored_nu``.  ``--rnet_pretrained`` loads a checkpoint of
the R-Net subtree (a failure is logged and training goes on).
``--profile_dir``: a torch.profiler trace from the first dispatch at batch
2 over at least 4 steps (or to the epoch's end), written there as a
Chrome trace (``*.pt.trace.json``).  Progress bars (``utils.logging.
progress``) count dispatch items and show only on a terminal.

``--device_dataset`` (the JAX trainer's resident corpus): under ``on``,
and under ``auto`` where the packed text arrays of train + valid (for
full UMPR with a bank of every distinct photo, decoded once) fit
``--device_dataset_mb``, ``fit`` uploads them to the device once and each
dispatch ships (B,) or (k, B) int32 row indices and the live-row counts
(``_index_stream``: the loader's order, chunking and dead padding); the
steps gather their batches on the device (``step.gather_batch``), the
loader's batches bit for bit.  Evaluation of an uploaded split pads its
last chunk with all-dead batches, which add (0, 0); any other split
(test()'s) streams.  ``--grad_accum_steps k``: each train step is
``step.train_step_accum`` over k micro-batches; it streams (``on`` is
then logged as not honoured) and excludes ``--steps_per_dispatch``.

Data parallelism (``parallel/``, ROADMAP A7): after
``multihost.initialize`` the Trainer lays out the mesh
(``mesh.setup_runtime``) and every rank trains on its row block of each
global batch, which every rank builds alike: streamed, it keeps its rows
of the loader's batch (and decodes only their photos, ``photo_rows``);
resident, it holds the whole corpus and gathers its rows of the global
index on the device, inside the CUDA graph too.  Each block carries the
global batch's pad maxima and sample count, and the steps sum the ranks'
gradients, losses and evaluation parts over the ``dp`` group
(train/step.py).  Dropout masks are drawn at the global batch's shape
from the step's generator and each rank takes its rows, so the ranks'
samples get the masks of the 1-rank run.  ``--shard_embedding`` splits the
frozen table's rows over the mesh (models/layers.py ``ShardedEmbedding``).
Files are the primary's: it alone writes ``best/``, ``last/`` and the
metrics, each write followed by a named barrier; it reads ``--resume_path``
and ``best/`` and broadcasts them, an error text first, so that a failed
restore raises on every rank instead of leaving the others waiting; it
decodes the photo bank and broadcasts it; and its save decisions are
broadcast.  Checkpoint writes are synchronous in a world of more than one
rank (as in the JAX trainer): a barrier announces a durable file.
"""

from __future__ import annotations

import json
import math
import os
import time

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from umpr_tpu_torch.convert import (adam_from_jax, adam_to_jax, params_from_jax,
                                    params_to_jax, shape_only)
from umpr_tpu_torch.data.images import PhotoCache, load_photo_batch
from umpr_tpu_torch.data.loader import BatchLoader, chunk_stream, prefetch_iter, to_device
from umpr_tpu_torch.models.layers import ShardedEmbedding
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.models.visual_net import keep_masks
from umpr_tpu_torch.parallel import multihost
from umpr_tpu_torch.parallel.mesh import setup_runtime
from umpr_tpu_torch.serve import set_f32_parity
from umpr_tpu_torch.train import checkpoint as ckpt
from umpr_tpu_torch.train.optim import lr_at_epoch, make_optimizer
from umpr_tpu_torch.train.step import (RESIDENT_FIELDS, MultiEvalStep, MultiTrainStep,
                                       chunk_len, eval_step, gather_batch, mse_from_parts,
                                       train_step, train_step_accum)
from umpr_tpu_torch.utils.logging import progress


def dispatch_items(n_batches, k, pad_final_chunk=False):
    """Dispatches over n_batches batches at k steps each: full chunks, then
    the rest one by one, or as one padded chunk (resident evaluation);
    what a progress total counts."""
    rest = n_batches % k
    return n_batches // k + (min(rest, 1) if pad_final_chunk and k > 1 else rest)


class Trainer:
    def __init__(self, config, logger, word2vec):
        self.config = config
        self.logger = logger
        self.device = config.torch_device
        self.k_dispatch = config.steps_per_dispatch
        if self.k_dispatch < 1 or config.eval_every % self.k_dispatch:
            # keeps the eval cadence exact (umpr_tpu/train/trainer.py:104-112)
            raise ValueError(f"--steps_per_dispatch {self.k_dispatch} must be >= 1 and "
                             f"divide --eval_every {config.eval_every}")
        self.k_accum = config.grad_accum_steps
        if self.k_accum < 1 or config.batch_size % self.k_accum:
            raise ValueError(f"--grad_accum_steps {self.k_accum} must be >= 1 and divide "
                             f"--batch_size {config.batch_size}")
        self.world = multihost.world_size()
        self.mesh = setup_runtime(config)
        # this rank's row block of every global batch (None: the whole batch)
        self._rows = None if self.mesh is None else self.mesh.rows(config.batch_size)
        if self.mesh is not None:
            logger.info(f"Data parallel: {self.mesh}.")
            if self._rows is not None and (config.batch_size // self.mesh.dp) % self.k_accum:
                raise ValueError(f"--grad_accum_steps {self.k_accum} must divide the "
                                 f"{config.batch_size // self.mesh.dp} rows of a rank")
            if (self.device.type == "cuda" and self.mesh.backend == "gloo"
                    and self.k_dispatch > 1):
                raise NotImplementedError(
                    f"--steps_per_dispatch {self.k_dispatch} with gloo collectives on "
                    "CUDA: a CUDA graph cannot capture gloo's all-reduce (it runs on "
                    "the host), and ranks that share a card cannot use NCCL; run one "
                    "rank per card, or --steps_per_dispatch 1")
        if self.device.type == "cuda":
            set_f32_parity()
            # a resumed run matches an uninterrupted one bit for bit only
            # where every kernel repeats its bits: pin cuDNN's algorithms
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.dims = ModelDims.from_config(config)
        self.embedding = word2vec.embedding
        model = self._new_model()
        if config.rnet_pretrained:
            # the reference's RNet(pretrained=...) swallows a failed load
            # with a message (model.py:30-34); so does the JAX trainer
            try:
                ckpt.restore_module(config.rnet_pretrained, model.review_net.rnet)
                logger.info(f"Loaded R-Net pre-trained weights from "
                            f'"{config.rnet_pretrained}"')
            except Exception:
                logger.info(f"Failed to load R-Net pre-trained weights from "
                            f'"{config.rnet_pretrained}"')
        if config.vgg16_weights and not config.review_net_only:
            try:
                ckpt.restore_module(config.vgg16_weights, model.visual_net.vgg16)
                logger.info(f'Loaded VGG16 pretrained weights from "{config.vgg16_weights}"')
            except Exception:
                logger.info(f'Failed to load VGG16 weights from "{config.vgg16_weights}"')
        self.model = self._place(model)
        self.opt = make_optimizer(self.model, config.l2_regularization,
                                  config.learning_rate, config.adam_moment_dtype,
                                  config.adam_factored_nu)
        if self.k_dispatch > 1:
            self.multi_train_step = MultiTrainStep(self.model, self.opt, self.mesh)
            self.multi_eval_step = MultiEvalStep(self.mesh)
        self.photo_cache = (PhotoCache(config.photo_cache_mb << 20)
                            if config.photo_cache_mb > 0 else None)
        self._host_embedding = np.asarray(word2vec.embedding, np.float32)
        # in a world of more than one rank a barrier after each write says
        # that the file is durable: the writes are synchronous there
        self._saver = (ckpt.AsyncSaver() if config.async_checkpoint and self.world == 1
                       else None)
        # the resident corpus of the current fit: id(dataset) -> (dataset,
        # its tensors), and the photo bank's sorted paths
        self._resident = False
        self._dev_data = {}
        self._bank_uniq = None
        self._bank = None
        self.batch_counter = 0
        self.start_epoch = 0
        self.start_batch_in_epoch = 0
        self.best_loss = 100.0
        if config.resume_path:
            self._resume(config.resume_path)

    def _trainable(self):
        return [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]

    def _resume(self, path):
        """Parameters, Adam's state, counters and best_loss from
        ``<path>/last`` (written by either package)."""
        like = params_to_jax({n: torch.empty(p.shape, dtype=p.dtype)
                              for n, p in self._trainable()})
        trainable, (count, mu, nu), meta = self._primary_read(
            f"resume from {path}", ckpt.restore_last, path, like,
            adam_to_jax(self.model, self.opt, leaf=shape_only),
            self.config.adam_moment_dtype)
        missing, unexpected = self.model.load_state_dict(params_from_jax(trainable),
                                                         strict=False)
        if missing != ["embedding.weight"] or unexpected:
            raise ValueError(f"{path}/last does not match the model: missing "
                             f"{missing}, unexpected {unexpected}")
        adam_from_jax(self.model, self.opt, count, mu, nu)
        self.batch_counter = meta["batch_counter"]
        self.start_epoch = meta["epoch"]
        # mid-epoch checkpoints carry the batch offset in the epoch; fit()
        # fast-forwards the first epoch's order to it
        self.start_batch_in_epoch = meta.get("batch_in_epoch", 0)
        self.best_loss = meta["best_loss"]
        self.logger.info(
            f"Resumed from {path} at epoch {self.start_epoch}, batch "
            f"{self.batch_counter}" + (f" (+{self.start_batch_in_epoch} into the epoch)"
                                       if self.start_batch_in_epoch else "") + ".")

    def _primary_read(self, what, fn, *args):
        """fn(*args) on the primary (the only reader of checkpoint files),
        its result broadcast.  A failure's text is broadcast before the
        arrays, so every rank raises instead of waiting for them."""
        if self.world == 1:
            return fn(*args)
        out, err = None, ""
        if multihost.is_primary():
            try:
                out = fn(*args)
            except Exception as e:
                err = f"{type(e).__name__}: {e}"
        err = multihost.broadcast_str(err)
        if err:
            raise RuntimeError(f"{what} failed on the primary rank: {err}")
        return multihost.broadcast_tree(out)

    def _decide(self, flag):
        """The primary's decision on every rank."""
        return multihost.broadcast_str("1" if flag else "0") == "1"

    def _durable(self, name):
        """After the primary's write: the write joined, then every rank
        meets at the barrier `name`."""
        self._ckpt_wait()
        multihost.barrier(name)

    # ---- checkpoint writes (sync, or the file writes on a worker thread) --
    def _host_params(self):
        """Host copies of the trainable parameters, JAX layout: taken on
        the main thread, before the next step changes them in place."""
        return params_to_jax({n: p.detach().to("cpu", copy=True)
                              for n, p in self._trainable()})

    def _write(self, fn, *args, **kwargs):
        if self._saver is None:
            fn(*args, **kwargs)
        else:
            self._saver.submit(fn, *args, **kwargs)

    def _ckpt_wait(self):
        """Join the write in flight: every reader of the files waits here."""
        if self._saver is not None:
            self._saver.wait()

    def _save_best(self, model_path):
        tree = self._host_params()
        tree["embedding"] = self._host_embedding
        self._write(ckpt.save_pytree, os.path.join(model_path, "best"), tree)

    def _save_last(self, model_path, **meta):
        self._write(ckpt.save_last, model_path, self._host_params(),
                    adam_to_jax(self.model, self.opt),
                    moment_dtype=self.config.adam_moment_dtype, **meta)

    def _new_model(self):
        return UMPR(self.dims, self.embedding,
                    torch.Generator().manual_seed(self.config.seed))

    def _place(self, model):
        """`model` on the device; with --shard_embedding its frozen table
        split over the mesh (one rank: the whole table).  best/ is written
        from the unpadded host table, so it does not depend on the layout."""
        if self.config.shard_embedding and self.mesh is not None:
            model.embedding = ShardedEmbedding(model.embedding.weight.detach(),
                                               self.mesh.table_group())
        return model.to(self.device)

    def _loader(self, dataset, shuffle=False, seed=0, start_batch=0):
        cfg = self.config
        return BatchLoader(dataset, cfg.batch_size, shuffle=shuffle, seed=seed,
                           start_batch=start_batch,
                           ignore_photos=cfg.review_net_only,
                           resize=(cfg.photo_size, cfg.photo_size),
                           workers=cfg.data_workers, photo_cache=self.photo_cache,
                           photo_rows=self._rows)

    def _dropout(self, batch_counter):
        """Train step `batch_counter`'s dropout: its generator or, on a rank
        of a split batch, this rank's rows of the masks that the generator
        draws for the whole batch, micro-batch by micro-batch as the 1-rank
        step draws them (so every sample gets the 1-rank run's masks)."""
        g = self.dropout_generator(batch_counter)
        if g is None or self._rows is None:
            return g
        cfg = self.config
        per_sample = len(cfg.views) * cfg.photo_count  # VGG rows of a sample
        shapes = self.model.visual_net.vgg16.dropout_shapes(
            cfg.batch_size // self.k_accum * per_sample)
        micro = [keep_masks(shapes, g, self.device) for _ in range(self.k_accum)]
        rows = slice(self._rows.start * per_sample, self._rows.stop * per_sample)
        return [torch.cat(call)[rows] for call in zip(*micro)]

    def dropout_generator(self, batch_counter):
        """The generator of train step `batch_counter`'s dropout masks, on
        the model's device, seeded from (seed, batch_counter); None for
        UMPR-R, which has no dropout."""
        if self.config.review_net_only:
            return None
        seed = np.random.SeedSequence([self.config.seed, batch_counter])
        return torch.Generator(device=self.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0]))

    def _device_batches(self, loader):
        return prefetch_iter((multihost.put_local(b, self.device, self._rows) for b in loader),
                             depth=self.config.prefetch_depth)

    def _dispatch_stream(self, loader):
        """("single", device batch) or ("chunk", k stacked device batches)
        items over `loader`; with k > 1 the batches left that cannot fill a
        chunk come as singles (a dead batch inside a chunk of train steps
        would still apply weight decay)."""
        if self.k_dispatch == 1:
            for b in self._device_batches(loader):
                yield "single", b
            return
        put = lambda hb: to_device(hb, self.device)
        if self._rows is not None:  # this rank's rows of each global batch
            loader = (multihost.put_global(hb, self._rows) for hb in loader)
        # extract: the host batches (decoded photos included) are dropped
        # as soon as their transfer is made; nothing reads them back
        for dev, _, chunked in chunk_stream(loader, self.k_dispatch, put, put,
                                            depth=self.config.prefetch_depth,
                                            extract=lambda hb: None):
            yield ("chunk" if chunked else "single"), dev

    def _train_step(self, batch, drop):
        """One train step of a device batch -> (loss, n_real)."""
        if self.k_accum > 1:
            return train_step_accum(self.model, self.opt, batch, self.k_accum, drop,
                                    self.mesh)[:2]
        return train_step(self.model, self.opt, batch, drop=drop, mesh=self.mesh)

    # ---- the device-resident corpus (--device_dataset) ----
    def _resident_mode(self, *datasets):
        """Does this fit keep `datasets` on the device (the JAX trainer's
        gate)?  Sets ``_bank_uniq`` where full UMPR takes a photo bank."""
        cfg = self.config
        mode = cfg.device_dataset
        self._bank_uniq = None
        if mode == "off":
            return False
        reasons = []
        if self.k_accum > 1:
            reasons.append("grad_accum_steps uses the streaming micro-batch step")
        total = sum(getattr(d, f).nbytes for d in datasets for f in RESIDENT_FIELDS)
        if not reasons and mode == "auto" and total > (cfg.device_dataset_mb << 20):
            reasons.append(f"packed arrays {total >> 20} MB exceed "
                           f"device_dataset_mb={cfg.device_dataset_mb}")
        bank_note = ""
        if not reasons and not cfg.review_net_only:
            # the bank of every distinct photo (uint8, row 0 the zeros of
            # the path '') must fit the budget too
            uniq = np.unique(np.concatenate([d.photo_paths.ravel() for d in datasets]))
            if uniq.size == 0 or uniq[0] != "":
                uniq = np.concatenate([np.array([""], dtype=uniq.dtype), uniq])
            bank_bytes = uniq.size * cfg.photo_size * cfg.photo_size * 3
            total += bank_bytes + sum(d.photo_paths.size * 4 for d in datasets)
            if mode == "auto" and total > (cfg.device_dataset_mb << 20):
                reasons.append(f"packed arrays + {uniq.size - 1}-photo bank = "
                               f"{total >> 20} MB exceed "
                               f"device_dataset_mb={cfg.device_dataset_mb}")
            else:
                self._bank_uniq = uniq
                bank_note = f" (incl. a {uniq.size - 1}-photo {bank_bytes >> 20} MB bank)"
        if reasons:
            if mode == "on":
                self.logger.info("device_dataset=on not honored (" + "; ".join(reasons)
                                 + "); streaming.")
            return False
        self.logger.info(f"Device-resident dataset mode: {total >> 20} MB of packed "
                         f"arrays on {self.device}{bank_note}, index-only dispatch.")
        return True

    def _device_data(self, dataset):
        """The dataset's packed arrays on the device, uploaded once per fit
        (and the bank with the (N, V, P) bank rows of its photos: the bank
        holds the sorted distinct paths, so searchsorted is exact)."""
        entry = self._dev_data.get(id(dataset))
        if entry is None:
            data = {f: multihost.put_replicated(getattr(dataset, f), self.device)
                    for f in RESIDENT_FIELDS}
            if self._bank_uniq is not None:
                data["photo_bank"] = self._photo_bank()
                data["photo_idx"] = multihost.put_replicated(
                    np.searchsorted(self._bank_uniq, dataset.photo_paths).astype(np.int32),
                    self.device)
            # the dataset is held so that its id is not reused
            entry = self._dev_data[id(dataset)] = (dataset, data)
        return entry[1]

    def _photo_bank(self):
        """The (C, H, W, 3) uint8 bank of ``_bank_uniq``, each photo decoded
        once, by the streaming loader's decoder and cache (so '' and
        unreadable files give its zeros).  In a world of more than one rank
        the primary decodes it and broadcasts the bytes: replicas must hold
        the same bank, and the other ranks need not have the files."""
        if self._bank is None:
            cfg = self.config
            imgs = None
            if multihost.is_primary():
                workers = cfg.data_workers
                executor = ThreadPoolExecutor(max_workers=workers) if workers > 0 else None
                try:
                    imgs = load_photo_batch(self._bank_uniq.reshape(-1, 1, 1),
                                            (cfg.photo_size, cfg.photo_size), executor,
                                            self.photo_cache)[:, 0, 0]
                finally:
                    if executor is not None:
                        executor.shutdown()
            self._bank = torch.from_numpy(multihost.broadcast_tree(imgs)).to(self.device)
        return self._bank

    def _index_stream(self, n, seed, start_batch, shuffle=True, pad_final_chunk=False):
        """The resident twin of BatchLoader + chunk_stream over n rows:
        ("chunk", {"idx": (k, B), "n_real": (k,)}) for full chunks and
        ("single", {"idx": (B,), "n_real": ()}) for the rest, int32 numpy,
        in the loader's order for `seed` from `start_batch` on, dead rows
        pointing at row 0.  pad_final_chunk (evaluation only: a dead batch
        in a train chunk would still apply weight decay) fills the rest
        up to one last chunk with all-dead batches."""
        B, k = self.config.batch_size, self.k_dispatch
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        chunk = lambda buf: ("chunk", {"idx": np.stack([r for r, _ in buf]),
                                       "n_real": np.asarray([m for _, m in buf], np.int32)})
        buf = []
        for start in range(start_batch * B, n, B):
            rows = order[start:start + B]
            n_real = len(rows)
            rows = np.concatenate([rows, np.zeros(B - n_real, rows.dtype)])
            buf.append((rows.astype(np.int32), n_real))
            if k > 1 and len(buf) == k:
                yield chunk(buf)
                buf = []
        if pad_final_chunk and k > 1 and len(buf) > 1:
            yield chunk(buf + [(np.zeros(B, np.int32), 0)] * (k - len(buf)))
            return
        for rows, n_real in buf:
            yield "single", {"idx": rows, "n_real": np.asarray(n_real, np.int32)}

    def _resident_stream(self, *args, **kwargs):
        """_index_stream's items with their arrays on the device, made
        ahead on the prefetch thread."""
        put = lambda p: {key: torch.from_numpy(v).to(self.device) for key, v in p.items()}
        return prefetch_iter(((kind, put(p)) for kind, p in self._index_stream(*args, **kwargs)),
                             depth=self.config.prefetch_depth)

    def _evaluate(self, loader, model=None):
        """MSE over `loader` with the training model, or `model` (test()'s
        restored one), through the same dispatch as training: resident
        where fit() uploaded the loader's dataset."""
        model = self.model if model is None else model
        entry = self._dev_data.get(id(loader.ds))
        data = None if entry is None else entry[1]
        if data is None:
            stream = self._dispatch_stream(loader)
            n_items = dispatch_items(len(loader), self.k_dispatch)
        else:
            stream = self._resident_stream(len(loader.ds), 0, 0, shuffle=False,
                                           pad_final_chunk=True)
            n_items = dispatch_items(len(loader), self.k_dispatch, pad_final_chunk=True)
        parts = []
        for kind, payload in progress(stream, "Evaluate", n_items):
            if kind == "chunk":
                parts.append(self.multi_eval_step(model, payload, data))
            else:
                parts.append(eval_step(model, payload if data is None else gather_batch(
                    data, payload["idx"], payload["n_real"], self._rows), self.mesh))
        return mse_from_parts(parts)

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof):
        """Close the trace and write it under --profile_dir."""
        prof.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(self.config.profile_dir,
                            f"train_{os.getpid()}_{self.batch_counter}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.logger.info(f"Profile trace written to {path}")

    def _metric(self, event, **kv):
        """Append one JSON line to --metrics_jsonl (the primary's); non-finite
        floats are written as null."""
        path = self.config.metrics_jsonl
        if not path or not multihost.is_primary():
            return
        kv = {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
              for k, v in kv.items()}
        kv = {"event": event, "ts": round(time.time(), 3), **kv}
        try:
            with open(path, "a") as f:
                f.write(json.dumps(kv) + "\n")
        except OSError as e:
            self.logger.info(f"metrics_jsonl write failed: {e}")

    def fit(self, train_data, valid_data, model_path, _stop_after_batches=0):
        """_stop_after_batches: a test hook; return after that many train
        steps of this call, as an interruption would leave the run
        (whatever checkpoints exist, no epoch-end bookkeeping)."""
        cfg, logger = self.config, self.logger
        logger.info("Start to train!")
        # a second fit() may bring other datasets: drop the last fit's
        # resident tensors, its bank and every graph that reads them
        self._dev_data, self._bank = {}, None
        if self.k_dispatch > 1:
            self.multi_train_step.drop_resident()
            self.multi_eval_step.drop_resident()
        self._resident = self._resident_mode(train_data, valid_data)
        dev_train = None
        if self._resident:
            dev_train = self._device_data(train_data)
            self._device_data(valid_data)
        valid_loader = self._loader(valid_data)
        valid_mse = self._evaluate(valid_loader)
        logger.info(f"Initial validation mse is {valid_mse:.6f}")
        self._metric("eval", epoch=self.start_epoch, batch=self.batch_counter,
                     valid_mse=valid_mse)
        start_time = time.perf_counter()
        batches_this_call = 0
        profiled = False

        for epoch in range(self.start_epoch, cfg.train_epochs):
            lr = lr_at_epoch(cfg.learning_rate, cfg.lr_decay, epoch)
            self.opt.set_lr(lr)
            # a mid-epoch resume fast-forwards the first epoch's order
            epoch_offset = self.start_batch_in_epoch if epoch == self.start_epoch else 0
            batch_in_epoch = epoch_offset
            if self._resident:
                stream = self._resident_stream(len(train_data), cfg.seed + epoch, epoch_offset)
            else:
                stream = self._dispatch_stream(self._loader(
                    train_data, shuffle=True, seed=cfg.seed + epoch, start_batch=epoch_offset))
            # (loss * n_real, n_real) device tensors per dispatch, 0-d or
            # (k,), summed only at the logging points in batch order:
            # reading one per step would wait for the card
            parts = []

            def totals():
                if not parts:
                    return 0.0, 0.0
                ls = torch.cat([p[0].reshape(-1) for p in parts]).sum()
                ns = torch.cat([p[1].reshape(-1) for p in parts]).sum()
                parts[:] = [(ls, ns)]
                return float(ls), float(ns)

            def after_steps(n_steps):
                nonlocal batch_in_epoch, batches_this_call, profiled
                before = self.batch_counter
                self.batch_counter += n_steps
                batch_in_epoch += n_steps
                batches_this_call += n_steps
                # the trace covers at least 4 steps, counted in dispatches
                if prof is not None and not profiled and \
                        self.batch_counter >= profile_start + 4:
                    self._stop_profile(prof)
                    profiled = True
                # crossing a multiple of eval_every, as the JAX trainer
                # counts: chunks after an epoch's remainder need not land
                # on one
                if self.batch_counter // cfg.eval_every > before // cfg.eval_every:
                    valid_mse = self._evaluate(valid_loader)
                    t_loss, t_n = totals()
                    train_loss = t_loss / t_n
                    logger.info(f"\rEpoch {epoch:2d}; batch {self.batch_counter:5d}; "
                                f"train loss {train_loss:.6f}; "
                                f"valid mse {valid_mse:.6f}")
                    self._metric("eval", epoch=epoch, batch=self.batch_counter,
                                 train_loss=train_loss, valid_mse=valid_mse,
                                 lr=lr, elapsed_s=round(
                                     time.perf_counter() - start_time, 3))
                    if self._decide(self.best_loss > valid_mse):
                        if multihost.is_primary():
                            self._save_best(model_path)
                        self._durable(f"save_best_{self.batch_counter}")
                        self.best_loss = valid_mse
                if (cfg.save_every_batches and self.batch_counter // cfg.save_every_batches
                        > before // cfg.save_every_batches):
                    if multihost.is_primary():
                        self._save_last(model_path, epoch=epoch,
                                        batch_counter=self.batch_counter,
                                        best_loss=self.best_loss,
                                        batch_in_epoch=batch_in_epoch)
                    self._durable(f"save_mid_{self.batch_counter}")

            prof, profile_start = None, 0
            stopped = False
            # the bar counts dispatches, over the batches left after a
            # mid-epoch resume
            n_batches = -(-len(train_data) // cfg.batch_size)
            n_items = dispatch_items(n_batches - epoch_offset, self.k_dispatch)
            for kind, payload in progress(stream, f"Training epoch {epoch}", n_items):
                if cfg.profile_dir and not profiled and prof is None \
                        and self.batch_counter >= 2:
                    prof, profile_start = self._start_profile(), self.batch_counter
                if kind == "chunk":
                    k = chunk_len(payload)
                    gens = [self._dropout(self.batch_counter + j) for j in range(k)]
                    parts.append(self.multi_train_step(payload, gens, dev_train))
                    after_steps(k)
                else:
                    if dev_train is not None:
                        payload = gather_batch(dev_train, payload["idx"], payload["n_real"],
                                               self._rows)
                    loss, n_real = self._train_step(payload, self._dropout(self.batch_counter))
                    parts.append((loss * n_real, n_real))
                    after_steps(1)
                if _stop_after_batches and batches_this_call >= _stop_after_batches:
                    stopped = True
                    break
            if prof is not None and not profiled:
                # a short epoch (or a stop) closes the trace
                self._stop_profile(prof)
                profiled = True
            if stopped:
                stream.close()  # its prefetch thread ends here, not at exit
                self._ckpt_wait()  # the caller reads the files next
                return

            t_loss, t_n = totals()
            logger.info(f"Epoch {epoch:3d} done; train loss "
                        f"{t_loss / max(t_n, 1.0):.6f}")
            self._metric("epoch", epoch=epoch, batch=self.batch_counter,
                         train_loss=t_loss / max(t_n, 1.0), lr=lr,
                         elapsed_s=round(time.perf_counter() - start_time, 3))
            # the final epoch and a stop at max_batches always save, so a
            # finished fit() is resumable from its end
            every = max(1, cfg.save_last_every_epochs)
            if ((epoch + 1) % every == 0 or epoch + 1 == cfg.train_epochs
                    or self.batch_counter > cfg.max_batches):
                if multihost.is_primary():
                    self._save_last(model_path, epoch=epoch + 1,
                                    batch_counter=self.batch_counter,
                                    best_loss=self.best_loss, batch_in_epoch=0)
                self._durable(f"save_last_{epoch}")
            if self.batch_counter > cfg.max_batches:
                break

        # a run shorter than eval_every reaches no eval point: evaluate once
        # and save, so that test() and --test_only find a best/
        self._ckpt_wait()
        if self._decide(multihost.is_primary() and not ckpt.has_best(model_path)):
            valid_mse = self._evaluate(valid_loader)
            logger.info(f"Final validation mse is {valid_mse:.6f}")
            self._metric("eval", epoch=cfg.train_epochs,
                         batch=self.batch_counter, valid_mse=valid_mse)
            if multihost.is_primary():
                self._save_best(model_path)
            self._durable("save_best_final")
            self.best_loss = min(self.best_loss, valid_mse)
        self._ckpt_wait()  # fit() returns with its checkpoints written

        second = int(time.perf_counter() - start_time)
        logger.info(f"End of training! Time used {second // 3600}:"
                    f"{second % 3600 // 60}:{second % 60}.")

    def test(self, test_data, model_path):
        """Test-set MSE of the parameters in ``<model_path>/best``."""
        logger = self.logger
        logger.info("Start to test.")
        self._ckpt_wait()  # best/ may still be in the writer's hands
        model = self._new_model()
        best = os.path.join(model_path, "best")
        tree = self._primary_read(f"restore_best from {model_path}", ckpt.restore_pytree,
                                  best, params_to_jax(model.state_dict()))
        model.load_state_dict(params_from_jax(tree))
        mse = self._evaluate(self._loader(test_data), self._place(model))
        logger.info(f"Test end, test mse is {mse:.6f}")
        self._metric("test", test_mse=mse)
        return mse
