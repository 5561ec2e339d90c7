"""Training / evaluation loop (port of umpr_tpu/train/trainer.py: the
single-host path with one train step per batch and the host loader).

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

Not ported (their flags raise, ROADMAP A4/A5/A7): R-Net warm starts,
bfloat16 and factored Adam moments, profiling, multi-step dispatch, the
device-resident corpus (``--device_dataset on``) and multi-host runs.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from umpr_tpu_torch.convert import (adam_from_jax, adam_to_jax, params_from_jax,
                                    params_to_jax)
from umpr_tpu_torch.data.images import PhotoCache
from umpr_tpu_torch.data.loader import BatchLoader, prefetch_iter, to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.serve import set_f32_parity
from umpr_tpu_torch.train import checkpoint as ckpt
from umpr_tpu_torch.train.optim import lr_at_epoch, make_optimizer
from umpr_tpu_torch.train.step import evaluate_mse, train_step


class Trainer:
    def __init__(self, config, logger, word2vec):
        self.config = config
        self.logger = logger
        self.device = config.torch_device
        if config.device_dataset == "on":
            raise NotImplementedError(
                "--device_dataset on (the training corpus resident on the "
                "device) is not ported yet (ROADMAP A5); 'auto' and 'off' "
                "stream every batch from the host loader")
        if self.device.type == "cuda":
            set_f32_parity()
            # a resumed run matches an uninterrupted one bit for bit only
            # where every kernel repeats its bits: pin cuDNN's algorithms
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.dims = ModelDims.from_config(config)
        self.embedding = word2vec.embedding
        model = self._new_model()
        if config.vgg16_weights and not config.review_net_only:
            try:
                ckpt.restore_module(config.vgg16_weights, model.visual_net.vgg16)
                logger.info(f'Loaded VGG16 pretrained weights from "{config.vgg16_weights}"')
            except Exception:
                logger.info(f'Failed to load VGG16 weights from "{config.vgg16_weights}"')
        self.model = model.to(self.device)
        self.opt = make_optimizer(self.model, config.l2_regularization,
                                  config.learning_rate)
        self.photo_cache = (PhotoCache(config.photo_cache_mb << 20)
                            if config.photo_cache_mb > 0 else None)
        self._host_embedding = np.asarray(word2vec.embedding, np.float32)
        self._saver = ckpt.AsyncSaver() if config.async_checkpoint else None
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
        trainable, (count, mu, nu), meta = ckpt.restore_last(path, like)
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
                    adam_to_jax(self.model, self.opt), **meta)

    def _new_model(self):
        return UMPR(self.dims, self.embedding,
                    torch.Generator().manual_seed(self.config.seed))

    def _loader(self, dataset, shuffle=False, seed=0, start_batch=0):
        cfg = self.config
        return BatchLoader(dataset, cfg.batch_size, shuffle=shuffle, seed=seed,
                           start_batch=start_batch,
                           ignore_photos=cfg.review_net_only,
                           resize=(cfg.photo_size, cfg.photo_size),
                           workers=cfg.data_workers, photo_cache=self.photo_cache)

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
        return prefetch_iter((to_device(b, self.device) for b in loader),
                             depth=self.config.prefetch_depth)

    def _evaluate(self, loader, model=None):
        return evaluate_mse(self.model if model is None else model,
                            self._device_batches(loader))

    def _metric(self, event, **kv):
        """Append one JSON line to --metrics_jsonl; non-finite floats are
        written as null."""
        path = self.config.metrics_jsonl
        if not path:
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
        valid_loader = self._loader(valid_data)
        valid_mse = self._evaluate(valid_loader)
        logger.info(f"Initial validation mse is {valid_mse:.6f}")
        self._metric("eval", epoch=self.start_epoch, batch=self.batch_counter,
                     valid_mse=valid_mse)
        start_time = time.perf_counter()
        batches_this_call = 0

        for epoch in range(self.start_epoch, cfg.train_epochs):
            lr = lr_at_epoch(cfg.learning_rate, cfg.lr_decay, epoch)
            # a mid-epoch resume fast-forwards the first epoch's order
            batch_in_epoch = self.start_batch_in_epoch if epoch == self.start_epoch else 0
            train_loader = self._loader(train_data, shuffle=True,
                                        seed=cfg.seed + epoch, start_batch=batch_in_epoch)
            # (loss * n_real, n_real) device scalars, summed only at the
            # logging points: reading one per step would wait for the card
            parts = []

            def totals():
                if not parts:
                    return 0.0, 0.0
                ls = torch.stack([p[0] for p in parts]).sum()
                ns = torch.stack([p[1] for p in parts]).sum()
                parts[:] = [(ls, ns)]
                return float(ls), float(ns)

            stopped = False
            for batch in self._device_batches(train_loader):
                loss, n_real = train_step(self.model, self.opt, batch, lr,
                                          self.dropout_generator(self.batch_counter))
                parts.append((loss * n_real, n_real))
                before = self.batch_counter
                self.batch_counter += 1
                batch_in_epoch += 1
                batches_this_call += 1
                # crossing a multiple of eval_every, as the JAX trainer counts
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
                    if self.best_loss > valid_mse:
                        self._save_best(model_path)
                        self.best_loss = valid_mse
                if (cfg.save_every_batches and self.batch_counter // cfg.save_every_batches
                        > before // cfg.save_every_batches):
                    self._save_last(model_path, epoch=epoch,
                                    batch_counter=self.batch_counter,
                                    best_loss=self.best_loss,
                                    batch_in_epoch=batch_in_epoch)
                if _stop_after_batches and batches_this_call >= _stop_after_batches:
                    stopped = True
                    break
            if stopped:
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
                self._save_last(model_path, epoch=epoch + 1,
                                batch_counter=self.batch_counter,
                                best_loss=self.best_loss, batch_in_epoch=0)
            if self.batch_counter > cfg.max_batches:
                break

        # a run shorter than eval_every reaches no eval point: evaluate once
        # and save, so that test() and --test_only find a best/
        self._ckpt_wait()
        if not ckpt.has_best(model_path):
            valid_mse = self._evaluate(valid_loader)
            logger.info(f"Final validation mse is {valid_mse:.6f}")
            self._metric("eval", epoch=cfg.train_epochs,
                         batch=self.batch_counter, valid_mse=valid_mse)
            self._save_best(model_path)
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
        ckpt.restore_best(model_path, model)
        mse = self._evaluate(self._loader(test_data), model.to(self.device))
        logger.info(f"Test end, test mse is {mse:.6f}")
        self._metric("test", test_mse=mse)
        return mse
