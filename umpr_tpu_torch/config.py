"""Config / flag system: the port's own copy of umpr_tpu's flag surface.

Every public class attribute is a hyperparameter default and becomes a
``--<name>`` CLI flag; ``bool``/``int``/``float``/``list`` attributes are
parsed with ``ast.literal_eval`` so ``--review_net_only True`` and
``--views "['food']"`` work as in umpr_tpu/config.py.

Differences from the JAX package:

- ``device`` defaults to ``"cuda"``.  A CUDA device that is not there
  raises; nothing carries on on the CPU.  ``--device cpu`` is the only way
  onto the CPU.
- ``multi_gpu`` defaults to False (the port runs on one card) and
  ``build_chunk_rows`` to 0 (the port always takes the full-memory build).
- Every flag that nothing in the port reads yet keeps its name and
  default, and raises ``NotImplementedError`` naming the ROADMAP.md item
  that ports it when given another value (``NOT_PORTED``).  So a flag the
  port accepts is a flag it honours.
"""

from __future__ import annotations

import argparse
import ast

import torch


class Config:
    # ----- training schedule -----
    device = "cuda"  # "cuda" | "cuda:<n>" | "cpu"
    multi_gpu = False  # True over more than one card: ROADMAP A6
    train_epochs = 20
    batch_size = 64
    learning_rate = 1e-6
    l2_regularization = 1e-3
    lr_decay = 0.99

    # ----- paths -----
    word2vec_file = "embedding/glove.6B.50d.txt"
    data_dir = "data/music"
    log_path = ""
    model_path = ""

    # ----- mode switches -----
    test_only = False
    review_net_only = False  # False (full UMPR) is ROADMAP A3; pass True

    # ----- dataset shaping -----
    review_level = "sentence"  # 'sentence' or 'review'
    max_sent_count = 20
    min_sent_count = 5
    max_ui_sent_count = 5
    max_sent_length = 20
    views = ["unknown"]
    photo_count = 1

    # ----- model sizes -----
    gru_size = 64
    self_atte_size = 64
    kernel_count = 120
    kernel_size = 3
    threshold = 0.35
    loss_v_rate = 0.1

    # ----- additions of umpr_tpu (same names and defaults) -----
    seed = 0
    compute_dtype = "float32"
    eval_every = 500
    max_batches = 50000
    prefetch_depth = 2  # host->device look-ahead batches while serving
    save_every_batches = 0
    save_last_every_epochs = 1
    steps_per_dispatch = 1
    grad_accum_steps = 1
    data_workers = 0
    device_dataset = 'auto'
    device_dataset_mb = 4096
    serve_coalesce_ms = 0  # HTTP serving: merge concurrent /predict
                           # requests arriving within this window into one
                           # device batch (0 = every request alone)
    photo_cache_mb = 2048
    use_pallas = True  # the port's bi-GRU always runs the kernels of
                       # ops/gru_cuda.py (plain versions on CPU)
    mesh_shape = []
    shard_embedding = False
    resume_path = ""
    rnet_pretrained = ""
    vgg16_weights = ""
    photo_size = 224
    vgg_fold_w = True
    vgg_fused_pool = False
    remat_vgg = False
    adam_moment_dtype = "float32"
    adam_factored_nu = False
    profile_dir = ""
    metrics_jsonl = ""
    cache_dataset = True
    checkpoint_backend = "npz"  # 'orbax' is a JAX library
    async_checkpoint = True
    coordinator_address = ""
    num_processes = 0
    process_id = -1
    build_chunk_rows = 0  # 0 = the full-memory build; streaming is ROADMAP A4

    def __init__(self, argv=None):
        parser = argparse.ArgumentParser()
        for key, val in self._attributes():
            receive_type = type(val)
            if receive_type in (bool, int, float, list):
                receive_type = ast.literal_eval
            parser.add_argument("--" + key, dest=key, type=receive_type, default=val)
        for key, val in vars(parser.parse_args(argv)).items():
            setattr(self, key, val)

        if self.review_level not in ("sentence", "review"):
            raise ValueError('"review_level" must be equal to "sentence" or "review"!')
        if not self.review_net_only:
            raise NotImplementedError(
                "full UMPR (--review_net_only False) is not ported yet "
                "(ROADMAP A3); pass --review_net_only True")
        defaults = dict(self._attributes())
        for key, item in NOT_PORTED.items():
            if getattr(self, key) != defaults[key]:
                raise NotImplementedError(
                    f"--{key} {getattr(self, key)!r} is not ported yet "
                    f"({item}); only its default {defaults[key]!r} is taken")
        self.torch_device = resolve_device(self.device, self.multi_gpu)

    @classmethod
    def _attributes(cls):
        items = {}
        for klass in reversed(cls.__mro__):
            for key, val in vars(klass).items():
                if key.startswith("_") or callable(val) or isinstance(
                        val, (classmethod, staticmethod, property)):
                    continue
                items[key] = val
        return sorted(items.items())


# flag -> the ROADMAP.md item that ports what it selects.  Every other flag
# is read by the port.
NOT_PORTED = {
    **dict.fromkeys((
        "train_epochs", "learning_rate", "l2_regularization", "lr_decay",
        "log_path", "test_only", "eval_every", "max_batches",
        "save_every_batches", "save_last_every_epochs", "resume_path",
        "rnet_pretrained", "adam_moment_dtype", "adam_factored_nu",
        "profile_dir", "metrics_jsonl", "cache_dataset", "checkpoint_backend",
    ), "ROADMAP A2, training"),
    **dict.fromkeys((
        "kernel_count", "kernel_size", "threshold", "loss_v_rate",
        "data_workers", "photo_cache_mb", "vgg16_weights", "photo_size",
        "vgg_fold_w", "vgg_fused_pool", "remat_vgg",
    ), "ROADMAP A3, full UMPR"),
    **dict.fromkeys((
        "compute_dtype", "steps_per_dispatch", "grad_accum_steps",
        "device_dataset", "device_dataset_mb", "async_checkpoint",
        "build_chunk_rows",
    ), "ROADMAP A4, runtime features"),
    **dict.fromkeys((
        "mesh_shape", "shard_embedding", "coordinator_address",
        "num_processes", "process_id",
    ), "ROADMAP A6, parallelism"),
    # the port has no kernel-free path on the card; --device cpu runs the
    # plain versions
    "use_pallas": "no ROADMAP item: the card always runs the CUDA kernels",
}


def resolve_device(name, multi_gpu=False):
    """``--device`` -> torch.device.  A CUDA device must exist: this raises
    instead of running on the CPU."""
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"--device {name}: expected 'cuda', 'cuda:<n>' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name} asks for a CUDA device and none is available; "
            "pass --device cpu to run on the CPU")
    if multi_gpu and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"--multi_gpu True over {torch.cuda.device_count()} devices is "
            "not ported yet (ROADMAP A6); pass --multi_gpu False")
    return device
