"""Config / flag system: the port's own copy of umpr_tpu's flag surface.

Every public class attribute is a hyperparameter default and becomes a
``--<name>`` CLI flag; ``bool``/``int``/``float``/``list`` attributes are
parsed with ``ast.literal_eval`` so ``--review_net_only True`` and
``--views "['food']"`` work as in umpr_tpu/config.py.

Differences from the JAX package:

- ``device`` defaults to ``"cuda"``.  A CUDA device that is not there
  raises; nothing carries on on the CPU.  ``--device cpu`` is the only way
  onto the CPU.
- ``multi_gpu`` defaults to False (the port runs on one card),
  ``build_chunk_rows`` to 0 (the port always takes the full-memory build)
  and ``cache_dataset`` to False (each split is built in memory).
- ``device_dataset``: serving full UMPR keeps the decode-once photo bank
  on the card unless it is ``off`` (``device_dataset_mb`` caps it);
  training streams every batch from the host loader under ``off`` and
  ``auto``, and raises under ``on`` (the resident training corpus is
  ROADMAP A5).
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
    multi_gpu = False  # True over more than one card: ROADMAP A7
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
    review_net_only = False  # True: UMPR-R; False: full UMPR (photos, VGG16)

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
    prefetch_depth = 2  # host->device look-ahead batches
    save_every_batches = 0
    save_last_every_epochs = 1
    steps_per_dispatch = 1
    grad_accum_steps = 1
    data_workers = 0
    device_dataset = 'auto'  # 'auto' | 'on' | 'off'
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
    photo_size = 224  # a positive multiple of 32 (VGG16's five pools)
    vgg_fold_w = True  # the JAX package's TPU lane-layout trick: the same
                       # function either way; the port never folds
    vgg_fused_pool = False  # close VGG blocks with H >= 56 with K5/K6
    remat_vgg = False
    adam_moment_dtype = "float32"
    adam_factored_nu = False
    profile_dir = ""
    metrics_jsonl = ""
    cache_dataset = False  # the dataset cache is ROADMAP A5
    checkpoint_backend = "npz"  # 'orbax' is a JAX library
    async_checkpoint = True
    coordinator_address = ""
    num_processes = 0
    process_id = -1
    build_chunk_rows = 0  # 0 = the full-memory build; streaming is ROADMAP A5

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
        if self.device_dataset not in ("auto", "on", "off"):
            raise ValueError(f"--device_dataset {self.device_dataset!r}: expected "
                             "'auto', 'on' or 'off'")
        if self.photo_size <= 0 or self.photo_size % 32:
            raise ValueError(f"--photo_size {self.photo_size}: expected a positive "
                             "multiple of 32")
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

    def __str__(self):
        return "".join(f"{key} = {getattr(self, key)}\n"
                       for key, _ in self._attributes())


# flag -> the ROADMAP.md item that ports what it selects.  Every other flag
# is read by the port.
NOT_PORTED = {
    **dict.fromkeys((
        "rnet_pretrained", "adam_moment_dtype", "adam_factored_nu",
        "profile_dir", "checkpoint_backend",
    ), "ROADMAP A4, training"),
    **dict.fromkeys((
        "compute_dtype", "steps_per_dispatch", "grad_accum_steps",
        "build_chunk_rows", "cache_dataset", "remat_vgg",
    ), "ROADMAP A5, runtime features"),
    **dict.fromkeys((
        "mesh_shape", "shard_embedding", "coordinator_address",
        "num_processes", "process_id",
    ), "ROADMAP A7, parallelism"),
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
            "not ported yet (ROADMAP A7); pass --multi_gpu False")
    return device
