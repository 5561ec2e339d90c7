"""Train and test UMPR with the port (port of the repository's main.py).

    python -m umpr_tpu_torch.main --review_net_only False \
        --data_dir data/music --word2vec_file embedding/glove.6B.50d.txt

trains full UMPR (photos from ``<data_dir>/photos``, listed in
``photos.json``); ``--review_net_only True`` trains UMPR-R.  It builds
the train, valid and test splits from ``<data_dir>/{train,valid,
test}.csv``, logs the initial validation MSE, trains with Adam (evaluating
every ``--eval_every`` batches and saving ``best/`` on improvement), then
reports the test MSE of ``best/``.  ``--test_only True --model_path <run>``
skips training.  ``last/`` (parameters, Adam's state, counters) is saved
at the end of every ``--save_last_every_epochs``-th epoch and of the last
one, and with ``--save_every_batches N`` every N batches;
``--resume_path <run>`` continues from ``<run>/last``, mid-epoch
included, as the uninterrupted run would have gone on.  Log lines are the
JAX entry point's.  Runs on ``--device`` (default cuda; ``--device cpu``
runs the kernels' plain versions).  With ``--cache_dataset`` (the
default) each split is loaded from ``<data_dir>/dataset_<split>.cache``
(or the legacy ``dataset_<split>.npz``) where one exists, else built and
saved there; the cache is not keyed by the shaping flags, so a data_dir
built again under other ones needs ``--cache_dataset False``.

Data-parallel training (``parallel/``): ``--multi_gpu True`` starts one
rank per visible card of this machine; ``--coordinator_address host:port
--num_processes P --process_id i`` joins P such processes (rank 0 listens
at the address), each of ``G`` ranks, rank ``i * G + card``.  ``--device
cpu`` ranks are processes of one card each::

    python -m umpr_tpu_torch.main --device cpu --coordinator_address \
        127.0.0.1:29500 --num_processes 2 --process_id 0 ...   # and 1

The primary (rank 0) builds each split's cache while the others wait, the
run's stamp is the primary's, and the log files are per rank
(``<log>.p<rank>``).  ``--mesh_shape`` lays the ranks out (its product is
the world's size) and ``--shard_embedding`` splits the frozen table over
them.
"""

from __future__ import annotations

import os
import socket
import sys

import torch

from umpr_tpu_torch.config import Config
from umpr_tpu_torch.data.dataset import UMPRDataset, build_dataset
from umpr_tpu_torch.parallel import multihost
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train.trainer import Trainer
from umpr_tpu_torch.utils.logging import date, get_logger


def load_split(name, csv_path, photo_json, photo_dir, w2v, config, logger):
    """A packed split from its cache in data_dir or, failing that, built
    (and cached, with --cache_dataset).  As in the JAX entry point's
    load_split, only the primary builds and writes the cache (two writers
    of one memmap directory would corrupt it); the others wait at a
    barrier, then load it, or build in memory where they do not share its
    filesystem (a reader before the barrier could meet a cache half
    written).  Every rank passes the barrier once per split, on every
    path; without a group the barrier is a no-op."""
    cache_dir = os.path.join(config.data_dir, f"dataset_{name}.cache")
    legacy = os.path.join(config.data_dir, f"dataset_{name}.npz")

    def cached():
        if not config.cache_dataset:
            return None
        for cache in (cache_dir, legacy):
            try:
                ds = UMPRDataset.load(cache)
            except (FileNotFoundError, NotADirectoryError):
                continue
            logger.info(f"Loaded {name} dataset from {cache}!")
            return ds
        return None

    def build(write_cache):
        logger.debug(f"Loading {name} dataset.")
        # with caching on, the streaming build writes its packed arrays
        # straight into the cache directory as memmaps
        ds = build_dataset(csv_path, photo_json, photo_dir, w2v, config,
                           mmap_dir=cache_dir if write_cache else None)
        if write_cache and not os.path.exists(os.path.join(cache_dir, "complete.marker")):
            ds.save(cache_dir)  # the full-memory build: save it
        return ds

    ds = None
    if multihost.is_primary():
        ds = cached()  # an empty split is a valid hit: `is None`, not `or`
        if ds is None:
            ds = build(config.cache_dataset)
    # the others look for the cache only once it is whole
    multihost.barrier(f"dataset_{name}")
    if ds is None:
        ds = cached()
    return ds if ds is not None else build(False)


def _free_address():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def main(argv=None):
    """Returns the Trainer after its test pass; under --multi_gpu True over
    more than one card, None after every rank's (one process each)."""
    config = Config(argv)
    cards = multihost.local_cards(config.device, config.multi_gpu)
    if cards == 1:
        return run(config)
    # the kernels are built once here, so that the ranks load the built
    # libraries instead of each running every nvcc
    from umpr_tpu_torch.ops import _build
    _build.build()
    address = config.coordinator_address or _free_address()
    torch.multiprocessing.start_processes(
        _card_rank, args=(list(sys.argv[1:] if argv is None else argv), cards, address),
        nprocs=cards, start_method="spawn")
    return None


def _card_rank(card, argv, cards, address):
    """Rank `card` of this process's cards (--multi_gpu True)."""
    config = Config(argv + ["--device", f"cuda:{card}"])
    try:
        run(config, cards, card, address)
    finally:
        multihost.shutdown()


def run(config, cards=1, card=0, address=None):
    """Train and test on this rank (the whole run in a world of 1)."""
    # join the world before any device use: the mesh spans every rank
    multihost.initialize(address or config.coordinator_address, config.num_processes,
                         config.process_id, card, cards, config.torch_device)
    if config.test_only:
        if not os.path.exists(config.model_path):
            print(f"{config.model_path} is not exist! Please train first "
                  f"(set test_only=False in config.py)!")
            sys.exit(-1)
    else:
        # abspath so `--data_dir .` names the run after the real directory
        save_name = os.path.basename(os.path.abspath(config.data_dir)) + (
            "_review_net" if config.review_net_only else "")
        # every rank names the run by the primary's clock
        stamp = multihost.broadcast_str(date("%Y%m%d_%H%M%S"))
        config.log_path = config.log_path or f"./log/{save_name}{stamp}.txt"
        config.model_path = config.model_path or f"./model/{save_name}{stamp}"
    if multihost.world_size() > 1 and config.log_path:
        # one log file per rank: ranks appending to one file would
        # interleave mid-record
        root, ext = os.path.splitext(config.log_path)
        config.log_path = f"{root}.p{multihost.rank()}{ext}"
    if not config.test_only:
        log_dir = os.path.dirname(config.log_path)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        os.makedirs(config.model_path, exist_ok=True)

    photo_dir = os.path.join(config.data_dir, "photos")
    photo_json = os.path.join(config.data_dir, "photos.json")
    paths = {split: os.path.join(config.data_dir, f"{split}.csv")
             for split in ("train", "valid", "test")}

    logger = get_logger(config.log_path)
    logger.info(config)
    logger.info(f"Logging to {config.log_path}")
    logger.info(f"Save model {config.model_path}")
    logger.info(f"Photo path {photo_dir}")
    logger.info(f"Photo json {photo_json}")
    logger.info(f"Train file {paths['train']}")
    logger.info(f"Valid file {paths['valid']}")
    logger.info(f"Test  file {paths['test']}\n")

    w2v = Word2vec(config.word2vec_file)
    trainer = Trainer(config, logger, w2v)

    def load(split):
        return load_split(split, paths[split], photo_json, photo_dir, w2v, config, logger)

    if not config.test_only:
        train_data, valid_data = load("train"), load("valid")
        logger.info(f"Training dataset contains {len(train_data)} samples.")
        trainer.fit(train_data, valid_data, config.model_path)
    trainer.test(load("test"), config.model_path)
    return trainer


if __name__ == "__main__":
    main()
    multihost.shutdown()
