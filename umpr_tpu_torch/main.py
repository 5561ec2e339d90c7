"""Train and test UMPR with the port (port of the repository's main.py).

    python -m umpr_tpu_torch.main --review_net_only False \
        --data_dir data/music --word2vec_file embedding/glove.6B.50d.txt

trains full UMPR (photos from ``<data_dir>/photos``, listed in
``photos.json``); ``--review_net_only True`` trains UMPR-R.  It builds
the train, valid and test splits from ``<data_dir>/{train,valid,
test}.csv``, logs the initial validation MSE, trains with Adam (evaluating
every ``--eval_every`` batches and saving ``best/`` on improvement), then
reports the test MSE of ``best/``.  ``--test_only True --model_path <run>``
skips training.  Log lines are the JAX entry point's.  Runs on
``--device`` (default cuda; ``--device cpu`` runs the kernels' plain
versions); each split is built in memory (``--cache_dataset`` is ROADMAP
A4).
"""

from __future__ import annotations

import os
import sys

from umpr_tpu_torch.config import Config
from umpr_tpu_torch.data.dataset import build_dataset
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train.trainer import Trainer
from umpr_tpu_torch.utils.logging import date, get_logger


def main(argv=None):
    """Returns the Trainer after its test pass."""
    config = Config(argv)
    if config.test_only:
        if not os.path.exists(config.model_path):
            print(f"{config.model_path} is not exist! Please train first "
                  f"(set test_only=False in config.py)!")
            sys.exit(-1)
    else:
        # abspath so `--data_dir .` names the run after the real directory
        save_name = os.path.basename(os.path.abspath(config.data_dir)) + (
            "_review_net" if config.review_net_only else "")
        stamp = date("%Y%m%d_%H%M%S")
        config.log_path = config.log_path or f"./log/{save_name}{stamp}.txt"
        config.model_path = config.model_path or f"./model/{save_name}{stamp}"
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
        logger.debug(f"Loading {split} dataset.")
        return build_dataset(paths[split], photo_json, photo_dir, w2v, config)

    if not config.test_only:
        train_data, valid_data = load("train"), load("valid")
        logger.info(f"Training dataset contains {len(train_data)} samples.")
        trainer.fit(train_data, valid_data, config.model_path)
    trainer.test(load("test"), config.model_path)
    return trainer


if __name__ == "__main__":
    main()
