"""Logging helpers (the port's copy of umpr_tpu/utils/logging.py).

A logger with a file handler at INFO and a stdout handler at DEBUG,
timestamped records, and ``date()`` for per-run log and model names.
"""

from __future__ import annotations

import logging
import sys
import time


def get_logger(log_file=None, file_level=logging.INFO, stdout_level=logging.DEBUG,
               logger_name="umpr_tpu_torch"):
    logging.root.setLevel(0)
    formatter = logging.Formatter(
        "%(asctime)s %(levelname)5s: %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
    )
    logger = logging.getLogger(logger_name)
    logger.handlers.clear()  # idempotent across repeated calls (tests)

    if log_file:
        file_handler = logging.FileHandler(log_file)
        file_handler.setLevel(file_level)
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)

    stream_handler = logging.StreamHandler(sys.stdout)
    stream_handler.setLevel(stdout_level)
    stream_handler.setFormatter(formatter)
    logger.addHandler(stream_handler)
    return logger


def date(f="%Y-%m-%d %H:%M:%S"):
    return time.strftime(f, time.localtime())
