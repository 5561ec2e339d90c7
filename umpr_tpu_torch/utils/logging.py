"""Logging helpers (the port's copy of umpr_tpu/utils/logging.py).

A logger with a file handler at INFO and a stdout handler at DEBUG,
timestamped records, ``date()`` for per-run log and model names, and
``progress`` bars like the reference's.
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


def progress(it, desc, total, stream=None):
    """A progress bar over `it` on stderr, like the reference's tqdm bars
    (main.py:31, evaluate.py:10), shown only when stderr is a terminal.
    tqdm is optional: it is imported only then, and without it a plain
    ``desc n/total`` counter takes its place.  Display only."""
    stream = stream or sys.stderr
    if not stream.isatty():
        return it
    try:
        from tqdm import tqdm
    except ImportError:
        return _counter(it, desc, total, stream)
    return tqdm(it, desc=desc, total=total, leave=False, file=stream)


def _counter(it, desc, total, stream):
    n = 0
    for item in it:
        yield item
        n += 1
        stream.write(f"\r{desc} {n}/{total}")
        stream.flush()
    stream.write("\n")
