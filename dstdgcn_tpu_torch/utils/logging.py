"""Logger setup: console + ``log.txt`` (colorlog optional), rank-aware: a
process of rank above 0 gets a logger without handlers, as in the JAX
package."""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["setup_logger"]


def setup_logger(name: str, save_dir: str | None, distributed_rank: int = 0,
                 filename: str = "log.txt") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if distributed_rank > 0 or logger.handlers:
        return logger

    fmt = "%(asctime)s %(name)s %(levelname)s: %(message)s"
    try:
        import colorlog
        console_fmt = colorlog.ColoredFormatter(
            "%(log_color)s" + fmt, datefmt="%m/%d %H:%M:%S")
    except ImportError:
        console_fmt = logging.Formatter(fmt, datefmt="%m/%d %H:%M:%S")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(console_fmt)
    logger.addHandler(ch)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt, datefmt="%m/%d %H:%M:%S"))
        logger.addHandler(fh)
    return logger
