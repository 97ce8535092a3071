"""The port's logger: ``log.info`` / ``log.warning`` / ``log.error`` on
stderr, colored when ``colorlog`` is installed."""

from __future__ import annotations

import logging
import sys


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("vqa_torch")
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stderr)
    try:
        import colorlog

        handler.setFormatter(
            colorlog.ColoredFormatter(
                "%(log_color)s[%(levelname).1s %(asctime)s]%(reset)s %(message)s",
                datefmt="%H:%M:%S",
            )
        )
    except ImportError:  # colorlog is optional
        handler.setFormatter(
            logging.Formatter("[%(levelname).1s %(asctime)s] %(message)s",
                              datefmt="%H:%M:%S")
        )
    logger.addHandler(handler)
    logger.propagate = False
    return logger


log = _build_logger()
