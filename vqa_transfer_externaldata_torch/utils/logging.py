"""The port's logger (``log.info`` / ``log.warning`` / ``log.error`` on
stderr, colored when ``colorlog`` is installed), a wall-clock timer, and the
JSONL metric stream (``metrics.jsonl``) that training writes."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional


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


class Timer:
    """Wall-clock interval timer."""

    def __init__(self) -> None:
        self._start = time.perf_counter()

    def reset(self) -> float:
        """Return seconds since last reset/start and restart the clock."""
        now = time.perf_counter()
        out = now - self._start
        self._start = now
        return out


class MetricWriter:
    """Appends one JSON object per record to ``<train_dir>/metrics.jsonl``:
    ``{"step": n, "<prefix>/<name>": value, ...}``, the JAX package's keys
    (``train/loss``, ``train/questions_per_sec``, ...). With ``enabled``
    false (every rank but rank 0 of a multi-process run, whose metrics are
    the global ones on every rank) it writes nothing."""

    def __init__(self, train_dir: str, enabled: bool = True) -> None:
        self._jsonl = None
        if enabled:
            os.makedirs(train_dir, exist_ok=True)
            self._jsonl = open(os.path.join(train_dir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict[str, float],
              prefix: Optional[str] = None) -> None:
        if self._jsonl is None:
            return
        record = {"step": int(step)}
        for k, v in metrics.items():
            record[f"{prefix}/{k}" if prefix else k] = float(v)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
