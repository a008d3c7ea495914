"""Logger helper (the port's copy of ``fast_autoaugment_tpu/utils/logging.py``
``get_logger``)."""

from __future__ import annotations

import logging
import sys

__all__ = ["get_logger"]

_FORMAT = "[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s"


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    return logger
