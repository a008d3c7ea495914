"""Logging helpers (the port's copy of ``fast_autoaugment_tpu/utils/logging.py``):
``get_logger``, and the append-only JSONL scalar logs ``{tag}_{train,valid,
test}.jsonl`` that ``train_and_eval`` writes beside a checkpoint
(:class:`ScalarWriter`, :class:`NullWriter`, :func:`make_writers`).

TensorBoard-compatible export: set ``FAA_TB_EVENTS=1`` (or pass ``tb=True``
to :func:`make_writers`) to also write ``tfevents`` files under
``<logdir>/tb/<run>_<split>/`` (``utils/tb_events.py``, no tensorboard
install needed).  Opt-in, because search flows create many short runs whose
sidecar promotion tracks the fixed JSONL names, not timestamped event
files."""

from __future__ import annotations

import json
import logging
import os
import sys
import time

__all__ = ["get_logger", "ScalarWriter", "NullWriter", "TeeWriter", "make_writers"]

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


class ScalarWriter:
    """Append-only JSONL scalar log, one event per line:
    ``{"tag": "loss", "value": 1.2, "step": 10, "wall": 169...}``."""

    def __init__(self, logdir: str, name: str):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, f"{name}.jsonl")
        self._fh = open(self._path, "a", buffering=1)

    @property
    def path(self) -> str:
        return self._path

    def add_scalar(self, tag: str, value, step: int):
        self._fh.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                   "wall": time.time()}) + "\n")

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.close()


class NullWriter:
    """The writer of a run without a log directory: writes nothing."""

    path = None

    def add_scalar(self, tag: str, value, step: int):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class TeeWriter:
    """Fan a scalar stream out to several writers (JSONL + tfevents)."""

    def __init__(self, *writers):
        self._writers = writers
        self.path = writers[0].path if writers else None

    def add_scalar(self, tag: str, value, step: int):
        for w in self._writers:
            w.add_scalar(tag, value, step)

    def flush(self):
        for w in self._writers:
            w.flush()

    def close(self):
        for w in self._writers:
            w.close()


def make_writers(logdir: str | None, tag: str, is_master: bool = True,
                 tb: bool | None = None):
    """The (train, valid, test) writers of run `tag` under `logdir`; writers
    that write nothing without a `logdir` or off the master process.  `tb`
    adds TensorBoard event files (None: read ``FAA_TB_EVENTS``)."""
    if not is_master or not logdir:
        return NullWriter(), NullWriter(), NullWriter()
    if tb is None:
        tb = os.environ.get("FAA_TB_EVENTS", "0") == "1"
    writers = []
    for split in ("train", "valid", "test"):
        w = ScalarWriter(logdir, f"{tag}_{split}")
        if tb:
            from fast_autoaugment_tpu_torch.utils.tb_events import TBEventWriter

            w = TeeWriter(w, TBEventWriter(os.path.join(logdir, "tb", f"{tag}_{split}"), split))
        writers.append(w)
    return tuple(writers)
