"""Eval batching of in-memory datasets (``fast_autoaugment_tpu/data/pipeline.py``).

:func:`eval_batches` keeps the JAX package's semantics for in-memory
datasets (``:379-423``): deterministic order, the final partial batch kept
and padded by repeating its last sample up to a multiple of
`pad_multiple`, and a mask that is 1.0 for real samples.  The search pads
every fold to full batches (``pad_multiple=batch``), so every batch has one
shape.  :func:`device_batches` uploads such a fold to the card once, as the
search driver's ``_FoldEval`` does, so that every trial replays the same
device tensors.  Lazy (on-disk) datasets and multi-process sharding are not
ported yet.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.data.datasets import ArrayDataset

__all__ = ["eval_batches", "device_batches"]


def eval_batches(dataset: ArrayDataset, indices: np.ndarray | None, batch: int, *,
                 pad_multiple: int = 1) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Deterministic eval batches ``(images, labels, mask)`` of an in-memory
    dataset, over `indices` (all samples when None)."""
    if dataset.lazy:
        raise NotImplementedError("lazy (on-disk) datasets are not ported yet")
    idx = np.arange(len(dataset)) if indices is None else np.asarray(indices)
    multiple = max(1, int(pad_multiple))
    for s in range(0, len(idx), batch):
        chunk = idx[s:s + batch]
        n = len(chunk)
        pad = (-n) % multiple
        mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad)])
        yield dataset.images[chunk], dataset.labels[chunk], mask


def device_batches(batches: Iterable[tuple[np.ndarray, np.ndarray, np.ndarray]],
                   device="cuda") -> list[dict[str, torch.Tensor]]:
    """Upload ``(images, labels, mask)`` batches once: a list of
    ``{"x": uint8 [B, H, W, C], "y": int64 [B], "m": float32 [B]}`` on
    `device`, to replay for every trial."""
    dev = resolve_device(device)
    return [{"x": torch.as_tensor(np.ascontiguousarray(x), device=dev),
             "y": torch.as_tensor(np.asarray(y, np.int64), device=dev),
             "m": torch.as_tensor(np.asarray(m, np.float32), device=dev)}
            for x, y, m in batches]
