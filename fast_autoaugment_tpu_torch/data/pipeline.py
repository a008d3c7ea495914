"""Train and eval batching of in-memory datasets
(``fast_autoaugment_tpu/data/pipeline.py``).

:func:`train_batches` walks :func:`train_index_matrix`: each epoch the
indices are shuffled by ``default_rng((seed, epoch))`` and the last partial
batch is dropped (``drop_last=True``, reference ``data.py:205-224``), with
each process taking its contiguous shard of every global batch, so both
packages train on the same batches in the same order.  :func:`eval_batches` keeps the JAX package's semantics for in-memory
datasets (``:379-423``): deterministic order, the final partial batch kept
and padded by repeating its last sample up to a multiple of
`pad_multiple`, and a mask that is 1.0 for real samples.  The search pads
every fold to full batches (``pad_multiple=batch``), so every batch has one
shape.  :func:`device_batches` uploads such a fold to the card once, as the
search driver's ``_FoldEval`` does, so that every trial replays the same
device tensors.  :class:`BatchIterator` bundles a dataset with a fold's
indices.  Lazy (on-disk) datasets and the prefetch thread are not ported
yet (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.data.datasets import ArrayDataset

__all__ = ["train_index_matrix", "train_batches", "eval_batches", "device_batches",
           "BatchIterator"]


def _eager(dataset: ArrayDataset) -> None:
    if dataset.lazy:
        raise NotImplementedError("lazy (on-disk) datasets are not ported yet "
                                  "(ROADMAP Queue 1 item 11)")


def train_index_matrix(indices: np.ndarray, global_batch: int, epoch: int, *, seed: int = 0,
                       process_index: int = 0, process_count: int = 1,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """The epoch's batch composition as an int64 ``[steps, shard]`` matrix:
    the ``default_rng((seed, epoch))`` permutation of `indices`, cut into
    ``len // global_batch`` full batches, each process's contiguous shard."""
    if rng is None:
        rng = np.random.default_rng((seed, epoch))
    idx = rng.permutation(np.asarray(indices))
    steps = len(idx) // global_batch
    shard = global_batch // process_count
    mat = idx[:steps * global_batch].reshape(steps, global_batch)
    return mat[:, process_index * shard:(process_index + 1) * shard]


def train_batches(dataset: ArrayDataset, indices: np.ndarray | None, global_batch: int,
                  epoch: int, *, seed: int = 0, process_index: int = 0,
                  process_count: int = 1) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Shuffled, drop-last ``(images, labels)`` train batches of one epoch
    of an in-memory dataset, over `indices` (all samples when None)."""
    _eager(dataset)
    idx = np.arange(len(dataset)) if indices is None else np.asarray(indices)
    mat = train_index_matrix(idx, global_batch, epoch, seed=seed, process_index=process_index,
                             process_count=process_count)
    for chunk in mat:
        yield dataset.images[chunk], dataset.labels[chunk]


def eval_batches(dataset: ArrayDataset, indices: np.ndarray | None, batch: int, *,
                 pad_multiple: int = 1) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Deterministic eval batches ``(images, labels, mask)`` of an in-memory
    dataset, over `indices` (all samples when None)."""
    _eager(dataset)
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


class BatchIterator:
    """A dataset and a fold's indices (all samples when None), with its
    train and eval epochs (in-memory datasets)."""

    def __init__(self, dataset: ArrayDataset, indices=None):
        _eager(dataset)
        self.dataset = dataset
        self.indices = indices

    def __len__(self):
        return len(self.indices) if self.indices is not None else len(self.dataset)

    def train_epoch(self, global_batch: int, epoch: int, **kw):
        return train_batches(self.dataset, self.indices, global_batch, epoch, **kw)

    def eval_epoch(self, batch: int, **kw):
        return eval_batches(self.dataset, self.indices, batch, **kw)
