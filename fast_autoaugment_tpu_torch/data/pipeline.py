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

The device-resident path (``:295-376``): :class:`DeviceCache` puts a whole
in-memory dataset (uint8 NHWC images and labels) on the device once, and
the train step gathers each batch from it by index
(``train/steps.py make_multistep_train_step``), so an epoch ships only its
:func:`train_index_matrix`.  :func:`resolve_device_cache` turns the
``auto``/``on``/``off`` knob into a yes or no with the JAX package's gates,
and :func:`split_dispatch_chunks` cuts an epoch into dispatches of N steps
and one remainder.  One device: the mesh sharding of the JAX cache is
ROADMAP Queue 1 item 10c.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.data.datasets import ArrayDataset

__all__ = ["train_index_matrix", "train_batches", "eval_batches", "device_batches",
           "BatchIterator", "DeviceCache", "resolve_device_cache", "split_dispatch_chunks"]


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


class DeviceCache:
    """An in-memory dataset resident on `device`: ``images`` (the uint8
    ``[N, H, W, 3]`` array as it is) and ``labels`` (int64 ``[N]``), uploaded
    once.  CIFAR-10's train set is 146 MiB of it.  A lazy dataset has
    nothing to hold and raises."""

    def __init__(self, dataset: ArrayDataset, device="cuda"):
        if dataset.lazy:
            raise ValueError("DeviceCache needs an in-memory dataset; lazy (on-disk) "
                             "datasets keep the host feed")
        dev = resolve_device(device)
        images = np.ascontiguousarray(dataset.images)
        labels = np.asarray(dataset.labels, np.int64)
        self.num_examples = len(dataset)
        self.nbytes = int(images.nbytes + np.asarray(dataset.labels).nbytes)
        self.images = torch.as_tensor(images, device=dev)
        self.labels = torch.as_tensor(labels, device=dev)


def resolve_device_cache(mode, dataset: ArrayDataset, *, process_count: int = 1) -> bool:
    """The ``--device-cache {auto,on,off}`` knob as a bool: ``"auto"`` (the
    default) is on for an in-memory dataset in a single process; ``"on"``
    raises where ``"auto"`` would fall back (a lazy dataset, several
    processes), so a launch never believes it cached what it streamed."""
    if mode in (False, None, 0, "off", "0"):
        return False
    if mode in (True, 1, "on"):
        if dataset.lazy:
            raise ValueError("--device-cache on: dataset is lazy (on-disk) - the device "
                             "cache only serves in-memory datasets; use --device-cache "
                             "auto/off")
        if process_count > 1:
            raise ValueError("--device-cache on: multi-host runs keep the per-process host "
                             "feed; use --device-cache auto/off")
        return True
    if mode == "auto":
        return not dataset.lazy and process_count == 1
    raise ValueError(f"unknown device-cache mode {mode!r}: use auto/on/off")


def split_dispatch_chunks(total_steps: int, steps_per_dispatch: int) -> list[int]:
    """An epoch's steps as dispatch sizes: full chunks of
    `steps_per_dispatch` and one remainder, so an epoch has at most two
    dispatch sizes and its end is a dispatch boundary."""
    if steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
    full, rem = divmod(total_steps, steps_per_dispatch)
    return [steps_per_dispatch] * full + ([rem] if rem else [])
