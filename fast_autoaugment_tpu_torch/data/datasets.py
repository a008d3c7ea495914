"""In-memory datasets (``fast_autoaugment_tpu/data/datasets.py``).

:class:`ArrayDataset` and the deterministic numpy-only ``synthetic``
dataset are copied.  The split (``cv_split``, which uses sklearn) and the
on-disk readers wait for a numpy-only copy (ROADMAP Queue 1 items 6 and 8).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

__all__ = ["ArrayDataset"]


@dataclass
class ArrayDataset:
    """In-memory image classification dataset: uint8 NHWC + int labels.

    ``lazy=True`` marks an object array of file paths (decoded per batch in
    the JAX package); the port reads in-memory datasets only so far."""

    images: np.ndarray
    labels: np.ndarray
    num_classes: int
    lazy: bool = False

    def __len__(self):
        return len(self.labels)

    def subset(self, idx) -> "ArrayDataset":
        idx = np.asarray(idx)
        return replace(self, images=self.images[idx], labels=self.labels[idx])


def _synthetic(num_classes: int, n_train: int = 512, n_test: int = 256,
              size: int = 32) -> tuple[ArrayDataset, ArrayDataset]:
    """Random uint8 images and labels from ``default_rng(0)``: the same
    arrays as the JAX package's ``_synthetic``."""
    rng = np.random.default_rng(0)
    mk = lambda n: ArrayDataset(  # noqa: E731
        rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
        rng.integers(0, num_classes, (n,), dtype=np.int32),
        num_classes,
    )
    return mk(n_train), mk(n_test)
