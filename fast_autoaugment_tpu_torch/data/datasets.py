"""Dataset readers and the CV split (``fast_autoaugment_tpu/data/datasets.py``).

:class:`ArrayDataset`, the readers and the deterministic numpy-only
``synthetic`` and ``synthetic_shapes`` datasets are copied, and
:func:`load_dataset` serves every name of the JAX registry: ``cifar10``,
``cifar100``, ``reduced_cifar10`` (CIFAR pickle batches, no download),
``svhn`` and ``reduced_svhn`` (``scipy.io.loadmat`` of the ``.mat`` files),
``cifar10.1`` (the CIFAR-10 train set and the v6 ``.npy`` test set),
``imagenet`` and ``reduced_imagenet`` (lazy JPEG listings: the images stay
on disk as an object array of paths, decoded per batch by
``data/pipeline.py``), and the ``synthetic*`` names.

An ImageNet split is listed from ``{split}_cls.txt`` beside the split's
folder when there is one, in either form: ``<relpath> <index> <label>``, or
the Kaggle CLS-LOC ``<wnid>/<stem> <index>`` (labels are the ranks of the
sorted wnids, extensionless stems get ``.JPEG``; a flat listing without
``<wnid>/`` prefixes is refused, since its labels cannot be derived).
Without a listfile the split's class folders are walked in sorted order.

Split parity: the reference's reduced datasets and CV folds come from
sklearn's ``StratifiedShuffleSplit(random_state=0)`` (``data.py:119,137,
192-196``).  :func:`cv_split` and :func:`_stratified_split` are that
algorithm in numpy alone (so the port needs no sklearn), drawing from
``np.random.RandomState(0)`` in sklearn's order, so they give the same index
arrays (``tests/test_torch_train.py`` holds them against sklearn).  The
reference's 5 "folds" are 5 independent overlapping train/valid resamples,
not disjoint K-folds.
"""

from __future__ import annotations

import math
import os
import pickle
from dataclasses import dataclass, replace

import numpy as np

__all__ = ["ArrayDataset", "load_dataset", "cv_split", "IDX120"]

# reference data.py:154 - the fixed 120 ImageNet classes of reduced_imagenet
IDX120 = [
    16, 23, 52, 57, 76, 93, 95, 96, 99, 121, 122, 128, 148, 172, 181, 189,
    202, 210, 232, 238, 257, 258, 259, 277, 283, 289, 295, 304, 307, 318,
    322, 331, 337, 338, 345, 350, 361, 375, 376, 381, 388, 399, 401, 408,
    424, 431, 432, 440, 447, 462, 464, 472, 483, 497, 506, 512, 530, 541,
    553, 554, 557, 564, 570, 584, 612, 614, 619, 626, 631, 632, 650, 657,
    658, 660, 674, 675, 680, 682, 691, 695, 699, 711, 734, 736, 741, 754,
    757, 764, 769, 770, 780, 781, 787, 797, 799, 811, 822, 829, 830, 835,
    837, 842, 843, 845, 873, 883, 897, 900, 902, 905, 913, 920, 925, 937,
    938, 940, 941, 944, 949, 959,
]


@dataclass
class ArrayDataset:
    """In-memory image classification dataset: uint8 NHWC + int labels.

    ``lazy=True`` marks an object array of file paths instead of images
    (ImageNet), decoded per batch by ``data/pipeline.py``."""

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


# ---------------------------------------------------------------------------
# the stratified shuffle split (sklearn's StratifiedShuffleSplit, in numpy)
# ---------------------------------------------------------------------------


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``_approximate_mode``: per-class draw counts summing to
    `n_draws`, the remainders handed out largest first, ties broken by
    `rng`."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _split_sizes(n_samples: int, test_size) -> tuple[int, int]:
    """(n_train, n_test) as sklearn's ``_validate_shuffle_split`` gives
    them for a float fraction or an integer count and no train size."""
    if np.asarray(test_size).dtype.kind == "f":
        if not 0 < test_size < 1:
            raise ValueError(f"test_size={test_size} should be in (0, 1)")
        n_test = math.ceil(test_size * n_samples)
    else:
        if not 0 < test_size < n_samples:
            raise ValueError(f"test_size={test_size} should be in (0, {n_samples})")
        n_test = int(test_size)
    return n_samples - n_test, n_test


def _stratified_shuffle_splits(labels, test_size, n_splits: int, random_state: int = 0):
    """Yield the ``(train, test)`` index arrays of
    ``StratifiedShuffleSplit(n_splits, test_size=test_size,
    random_state=random_state).split(X, labels)``."""
    labels = np.asarray(labels)
    n_train, n_test = _split_sizes(len(labels), test_size)
    classes, y_indices, class_counts = np.unique(labels, return_inverse=True,
                                                 return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("the least populated class has only 1 member; every class "
                         "needs at least 2")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must be >= the "
                         f"number of classes ({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    for _ in range(n_splits):
        n_i = _approximate_mode(class_counts, n_train, rng)
        t_i = _approximate_mode(class_counts - n_i, n_test, rng)
        train, test = [], []
        for i in range(len(classes)):
            perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
            train.extend(perm[:n_i[i]])
            test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
        yield rng.permutation(train), rng.permutation(test)


def _stratified_split(labels, test_size, random_state: int = 0):
    """``StratifiedShuffleSplit(n_splits=1)``'s one split."""
    return next(_stratified_shuffle_splits(labels, test_size, 1, random_state))


def cv_split(labels, split: float, split_idx: int, random_state: int = 0):
    """The reference's CV machinery (``data.py:192-196``): 5 independent
    stratified shuffle resamples; take resample `split_idx`."""
    gen = _stratified_shuffle_splits(labels, split, 5, random_state)
    for _ in range(split_idx + 1):
        train_idx, valid_idx = next(gen)
    return train_idx, valid_idx


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


def _load_cifar(dataroot: str, kind: str):
    """CIFAR-10/100 python pickle batches -> uint8 NHWC arrays."""
    if kind == "cifar10":
        base = os.path.join(dataroot, "cifar-10-batches-py")
        train_files = [f"data_batch_{i}" for i in range(1, 6)]
        test_files = ["test_batch"]
        label_key = b"labels"
        num_classes = 10
    else:
        base = os.path.join(dataroot, "cifar-100-python")
        train_files = ["train"]
        test_files = ["test"]
        label_key = b"fine_labels"
        num_classes = 100

    def read(files):
        xs, ys = [], []
        for name in files:
            with open(os.path.join(base, name), "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            ys.extend(d[label_key])
        return np.concatenate(xs).astype(np.uint8), np.asarray(ys, np.int32)

    train = read(train_files)
    test = read(test_files)
    return (
        ArrayDataset(train[0], train[1], num_classes),
        ArrayDataset(test[0], test[1], num_classes),
    )


def _load_svhn(dataroot: str, split: str) -> ArrayDataset:
    """SVHN ``{split}_32x32.mat``; labels 10 -> 0 as torchvision does."""
    import scipy.io

    mat = scipy.io.loadmat(os.path.join(dataroot, f"{split}_32x32.mat"))
    images = np.transpose(mat["X"], (3, 0, 1, 2)).astype(np.uint8)
    labels = mat["y"].reshape(-1).astype(np.int32) % 10
    return ArrayDataset(images, labels, 10)


def _load_imagenet_listing(dataroot: str, split: str) -> ArrayDataset:
    """An ImageNet split as a lazy listing of ``{dataroot}/{split}``: from
    ``{split}_cls.txt`` when present (the module docstring's two forms),
    else by walking the class folders in sorted order."""
    root = os.path.join(dataroot, split)
    listfile = os.path.join(dataroot, f"{split}_cls.txt")
    paths, labels = [], []
    if os.path.exists(listfile):
        with open(listfile) as fh:
            lines = [ln.split() for ln in fh if ln.strip()]
        if lines and len(lines[0]) >= 3:  # <relpath> <index> <label>
            for rel, _idx, lb in lines:
                paths.append(os.path.join(root, rel))
                labels.append(int(lb))
        else:  # Kaggle CLS-LOC: <wnid>/<stem> <index>
            rels = [ln[0] for ln in lines]
            flat = [r for r in rels if "/" not in r]
            if flat:
                raise ValueError(
                    f"{listfile}: {len(flat)} entries lack a '<wnid>/' directory prefix "
                    "(e.g. a flat val listing) - labels cannot be derived; move val into "
                    "wnid folders with data/imagenet_tools.py prepare_val_folder and "
                    "regenerate, or use the "
                    "3-token '<relpath> <index> <label>' form")
            class_to_idx = {w: i for i, w in enumerate(sorted({r.split("/")[0] for r in rels}))}
            for rel in rels:
                if not os.path.splitext(rel)[1]:
                    rel += ".JPEG"
                paths.append(os.path.join(root, rel))
                labels.append(class_to_idx[rel.split("/")[0]])
    else:
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        for lb, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for name in sorted(os.listdir(cdir)):
                paths.append(os.path.join(cdir, name))
                labels.append(lb)
    return ArrayDataset(np.asarray(paths, object), np.asarray(labels, np.int32), 1000,
                        lazy=True)


def _reduce_to_idx120(ds: ArrayDataset, idx) -> ArrayDataset:
    """The samples of `idx` whose class is in :data:`IDX120`, relabelled
    to their rank there (120 classes)."""
    idx = np.asarray(idx)
    idx = idx[np.isin(ds.labels[idx], IDX120)]
    remap = {cls: i for i, cls in enumerate(IDX120)}
    return ArrayDataset(ds.images[idx],
                        np.asarray([remap[int(lb)] for lb in ds.labels[idx]], np.int32),
                        120, lazy=True)


def _synthetic_shapes(n_train: int = 600, n_test: int = 2000, size: int = 32,
                      noise: float = 12.0, fg_lo: float = 60.0, fg_hi: float = 130.0,
                      max_rot: float = 0.0, scale_lo: float = 1.0, scale_hi: float = 1.0):
    """The structured 10-class glyph dataset of the JAX package (each class
    a fixed 12x12 glyph rendered at a random place, intensity, contrast and
    noise; optional rotation and scale), from the same seeds: the same
    arrays."""
    glyph_rng = np.random.default_rng(7)
    glyphs = (glyph_rng.uniform(size=(10, 12, 12)) < 0.45).astype(np.float32)

    def render(n, seed):
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, 10, n).astype(np.int32)
        images = np.empty((n, size, size, 3), np.uint8)
        for i, lb in enumerate(labels):
            bg = rng.uniform(30, 120)
            fg = bg + rng.uniform(fg_lo, fg_hi)
            contrast = rng.uniform(0.7, 1.3)
            glyph = glyphs[lb]
            if max_rot or scale_lo != 1.0 or scale_hi != 1.0:
                theta = np.deg2rad(rng.uniform(-max_rot, max_rot))
                s = rng.uniform(scale_lo, scale_hi)
                g = 12
                co, si = np.cos(theta), np.sin(theta)
                out_px = int(np.ceil(g * max(s, 1.0) * (abs(co) + abs(si)))) + 2
                yy, xx = np.mgrid[0:out_px, 0:out_px].astype(np.float32)
                cy = cx = (out_px - 1) / 2.0
                ys = (co * (yy - cy) + si * (xx - cx)) / s + (g - 1) / 2.0
                xs = (-si * (yy - cy) + co * (xx - cx)) / s + (g - 1) / 2.0
                yi = np.clip(np.round(ys).astype(int), 0, g - 1)
                xi = np.clip(np.round(xs).astype(int), 0, g - 1)
                inside = (ys >= -0.5) & (ys <= g - 0.5) & (xs >= -0.5) & (xs <= g - 0.5)
                glyph = np.where(inside, glyphs[lb][yi, xi], 0.0).astype(np.float32)
            gh, gw = glyph.shape
            canvas = np.full((size, size), bg, np.float32)
            y = rng.integers(0, max(size - gh, 1))
            x = rng.integers(0, max(size - gw, 1))
            canvas[y:y + gh, x:x + gw] += glyph * (fg - bg)
            canvas = (canvas - canvas.mean()) * contrast + canvas.mean()
            canvas = canvas + rng.normal(0, noise, (size, size))
            images[i] = np.clip(canvas, 0, 255)[..., None].astype(np.uint8)
        return ArrayDataset(images, labels, 10)

    return render(n_train, 1), render(n_test, 2)


def load_dataset(dataset: str, dataroot: str):
    """``(total_trainset, testset)`` for a dataset name, with the reference's
    reduction rules (``data.py:114-185``)."""
    if dataset == "cifar10":
        return _load_cifar(dataroot, "cifar10")
    if dataset == "cifar100":
        return _load_cifar(dataroot, "cifar100")
    if dataset == "reduced_cifar10":
        train, test = _load_cifar(dataroot, "cifar10")
        train_idx, _ = _stratified_split(train.labels, test_size=46000)  # 4000 kept
        return train.subset(train_idx), test
    if dataset == "synthetic_shapes":
        return _synthetic_shapes()
    if dataset == "synthetic_shapes_hard":
        return _synthetic_shapes(n_train=150)
    if dataset.startswith("synthetic_shapes_n"):
        return _synthetic_shapes(n_train=int(dataset.rsplit("n", 1)[1]))
    if dataset.startswith("synthetic_shapes_pose"):
        suffix = dataset[len("synthetic_shapes_pose"):]
        return _synthetic_shapes(n_train=int(suffix) if suffix else 200, max_rot=25.0,
                                 scale_lo=0.7, scale_hi=1.3)
    if dataset.startswith("synthetic"):
        return _synthetic(100 if dataset.endswith("100") else 10)
    if dataset == "svhn":
        train, extra = _load_svhn(dataroot, "train"), _load_svhn(dataroot, "extra")
        merged = ArrayDataset(np.concatenate([train.images, extra.images]),
                              np.concatenate([train.labels, extra.labels]), 10)
        return merged, _load_svhn(dataroot, "test")
    if dataset == "reduced_svhn":
        train = _load_svhn(dataroot, "train")
        train_idx, _ = _stratified_split(train.labels, test_size=73257 - 1000)  # 1000 kept
        return train.subset(train_idx), _load_svhn(dataroot, "test")
    if dataset == "imagenet":
        return (_load_imagenet_listing(dataroot, "train"),
                _load_imagenet_listing(dataroot, "val"))
    if dataset == "reduced_imagenet":
        train = _load_imagenet_listing(dataroot, "train")
        test = _load_imagenet_listing(dataroot, "val")
        train_idx, _ = _stratified_split(train.labels, test_size=len(train) - 50000)
        return _reduce_to_idx120(train, train_idx), _reduce_to_idx120(test, np.arange(len(test)))
    if dataset == "cifar10.1":
        # the CIFAR-10.1 v6 test set (Recht et al.) with the CIFAR-10 train set
        train, _ = _load_cifar(dataroot, "cifar10")
        data = np.load(os.path.join(dataroot, "cifar10.1_v6_data.npy"))
        labels = np.load(os.path.join(dataroot, "cifar10.1_v6_labels.npy"))
        return train, ArrayDataset(data.astype(np.uint8), labels.astype(np.int32), 10)
    raise ValueError(f"invalid dataset name {dataset!r}")
