"""Train and eval batching, the lazy JPEG decode and the prefetch thread
(``fast_autoaugment_tpu/data/pipeline.py``).

:func:`train_batches` walks :func:`train_index_matrix`: each epoch the
indices are shuffled by ``default_rng((seed, epoch))`` and the last partial
batch is dropped (``drop_last=True``, reference ``data.py:205-224``), with
each process taking its contiguous shard of every global batch, so both
packages train on the same batches in the same order.  :func:`eval_batches`
keeps the JAX package's semantics (``:379-423``): deterministic order, the
final partial batch kept and padded by repeating its last sample up to a
multiple of `pad_multiple`, and a mask that is 1.0 for real samples.  The
search pads every fold to full batches (``pad_multiple=batch``), so every
batch has one shape.  :func:`device_batches` uploads such a fold to the
card once, as the search driver's ``_FoldEval`` does, so that every trial
replays the same device tensors.  :class:`BatchIterator` bundles a dataset
with a fold's indices and, for a lazy dataset, its crop boxes.

A lazy (on-disk) dataset is decoded per batch (``:36-108``): with a box
function (``box_fn(rng, width, height)``, ImageNet's random or center crop
box) each image's box is drawn on the host from the batch's generator (the
epoch's ``default_rng((seed, epoch))`` after its permutation; eval batches
draw from ``default_rng(0)``), and the decoder crops and resizes to
`imgsize` in one pass; without one, PIL decodes and applies
`host_transform` or a bicubic resize.  The decoder is explicit
(:data:`DECODERS`): ``"native"`` is the native loader
(``data/native_loader.py``: libjpeg, or nvJPEG on a host without libjpeg)
and raises when it cannot be built; ``"pil"`` is PIL's decode and bicubic
resize (the golden-parity path of the JAX package); ``"auto"`` keeps the JAX
rule, native when it is available and PIL otherwise.  Images that fail to
decode are zero-filled and counted in the iterator's :class:`DecodeStats`.

:func:`prefetch` runs an iterator in a worker thread behind a bounded
queue (``:430-538``): the worker applies `transform` (the trainer's,
:func:`stage_batch`, stages each batch into pinned host memory, from which
the step copies it to the card with ``non_blocking``), errors re-raise in
the consumer, and a consumer that stops early stops the worker.

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

import logging
import os
import queue
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.data import native_loader
from fast_autoaugment_tpu_torch.data.datasets import ArrayDataset

__all__ = ["DECODERS", "DecodeStats", "SizeCache", "train_index_matrix", "train_batches",
           "eval_batches", "device_batches", "BatchIterator", "DeviceCache",
           "resolve_device_cache", "split_dispatch_chunks", "default_prefetch_depth",
           "prefetch", "stage_batch"]

#: the decoders of a lazy dataset
DECODERS = ("auto", "native", "pil")


class DecodeStats:
    """What a lazy dataset's decoder did: images decoded, those that failed
    (zero-filled), the seconds spent in decode calls, and the decoder used
    (``"libjpeg"``, ``"nvjpeg"`` or ``"pil"``).  Thread-safe: the prefetch
    worker adds while the consumer reads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.images = self.failures = 0
        self.seconds = 0.0
        self.decoder: str | None = None

    def add(self, decoder: str, images: int, failures: int, seconds: float) -> None:
        with self._lock:
            self.decoder = decoder
            self.images += images
            self.failures += failures
            self.seconds += seconds

    def snapshot(self) -> dict:
        with self._lock:
            return {"decoder": self.decoder, "images": self.images,
                    "failures": self.failures, "decode_s": self.seconds}


def _decoder_name(decoder: str) -> str:
    """The decoder `decoder` resolves to here: ``"pil"`` or the native
    loader's backend.  ``"native"`` raises where the loader is off or cannot
    be built."""
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    if decoder == "pil":
        return "pil"
    if native_loader.available():
        return native_loader.loaded_backend()
    if decoder == "native":
        raise RuntimeError("the native JPEG loader was asked for but is off "
                           "(FAA_NATIVE_LOADER=0) or cannot be built here (neither "
                           "<jpeglib.h> nor the CUDA toolkit's nvjpeg.h)")
    return "pil"


def _decode(paths: np.ndarray, transform=None, size: int | None = None) -> np.ndarray:
    """PIL decode of a batch of image files to uint8 NHWC: `transform(img)`
    per image, or a bicubic resize to `size`."""
    import PIL.Image

    out = []
    for p in paths:
        with PIL.Image.open(p) as f:
            img = f.convert("RGB")
        if transform is not None:
            out.append(transform(img))
        else:
            if size is not None:
                img = img.resize((size, size), PIL.Image.BICUBIC)
            out.append(np.asarray(img, np.uint8))
    return np.stack(out)


class SizeCache:
    """A lazy per-path ``(width, height)`` cache for boxed decoding: the
    native loader's header read, or PIL's."""

    def __init__(self):
        self._sizes: dict = {}

    def get(self, path) -> tuple[int, int]:
        got = self._sizes.get(path)
        if got is None:
            got = native_loader.image_size(path)
            if got is None:
                import PIL.Image

                with PIL.Image.open(path) as img:  # header-only read
                    got = img.size
            self._sizes[path] = got
        return got


def _decode_boxed(paths, imgsize: int, box_fn, rng, size_cache: SizeCache,
                  decoder: str = "auto", stats: DecodeStats | None = None) -> np.ndarray:
    """Decode, crop to ``box_fn(rng, width, height)`` and resize a batch to
    `imgsize`: the native loader (one threaded pass, triangle filter) or
    PIL (bicubic), as `decoder` resolves."""
    name = _decoder_name(decoder)
    boxes = np.empty((len(paths), 4), np.float32)
    for i, p in enumerate(paths):
        w, h = size_cache.get(p)
        boxes[i] = box_fn(rng, w, h)
    t0 = time.perf_counter()
    if name != "pil":
        batch, failures = native_loader.decode_resize_batch(paths, imgsize, boxes)
        if failures:
            logging.getLogger("faa_torch.data").warning(
                "native loader: %d/%d images failed to decode (zero-filled)", failures,
                len(paths))
    else:
        import PIL.Image

        out = []
        for p, box in zip(paths, boxes):
            with PIL.Image.open(p) as f:
                img = f.convert("RGB")
            img = img.crop(tuple(box)).resize((imgsize, imgsize), PIL.Image.BICUBIC)
            out.append(np.asarray(img, np.uint8))
        batch, failures = np.stack(out), 0
    if stats is not None:
        stats.add(name, len(paths), failures, time.perf_counter() - t0)
    return batch


def _decode_lazy(images, rng, *, box_fn, imgsize, size_cache, decoder, stats,
                 transform, decode_size) -> np.ndarray:
    if box_fn is not None:
        return _decode_boxed(images, imgsize, box_fn, rng, size_cache or SizeCache(), decoder,
                             stats)
    return _decode(images, transform, decode_size)


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
                  process_count: int = 1, decode_size: int | None = None,
                  host_transform=None, box_fn=None, imgsize: int | None = None,
                  size_cache: SizeCache | None = None, decoder: str = "auto",
                  stats: DecodeStats | None = None
                  ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Shuffled, drop-last ``(images, labels)`` train batches of one epoch,
    over `indices` (all samples when None).  A lazy dataset is decoded per
    batch: with `box_fn` and `imgsize` by the boxed decode (`decoder`), else
    by PIL with ``host_transform(img, rng)`` or a resize to `decode_size`;
    the boxes draw from the epoch's generator after its permutation."""
    idx = np.arange(len(dataset)) if indices is None else np.asarray(indices)
    rng = np.random.default_rng((seed, epoch))
    mat = train_index_matrix(idx, global_batch, epoch, seed=seed, process_index=process_index,
                             process_count=process_count, rng=rng)
    transform = None
    if host_transform is not None:
        transform = lambda img: host_transform(img, rng)  # noqa: E731
    for chunk in mat:
        images = dataset.images[chunk]
        if dataset.lazy:
            images = _decode_lazy(images, rng, box_fn=box_fn, imgsize=imgsize,
                                  size_cache=size_cache, decoder=decoder, stats=stats,
                                  transform=transform, decode_size=decode_size)
        yield images, dataset.labels[chunk]


def eval_batches(dataset: ArrayDataset, indices: np.ndarray | None, batch: int, *,
                 pad_multiple: int = 1, decode_size: int | None = None, host_transform=None,
                 box_fn=None, imgsize: int | None = None, size_cache: SizeCache | None = None,
                 decoder: str = "auto", stats: DecodeStats | None = None
                 ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Deterministic eval batches ``(images, labels, mask)`` over `indices`
    (all samples when None).  A lazy dataset is decoded per batch as in
    :func:`train_batches`, its boxes drawn from ``default_rng(0)`` (the eval
    boxes ignore it; the search's fold stream draws its random boxes from
    it, so every pass over a fold decodes the same crops)."""
    idx = np.arange(len(dataset)) if indices is None else np.asarray(indices)
    rng = np.random.default_rng(0)
    multiple = max(1, int(pad_multiple))
    for s in range(0, len(idx), batch):
        chunk = idx[s:s + batch]
        n = len(chunk)
        pad = (-n) % multiple
        mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad)])
        images = dataset.images[chunk]
        if dataset.lazy:
            images = _decode_lazy(images, rng, box_fn=box_fn, imgsize=imgsize,
                                  size_cache=size_cache, decoder=decoder, stats=stats,
                                  transform=host_transform, decode_size=decode_size)
        yield images, dataset.labels[chunk], mask


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
    train and eval epochs; for a lazy dataset, also its host-side crop
    semantics (box functions or PIL transforms, the output size), the
    decoder, a :class:`SizeCache` and the :class:`DecodeStats` of every
    batch it decodes."""

    def __init__(self, dataset: ArrayDataset, indices=None, decode_size=None,
                 train_transform=None, eval_transform=None, train_box_fn=None,
                 eval_box_fn=None, imgsize=None, decoder: str = "auto",
                 stats: DecodeStats | None = None):
        self.dataset = dataset
        self.indices = indices
        self.decode_size = decode_size
        self.train_transform = train_transform
        self.eval_transform = eval_transform
        self.train_box_fn = train_box_fn
        self.eval_box_fn = eval_box_fn
        self.imgsize = imgsize
        self.decoder = decoder
        self.size_cache = SizeCache()
        self.stats = stats if stats is not None else DecodeStats()

    def __len__(self):
        return len(self.indices) if self.indices is not None else len(self.dataset)

    def train_epoch(self, global_batch: int, epoch: int, **kw):
        return train_batches(self.dataset, self.indices, global_batch, epoch,
                             decode_size=self.decode_size, host_transform=self.train_transform,
                             box_fn=self.train_box_fn, imgsize=self.imgsize,
                             size_cache=self.size_cache, decoder=self.decoder,
                             stats=self.stats, **kw)

    def eval_epoch(self, batch: int, **kw):
        return eval_batches(self.dataset, self.indices, batch, decode_size=self.decode_size,
                            host_transform=self.eval_transform, box_fn=self.eval_box_fn,
                            imgsize=self.imgsize, size_cache=self.size_cache,
                            decoder=self.decoder, stats=self.stats, **kw)


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


def default_prefetch_depth() -> int:
    """The queue depth when the caller names none: 1 on a single-core host
    (the worker and the consumer share the core), else 2."""
    return 1 if (os.cpu_count() or 1) < 2 else 2


def stage_batch(batch: tuple, device) -> tuple:
    """A batch of numpy arrays as host tensors bound for `device`: in pinned
    memory for a CUDA device, from which a ``non_blocking`` copy is
    asynchronous (the prefetch worker's transform), as they are for the
    CPU."""
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
    if torch.device(device).type == "cuda":
        return tuple(t.pin_memory() for t in tensors)
    return tensors


def prefetch(iterator, depth: int | None = None, transform=None):
    """Run `iterator` in a background thread behind a queue of `depth`
    items (:func:`default_prefetch_depth` when None; ``FAA_PREFETCH_SYNC=1``
    makes a default-depth caller synchronous, an explicit depth wins), with
    ``transform(item)`` applied in the worker.  ``depth=0`` is an inline
    loop without a thread.

    A worker exception re-raises in the consumer.  Abandoning the generator
    (``break``, or an exception in the consumer) stops the worker: every put
    waits in bounded slices against a stop event, and the worker closes the
    source iterator from its own thread."""
    if depth is None:
        if os.environ.get("FAA_PREFETCH_SYNC", "0") not in ("", "0"):
            depth = 0
        else:
            depth = default_prefetch_depth()
    if depth == 0:
        for item in iterator:
            yield transform(item) if transform is not None else item
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()
    err: list[BaseException] = []

    def put(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item if transform is None else transform(item)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            err.append(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException as e:  # noqa: BLE001
                    if not err:
                        err.append(e)
            put(end)

    t = threading.Thread(target=worker, name="faa-prefetch", daemon=True)
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=5.0)
            except queue.Empty:
                # a worker that died without its end marker must not park
                # the consumer forever; queued items always come first
                if t.is_alive():
                    continue
                if err:
                    raise err[0]
                return
            if item is end:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
