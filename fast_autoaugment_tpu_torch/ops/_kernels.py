"""Build, load and launch the hand-written CUDA kernels of the port.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface and bound with
``ctypes``:

- ``augment.cu``: the policy augmentation (``augment``, K1) from the
  policy, the sub-policy indices and the draws, each slot's record built on
  chip: every op slot in one launch with the image held in shared memory,
  one thread-block cluster per image, or one launch per slot for images too
  large for a cluster (:func:`augment_plan` chooses by shape);
- ``preprocess.cu``: the CIFAR crop/flip/normalize/cutout stack
  (``cifar_stack``, one block per image, :func:`cifar_plan`);
- ``imagenet.cu``: the ImageNet flip/ColorJitter/lighting/normalize/cutout
  stack (``imagenet_stack``): one launch with the image held in shared
  memory by one block or by a thread-block cluster that reduces the
  contrast mean through distributed shared memory, or a grey-sum pass and
  a per-pixel pass for images too large for a cluster
  (:func:`imagenet_plan` chooses by shape and dtype);
- ``sampler.cu``: the draw sampler (K7: the key entry ``sampler_keys``, the
  exact records ``sampler_lanes``, the grouped records ``sampler_grouped``)
  and the train noise (K8: ``train_noise`` alone, ``step_draws`` as all of
  a train step's draws), each one launch a call.

Each wrapper counts its launches (:func:`launch_counts`).  A launch that
a CUDA graph capture records is not a launch yet: it goes to the tally of
:func:`counting_capture`, and the graph's owner adds that tally once per
replay (:func:`count_replays`), so the counts say what ran on the card.

The build happens on first use, into ``fast_autoaugment_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the source and the flags, so
a second process finds the libraries already built.  The sources that are
not built yet are compiled together, one ``nvcc`` process each.  Nothing is
built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCES", "AugmentPlan", "CifarPlan", "ImageNetPlan",
           "augment_plan", "cifar_plan", "imagenet_plan", "load_libraries", "augment",
           "augment_operands",
           "augment_max_active_clusters", "cifar_stack", "imagenet_stack",
           "imagenet_max_active_clusters", "on_card", "sampler_keys", "sampler_lanes",
           "sampler_grouped", "train_noise", "step_draws", "empty_kernel", "launch_counts",
           "reset_launch_counts", "counting_capture", "count_replays"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"augment": _PKG / "csrc" / "augment.cu",
           "preprocess": _PKG / "csrc" / "preprocess.cu",
           "imagenet": _PKG / "csrc" / "imagenet.cu",
           "sampler": _PKG / "csrc" / "sampler.cu"}
#: where the libraries are built and loaded from: the package's own
#: ``_build``, or the compile cache's directory (``core/compilecache.py``)
DEFAULT_BUILD_DIR = BUILD_DIR = _PKG / "_build"
#: --fmad=false: the kernels are held bitwise against references that
#: round every product and sum on its own, and a contracted multiply-add
#: rounds differently
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_L, _U = ctypes.c_longlong, ctypes.c_uint
#: the record outputs of faa_sampler_lanes and faa_sampler_grouped: sub,
#: pol, crop, then the ImageNet fields (flip, order, centre, factors, alpha),
#: each with its row stride
_RECORD_ARGS = [_P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I]
#: {C function: argument types} of each library; each returns an int
_SIGNATURES = {
    "augment": {"faa_augment": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P],
                "faa_augment_slot": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, _P],
                "faa_augment_max_active_clusters": [_I, _I, _I, _I, _I, _I,
                                                    ctypes.POINTER(_I)]},
    "preprocess": {"faa_cifar_stack": [_P, _P, _P, _I, _I, _I, _I, _I, _F,
                                       _F, _F, _F, _F, _F, _F, _I, _I, _I, _P]},
    "imagenet": {"faa_imagenet_stack": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                        _F, _F, _F, _F, _F, _F, _I, _I, _I, _I, _P],
                 "faa_imagenet_tiles": [_I, _I],
                 "faa_imagenet_max_active_clusters": [_I, _I, _I, _I, _I, _I, _I,
                                                      ctypes.POINTER(_I)]},
    "sampler": {"faa_sampler_keys": [_P, _I, _I, _L, _P, _U, _I, _P, _I, _P],
                "faa_sampler_lanes": [_P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _D,
                                      *_RECORD_ARGS, _I, _P],
                "faa_sampler_grouped": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _D,
                                        *_RECORD_ARGS, _I, _P],
                "faa_train_noise": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _D,
                                    _D, _D, _I, _P, _P, _I, _P],
                "faa_step_draws": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _D, _D,
                                   _D, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _D,
                                   *_RECORD_ARGS, _I, _P],
                "faa_empty_kernel": [_I, _P]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_launches = {"augment": 0, "cifar_stack": 0, "imagenet_stack": 0, "sampler": 0,
             "train_noise": 0}
#: per thread: the launches recorded into the CUDA graph that thread is
#: capturing under counting_capture (None outside it); threads may capture
#: side by side (the search pipeline)
_capture = threading.local()
#: wall seconds of the last build of all missing libraries (0.0 when every
#: library was already built)
build_seconds = 0.0


# ---------------------------------------------------------------- launch plans
#: the H100's dynamic shared memory per block, after opting in
MAX_SMEM_BYTES = 232_448
#: cluster sizes of the augmentation kernel: 8 is the portable limit, 16
#: needs the non-portable attribute (which the kernel sets)
AUGMENT_CLUSTERS = (1, 2, 4, 8, 16)
#: csrc/augment.cu's kScratchBytes: the reductions and the mbarrier
_AUGMENT_SCRATCH_BYTES = 6400
#: csrc/preprocess.cu: kHeaderBytes before the image, and the shared memory
#: a block gets without opting in
_CIFAR_HEADER_BYTES = 64
_CIFAR_SMEM_LIMIT = 48 * 1024
#: cluster sizes of the ImageNet stack's cluster kernel, and
#: csrc/imagenet.cu's kHeaderBytes before the staged band and
#: kScratchPerThread, the per-warp scratch of the stores
IMAGENET_CLUSTERS = (1, 2, 4, 8, 16)
_IMAGENET_HEADER_BYTES = 256
_IMAGENET_SCRATCH_PER_THREAD = 48


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def augment_smem_bytes(h: int, w: int, cluster: int) -> int:
    """Dynamic shared memory of one block of the augmentation kernel when
    clusters of `cluster` blocks hold an ``h x w`` image: the scratch and two
    float32 buffers of one band of ``ceil(h / cluster)`` rows, each padded to
    16 bytes with 16 more of slack (``csrc/augment.cu band_floats``)."""
    rows = -(-h // cluster)
    return _AUGMENT_SCRATCH_BYTES + 2 * 4 * (_round_up(rows * w * 3, 4) + 4)


@dataclass(frozen=True)
class AugmentPlan:
    """How :func:`augment` runs on an ``h x w`` image with `num_op` slots.

    ``path`` is ``"cluster"`` (``augment_kernel``: one launch, clusters of
    `cluster` blocks of `threads` threads with `smem_bytes` of dynamic
    shared memory each) or ``"per_slot"`` (``augment_slot_kernel``: one
    launch per slot).  `launches` is the kernel launches per call."""

    path: str
    cluster: int
    smem_bytes: int
    threads: int
    launches: int

    @property
    def kernel(self) -> str:
        return "augment_kernel" if self.path == "cluster" else "augment_slot_kernel"


def augment_plan(h: int, w: int, num_op: int, cluster: int | None = None) -> AugmentPlan:
    """Choose the augmentation kernel's launch from the shape alone.

    The cluster path holds one image per thread-block cluster, a band of
    ``ceil(h / cluster)`` rows per block in shared memory.  The cluster size
    is the smallest of :data:`AUGMENT_CLUSTERS` whose block fits in
    :data:`MAX_SMEM_BYTES` (1 at 32x32; 8 at 224x224, where 8 measured a
    little faster than 16 on the H100).  A block takes 512 threads when it
    has an SM's shared memory to itself, else 256.  An image whose band does
    not fit even at 16 blocks takes the per-slot path.

    `cluster` forces a cluster size (for measurement); one that is not a
    cluster size or does not fit raises ``ValueError``.  Nothing here looks
    at a device, and no launch ever falls back from one path to the other."""
    if h < 1 or w < 1 or num_op < 1:
        raise ValueError(f"no augmentation plan for {h}x{w} with {num_op} slots")
    sizes = AUGMENT_CLUSTERS if cluster is None else (cluster,)
    if cluster is not None and cluster not in AUGMENT_CLUSTERS:
        raise ValueError(f"cluster must be one of {AUGMENT_CLUSTERS}, got {cluster}")
    fits = [c for c in sizes if augment_smem_bytes(h, w, c) <= MAX_SMEM_BYTES]
    if not fits:
        if cluster is not None:
            raise ValueError(f"a {h}x{w} image does not fit clusters of {cluster} blocks "
                             f"({augment_smem_bytes(h, w, cluster)} bytes of shared memory "
                             f"per block, at most {MAX_SMEM_BYTES})")
        return AugmentPlan("per_slot", 1, 0, 256, num_op)
    smem = augment_smem_bytes(h, w, fits[0])
    return AugmentPlan("cluster", fits[0], smem, 512 if 2 * smem > MAX_SMEM_BYTES else 256, 1)


@dataclass(frozen=True)
class CifarPlan:
    """How :func:`cifar_stack` runs on an ``h x w`` image: ``staged`` (the
    image bulk-copied into shared memory) or read from global memory, with
    `smem_bytes` of dynamic shared memory per block; one launch."""

    staged: bool
    smem_bytes: int


def cifar_plan(h: int, w: int) -> CifarPlan:
    """Stage the image when it fits in the 48 KB of shared memory a block
    gets without opting in (a 32x32 image takes 12 KB); otherwise the same
    kernel reads it from global memory.  Shape alone decides."""
    staged = _CIFAR_HEADER_BYTES + 4 * (_round_up(h * w * 3, 4) + 4)
    if staged <= _CIFAR_SMEM_LIMIT:
        return CifarPlan(True, staged)
    return CifarPlan(False, _CIFAR_HEADER_BYTES)


def imagenet_smem_bytes(h: int, w: int, itemsize: int, cluster: int, threads: int) -> int:
    """Dynamic shared memory of one block of `threads` threads of the
    ImageNet stack's cluster kernel when clusters of `cluster` blocks hold an
    ``h x w`` image of `itemsize`-byte values: the header, a band of
    ``ceil(h / cluster)`` rows in the input's dtype, padded to 16 bytes with
    16 more of slack, and each warp's scratch of 128 pixels
    (``csrc/imagenet.cu cluster_smem_bytes``)."""
    rows = -(-h // cluster)
    return (_IMAGENET_HEADER_BYTES + _round_up(rows * w * 3 * itemsize, 16) + 16
            + _IMAGENET_SCRATCH_PER_THREAD * threads)


@dataclass(frozen=True)
class ImageNetPlan:
    """How :func:`imagenet_stack` runs on an ``h x w`` image.

    ``path`` is ``"cluster"`` (``imagenet_cluster_kernel``: one launch,
    clusters of `cluster` blocks of `threads` threads with `smem_bytes` of
    dynamic shared memory each) or ``"two_pass"`` (``grey_sum_kernel`` then
    ``imagenet_stack_kernel``; `cluster`, `smem_bytes` and `threads` are 0).
    `launches` is the kernel launches per call."""

    path: str
    cluster: int
    smem_bytes: int
    threads: int
    launches: int

    @property
    def kernel(self) -> tuple[str, ...]:
        """The names of the kernels one call launches."""
        if self.path == "cluster":
            return ("imagenet_cluster_kernel",)
        return ("grey_sum_kernel", "imagenet_stack_kernel")


def imagenet_plan(h: int, w: int, dtype: torch.dtype, cluster: int | None = None) -> ImageNetPlan:
    """Choose the ImageNet stack's launch from the shape and dtype alone.

    The cluster path holds one image per thread-block cluster, a band of
    ``ceil(h / cluster)`` rows per block in shared memory in the input's
    dtype (uint8 or float32).  The rule, measured on the H100 at 224x224
    (PERF.md): one block per image when the whole image fits a block, with
    1024 threads (uint8 at 224x224); otherwise the smallest cluster of
    :data:`IMAGENET_CLUSTERS` at which two blocks of 512 threads share an
    SM's shared memory, so that one block's copy overlaps the other's work
    (8 for float32 at 224x224); otherwise the smallest cluster whose block of
    1024 threads fits alone.  An image whose band fits no cluster of 16
    blocks takes the two-pass path.

    `cluster` forces a cluster size (for measurement), with 512 threads when
    two such blocks share an SM and 1024 otherwise; one that is not a
    cluster size or does not fit raises ``ValueError``.  Nothing here looks
    at a device, and no launch ever falls back from one path to the other."""
    if h < 1 or w < 1:
        raise ValueError(f"no ImageNet stack plan for {h}x{w}")
    if dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"the ImageNet stack takes uint8 or float32 images, not {dtype}")
    if cluster is not None and cluster not in IMAGENET_CLUSTERS:
        raise ValueError(f"cluster must be one of {IMAGENET_CLUSTERS}, got {cluster}")
    itemsize = 1 if dtype == torch.uint8 else 4

    def plan(c: int, threads: int) -> ImageNetPlan:
        return ImageNetPlan("cluster", c, imagenet_smem_bytes(h, w, itemsize, c, threads),
                            threads, 1)

    def shared(c: int) -> bool:  # two blocks of 512 threads share an SM
        return 2 * imagenet_smem_bytes(h, w, itemsize, c, 512) <= MAX_SMEM_BYTES

    def alone(c: int) -> bool:  # one block of 1024 threads fits
        return imagenet_smem_bytes(h, w, itemsize, c, 1024) <= MAX_SMEM_BYTES

    if cluster is not None:
        if shared(cluster) or alone(cluster):
            return plan(cluster, 512 if shared(cluster) else 1024)
        raise ValueError(f"a {h}x{w} {dtype} image does not fit clusters of {cluster} blocks "
                         f"({imagenet_smem_bytes(h, w, itemsize, cluster, 1024)} bytes of "
                         f"shared memory per block, at most {MAX_SMEM_BYTES})")
    if alone(1) and not shared(1):
        return plan(1, 1024)
    for c in IMAGENET_CLUSTERS:
        if shared(c):
            return plan(c, 512)
    for c in IMAGENET_CLUSTERS:
        if alone(c):
            return plan(c, 1024)
    return ImageNetPlan("two_pass", 0, 0, 0, 2)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def _build(missing: dict[str, Path]) -> None:
    """Compile every missing library at once, one ``nvcc`` per source."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in missing.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (cmd, tmp, out, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            errors.append(f"nvcc timed out: {' '.join(cmd)}\n{log}")
            continue
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    build_seconds = time.perf_counter() - t0


def load_libraries() -> dict[str, ctypes.CDLL]:
    """Build (once per source and flag set) and load every kernel library."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(_libs)
        t0 = time.perf_counter()
        paths = {name: _library_path(name) for name in SOURCES}
        missing = {n: p for n, p in paths.items() if not p.exists()}
        if missing:
            _build(missing)
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.faa_error_string.argtypes = [ctypes.c_int]
            lib.faa_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        from fast_autoaugment_tpu_torch.core import compilecache

        compilecache.record_libraries(sorted(set(paths) - set(missing)), sorted(missing),
                                      time.perf_counter() - t0)
        return dict(_libs)


def launch_counts() -> dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for k in _launches:
            _launches[k] = 0


def _count(name: str, n: int = 1) -> None:
    """Count `n` launches of `name`: launched now, or recorded into a graph
    under capture (then they count when the graph is replayed)."""
    capturing = torch.cuda.is_current_stream_capturing()
    tally = getattr(_capture, "tally", None)
    with _lock:
        if not capturing:
            _launches[name] += n
        elif tally is not None:
            tally[name] += n


@contextlib.contextmanager
def counting_capture():
    """Around a CUDA graph capture: yields a dict that, after the block,
    holds the launches the wrappers recorded into the graph."""
    tally = {k: 0 for k in _launches}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None


def count_replays(tally: dict[str, int], replays: int = 1) -> None:
    """Count `replays` replays of a graph whose capture recorded `tally`."""
    with _lock:
        for k, v in tally.items():
            _launches[k] += v * replays


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.faa_error_string(rc).decode()}")


def augment_operands(policy: torch.Tensor, sub_idx: torch.Tensor,
                     draws: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """What K1 reads besides the images, in the order of ``faa_augment``'s
    pointers: the policy, ``sub_idx``, the draws, and the ops' range tables
    (low, high, mirror) on the policy's device, ``ops/augment.py
    _op_tables``' tensors, so the table stays in one place and a call inside
    a CUDA graph capture copies nothing from the host."""
    from fast_autoaugment_tpu_torch.ops.augment import _op_tables

    return (policy, sub_idx, draws, *_op_tables(policy.device))


def augment(images: torch.Tensor, policy: torch.Tensor, sub_idx: torch.Tensor,
            draws: torch.Tensor, *, cluster: int | None = None,
            records: torch.Tensor | None = None) -> torch.Tensor:
    """Apply sub-policy ``policy[sub_idx[i]]`` (``policy [num_sub, num_op,
    3]`` float32) to image i of ``images [B, H, W, 3]`` float32 with its
    draws ``draws [B, num_op, 4]`` float32 (``sub_idx [B]`` int32) with the
    CUDA kernel as :func:`augment_plan` says: one launch on the cluster path;
    on the per-slot path one launch per slot, ping-ponging between two
    buffers so that the last slot writes the result.  The kernel builds each
    slot's record (``ops/augment.py slot_records``) on chip; a sub-policy
    index or an op id out of range makes it print and trap.

    `cluster` forces the cluster size (for measurement).  `records`, a
    contiguous ``[B, num_op, 16]`` float32 tensor on the images' device,
    receives the records the kernel built (to hold them against
    ``slot_records``).  A launch the device refuses raises ``RuntimeError``."""
    operands = augment_operands(policy, sub_idx, draws)
    extra = () if records is None else (records,)
    if images.device.type != "cuda" or any(t.device != images.device
                                           for t in operands + extra):
        raise ValueError("the augmentation kernel takes CUDA tensors on one device")
    if images.dtype != torch.float32 or policy.dtype != torch.float32 \
            or draws.dtype != torch.float32 or sub_idx.dtype != torch.int32 \
            or any(t.dtype != torch.float32 for t in extra):
        raise TypeError("the augmentation kernel takes float32 images, policy, draws and "
                        "records and int32 sub_idx")
    if not all(t.is_contiguous() for t in (images,) + operands + extra):
        raise ValueError("the augmentation kernel takes contiguous tensors")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [B, H, W, 3], got {tuple(images.shape)}")
    b, h, w, _ = images.shape
    if policy.dim() != 3 or policy.shape[-1] != 3 or min(policy.shape) < 1:
        raise ValueError(f"policy must be [num_sub, num_op, 3], got {tuple(policy.shape)}")
    num_sub, num_op = int(policy.shape[0]), int(policy.shape[1])
    if tuple(sub_idx.shape) != (b,) or tuple(draws.shape) != (b, num_op, 4):
        raise ValueError(f"sub_idx must be [{b}] and draws [{b}, {num_op}, 4], got "
                         f"{tuple(sub_idx.shape)} and {tuple(draws.shape)}")
    if records is not None and tuple(records.shape) != (b, num_op, 16):
        raise ValueError(f"records must be [{b}, {num_op}, 16], got {tuple(records.shape)}")
    if h * w >= 1 << 24:
        raise ValueError(f"image of {h}x{w} pixels is too large for the kernel")
    plan = augment_plan(h, w, num_op, cluster)
    if b == 0:
        return torch.empty_like(images)
    lib = load_libraries()["augment"]
    out = torch.empty_like(images)
    dev = images.device.index or 0
    stream = torch.cuda.current_stream(images.device).cuda_stream
    ptrs = [t.data_ptr() for t in operands] + [records.data_ptr() if extra else None]
    if plan.path == "cluster":
        rc = lib.faa_augment(images.data_ptr(), out.data_ptr(), *ptrs, num_sub, num_op, b, h, w,
                             plan.cluster, plan.smem_bytes, plan.threads, dev, stream)
        _check_rc(lib, rc, "augment")
        _count("augment")
        return out
    tmp = torch.empty_like(images) if num_op > 1 else None
    src = images
    for slot in range(num_op):
        dst = out if (num_op - 1 - slot) % 2 == 0 else tmp
        rc = lib.faa_augment_slot(src.data_ptr(), dst.data_ptr(), *ptrs, slot, num_sub, num_op,
                                  b, h, w, dev, stream)
        _check_rc(lib, rc, "augment")
        _count("augment")
        src = dst
    return out


def augment_max_active_clusters(h: int, w: int, num_op: int = 2, cluster: int | None = None,
                                device: int = 0) -> int:
    """How many clusters of :func:`augment_plan`'s cluster path the device
    holds at once (``cudaOccupancyMaxActiveClusters``); 0 would refuse the
    launch."""
    plan = augment_plan(h, w, num_op, cluster)
    if plan.path != "cluster":
        raise ValueError(f"a {h}x{w} image takes the per-slot path")
    lib = load_libraries()["augment"]
    active = ctypes.c_int(0)
    rc = lib.faa_augment_max_active_clusters(h, w, plan.cluster, plan.smem_bytes,
                                             plan.threads, device, ctypes.byref(active))
    _check_rc(lib, rc, "augment occupancy")
    return active.value


def cifar_stack(images: torch.Tensor, draws: torch.Tensor, *, pad: int,
                cutout_length: int, scale: float, mean, rstd) -> torch.Tensor:
    """Crop with zero pad, flip, normalize and cut out ``images [N, H, W, 3]``
    (float32, integral in [0, 255]) with the CUDA kernel, one launch of one
    block per image (:func:`cifar_plan` says whether the image is staged in
    shared memory).

    ``draws [N, 5]`` int32 holds (oy, ox, flip, cy, cx) per image.  A
    value is normalized as ``(v * scale - mean[c]) * rstd[c]``, each product
    and difference rounded to float32 on its own; `scale` is ``1 / 255`` and
    `rstd` ``1 / std``, both as float32.  Returns ``[N, 3, H, W]`` float32 in ``channels_last``
    strides (NHWC in memory)."""
    if images.device.type != "cuda" or draws.device != images.device:
        raise ValueError("the CIFAR stack kernel takes CUDA tensors on one device")
    if images.dtype != torch.float32 or draws.dtype != torch.int32:
        raise TypeError("the CIFAR stack kernel takes float32 images and int32 draws")
    if not (images.is_contiguous() and draws.is_contiguous()):
        raise ValueError("the CIFAR stack kernel takes contiguous tensors")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [N, H, W, 3], got {tuple(images.shape)}")
    n, h, w, _ = images.shape
    if tuple(draws.shape) != (n, 5):
        raise ValueError(f"draws must be [{n}, 5], got {tuple(draws.shape)}")
    if n * h * w * 3 >= 1 << 31:
        raise ValueError(f"batch of {n}x{h}x{w} is too large for the kernel")
    if pad < 0 or cutout_length < 0:
        raise ValueError("pad and cutout_length must be >= 0")
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=images.device)
    if n:
        plan = cifar_plan(h, w)
        lib = load_libraries()["preprocess"]
        stream = torch.cuda.current_stream(images.device).cuda_stream
        m = [float(v) for v in mean]
        r = [float(v) for v in rstd]
        rc = lib.faa_cifar_stack(images.data_ptr(), out.data_ptr(), draws.data_ptr(),
                                 n, h, w, int(pad), int(cutout_length) // 2,
                                 float(scale), *m, *r, int(plan.staged), plan.smem_bytes,
                                 images.device.index or 0, stream)
        _check_rc(lib, rc, "CIFAR stack")
        _count("cifar_stack")
    return out.permute(0, 3, 1, 2)


def imagenet_stack(images: torch.Tensor, ints: torch.Tensor, floats: torch.Tensor, *,
                   cutout_length: int, scale: float, mean, rstd,
                   cluster: int | None = None) -> torch.Tensor:
    """Flip, ColorJitter, scale, light, normalize and cut out ``images
    [N, H, W, 3]`` (uint8 or float32) with the CUDA kernels as
    :func:`imagenet_plan` says: one launch on the cluster path, a grey-sum
    pass and a per-pixel pass on the two-pass path.  `cluster` forces the
    cluster size (for measurement).  A launch the device refuses, or a
    cluster that cannot be resident, raises ``RuntimeError``.

    ``ints [N, 4]`` int32 holds (flip, jitter order, cutout centre y, x),
    ``floats [N, 6]`` float32 (brightness, contrast, saturation factors,
    lighting offset r, g, b).  A value ends as
    ``((v * scale + rgb[c]) - mean[c]) * rstd[c]``, each operation rounded
    on its own.  Returns ``[N, 3, H, W]`` float32 in ``channels_last``
    strides."""
    if images.device.type != "cuda" or {ints.device, floats.device} != {images.device}:
        raise ValueError("the ImageNet stack kernel takes CUDA tensors on one device")
    if images.dtype not in (torch.uint8, torch.float32) or ints.dtype != torch.int32 \
            or floats.dtype != torch.float32:
        raise TypeError("the ImageNet stack kernel takes uint8 or float32 images, int32 "
                        "ints and float32 floats")
    if not (images.is_contiguous() and ints.is_contiguous() and floats.is_contiguous()):
        raise ValueError("the ImageNet stack kernel takes contiguous tensors")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [N, H, W, 3], got {tuple(images.shape)}")
    n, h, w, _ = images.shape
    if tuple(ints.shape) != (n, 4) or tuple(floats.shape) != (n, 6):
        raise ValueError(f"ints must be [{n}, 4] and floats [{n}, 6], got "
                         f"{tuple(ints.shape)} and {tuple(floats.shape)}")
    if n > 65535 or h * w >= 1 << 24:
        raise ValueError(f"batch of {n}x{h}x{w} is too large for the kernel")
    if cutout_length < 0:
        raise ValueError("cutout_length must be >= 0")
    plan = imagenet_plan(h, w, images.dtype, cluster)
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=images.device)
    if n:
        lib = load_libraries()["imagenet"]
        partial = None
        if plan.path == "two_pass":
            partial = torch.empty((n, lib.faa_imagenet_tiles(h, w)), dtype=torch.int64,
                                  device=images.device)
        stream = torch.cuda.current_stream(images.device).cuda_stream
        m = [float(v) for v in mean]
        r = [float(v) for v in rstd]
        rc = lib.faa_imagenet_stack(images.data_ptr(), int(images.dtype == torch.uint8),
                                    out.data_ptr(), ints.data_ptr(), floats.data_ptr(),
                                    None if partial is None else partial.data_ptr(), n, h, w,
                                    int(cutout_length) // 2, float(scale), *m, *r,
                                    plan.cluster, plan.smem_bytes, plan.threads,
                                    images.device.index or 0, stream)
        _check_rc(lib, rc, "ImageNet stack")
        _count("imagenet_stack", plan.launches)
    return out.permute(0, 3, 1, 2)


def imagenet_max_active_clusters(h: int, w: int, dtype: torch.dtype, cluster: int | None = None,
                                 device: int = 0) -> int:
    """How many clusters of :func:`imagenet_plan`'s cluster path the device
    holds at once (``cudaOccupancyMaxActiveClusters``); 0 would refuse the
    launch."""
    plan = imagenet_plan(h, w, dtype, cluster)
    if plan.path != "cluster":
        raise ValueError(f"a {h}x{w} {dtype} image takes the two-pass path")
    lib = load_libraries()["imagenet"]
    active = ctypes.c_int(0)
    rc = lib.faa_imagenet_max_active_clusters(int(dtype == torch.uint8), h, w, plan.cluster,
                                              plan.smem_bytes, plan.threads, device,
                                              ctypes.byref(active))
    _check_rc(lib, rc, "ImageNet stack occupancy")
    return active.value


# ---------------------------------------------------------------- the sampler
#: Philox counter words of the key entry: fold_in's and split's second word
FOLD, SPLIT = 0x466F6C64, 0x53706C74


def on_card(t: torch.Tensor) -> bool:
    """Whether the draws of keys `t` go through the sampler's kernels (a
    CUDA tensor) or through the plain versions (a CPU tensor); any other
    device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no sampler for device {t.device}")
    return True


def _check_keys(what: str, *tensors: torch.Tensor) -> torch.device:
    """Key tensors of the sampler's kernels: int64, contiguous, ``[..., 2]``,
    CUDA, on one device.  Returns the device."""
    if any(t.device.type != "cuda" for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(f"the {what} kernel takes CUDA tensors on one device")
    if any(t.dtype != torch.int64 for t in tensors):
        raise TypeError(f"the {what} kernel takes int64 keys")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {what} kernel takes contiguous tensors")
    if any(t.dim() < 1 or t.shape[-1] != 2 for t in tensors):
        raise ValueError(f"the {what} kernel takes keys [..., 2]")
    return tensors[0].device


def _launch(lib_fn, what: str, name: str, *args) -> None:
    """Call one launcher on the current stream, raise if the card refused
    the launch, count it under `name`."""
    rc = lib_fn(*args)
    _check_rc(load_libraries()["sampler"], rc, what)
    _count(name)


def sampler_keys(keys: torch.Tensor, num: int, stream: int, *, base: int = 0,
                 data: torch.Tensor | None = None, words: int = 2) -> torch.Tensor:
    """Philox blocks ``(base + j, stream, 0, 0)``, ``j < num``, of each key of
    ``keys [N, 2]`` in one launch (``ops/rng.py`` ``fold_in``, ``split``,
    ``fold_in_range``, ``blocks``).  `data`, a one-element int64 tensor on the
    keys' device, takes the place of `base` and is read by the kernel, so a
    captured graph reads it at each replay.  Returns ``[N, num, 2]`` (words
    0 and 1) or, with ``words=4``, ``[4, N, num]``, int64 words."""
    dev = _check_keys("sampler", keys)
    if keys.dim() != 2:
        raise ValueError(f"keys must be [N, 2], got {tuple(keys.shape)}")
    if data is not None and (data.device != dev or data.dtype != torch.int64
                             or data.numel() != 1):
        raise ValueError("data must be one int64 on the keys' device")
    if words not in (2, 4) or num < 0:
        raise ValueError(f"no key entry with words={words}, num={num}")
    n = keys.shape[0]
    out = torch.empty((n, num, 2) if words == 2 else (4, n, num), dtype=torch.int64, device=dev)
    if n * num:
        lib = load_libraries()["sampler"]
        _launch(lib.faa_sampler_keys, "sampler", "sampler", keys.data_ptr(), n, num,
                int(base) & 0xFFFFFFFF, None if data is None else data.data_ptr(),
                int(stream) & 0xFFFFFFFF, words, out.data_ptr(), dev.index or 0,
                torch.cuda.current_stream(dev).cuda_stream)
    return out


def _jitter_range(strength: float) -> tuple[float, float]:
    """``(span, lo)`` of the ColorJitter factors as float32 values, the
    plain version's ``np.float32(1 + s) - np.float32(1 - s)`` and
    ``np.float32(1 - s)`` (``ops/augment.py sample_imagenet``)."""
    import numpy as np

    lo = np.float32(1.0 - strength)
    return float(np.float32(1.0 + strength) - lo), float(lo)


def _records(dev, lanes: int, *, num_op: int | None, crop: bool,
             imagenet: bool) -> tuple[dict, list]:
    """The output tensors of `lanes` lanes and the record arguments of a
    launcher (``_RECORD_ARGS``); with `imagenet` the ImageNet stack's
    ``flip``, ``order``, ``centre``, ``factors`` and ``alpha``, each
    contiguous (``ImageNetDraws``')."""
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = {}
    if num_op is not None:
        out["sub"] = torch.empty((lanes,), **i32)
        out["pol"] = torch.empty((lanes, num_op, 4), **f32)
    if crop:
        out["crop"] = torch.empty((lanes, 5), **i32)
    fields = [(None, 0)] * 5
    if imagenet:
        out.update(flip=torch.empty((lanes,), **i32), order=torch.empty((lanes,), **i32),
                   centre=torch.empty((lanes, 2), **i32),
                   factors=torch.empty((lanes, 3), **f32),
                   alpha=torch.empty((lanes, 3), **f32))
        fields = [(out[k].data_ptr(), out[k].shape[1] if out[k].dim() == 2 else 1)
                  for k in ("flip", "order", "centre", "factors", "alpha")]
    ptr = lambda k: out[k].data_ptr() if k in out else None  # noqa: E731
    args = [ptr("sub"), ptr("pol"), ptr("crop")]
    for p, stride in fields:
        args += [p, stride]
    return out, args


def _record_scalars(num_sub: int, num_op: int | None, height: int, width: int, pad: int,
                    strength: float, alphastd: float) -> list:
    if height < 1 or width < 1:
        raise ValueError(f"no draws for {height}x{width} images")
    span, lo = _jitter_range(strength)
    return [int(num_sub), int(num_op or 0), int(height), int(width), 2 * int(pad) + 1, span,
            lo, float(alphastd)]


def sampler_lanes(keys: torch.Tensor, *, batch: int, height: int, width: int,
                  num_sub: int = 1, num_op: int | None = None, crop: bool = False,
                  imagenet: bool = False, pad: int = 4, strength: float = 0.4,
                  alphastd: float = 0.1) -> dict:
    """The exact records of every lane in one launch: the lanes are
    ``split(key, batch)`` of each key of ``keys [D, 2]``, draw-major, or the
    keys themselves with ``batch=0``.  With `num_op` a lane draws its
    sub-policy (``sub [L]``) and slots (``pol [L, num_op, 4]``, the exact
    sampler); with `crop` the CIFAR stack's ``crop [L, 5]`` (offsets in
    ``[0, 2 pad]``); with `imagenet` the ImageNet stack's draws
    (:func:`_records`).  Returns the dict of outputs."""
    dev = _check_keys("sampler", keys)
    if keys.dim() != 2 or batch < 0:
        raise ValueError(f"keys must be [D, 2] and batch >= 0, got {tuple(keys.shape)}, {batch}")
    if num_op is not None and (num_op < 1 or num_sub < 1):
        raise ValueError(f"no exact draws of {num_sub} sub-policies x {num_op} slots")
    lanes = keys.shape[0] * batch if batch else keys.shape[0]
    out, rec = _records(dev, lanes, num_op=num_op, crop=crop, imagenet=imagenet)
    if lanes:
        lib = load_libraries()["sampler"]
        _launch(lib.faa_sampler_lanes, "sampler", "sampler", keys.data_ptr(), keys.shape[0],
                int(batch), *_record_scalars(num_sub, num_op, height, width, pad, strength,
                                             alphastd),
                *rec, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    return out


def sampler_grouped(keys: torch.Tensor, *, batch: int, groups: int, num_sub: int, num_op: int,
                    height: int, width: int, presplit: bool = False, crop: bool = False,
                    imagenet: bool = False, pad: int = 4, strength: float = 0.4,
                    alphastd: float = 0.1) -> dict:
    """The grouped records of each draw key of ``keys [D, 2]`` over `batch`
    images in one launch, one block a key (``ops/augment.py sample_grouped``:
    ``min(groups, batch)`` chunks of a stable-sorted permutation, one
    sub-policy a chunk, per-image slots), draw-major; with `crop` or
    `imagenet` also each lane's stack draws from ``split(key, batch)``.
    `presplit` takes the lanes from ``split(key, 2)[0]`` and the policy from
    ``split(key, 2)[1]`` (the ImageNet tree).  Returns the dict of outputs."""
    dev = _check_keys("sampler", keys)
    if keys.dim() != 2 or batch < 0 or num_op < 1 or num_sub < 1:
        raise ValueError(f"no grouped draws for keys {tuple(keys.shape)}, batch {batch}, "
                         f"{num_sub} x {num_op}")
    g = max(1, min(int(groups), batch))
    lanes = keys.shape[0] * batch
    out, rec = _records(dev, lanes, num_op=num_op, crop=crop, imagenet=imagenet)
    if lanes:
        lib = load_libraries()["sampler"]
        _launch(lib.faa_sampler_grouped, "sampler", "sampler", keys.data_ptr(), keys.shape[0],
                int(batch), -(-batch // g), int(bool(presplit)),
                *_record_scalars(num_sub, num_op, height, width, pad, strength, alphastd),
                *rec, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    return out


def empty_kernel(device: torch.device) -> None:
    """Launch an empty kernel on `device`'s current stream: the fixed cost of
    one launch, the floor of any kernel that does a call's work in one
    launch (for timing beside K7; on no path, so not counted)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the empty kernel runs on a CUDA device")
    lib = load_libraries()["sampler"]
    _check_rc(lib, lib.faa_empty_kernel(dev.index or 0, torch.cuda.current_stream(dev).cuda_stream),
              "empty")


#: csrc/sampler.cu's record kinds of faa_step_draws
_NO_RECORD, _LANE_RECORD, _GROUPED_RECORD = 0, 1, 2


def _noise_table(sites) -> tuple[int, int, list]:
    """``(count, items, [begin, out, meta, thr])`` of a ``NoiseLayout`` (or
    None): host pointers the launcher copies into the launch's parameters."""
    if sites is None:
        return 0, 0, [None] * 4
    return sites.count, sites.items, [a.ctypes.data for a in (sites.begin, sites.out, sites.meta,
                                                             sites.thr)]


def train_noise(*, batch: int = 0, sites=None, key_shake: torch.Tensor | None = None,
                key_drop: torch.Tensor | None = None, mix_keys: torch.Tensor | None = None,
                perm_n: int = 0, gamma: tuple | None = None) -> dict:
    """K8 in one launch: the noise sites of a train step and mixup's draws.

    `sites` (``ops/shake.py NoiseLayout``) lays the sites' tensors out in one
    byte buffer (``"packed"``), drawn from ``key_shake`` and ``key_drop``
    (``[2]`` each).  Each key of ``mix_keys [N, 2]`` splits into ``(key_lam,
    key_perm)`` (``core/metrics.py:66-68``): a ``Beta(alpha, alpha)`` from
    each ``key_lam`` rounded to float32 (``"lam"``, ``[N]``), and the
    permutation of `perm_n` (``"perm"``, int64) from the first key's
    ``key_perm``.  `gamma` is ``(d, c, 1 / alpha, boost)`` of the Beta's
    Gammas (``ops/rng.py gamma_constants``)."""
    given = [t for t in (key_shake, key_drop, mix_keys) if t is not None]
    if not given:
        raise ValueError("the train-noise kernel needs at least one key")
    dev = _check_keys("train-noise", *given)
    out = {}
    num_lam = 0
    if mix_keys is not None:
        if gamma is None or mix_keys.dim() != 2:
            raise ValueError("mixup's draws need mix_keys [N, 2] and the Gamma constants")
        num_lam = mix_keys.shape[0]
        out["lam"] = torch.empty((num_lam,), dtype=torch.float32, device=dev)
    if perm_n:
        if not num_lam:
            raise ValueError("a permutation needs a mixup key")
        out["perm"] = torch.empty((perm_n,), dtype=torch.int64, device=dev)
    count, items, table = _noise_table(sites)
    fbuf = bbuf = None
    if sites is not None:
        if key_shake is None or key_drop is None:
            raise ValueError("noise sites need key_shake and key_drop")
        packed = out["packed"] = torch.empty((sites.nbytes,), dtype=torch.uint8, device=dev)
        fbuf = bbuf = packed.data_ptr()  # sites.out: floats and bytes from its start
    d, c, inv, boost = gamma or (0.0, 0.0, 0.0, False)
    if count or num_lam:
        lib = load_libraries()["sampler"]
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _launch(lib.faa_train_noise, "train-noise", "train_noise", count, items, *table,
                ptr(key_shake), ptr(key_drop), int(batch), fbuf, bbuf, ptr(mix_keys), num_lam,
                int(perm_n), float(d), float(c), float(inv), int(bool(boost)),
                ptr(out.get("lam")), ptr(out.get("perm")), dev.index or 0,
                torch.cuda.current_stream(dev).cuda_stream)
    return out


def step_draws(key: torch.Tensor, scalars: torch.Tensor, *, batch: int, sites=None,
               gamma: tuple | None = None, record: dict | None = None) -> dict:
    """K8 as all the draws of one train step, in one launch (``csrc/sampler.cu
    step_kernel``).

    The kernel derives the step's key chain on chip: ``fold_in(key, step)``
    with the step counter read from ``scalars[0]`` (the step's float64
    scalars, so a captured graph reads each replay's row), its split into
    ``(key_aug, key_model)`` (``"key_aug"`` ``[2]`` int64 is an output) and
    ``key_model``'s into ``(key_mix, key_shake, key_drop)``.  `sites` (a
    ``NoiseLayout``) draws the noise into ``"packed"`` as :func:`train_noise`
    does; `gamma` (``ops/rng.py gamma_constants``) draws mixup's Beta
    (``"lam"`` ``[1]``) and permutation of `batch` (``"perm"``) from
    ``key_mix``; `record` draws one key's augment record from ``key_aug``:
    ``dict(grouped, groups, num_sub, num_op, height, width, crop, imagenet,
    presplit)`` as :func:`sampler_lanes` (``num_op`` None: no sub-policy) or
    :func:`sampler_grouped` take them, the outputs under their names."""
    dev = _check_keys("step-draws", key)
    if tuple(key.shape) != (2,):
        raise ValueError(f"the step's key must be [2], got {tuple(key.shape)}")
    if scalars.device != dev or scalars.dtype != torch.float64 or not scalars.is_contiguous() \
            or scalars.numel() < 1:
        raise ValueError("scalars must be a contiguous float64 tensor on the key's device")
    if batch < 1:
        raise ValueError(f"a train step's draws need a batch >= 1, got {batch}")
    out = {"key_aug": torch.empty((2,), dtype=torch.int64, device=dev)}
    count, items, table = _noise_table(sites)
    fbuf = None
    if sites is not None:
        if sites.batch != batch:
            raise ValueError(f"the noise layout is for a batch of {sites.batch}, not {batch}")
        out["packed"] = torch.empty((sites.nbytes,), dtype=torch.uint8, device=dev)
        fbuf = out["packed"].data_ptr()  # sites.out: floats and bytes from its start
    if gamma is not None:
        out["lam"] = torch.empty((1,), dtype=torch.float32, device=dev)
        out["perm"] = torch.empty((batch,), dtype=torch.int64, device=dev)
    kind, chunk, presplit = _NO_RECORD, 0, 0
    rec_scalars = [0, 0, 1, 1, 1, 0.0, 0.0, 0.0]
    rec = [None, None, None] + [None, 0] * 5
    if record is not None:
        r = record
        num_op = r.get("num_op")
        if r["grouped"]:
            if num_op is None or num_op < 1 or r["num_sub"] < 1:
                raise ValueError(f"no grouped record of {r['num_sub']} x {num_op}")
            kind, chunk = _GROUPED_RECORD, -(-batch // max(1, min(int(r["groups"]), batch)))
            presplit = int(bool(r.get("presplit")))
        else:
            if num_op is not None and (num_op < 1 or r["num_sub"] < 1):
                raise ValueError(f"no exact record of {r['num_sub']} x {num_op}")
            kind = _LANE_RECORD
        outs, rec = _records(dev, batch, num_op=num_op, crop=bool(r.get("crop")),
                             imagenet=bool(r.get("imagenet")))
        out.update(outs)
        rec_scalars = _record_scalars(r.get("num_sub", 1), num_op, r["height"], r["width"],
                                      r.get("pad", 4), r.get("strength", 0.4),
                                      r.get("alphastd", 0.1))
    d, c, inv, boost = gamma or (0.0, 0.0, 0.0, False)
    lib = load_libraries()["sampler"]
    ptr = lambda k: out[k].data_ptr() if k in out else None  # noqa: E731
    _launch(lib.faa_step_draws, "step-draws", "train_noise", key.data_ptr(), scalars.data_ptr(),
            ptr("key_aug"), count, items, *table, int(batch), fbuf, fbuf, int(gamma is not None),
            float(d), float(c), float(inv), int(bool(boost)), ptr("lam"), ptr("perm"), kind,
            chunk, presplit, *rec_scalars, *rec, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    return out
