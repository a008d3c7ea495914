"""Build, load and launch the hand-written CUDA kernels of the port.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface and bound with
``ctypes``:

- ``augment.cu``: the policy augmentation (``augment``): every op slot in
  one launch with the image held in shared memory, one thread-block
  cluster per image, or one launch per slot for images too large for a
  cluster (:func:`augment_plan` chooses by shape);
- ``preprocess.cu``: the CIFAR crop/flip/normalize/cutout stack
  (``cifar_stack``, one block per image, :func:`cifar_plan`);
- ``imagenet.cu``: the ImageNet flip/ColorJitter/lighting/normalize/cutout
  stack (``imagenet_stack``): one launch with the image held in shared
  memory by one block or by a thread-block cluster that reduces the
  contrast mean through distributed shared memory, or a grey-sum pass and
  a per-pixel pass for images too large for a cluster
  (:func:`imagenet_plan` chooses by shape and dtype).

The build happens on first use, into ``fast_autoaugment_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the source and the flags, so
a second process finds the libraries already built.  The sources that are
not built yet are compiled together, one ``nvcc`` process each.  Nothing is
built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

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
           "augment_max_active_clusters", "cifar_stack", "imagenet_stack",
           "imagenet_max_active_clusters", "launch_counts", "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"augment": _PKG / "csrc" / "augment.cu",
           "preprocess": _PKG / "csrc" / "preprocess.cu",
           "imagenet": _PKG / "csrc" / "imagenet.cu"}
BUILD_DIR = _PKG / "_build"
#: --fmad=false: the kernels are held bitwise against references that
#: round every product and sum on its own, and a contracted multiply-add
#: rounds differently
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: {C function: argument types} of each library; each returns an int
_SIGNATURES = {
    "augment": {"faa_augment": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                "faa_augment_slot": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                "faa_augment_max_active_clusters": [_I, _I, _I, _I, _I, _I,
                                                    ctypes.POINTER(_I)]},
    "preprocess": {"faa_cifar_stack": [_P, _P, _P, _I, _I, _I, _I, _I, _F,
                                       _F, _F, _F, _F, _F, _F, _I, _I, _I, _P]},
    "imagenet": {"faa_imagenet_stack": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                        _F, _F, _F, _F, _F, _F, _I, _I, _I, _I, _P],
                 "faa_imagenet_tiles": [_I, _I],
                 "faa_imagenet_max_active_clusters": [_I, _I, _I, _I, _I, _I, _I,
                                                      ctypes.POINTER(_I)]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_launches = {"augment": 0, "cifar_stack": 0, "imagenet_stack": 0}
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
        return dict(_libs)


def launch_counts() -> dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for k in _launches:
            _launches[k] = 0


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.faa_error_string(rc).decode()}")


def augment(images: torch.Tensor, records: torch.Tensor, *,
            cluster: int | None = None) -> torch.Tensor:
    """Run every op slot of ``records [B, num_op, 16]`` over ``images
    [B, H, W, 3]`` with the CUDA kernel as :func:`augment_plan` says: one
    launch on the cluster path; on the per-slot path one launch per slot,
    ping-ponging between two buffers so that the last slot writes the
    result.  `cluster` forces the cluster size (for measurement).  A launch
    the device refuses raises ``RuntimeError``."""
    if images.device.type != "cuda" or records.device != images.device:
        raise ValueError("the augmentation kernel takes CUDA tensors on one device")
    if images.dtype != torch.float32 or records.dtype != torch.float32:
        raise TypeError("the augmentation kernel takes float32 images and records")
    if not (images.is_contiguous() and records.is_contiguous()):
        raise ValueError("the augmentation kernel takes contiguous tensors")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [B, H, W, 3], got {tuple(images.shape)}")
    b, h, w, _ = images.shape
    if records.dim() != 3 or records.shape[0] != b or records.shape[2] != 16:
        raise ValueError(f"records must be [{b}, num_op, 16], got {tuple(records.shape)}")
    if h * w >= 1 << 24:
        raise ValueError(f"image of {h}x{w} pixels is too large for the kernel")
    num_op = records.shape[1]
    if num_op == 0:
        raise ValueError("records must hold at least one op slot")
    plan = augment_plan(h, w, num_op, cluster)
    if b == 0:
        return torch.empty_like(images)
    lib = load_libraries()["augment"]
    out = torch.empty_like(images)
    dev = images.device.index or 0
    stream = torch.cuda.current_stream(images.device).cuda_stream
    if plan.path == "cluster":
        rc = lib.faa_augment(images.data_ptr(), out.data_ptr(), records.data_ptr(), num_op,
                             b, h, w, plan.cluster, plan.smem_bytes, plan.threads, dev,
                             stream)
        _check_rc(lib, rc, "augment")
        with _lock:
            _launches["augment"] += 1
        return out
    tmp = torch.empty_like(images) if num_op > 1 else None
    src = images
    for slot in range(num_op):
        dst = out if (num_op - 1 - slot) % 2 == 0 else tmp
        rc = lib.faa_augment_slot(src.data_ptr(), dst.data_ptr(), records.data_ptr(),
                                  slot, num_op, b, h, w, dev, stream)
        _check_rc(lib, rc, "augment")
        with _lock:
            _launches["augment"] += 1
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
        with _lock:
            _launches["cifar_stack"] += 1
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
        with _lock:
            _launches["imagenet_stack"] += plan.launches
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
