"""Build, load and launch the hand-written CUDA kernels of the port.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface and bound with
``ctypes``:

- ``augment.cu``: the policy augmentation (``augment_slot``);
- ``preprocess.cu``: the CIFAR crop/flip/normalize/cutout stack
  (``cifar_stack``);
- ``imagenet.cu``: the ImageNet flip/ColorJitter/lighting/normalize/cutout
  stack (``imagenet_stack``, two launches: a grey-sum pass and the
  per-pixel pass).

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
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCES", "load_libraries", "augment",
           "cifar_stack", "imagenet_stack", "launch_counts", "reset_launch_counts"]

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
    "augment": {"faa_augment_slot": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "preprocess": {"faa_cifar_stack": [_P, _P, _P, _I, _I, _I, _I, _I, _F,
                                       _F, _F, _F, _F, _F, _F, _I, _P]},
    "imagenet": {"faa_imagenet_stack": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                        _F, _F, _F, _F, _F, _F, _I, _P],
                 "faa_imagenet_tiles": [_I, _I]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_launches = {"augment_slot": 0, "cifar_stack": 0, "imagenet_stack": 0}
#: wall seconds of the last build of all missing libraries (0.0 when every
#: library was already built)
build_seconds = 0.0


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


def augment(images: torch.Tensor, records: torch.Tensor) -> torch.Tensor:
    """Run every op slot of ``records [B, num_op, 16]`` over ``images
    [B, H, W, 3]`` with the CUDA kernel, one launch per slot, ping-ponging
    between two buffers so that the last slot writes the result."""
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
    if b == 0:
        return torch.empty_like(images)
    lib = load_libraries()["augment"]
    out = torch.empty_like(images)
    tmp = torch.empty_like(images) if num_op > 1 else None
    stream = torch.cuda.current_stream(images.device).cuda_stream
    src = images
    for slot in range(num_op):
        dst = out if (num_op - 1 - slot) % 2 == 0 else tmp
        rc = lib.faa_augment_slot(src.data_ptr(), dst.data_ptr(), records.data_ptr(),
                                  slot, num_op, b, h, w, images.device.index or 0,
                                  stream)
        _check_rc(lib, rc, "augment")
        with _lock:
            _launches["augment_slot"] += 1
        src = dst
    return out


def cifar_stack(images: torch.Tensor, draws: torch.Tensor, *, pad: int,
                cutout_length: int, scale: float, mean, rstd) -> torch.Tensor:
    """Crop with zero pad, flip, normalize and cut out ``images [N, H, W, 3]``
    (float32, integral in [0, 255]) with the CUDA kernel, one launch.

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
        lib = load_libraries()["preprocess"]
        stream = torch.cuda.current_stream(images.device).cuda_stream
        m = [float(v) for v in mean]
        r = [float(v) for v in rstd]
        rc = lib.faa_cifar_stack(images.data_ptr(), out.data_ptr(), draws.data_ptr(),
                                 n, h, w, int(pad), int(cutout_length) // 2,
                                 float(scale), *m, *r, images.device.index or 0, stream)
        _check_rc(lib, rc, "CIFAR stack")
        with _lock:
            _launches["cifar_stack"] += 1
    return out.permute(0, 3, 1, 2)


def imagenet_stack(images: torch.Tensor, ints: torch.Tensor, floats: torch.Tensor, *,
                   cutout_length: int, scale: float, mean, rstd) -> torch.Tensor:
    """Flip, ColorJitter, scale, light, normalize and cut out ``images
    [N, H, W, 3]`` (uint8, or float32 integral in [0, 255]) with the CUDA
    kernel: two launches, a grey-sum pass and the per-pixel pass.

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
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=images.device)
    if n:
        lib = load_libraries()["imagenet"]
        partial = torch.empty((n, lib.faa_imagenet_tiles(h, w)), dtype=torch.int64,
                              device=images.device)
        stream = torch.cuda.current_stream(images.device).cuda_stream
        m = [float(v) for v in mean]
        r = [float(v) for v in rstd]
        rc = lib.faa_imagenet_stack(images.data_ptr(), int(images.dtype == torch.uint8),
                                    out.data_ptr(), ints.data_ptr(), floats.data_ptr(),
                                    partial.data_ptr(), n, h, w, int(cutout_length) // 2,
                                    float(scale), *m, *r, images.device.index or 0, stream)
        _check_rc(lib, rc, "ImageNet stack")
        with _lock:
            _launches["imagenet_stack"] += 2
    return out.permute(0, 3, 1, 2)
