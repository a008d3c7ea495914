"""Build, load and launch the hand-written CUDA kernels of the port.

``csrc/augment.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and bound with ``ctypes``.  The build
happens on first use, into ``fast_autoaugment_tpu_torch/_build/`` (listed
in ``.gitignore``), keyed by a hash of the source and the flags, so a
second process finds the library already built.  Nothing is built or
imported from CUDA when this module is imported.
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

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "load_library", "augment",
           "launch_counts", "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "augment.cu"
BUILD_DIR = _PKG / "_build"
#: --fmad=false: the ops are held bitwise against PIL-exact references,
#: and a contracted multiply-add rounds differently
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
_launches = {"augment_slot": 0}
#: wall seconds of the last build (0.0 when the library was already built)
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
                       "the augmentation kernel cannot be built")


def _build(out: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    build_seconds = time.perf_counter() - t0


def load_library():
    """Build (once per source and flag set) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(SOURCE.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"augment_{digest}.so"
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.faa_augment_slot.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.faa_augment_slot.restype = ctypes.c_int
        lib.faa_error_string.argtypes = [ctypes.c_int]
        lib.faa_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch_counts() -> dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for k in _launches:
            _launches[k] = 0


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
    lib = load_library()
    out = torch.empty_like(images)
    tmp = torch.empty_like(images) if num_op > 1 else None
    stream = torch.cuda.current_stream(images.device).cuda_stream
    src = images
    for slot in range(num_op):
        dst = out if (num_op - 1 - slot) % 2 == 0 else tmp
        rc = lib.faa_augment_slot(src.data_ptr(), dst.data_ptr(), records.data_ptr(),
                                  slot, num_op, b, h, w, images.device.index or 0,
                                  stream)
        if rc != 0:
            raise RuntimeError(f"augment kernel launch failed: "
                               f"{lib.faa_error_string(rc).decode()}")
        with _lock:
            _launches["augment_slot"] += 1
        src = dst
    return out
