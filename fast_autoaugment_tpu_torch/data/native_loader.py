"""The native JPEG loader (``fast_autoaugment_tpu/data/native_loader.py``): a
``ctypes`` binding of ``faa_decode_resize_batch``, ``faa_gather_u8`` and
``faa_image_size`` (``native/faa_loader.cpp:210-268``).

One C interface, two builds, picked by what the host's compiler finds:

- ``libjpeg``: ``native/faa_loader.cpp`` as it stands, compiled with
  ``g++ -O3 -fPIC -std=c++17 -shared -ljpeg -pthread`` when ``<jpeglib.h>``
  is there: a thread pool that decodes with libjpeg, crops to a box and
  resizes with a triangle filter;
- ``nvjpeg``: ``csrc/nvjpeg_loader.cpp``, when libjpeg's header is absent and
  the CUDA toolkit has ``nvjpeg.h`` (the H100 machine has no libjpeg): each
  worker thread decodes on the card with nvJPEG to the JPEG's Y, Cb and Cr
  planes, copies them back, upsamples the chroma and converts to RGB as
  libjpeg does (``csrc/jpeg_ycc.h``), and crops and resizes on the host with
  a copy of ``faa_loader.cpp``'s ``resize_box_bilinear``, so only nvJPEG's
  inverse DCT departs from the libjpeg build; a failure of the card raises
  (:func:`decode_resize_batch`), where a bad file is zero-filled and counted
  (``data/jpeg_golden.py`` states the tolerance against a libjpeg golden).

The library is built at first use into ``fast_autoaugment_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a digest of the source and the command,
as ``ops/_kernels.py`` keys the kernels.  Nothing is written under
``native/``: the JAX wrapper's ``make -C native`` is not used, and no
library built elsewhere is loaded.  A build that fails raises with the
compiler's output.  ``FAA_NATIVE_LOADER=0`` turns the loader off
(:func:`available` is then False and callers decode with PIL).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["BUILD_DIR", "available", "backend", "build", "decode_resize_batch", "gather_u8",
           "image_size"]

_PKG = Path(__file__).resolve().parent.parent
_REPO = _PKG.parent
#: where the library is built and loaded from
BUILD_DIR = _PKG / "_build"
SOURCES = {"libjpeg": _REPO / "native" / "faa_loader.cpp",
           "nvjpeg": _PKG / "csrc" / "nvjpeg_loader.cpp"}
#: the headers each source includes from the repository (they key its build too)
HEADERS = {"libjpeg": (), "nvjpeg": (_PKG / "csrc" / "jpeg_ycc.h",)}
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler (g++) found: the native loader cannot be built")
    return found


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"


def _has_header(header: str, include: list[str]) -> bool:
    """Whether the compiler's preprocessor finds `header`."""
    if not (os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")):
        return False
    proc = subprocess.run([_cxx(), "-E", "-x", "c++", *include, "-"],
                          input=f"#include <cstdio>\n#include <{header}>\n", text=True,
                          capture_output=True)
    return proc.returncode == 0


def backend() -> str | None:
    """``"libjpeg"`` where ``<jpeglib.h>`` is found, else ``"nvjpeg"`` where
    the CUDA toolkit's ``nvjpeg.h`` is, else None (no native loader here)."""
    if _has_header("jpeglib.h", []):
        return "libjpeg"
    if _has_header("nvjpeg.h", [f"-I{_cuda_home()}/include"]):
        return "nvjpeg"
    return None


def _command(name: str, out: Path) -> list[str]:
    if name == "libjpeg":
        return [_cxx(), *CXX_FLAGS, str(SOURCES[name]), "-o", str(out), "-ljpeg", "-pthread"]
    cuda = _cuda_home()
    return [_cxx(), *CXX_FLAGS, f"-I{cuda}/include", str(SOURCES[name]), "-o", str(out),
            f"-L{cuda}/lib64", f"-Wl,-rpath,{cuda}/lib64", "-lnvjpeg", "-lcudart", "-pthread"]


def build(name: str | None = None, build_dir: Path | str | None = None) -> Path:
    """Compile backend `name` (default :func:`backend`) into `build_dir`
    (default :data:`BUILD_DIR`) unless it is there already; returns the
    library's path.  A failed compile raises with the compiler's output."""
    name = name or backend()
    if name not in SOURCES:
        raise RuntimeError("no native loader can be built here: neither <jpeglib.h> nor the "
                           f"CUDA toolkit's nvjpeg.h ({_cuda_home()}/include) is found")
    out_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    probe = _command(name, Path("OUT"))
    text = b"".join(p.read_bytes() for p in (SOURCES[name], *HEADERS[name]))
    digest = hashlib.sha256(text + " ".join(probe).encode()).hexdigest()[:16]
    out = out_dir / f"faa_loader_{name}_{digest}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = _command(name, tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the native loader's build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load(path: Path | str) -> ctypes.CDLL:
    """Load a built library and declare its functions."""
    lib = ctypes.CDLL(str(path))
    lib.faa_decode_resize_batch.restype = ctypes.c_int
    lib.faa_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_void_p,  # boxes (float* or NULL)
        ctypes.c_int, ctypes.c_void_p,  # target, out
        ctypes.c_int,  # threads
    ]
    lib.faa_gather_u8.restype = None
    lib.faa_gather_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.faa_image_size.restype = ctypes.c_int
    lib.faa_image_size.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    if hasattr(lib, "faa_last_error"):  # the nvJPEG build's
        lib.faa_last_error.restype = ctypes.c_char_p
        lib.faa_last_error.argtypes = []
    return lib


def _lib() -> ctypes.CDLL | None:
    """The loaded library (built at the first call), or None when the loader
    is off or this host can build neither backend."""
    if os.environ.get("FAA_NATIVE_LOADER", "1") == "0":
        return None
    with _lock:
        if "lib" not in _libs:
            name = backend()
            _libs["lib"] = load(build(name)) if name is not None else None
            _libs["name"] = name
        return _libs["lib"]


def available() -> bool:
    """Whether the native loader is on and built (building it if needed)."""
    return _lib() is not None


def loaded_backend() -> str | None:
    """The backend of the loaded library (``"libjpeg"``/``"nvjpeg"``), or
    None when none is loaded."""
    return _libs.get("name") if available() else None


def image_size(path) -> tuple[int, int] | None:
    """``(width, height)`` from the JPEG header, or None on failure."""
    lib = _lib()
    if lib is None:
        return None
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.faa_image_size(os.fsencode(str(path)), ctypes.byref(w), ctypes.byref(h)):
        return None
    return int(w.value), int(h.value)


def _threads(threads: int | None) -> int:
    return int(threads or min(16, os.cpu_count() or 1))


def decode_resize_batch(paths, target: int, boxes: np.ndarray | None = None,
                        threads: int | None = None, lib: ctypes.CDLL | None = None
                        ) -> tuple[np.ndarray, int]:
    """Decode `paths` (JPEG files) into a ``[N, target, target, 3]`` uint8
    batch; `boxes` is an optional ``[N, 4]`` float32 of crop boxes
    ``(x0, y0, x1, y1)`` in source pixels.  Returns ``(batch,
    num_failures)``: a file that cannot be read or decoded is zero-filled
    and counted.  A failure of the card (the nvJPEG build: a device
    allocation, copy or decode that fails for another reason than the file)
    raises.  `lib` (a :func:`load` result) overrides the module's
    library."""
    lib = lib or _lib()
    if lib is None:
        raise RuntimeError("the native loader is off (FAA_NATIVE_LOADER=0) or cannot be built "
                           "here (no <jpeglib.h>, no nvjpeg.h)")
    n = len(paths)
    out = np.empty((n, target, target, 3), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
    boxes_ptr = None
    if boxes is not None:
        boxes = np.ascontiguousarray(boxes, np.float32)
        if boxes.shape != (n, 4):
            raise ValueError(f"boxes must be [{n}, 4], got {list(boxes.shape)}")
        boxes_ptr = boxes.ctypes.data_as(ctypes.c_void_p)
    failures = lib.faa_decode_resize_batch(c_paths, n, boxes_ptr, int(target),
                                           out.ctypes.data_as(ctypes.c_void_p),
                                           _threads(threads))
    if failures < 0:
        raise RuntimeError("the native loader's decode failed on the card: "
                           f"{lib.faa_last_error().decode(errors='replace')}")
    return out, int(failures)


def gather_u8(src: np.ndarray, index: np.ndarray, threads: int | None = None) -> np.ndarray:
    """Parallel batch gather: ``out[i] = src[index[i]]`` (contiguous rows);
    numpy's gather when the loader is off."""
    lib = _lib()
    if lib is None:
        return src[index]
    src = np.ascontiguousarray(src)
    index = np.ascontiguousarray(index, np.int64)
    if index.size and (index.min() < 0 or index.max() >= len(src)):
        raise IndexError(f"gather index out of range [0, {len(src)})")
    item_bytes = int(np.prod(src.shape[1:])) * src.itemsize
    out = np.empty((len(index),) + src.shape[1:], src.dtype)
    lib.faa_gather_u8(src.ctypes.data_as(ctypes.c_void_p),
                      index.ctypes.data_as(ctypes.c_void_p), len(index), item_bytes,
                      out.ctypes.data_as(ctypes.c_void_p), _threads(threads))
    return out
