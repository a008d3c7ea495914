"""The JPEG golden that the native loader's decode is held to
(``tests/data/jpeg_golden/``): five small JPEGs (4:2:0, 4:2:2, 4:4:4 and
greyscale, smooth content) and ``libjpeg.npz``, what the libjpeg build of
the loader (``native/faa_loader.cpp``) makes of them (:func:`golden_arrays`).
On the CPU the tests hold the port's libjpeg build to it bitwise; on the
card, where the loader decodes with nvJPEG (``csrc/nvjpeg_loader.cpp``),
``chip_smoke.py`` and the card tests hold it to :data:`NVJPEG_TOLERANCE`.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from fast_autoaugment_tpu_torch.data import native_loader

__all__ = ["GOLDEN_DIR", "GOLDEN_BOXES", "NVJPEG_TOLERANCE", "golden_paths", "golden_arrays",
           "departure"]

#: the golden's folder in a checkout of the repository
GOLDEN_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "jpeg_golden"
#: crop boxes (x0, y0, x1, y1) of the boxed golden, one per JPEG
GOLDEN_BOXES = np.array([[3.0, 2.0, 43.5, 40.0], [0.0, 5.25, 47.0, 60.0], [10.0, 0.0, 58.0, 48.0],
                         [7.5, 7.5, 63.5, 55.0], [1.0, 1.0, 50.0, 49.0]], np.float32)
#: nvJPEG's departure from libjpeg on the golden, in uint8 levels: the
#: largest difference of one value and the mean over all values, at full
#: resolution (the top-left squares) and resized (the 32 and boxed 24
#: batches).  The loader takes nvJPEG's Y, Cb and Cr planes and upsamples
#: and converts them as libjpeg does (``csrc/jpeg_ycc.h``), so only the
#: inverse DCT departs.  Measured on an H100 (CUDA 12.8's nvJPEG 12.4): 2
#: and 0.027 at full resolution (2.7% of the values differ), 1 and 0.026
#: resized; nvJPEG's own RGB conversion departed by 30 and 1.95.
NVJPEG_TOLERANCE = {"full_resolution": {"max_abs": 3, "mean_abs": 0.1},
                    "resized": {"max_abs": 2, "mean_abs": 0.1}}


def golden_paths(directory: Path | str = GOLDEN_DIR) -> list[str]:
    return sorted(str(p) for p in Path(directory).glob("*.jpg"))


def golden_arrays(lib, directory: Path | str = GOLDEN_DIR) -> dict[str, np.ndarray]:
    """What the native library `lib` (a ``native_loader.load`` result)
    makes of the golden JPEGs: each one's header size, its top-left square
    at full resolution (a box of the square at its own side resamples to
    the pixels themselves), the whole image resized to 32 and the
    :data:`GOLDEN_BOXES` crops resized to 24."""
    paths = golden_paths(directory)
    out, failures = {}, 0
    sizes = []
    for i, p in enumerate(paths):
        w, h = _size(lib, p)
        sizes.append((w, h))
        s = min(w, h)
        box = np.array([[0, 0, s, s]], np.float32)
        out[f"square_{i}"], f = native_loader.decode_resize_batch([p], s, box, lib=lib)
        failures += f
    out["sizes"] = np.array(sizes, np.int32)
    out["resized_32"], f = native_loader.decode_resize_batch(paths, 32, lib=lib)
    failures += f
    out["boxed_24"], f = native_loader.decode_resize_batch(paths, 24, GOLDEN_BOXES, lib=lib)
    out["failures"] = np.array(failures + f, np.int32)
    return out


def _size(lib, path) -> tuple[int, int]:
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.faa_image_size(os.fsencode(path), ctypes.byref(w), ctypes.byref(h)):
        raise RuntimeError(f"no JPEG header size for {path}")
    return int(w.value), int(h.value)


def departure(got: dict, want: dict) -> dict:
    """Max and mean absolute difference at full resolution and resized (the
    keys of :data:`NVJPEG_TOLERANCE`), and whether the sizes and failure
    counts agree."""
    out = {"sizes_equal": bool(np.array_equal(got["sizes"], want["sizes"])),
           "failures": int(got["failures"])}
    for kind, keys in (("full_resolution", [k for k in want if k.startswith("square_")]),
                       ("resized", ["resized_32", "boxed_24"])):
        flat = np.concatenate([np.abs(got[k].astype(np.int32) - want[k].astype(np.int32)).ravel()
                               for k in keys])
        out[kind] = {"max_abs": int(flat.max()), "mean_abs": float(flat.mean())}
    return out
