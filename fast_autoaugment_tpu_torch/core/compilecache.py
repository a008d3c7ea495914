"""The port's compile seam (``fast_autoaugment_tpu/core/compilecache.py``).

On the card "compile" is two things: the ``nvcc`` build of the kernel
libraries (``ops/_kernels.py``), and the first call of each graphed step,
which warms it up and captures its CUDA graph.

1. **The kernel cache** (``--compile-cache {off,DIR}``, env
   ``FAA_COMPILE_CACHE``): the libraries are built into and loaded from
   DIR, named by a digest of their source and flags (``ops/_kernels.py
   _library_path``), so a second process on the same DIR, an exit-77
   resume for example, loads them and builds nothing.  A library found in
   DIR is a hit, one built there a miss; the counts live in the telemetry
   registry (``faa_compile_cache_{hits,misses}_total``).  ``off`` (the
   default) keeps the package's own ``_build`` directory and counts
   nothing, as before.
2. **The seam** (:func:`timed_first`, :func:`record_first_call`): the first
   call of each label (``tta``, ``tta_batched``, ``audit``, ``train_dispatch``,
   ``kernels``) is timed and classified ``hit``/``miss`` (a library was
   loaded from or built into DIR during it), ``none`` (neither) or
   ``uncached`` (the cache is off).

:func:`compile_cache_stats` is the artifact stamp ``{dir, enabled, hits,
misses, first_step_secs, labels}``; :func:`process_is_warm` (hits and no
miss) lets the watchdog shrink its first-call allowance.
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path

from fast_autoaugment_tpu_torch.core import telemetry
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["ENV_VAR", "resolve_compile_cache", "configure_compile_cache", "enable_compile_cache",
           "cache_dir", "process_is_warm", "record_libraries", "record_first_call",
           "timed_first", "compile_cache_stats"]

logger = get_logger("faa_torch.compilecache")

#: env handoff: the CLIs export the resolved dir so child processes and
#: exit-77 relaunches inherit the cache without the flag
ENV_VAR = "FAA_COMPILE_CACHE"

_lock = threading.Lock()
_dir: str | None = None
_HITS = telemetry.registry().counter(
    "faa_compile_cache_hits_total",
    "persistent-compile-cache modules deserialized instead of compiled")
_MISSES = telemetry.registry().counter(
    "faa_compile_cache_misses_total",
    "persistent-compile-cache modules compiled fresh")
# {label: {"sec": float, "hit": n, "miss": n, "uncached": n, "none": n}}
_labels: dict[str, dict] = {}


def resolve_compile_cache(spec: str | None = None) -> str | None:
    """``--compile-cache {off,DIR}`` (or None) -> cache dir or None; unset or
    ``off`` falls back to the :data:`ENV_VAR` handoff (``off`` there too
    disables)."""
    spec = ("" if spec is None else str(spec)).strip()
    if spec.lower() in ("", "off"):
        env = os.environ.get(ENV_VAR, "").strip()
        if env.lower() in ("", "off"):
            return None
        return env
    return spec


def enable_compile_cache(directory: str) -> str:
    """Build and load the kernel libraries in `directory` from now on, and
    export :data:`ENV_VAR` for child processes.  Idempotent.  Libraries
    this process already loaded stay loaded."""
    global _dir
    from fast_autoaugment_tpu_torch.ops import _kernels

    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    with _lock:
        if _dir is not None and _dir != directory:
            logger.warning("compile cache re-pointed %s -> %s", _dir, directory)
        _dir = directory
    _kernels.BUILD_DIR = Path(directory)
    os.environ[ENV_VAR] = directory
    logger.info("kernel compile cache at %s", directory)
    return directory


def configure_compile_cache(spec: str | None = None) -> str | None:
    """Resolve `spec` (None = the environment only) and enable the cache when
    it names a directory.  Returns the active dir or None."""
    directory = resolve_compile_cache(spec)
    if directory:
        return enable_compile_cache(directory)
    return None


def cache_dir() -> str | None:
    return _dir


def process_is_warm() -> bool:
    """True once this process has loaded libraries from the cache and built
    none there: no cold build can still be coming."""
    return _dir is not None and _HITS.value > 0 and _MISSES.value == 0


def _snapshot() -> tuple[int, int]:
    return int(_HITS.value), int(_MISSES.value)


def _classify(h0: int, m0: int) -> str:
    if _dir is None:
        return "uncached"
    dh, dm = int(_HITS.value) - h0, int(_MISSES.value) - m0
    if dm > 0:
        return "miss"
    if dh > 0:
        return "hit"
    return "none"


def record_first_call(label: str, sec: float, verdict: str) -> None:
    """Add one first call of `label` (its seconds and verdict) to the stats
    and the journal."""
    with _lock:
        rec = _labels.setdefault(label, {"sec": 0.0, "hit": 0, "miss": 0, "uncached": 0,
                                         "none": 0})
        rec["sec"] += float(sec)
        rec[verdict] += 1
    telemetry.emit("compile", label, sec=round(float(sec), 6), verdict=verdict, cache_dir=_dir)
    if sec >= 1.0:
        logger.info("compile seam %r: first call %.1fs (%s)", label, sec, verdict)


def record_libraries(hits: list[str], misses: list[str], sec: float) -> None:
    """``ops/_kernels.py load_libraries``: the libraries loaded from the
    cache (`hits`) and built into it (`misses`) in `sec` seconds, recorded
    under the label ``kernels``."""
    if _dir is None:
        record_first_call("kernels", sec, "uncached")
        return
    _HITS.inc(len(hits))
    _MISSES.inc(len(misses))
    record_first_call("kernels", sec, "miss" if misses else "hit")


def timed_first(label: str):
    """Context manager timing one first call (a graph's warm-up and
    capture) under `label`."""
    return _FirstCall(label)


class _FirstCall:
    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.h0, self.m0 = _snapshot()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            record_first_call(self.label, time.perf_counter() - self.t0,
                              _classify(self.h0, self.m0))
        return False


def compile_cache_stats() -> dict:
    """The artifact stamp: ``{dir, enabled, hits, misses, first_step_secs,
    labels}``; ``first_step_secs`` is the total first-call seconds paid
    through the seam."""
    with _lock:
        labels = {lb: {"sec": round(r["sec"], 3), "hit": r["hit"], "miss": r["miss"],
                       "uncached": r["uncached"], "none": r["none"]}
                  for lb, r in sorted(_labels.items())}
        first_step = round(sum(r["sec"] for r in _labels.values()), 3)
    return {"dir": _dir, "enabled": _dir is not None, "hits": int(_HITS.value),
            "misses": int(_MISSES.value), "first_step_secs": first_step, "labels": labels}


def _reset_stats_for_tests() -> None:
    _HITS._reset()
    _MISSES._reset()
    with _lock:
        _labels.clear()


def _disable_for_tests() -> None:
    """Detach the cache dir (the package's ``_build`` again)."""
    global _dir
    from fast_autoaugment_tpu_torch.ops import _kernels

    with _lock:
        _dir = None
    _kernels.BUILD_DIR = _kernels.DEFAULT_BUILD_DIR
    os.environ.pop(ENV_VAR, None)
