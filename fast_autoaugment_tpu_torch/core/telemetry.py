"""The clock seam of the serving path (``mono`` and ``wall`` of
``fast_autoaugment_tpu/core/telemetry.py``; the registry, journal and
fault seams of that module are not ported yet)."""

from __future__ import annotations

import time

__all__ = ["mono", "wall"]


def wall() -> float:
    """Wall-clock seconds (``time.time``): anchors cross-host comparison."""
    return time.time()


def mono() -> float:
    """Monotonic seconds (``time.perf_counter``): anchors durations."""
    return time.perf_counter()
