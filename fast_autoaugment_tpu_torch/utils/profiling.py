"""Profiling, step timing and device-hours accounting
(``fast_autoaugment_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` trace of a region, written as a
  Chrome trace (``trace.json``) into a directory;
- :class:`StepTimer`: per-step wall timing with a warm-up skip;
- :class:`PhaseStopwatch`: named phases in wall and device seconds (wall x
  device count), the reference's GPU-hours ledger; on the card each start
  and stop synchronizes the device (``torch.cuda.synchronize``), so a phase
  holds the device work it launched.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from fast_autoaugment_tpu_torch.core.watchdog import capture_guard

__all__ = ["trace", "StepTimer", "PhaseStopwatch"]


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the region (CPU and, on the card, CUDA activity) and write
    ``logdir/trace.json``; a no-op when `logdir` is None."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Steady-state step timing: skips `warmup` steps, then tracks the mean
    step time and throughput.  With a `registry` (``core/telemetry.py``)
    and a `name`, every steady-state stop is observed into
    ``faa_step_seconds{timer=name}``."""

    def __init__(self, warmup: int = 3, *, name: str | None = None, registry=None):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self.items = 0
        self._last = None
        self._hist = None
        if registry is not None and name is not None:
            self._hist = registry.histogram("faa_step_seconds",
                                            "steady-state per-step wall seconds", timer=name)

    def start(self):
        self._last = time.perf_counter()

    def stop(self, items: int = 0) -> float:
        dt = time.perf_counter() - self._last
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
            self.items += items
            if self._hist is not None:
                self._hist.observe(dt)
        return dt

    @property
    def steps_timed(self) -> int:
        return max(0, self.count - self.warmup)

    @property
    def mean_step_seconds(self) -> float:
        return self.total / self.steps_timed if self.steps_timed else 0.0

    @property
    def items_per_second(self) -> float:
        return self.items / self.total if self.total else 0.0


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        # never while another thread captures a CUDA graph
        with capture_guard():
            torch.cuda.synchronize()


class PhaseStopwatch:
    """Named-phase wall and device-seconds ledger.  With a `registry`, every
    :meth:`stop` mirrors the totals into ``faa_phase_wall_seconds{phase}``
    and ``faa_phase_device_seconds{phase}``.  `device_count` None reads the
    visible cards (the CPU counts as one device) and records which device
    measured the seconds; an explicit count leaves it ``unspecified``."""

    def __init__(self, device_count: int | None = None, *, registry=None):
        if device_count is None:
            if torch.cuda.is_available():
                self.device_count = torch.cuda.device_count()
                self.backend = "cuda"
                self.device_kind = torch.cuda.get_device_name(0)
            else:
                self.device_count, self.backend, self.device_kind = 1, "cpu", "cpu"
        else:
            self.device_count = device_count
            self.backend = "unspecified"
            self.device_kind = "unspecified"
        self.phases: dict[str, float] = {}
        self._open: dict[str, float] = {}
        self._registry = registry

    @contextlib.contextmanager
    def phase(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def start(self, name: str):
        _sync()
        self._open[name] = time.time()

    def stop(self, name: str):
        if name not in self._open:
            return
        _sync()
        self.phases[name] = self.phases.get(name, 0.0) + (time.time() - self._open.pop(name))
        if self._registry is not None:
            w = self.phases[name]
            self._registry.gauge("faa_phase_wall_seconds",
                                 "accumulated wall seconds per named phase", phase=name).set(w)
            self._registry.gauge("faa_phase_device_seconds",
                                 "accumulated wall x device_count per named phase",
                                 phase=name).set(w * self.device_count)

    def wall_seconds(self, name: str) -> float:
        return self.phases.get(name, 0.0)

    def device_seconds(self, name: str) -> float:
        return self.wall_seconds(name) * self.device_count

    def device_hours(self, name: str) -> float:
        return self.device_seconds(name) / 3600.0

    def summary(self) -> dict:
        out = {name: {"wall_sec": round(w, 2), "device_sec": round(w * self.device_count, 2),
                      "device_hours": round(w * self.device_count / 3600.0, 4)}
               for name, w in self.phases.items()}
        out["_meta"] = {"backend": self.backend, "device_kind": self.device_kind,
                        "device_count": self.device_count}
        return out
