"""Watched device dispatch: deadline-guarded execution, hang detection
(the port's copy of ``fast_autoaugment_tpu/core/watchdog.py``).

:class:`DispatchWatchdog` runs a dispatch (a train dispatch, an eval
replay, a TTA or audit evaluation) in a worker thread and waits for it with
a deadline:

- the deadline comes from an **EMA of the observed wall per label**
  (``auto``: ``max(min_deadline, hang_factor x EMA)``) or is a fixed number
  of seconds;
- **the first call per label gets a generous allowance** (the kernels'
  build, cuDNN's plans, a CUDA-graph warm-up and capture must not read as
  a hang), shrunk to ``warm_allowance`` once the compile cache has proven
  the process warm (``core/compilecache.py process_is_warm``);
- expiry raises :class:`~fast_autoaugment_tpu_torch.core.resilience.
  DispatchHungError`, which the CLIs map to exit 77: the relaunch resumes
  from the newest intact checkpoint.

Where the JAX module blocks on ``block_until_ready``, this one waits on a
CUDA event recorded on the caller's stream after the call.  Waiting on
each watched dispatch serializes host and device, which is why the
default is ``off`` (values never change, only wall time).  The ``FAA_FAULT``
verbs ``hang@step=K`` and ``slow@step=K,factor=F`` drive it in tests
(``utils/faultinject.py``).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Callable

import torch

from fast_autoaugment_tpu_torch.core import telemetry
from fast_autoaugment_tpu_torch.core.resilience import DispatchHungError
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["DispatchWatchdog", "resolve_watchdog", "DispatchHungError",
           "arm_dispatch_serializer", "dispatch_enqueue_guard", "capture_guard"]

# ---------------------------------------------------------------------
# Process-wide dispatch serializer.  The async search pipeline launches
# device work from several threads (actor threads replaying TTA graphs,
# the overlapped phase-1 trainer): armed, every dispatch of the process
# (a trainer dispatch, an eval replay, a TTA/audit evaluation) and every
# CUDA-graph capture enqueues under ONE lock, so no thread's launches
# interleave with another's capture, and a graph's static buffers are
# staged, replayed and read back by one thread at a time.  Disarmed (the
# default, and every serial path) it is a no-op context.

_ENQUEUE_LOCK = threading.RLock()
_ENQUEUE_SERIALIZED = False


def arm_dispatch_serializer(on: bool = True) -> None:
    """Turn cross-thread dispatch serialization on/off (process-wide).
    ``search_policies`` arms it for async-pipeline runs and disarms it
    for serial runs, so one process can do both in sequence."""
    global _ENQUEUE_SERIALIZED
    _ENQUEUE_SERIALIZED = bool(on)


def dispatch_enqueue_guard():
    """Context manager for ONE dispatch (or capture): the serializer
    lock when armed, a no-op otherwise."""
    if _ENQUEUE_SERIALIZED:
        return _ENQUEUE_LOCK
    return contextlib.nullcontext()


#: always on: one CUDA-graph capture at a time in the process, and no
#: device-wide synchronize during one.  Two captures side by side, or a
#: capture beside another thread's ``empty_cache`` (which
#: ``torch.cuda.graph`` calls before it begins), invalidate each other
#: whatever the capture mode.  Taken after the dispatch guard, never before.
_CAPTURE_LOCK = threading.RLock()


def capture_guard():
    """Context manager around a CUDA-graph capture or a device-wide
    synchronize (``utils/profiling.py``)."""
    return _CAPTURE_LOCK

logger = get_logger("faa_torch.watchdog")

#: first-call-per-label deadline: covers the first call's set-up (the
#: kernels' nvcc build, cuDNN's plans, a CUDA-graph warm-up and capture)
#: with slack
DEFAULT_COMPILE_ALLOWANCE_SEC = 600.0
#: first-call deadline once the build is KNOWN paid (every kernel library
#: loaded from the compile cache, core/compilecache.py): a warm process
#: must not hide a 10-minute hang behind the blind window above
DEFAULT_WARM_ALLOWANCE_SEC = 60.0
#: auto mode: deadline = max(min_deadline, hang_factor * EMA)
DEFAULT_HANG_FACTOR = 20.0
DEFAULT_MIN_DEADLINE_SEC = 10.0
#: EMA smoothing for observed dispatch wall times
DEFAULT_EMA_ALPHA = 0.2


class DispatchWatchdog:
    """Deadline-guarded dispatch execution with per-label EMA timing.

    ``mode`` is ``"off"`` (disabled — :meth:`run` calls through with
    zero overhead), ``"auto"`` (EMA-derived deadlines), or a positive
    float (fixed steady-state deadline in seconds; the first call per
    label still gets ``max(seconds, compile_allowance)``).

    One instance is shared across a whole run (trainer + search) so
    :attr:`fires` aggregates every monitored seam; labels keep their
    own EMA because a train dispatch chunk and a whole-split eval
    replay have very different steady-state walls.

    THREAD-SAFE: the async search pipeline (``search/pipeline.py``)
    runs one monitored dispatch per actor thread concurrently, plus
    the overlapped phase-1 trainer thread — every read/write of the
    shared label state (EMAs, call counts, warm labels, fire count)
    goes through one internal lock.  :meth:`run` itself holds the lock
    only around that bookkeeping, never across the monitored wait, so
    concurrent dispatches still overlap freely.
    """

    def __init__(self, mode: str | float = "off", *,
                 compile_allowance: float = DEFAULT_COMPILE_ALLOWANCE_SEC,
                 warm_allowance: float = DEFAULT_WARM_ALLOWANCE_SEC,
                 hang_factor: float = DEFAULT_HANG_FACTOR,
                 min_deadline: float = DEFAULT_MIN_DEADLINE_SEC,
                 ema_alpha: float = DEFAULT_EMA_ALPHA):
        if isinstance(mode, str):
            mode = mode.strip().lower()
            if mode not in ("off", "auto"):
                mode = float(mode)  # "SECONDS" string from the CLI
        if isinstance(mode, (int, float)):
            if float(mode) <= 0:
                raise ValueError(f"watchdog deadline must be > 0, got {mode}")
            mode = float(mode)
        self.mode = mode
        self.compile_allowance = float(compile_allowance)
        self.warm_allowance = float(warm_allowance)
        self.hang_factor = float(hang_factor)
        self.min_deadline = float(min_deadline)
        self.ema_alpha = float(ema_alpha)
        self.fires = 0
        self._ema: dict[str, float] = {}
        self._calls: dict[str, int] = {}
        # labels whose executable is KNOWN pre-compiled (AOT-loaded) —
        # their first call gets the warm allowance, never the blind
        # compile window
        self._warm_labels: set[str] = set()
        # guards every access to the shared label state above: the
        # async pipeline dispatches from several actor threads at once
        self._lock = threading.RLock()

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def ema(self, label: str) -> float | None:
        """Current EMA of observed wall seconds for `label` (None until
        the first completed call)."""
        with self._lock:
            return self._ema.get(label)

    def mark_compile_warm(self, label: str) -> None:
        """Declare `label`'s executable pre-compiled (AOT-loaded / known
        persistent-cache hit): its first call gets the bounded
        ``warm_allowance`` instead of the blind compile window."""
        with self._lock:
            self._warm_labels.add(label)

    def _first_call_warm(self, label: str) -> bool:
        """Whether `label`'s FIRST call should be treated as compile-free:
        explicitly marked warm, or the process has already proven the
        persistent compile cache warm (hits observed, zero misses —
        ``core/compilecache.py``)."""
        with self._lock:
            if label in self._warm_labels:
                return True
        try:
            from fast_autoaugment_tpu_torch.core import compilecache
        except ImportError:  # pragma: no cover — core package is intact
            return False
        return compilecache.process_is_warm()

    def deadline(self, label: str) -> float:
        """The deadline the NEXT :meth:`run` for `label` will use.

        The first call per label normally gets the generous compile
        allowance (a 23-55 s first compile must never read as a hang);
        when the compile seam has reported cache hits and no misses —
        or the label's executable was AOT-loaded
        (:meth:`mark_compile_warm`) — that allowance shrinks to the
        normal deadline floor (``warm_allowance``), so a warm process
        cannot hide a genuine multi-minute hang behind a compile grace
        window it no longer needs."""
        with self._lock:
            first = self._calls.get(label, 0) == 0
        warm = first and self._first_call_warm(label)
        with self._lock:
            if isinstance(self.mode, float):
                if first and not warm:
                    return max(self.mode, self.compile_allowance)
                return self.mode
            # auto: generous compile allowance first, then EMA-derived
            if first or label not in self._ema:
                if warm:
                    return max(self.min_deadline, self.warm_allowance)
                return self.compile_allowance
            return max(self.min_deadline, self.hang_factor * self._ema[label])

    def observe(self, label: str, wall_sec: float) -> None:
        """Fold one observed dispatch wall time into the label's EMA.

        The first observation seeds the EMA directly — it is the
        compile call, but using it only ever makes deadlines MORE
        generous until steady-state observations pull the EMA down."""
        with self._lock:
            self._calls[label] = self._calls.get(label, 0) + 1
            prev = self._ema.get(label)
            if prev is None:
                self._ema[label] = float(wall_sec)
            else:
                self._ema[label] = (self.ema_alpha * float(wall_sec)
                                    + (1.0 - self.ema_alpha) * prev)
            ema = self._ema[label]
        # registry mirror (telemetry): the EMA any /metrics scrape or
        # bench stamp reads is the one the deadline math uses
        telemetry.registry().gauge(
            "faa_watchdog_ema_seconds",
            "per-label EMA of observed dispatch wall seconds",
            label=label).set(ema)

    def run(self, label: str, fn: Callable, *args: Any,
            inject_delay: float = 0.0) -> Any:
        """Run ``fn(*args)`` under the label's deadline and wait for the
        device to finish it.

        The call runs in a worker thread on the CALLER's current CUDA stream
        (PyTorch's current stream is per thread), and completion is a CUDA
        event recorded on that stream after the call: the deadline covers
        the launches and the device work they enqueued.  On the CPU the
        call itself is the work.  Disabled mode calls through inline, with
        no wait (an injected delay still sleeps: the real unwatched wedge).
        Raises :class:`DispatchHungError` on expiry; the worker is a
        daemon thread, so a wedged dispatch cannot block process exit (the
        recovery IS a process exit: a launched kernel cannot be
        cancelled)."""
        if not self.enabled:
            _sleep(inject_delay)
            with dispatch_enqueue_guard():
                return fn(*args)

        deadline = self.deadline(label)
        out_q: queue.Queue = queue.Queue(maxsize=1)
        stream = (torch.cuda.current_stream()
                  if torch.cuda.is_available() and torch.cuda.is_initialized() else None)
        t0 = time.monotonic()

        def _worker():
            try:
                _sleep(inject_delay)
                with contextlib.ExitStack() as stack:
                    if stream is not None:
                        stack.enter_context(torch.cuda.stream(stream))
                    with dispatch_enqueue_guard():
                        out = fn(*args)
                    if stream is not None:
                        done = torch.cuda.Event()
                        done.record(stream)
                        done.synchronize()
                # put_nowait: maxsize-1 queue, single producer, one
                # put per worker — can never block
                out_q.put_nowait(("ok", out, time.monotonic() - t0))
            except BaseException as e:  # delivered to the caller below
                out_q.put_nowait(("err", e, time.monotonic() - t0))

        worker = threading.Thread(target=_worker, daemon=True,
                                  name=f"watchdog-{label}")
        worker.start()
        try:
            kind, value, wall = out_q.get(timeout=deadline)
        except queue.Empty:
            with self._lock:
                self.fires += 1
                ema = self._ema.get(label)
            waited = time.monotonic() - t0
            telemetry.registry().counter(
                "faa_watchdog_fires_total",
                "dispatch watchdog deadline expiries", label=label).inc()
            telemetry.emit("watchdog_fire", label,
                           deadline_sec=round(deadline, 3),
                           waited_sec=round(waited, 3),
                           ema_sec=None if ema is None else round(ema, 6))
            logger.error(
                "watchdog FIRED on %r: no completion after %.1fs "
                "(deadline %.1fs, ema %s) — dispatch presumed hung",
                label, waited, deadline,
                f"{ema:.3f}s" if ema is not None else "n/a")
            raise DispatchHungError(label, deadline, waited)
        if kind == "err":
            raise value
        self.observe(label, wall)
        return value

    def stats(self) -> dict:
        """Artifact-ready accounting: mode, fire count, per-label
        deadlines + EMAs (stamped into bench JSON and
        ``search_result.json`` so hangs and stragglers are
        distinguishable after the fact)."""
        with self._lock:
            labels = list(self._calls)
            ema = dict(self._ema)
            fires = self.fires
            warm = sorted(self._warm_labels)
        return {
            "mode": self.mode if isinstance(self.mode, str) else float(self.mode),
            "fires": fires,
            # deadline() re-locks per label: a concurrent observe
            # between snapshots only ever yields a FRESHER deadline
            "deadline_sec": {lb: self.deadline(lb) for lb in labels},
            "ema_sec": {lb: round(v, 6) for lb, v in ema.items()},
            "warm_labels": warm,
        }


def _sleep(delay: float) -> None:
    """Sleep `delay` seconds in bounded chunks (`inf` = sleep forever —
    the injected-hang case; chunking sidesteps time.sleep's OverflowError
    on infinite values)."""
    if not delay or delay <= 0:
        return
    remaining = float(delay)
    while remaining > 0:
        time.sleep(min(remaining, 60.0))  # inf = the deliberate injected wedge
        remaining -= 60.0


def resolve_watchdog(spec, **kwargs) -> DispatchWatchdog:
    """``--watchdog {off,auto,SECONDS}`` (or an existing instance) to a
    :class:`DispatchWatchdog`.  Passing an instance through unchanged
    lets one watchdog aggregate fire counts across the whole search."""
    if isinstance(spec, DispatchWatchdog):
        return spec
    if spec is None:
        spec = "off"
    return DispatchWatchdog(spec, **kwargs)
