"""Fault-tolerance primitives: typed failures, the preemption contract,
the circuit breaker (the port's copy of
``fast_autoaugment_tpu/core/resilience.py``).

- **typed failures**: :class:`CheckpointCorruptError` (digest/size
  mismatch or an unreadable payload, raised by ``core/checkpoint.py``),
  :class:`PreemptedError` (a shutdown request was honoured at a safe
  boundary) and :class:`DispatchHungError` (a watched dispatch blew its
  deadline, ``core/watchdog.py``); the CLIs map the last two to
  :data:`PREEMPTED_EXIT_CODE`;
- **the preemption flag**: :func:`install_signal_handlers` registers
  SIGTERM/SIGUSR1 handlers that only set a process-wide flag (on the main
  thread only, where CPython allows ``signal.signal``); the training loops
  and the search pipeline poll :func:`preemption_requested` at dispatch
  and epoch boundaries, from any thread, checkpoint with ``preempted:
  true`` and raise :class:`PreemptedError`;
- **exit 77** means "preempted and checkpointed: resume me": it lies
  outside the shell (126+) and signal (128+N) ranges;
- **circuit breaking**: :class:`CircuitBreaker`, the closed / open /
  half-open state machine, with the JAX package's telemetry names
  (``faa_breaker_fires_total``, ``faa_breaker_open``).
"""

from __future__ import annotations

import signal
import threading
import time

from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = [
    "PREEMPTED_EXIT_CODE",
    "CheckpointCorruptError",
    "CircuitBreaker",
    "CircuitOpenError",
    "DispatchHungError",
    "PreemptedError",
    "install_signal_handlers",
    "preemption_requested",
    "request_preemption",
    "clear_preemption",
]

logger = get_logger("faa_torch.resilience")

#: exit code meaning "preempted: state checkpointed, resume me"
PREEMPTED_EXIT_CODE = 77


class CheckpointCorruptError(RuntimeError):
    """A checkpoint payload failed its integrity check (digest or size
    mismatch against the ``.meta.json`` sidecar, or an unreadable /
    truncated payload).  ``load_checkpoint_chain`` treats this as "walk
    back one link"; bare ``load_checkpoint`` propagates it."""


class PreemptedError(RuntimeError):
    """A SIGTERM/SIGUSR1 shutdown request was honored at a safe
    boundary: state is checkpointed (``preempted: true`` metadata) and
    the process should exit :data:`PREEMPTED_EXIT_CODE`."""

    exit_code = PREEMPTED_EXIT_CODE


class DispatchHungError(RuntimeError):
    """A monitored device dispatch blew past its watchdog deadline
    (``core/watchdog.py``): a wedged kernel or CUDA-graph replay.  A
    launched kernel cannot be cancelled, so recovery is the
    PROCESS-restart arm of the exit-77 contract: the CLIs map this to
    :data:`PREEMPTED_EXIT_CODE` and the relaunch resumes from the
    newest intact checkpoint-chain link.  A wedged rendezvous costs one
    process restart, not the run."""

    exit_code = PREEMPTED_EXIT_CODE

    def __init__(self, label: str, deadline_sec: float, waited_sec: float):
        super().__init__(
            f"dispatch {label!r} exceeded its watchdog deadline "
            f"({waited_sec:.1f}s waited > {deadline_sec:.1f}s allowed) — "
            "treating the dispatch as hung")
        self.label = label
        self.deadline_sec = deadline_sec
        self.waited_sec = waited_sec


class CircuitOpenError(RuntimeError):
    """The circuit breaker is OPEN: the backend has failed repeatedly
    and callers fail fast instead of queueing onto it.  Carries
    ``retry_after_s`` — the seconds until the breaker next admits a
    half-open probe (the ``Retry-After`` the serving layer returns)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(0.0, float(retry_after_s))


class CircuitBreaker:
    """Closed / open / half-open failure containment.

    - **closed**: calls flow; ``threshold`` CONSECUTIVE failures open
      the circuit (one success resets the count);
    - **open**: :meth:`allow` is False for ``cooldown_s`` — callers
      fail fast with :class:`CircuitOpenError` instead of stacking onto
      a backend that is erroring or hanging;
    - **half-open**: after the cooldown exactly ONE probe call is
      admitted; its success closes the circuit, its failure re-opens it
      (a fresh cooldown, :attr:`fires` incremented again).

    ``threshold <= 0`` disables the breaker entirely (:attr:`enabled`
    False, :meth:`allow` always True) — the bit-for-bit default.
    Thread-safe: a dispatching thread calls :meth:`allow` /
    :meth:`record_success` / :meth:`record_failure` around each
    dispatch while other threads read :meth:`is_open`.
    """

    def __init__(self, threshold: int = 5, cooldown_s: float = 5.0,
                 name: str = "breaker"):
        self.name = str(name)
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.state = "closed"
        self.fires = 0  # transitions into OPEN
        self.consecutive_failures = 0
        self._opened_at: float | None = None
        self._probe_inflight = False
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def _cooldown_left(self) -> float:
        if self._opened_at is None:
            return 0.0
        return max(0.0, self.cooldown_s - (time.monotonic() - self._opened_at))

    def is_open(self) -> bool:
        """Non-mutating admission check: True while the circuit is open
        AND still cooling down (half-open probes are admitted by
        :meth:`allow`, not here)."""
        if not self.enabled:
            return False
        with self._lock:
            return self.state == "open" and self._cooldown_left() > 0.0

    def retry_after_s(self) -> float:
        """Seconds until the next half-open probe is admitted."""
        with self._lock:
            return self._cooldown_left()

    def allow(self) -> bool:
        """Whether the caller may dispatch NOW.  Consumes the single
        half-open probe slot when the cooldown has elapsed; the probe's
        record_success/record_failure releases it."""
        if not self.enabled:
            return True
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self._cooldown_left() > 0.0:
                    return False
                self.state = "half_open"
                logger.warning(
                    "circuit breaker HALF-OPEN after %.1fs cooldown — "
                    "admitting one probe", self.cooldown_s)
            # half_open: exactly one probe in flight
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            reopened = self.state != "closed"
            if reopened:
                logger.warning("circuit breaker CLOSED (probe succeeded)")
            self.state = "closed"
            self.consecutive_failures = 0
            self._opened_at = None
            self._probe_inflight = False
        if reopened:
            # scrape-visible state: 1 while OPEN, 0 when closed
            from fast_autoaugment_tpu_torch.core import telemetry

            telemetry.registry().gauge(
                "faa_breaker_open",
                "1 while the circuit breaker is OPEN, else 0",
                breaker=self.name).set(0.0)

    def record_failure(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.consecutive_failures += 1
            self._probe_inflight = False
            if self.state == "half_open" \
                    or (self.state == "closed"
                        and self.consecutive_failures >= self.threshold):
                self.state = "open"
                self.fires += 1
                self._opened_at = time.monotonic()
                fires = self.fires
                failures = self.consecutive_failures
                logger.error(
                    "circuit breaker OPEN (fire #%d, %d consecutive "
                    "failures) — failing fast for %.1fs",
                    fires, failures, self.cooldown_s)
            else:
                return
        # outside the lock: telemetry evidence for the OPEN transition
        # (core/telemetry.py — counter always, journal when armed)
        from fast_autoaugment_tpu_torch.core import telemetry

        telemetry.registry().counter(
            "faa_breaker_fires_total",
            "circuit-breaker transitions into OPEN",
            breaker=self.name).inc()
        telemetry.registry().gauge(
            "faa_breaker_open",
            "1 while the circuit breaker is OPEN, else 0",
            breaker=self.name).set(1.0)
        telemetry.emit("breaker_fire", self.name, fires=fires,
                       consecutive_failures=failures,
                       cooldown_s=self.cooldown_s)

    def snapshot(self) -> dict:
        """Artifact-ready accounting."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "state": self.state if self.enabled else "disabled",
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
                "fires": self.fires,
                "consecutive_failures": self.consecutive_failures,
                "retry_after_s": round(self._cooldown_left(), 3),
            }


# -- the preemption flag ----------------------------------------------
# A plain Event, set from the signal handler (handlers must not do I/O
# or grab locks); every reader polls it at safe boundaries.
_preempt_flag = threading.Event()


def _handler(signum, frame):  # pragma: no cover — exercised via os.kill
    # flag-only: the epoch/dispatch loop does the actual checkpoint +
    # exit at its next safe boundary
    _preempt_flag.set()


def install_signal_handlers(signals=(signal.SIGTERM, signal.SIGUSR1)) -> bool:
    """Install the flag-setting preemption handlers.  Idempotent, and a
    handler that another library put in place since is replaced again;
    returns False (and changes nothing) off the main thread, where
    CPython forbids ``signal.signal``."""
    try:
        for s in signals:
            if signal.getsignal(s) is not _handler:
                signal.signal(s, _handler)
    except ValueError:  # not the main thread — caller keeps polling a
        logger.warning(  # flag that only request_preemption() can set
            "preemption handlers not installed (not on the main thread)")
        return False
    return True


def preemption_requested() -> bool:
    """True once a shutdown signal arrived (or request_preemption ran)."""
    return _preempt_flag.is_set()


def request_preemption() -> None:
    """Set the preemption flag programmatically (tests, embedders)."""
    _preempt_flag.set()


def clear_preemption() -> None:
    """Reset the flag (a new run in the same process starts clean)."""
    _preempt_flag.clear()
