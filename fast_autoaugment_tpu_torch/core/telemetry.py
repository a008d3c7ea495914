"""Telemetry: metrics registry, span seam, flight-recorder journal (the
port's copy of ``fast_autoaugment_tpu/core/telemetry.py``).

1. **Metrics registry** (:class:`MetricsRegistry`, process-wide
   :func:`registry`): thread-safe counters, gauges and fixed-bucket
   histograms with the JAX package's Prometheus names, label sets and
   bucket schemas; :meth:`MetricsRegistry.prometheus_text` is the text
   exposition behind ``GET /metrics`` (:func:`start_metrics_server`, the
   CLIs' ``--telemetry-port``).  Always on: in-memory numbers only.
2. **Span seam** (:func:`span` / :func:`record_dispatch`): one way to
   time a dispatch window.  The trainer's dispatches, the eval replays and
   the TTA/audit evaluations all route here: the registry gets a
   ``faa_dispatch_seconds`` observation, the journal (when armed) a typed
   ``dispatch`` event, and the search pipeline's ``DispatchTrace`` the same
   ``(t0, t1)`` window.  :func:`phase_event` records a phase window.
3. **Flight-recorder journal** (:class:`FlightRecorder`): an append-only
   JSONL stream of typed events (:data:`EVENT_TYPES`) with both clocks,
   host/attempt identity (``FAA_HOST_ID``/``FAA_ATTEMPT``), pid/tid and
   segment rotation; armed by ``--telemetry DIR`` or ``FAA_TELEMETRY``
   (:func:`configure_telemetry`), flushed every 0.25 s and by
   :func:`journal_flush`.  Off (the default) :func:`emit` is a None check.
   Its TensorBoard bridge writes every numeric field of a non-dispatch
   event as a scalar curve under ``<dir>/tb/`` (``utils/tb_events.py``).

Records are those of the JAX package field for field; :func:`wall` takes
the ``FAA_FSFAULT`` skew (``core/fsfault.py``).
"""

from __future__ import annotations

import bisect
import json
import os
import re
import threading
import time

from fast_autoaugment_tpu_torch.core import fsfault
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = [
    "ENV_VAR",
    "EVENT_TYPES",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "FlightRecorder",
    "registry",
    "wall",
    "mono",
    "span",
    "record_dispatch",
    "emit",
    "resolve_telemetry",
    "configure_telemetry",
    "enable_telemetry",
    "telemetry_dir",
    "journal_active",
    "journal_flush",
    "start_metrics_server",
]

logger = get_logger("faa_torch.telemetry")

#: env handoff, mirroring FAA_COMPILE_CACHE: the CLIs export the
#: resolved journal dir so fleet-launched hosts, exit-77 relaunches and
#: subprocess drills inherit the shared telemetry dir without flags
ENV_VAR = "FAA_TELEMETRY"

#: the journal's closed event taxonomy (docs/OBSERVABILITY.md) — a typo
#: in an event type must fail loudly, not fork a private schema
EVENT_TYPES = frozenset({
    "dispatch",       # one device dispatch window (the span seam)
    "compile",        # a first-call compile/lowering through the seam
    "checkpoint",     # save/load/corrupt on the checkpoint chain
    "lease",          # workqueue claim/renew-lost/reclaim/release
    "trial",          # one phase-2 trial told to the TPE
    "shed",           # serving admission/deadline/overload shed
    "breaker_fire",   # a circuit breaker transitioned to OPEN
    "watchdog_fire",  # a dispatch watchdog deadline expired
    "reload",         # serving hot policy reload
    "preempt",        # a preemption/hang was honored (exit-77 path)
    "phase",          # a phase window (phase-1 fold train, phase-2 fold)
    "mark",           # free-form marker (tools, tests)
    "round",          # fleet-search round transport: publish/claim/return/apply
    "rotation",       # a router ejected / re-admitted a serving replica
    "tenant",         # multi-policy tenancy admit/evict/warm (serve LRU)
    "scale_up",       # autoscaler grew the replica fleet (evidence inline)
    "scale_down",     # autoscaler shrank the replica fleet
    # closed-loop control plane (control/, docs/CONTROL.md): the four
    # stage transitions of the drift->promote loop, each carrying its
    # metric evidence inline exactly like the autoscaler's decisions
    "drift",          # a seeded statistical test tripped on served traffic
    "research",       # a warm-started top-up search produced a candidate
    "canary",         # canary rollout start/verify on a replica subset
    "promote",        # the delta gate promoted the candidate fleet-wide
    "rollback",       # the delta gate rolled the canary subset back
    "fsfault",        # the FAA_FSFAULT seam injected a shared-FS fault
    # trace-driven game days (gameday/, docs/GAMEDAYS.md): the scenario
    # runner's lifecycle marks and the verdict engine's rows, each
    # carrying its evidence inline like the decision events above
    "scenario",       # game-day lifecycle: start/progress/phase/end
    "verdict",        # one verdict predicate's pass/fail + evidence
})


# --------------------------------------------------------------------------
# clock seam — the one place train/search/serve hot paths read clocks
# (lint R8).  Wall time anchors cross-host comparison; monotonic time
# anchors durations (immune to NTP steps).
# --------------------------------------------------------------------------


def wall() -> float:
    """Wall-clock seconds (``time.time``): anchors cross-host comparison.

    The ``FAA_FSFAULT skew@host=H,offset=S`` verb lands here: a matched
    host sees (and stamps) wall time offset by S seconds
    (``core/fsfault.py``).  Unset, the consult is one cached None check."""
    t = time.time()
    plan = fsfault.active_plan()
    return t + plan.wall_offset if plan is not None else t


def mono() -> float:
    """Monotonic seconds (``time.perf_counter``): anchors durations."""
    return time.perf_counter()


# --------------------------------------------------------------------------
# metrics registry
# --------------------------------------------------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default latency buckets (seconds) — one fixed schema shared by every
#: dispatch-shaped histogram so cross-run artifacts stay comparable
DEFAULT_BUCKETS_SEC = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                       30.0, 120.0)


class Counter:
    """Monotonically non-decreasing counter (thread-safe)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge:
    """Last-writer-wins instantaneous value (thread-safe)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Fixed-bucket histogram (cumulative-on-read, Prometheus-style).

    The bucket schema is FIXED at first registration — a second
    registration of the same name with different buckets raises, so one
    metric can never carry two incomparable schemas across the repo.
    """

    __slots__ = ("name", "labels", "buckets", "_counts", "_sum", "_count",
                 "_lock")

    def __init__(self, name: str, labels: tuple, buckets: tuple):
        self.name = name
        self.labels = labels
        self.buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)  # C-speed bucket pick
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum = 0
        buckets = {}
        for edge, c in zip(self.buckets, counts):
            cum += c
            buckets[f"{edge:g}"] = cum
        buckets["+Inf"] = total
        return {"count": total, "sum": round(s, 6), "buckets": buckets}

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0


def _label_key(labels: dict) -> tuple:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


class MetricsRegistry:
    """Process-wide metric store: get-or-create counters/gauges/
    histograms keyed by ``(name, labels)``.

    One name has exactly ONE kind (and, for histograms, one bucket
    schema) — re-registering with a conflicting kind/schema raises.
    ``snapshot()`` is the artifact-stamp view; ``prometheus_text()`` is
    the scrape view (text exposition format 0.0.4).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # name -> ("counter"|"gauge"|"histogram", help, buckets|None)
        self._meta: dict[str, tuple] = {}
        # (name, label_key) -> metric object
        self._metrics: dict[tuple, object] = {}

    def _get(self, kind: str, name: str, help: str, labels: dict,
             buckets: tuple | None = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        lk = _label_key(labels)
        with self._lock:
            meta = self._meta.get(name)
            if meta is None:
                self._meta[name] = (kind, help, buckets)
            else:
                if meta[0] != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {meta[0]}, "
                        f"not {kind}")
                if kind == "histogram" and meta[2] != buckets:
                    raise ValueError(
                        f"histogram {name!r} has a fixed bucket schema "
                        f"{meta[2]}; cannot re-register with {buckets}")
            key = (name, lk)
            m = self._metrics.get(key)
            if m is None:
                if kind == "counter":
                    m = Counter(name, lk)
                elif kind == "gauge":
                    m = Gauge(name, lk)
                else:
                    m = Histogram(name, lk, buckets)
                self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS_SEC,
                  **labels) -> Histogram:
        return self._get("histogram", name, help, labels,
                         buckets=tuple(float(b) for b in buckets))

    # ------------------------------------------------------------ views

    def snapshot(self) -> dict:
        """Artifact-stamp view: plain nested dicts, keys
        ``name{label="v",...}`` (sorted), JSON-ready."""
        with self._lock:
            items = sorted(self._metrics.items())
            meta = dict(self._meta)
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, lk), m in items:
            key = f"{name}{_render_labels(lk)}"
            kind = meta[name][0]
            if kind == "counter":
                out["counters"][key] = m.value
            elif kind == "gauge":
                out["gauges"][key] = round(m.value, 6)
            else:
                out["histograms"][key] = m.snapshot()
        return out

    def counters_snapshot(self) -> dict[str, float]:
        """Flat ``{name{labels}: value}`` of the counters only — the
        compact block the unified bench stamp carries."""
        return dict(self.snapshot()["counters"])

    def prometheus_text(self) -> str:
        """Text exposition (format 0.0.4): ``# HELP``/``# TYPE`` per
        family, one sample line per child, histogram ``_bucket``/
        ``_sum``/``_count`` expansion."""
        with self._lock:
            items = sorted(self._metrics.items())
            meta = dict(self._meta)
        lines: list[str] = []
        seen_head: set[str] = set()
        for (name, lk), m in items:
            kind, help, _buckets = meta[name]
            if name not in seen_head:
                seen_head.add(name)
                if help:
                    lines.append(f"# HELP {name} {help}")
                lines.append(f"# TYPE {name} {kind}")
            if kind in ("counter", "gauge"):
                lines.append(f"{name}{_render_labels(lk)} {m.value:g}")
            else:
                snap = m.snapshot()
                for le, cum in snap["buckets"].items():
                    blabels = _render_labels(lk + (("le", le),))
                    lines.append(f"{name}_bucket{blabels} {cum}")
                lbl = _render_labels(lk)
                lines.append(f"{name}_sum{lbl} {snap['sum']:g}")
                lines.append(f"{name}_count{lbl} {snap['count']}")
        return "\n".join(lines) + "\n"

    def _reset_for_tests(self) -> None:
        """Zero every metric (registrations survive) — test isolation."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()


#: THE process-wide registry (tests may build private ones)
_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


# --------------------------------------------------------------------------
# flight-recorder journal
# --------------------------------------------------------------------------

#: rotation defaults: 4 MiB x 8 segments = ≤32 MiB per process chain —
#: a bounded flight recorder, not an unbounded log
DEFAULT_SEGMENT_BYTES = 4 * 1024 * 1024
DEFAULT_MAX_SEGMENTS = 8
#: flush cadence: events reach disk within this bound (plus the stdio
#: buffer's own overflow flushes).  Flushing per event costs a syscall
#: per dispatch — measured at ~2x the whole emit path — and the
#: flight-recorder contract only needs BOUNDED staleness: a killed
#: process loses at most this window's tail
DEFAULT_FLUSH_INTERVAL_SEC = 0.25
#: per-label journal budget for ``dispatch`` events: above this rate
#: individual slices are suppressed (counted in
#: ``faa_dispatch_events_suppressed_total``) — a serialized JSONL line
#: costs ~10 µs of Python, which a kHz dispatch loop cannot afford, and
#: sub-millisecond slices past ~50/s carry no timeline information a
#: human or Perfetto can use anyway.  The REGISTRY still observes EVERY
#: dispatch (counts and latency percentiles stay exact); only the
#: journal's slice stream is rate-bounded.  <= 0 disables the bound.
DEFAULT_DISPATCH_EVENTS_PER_SEC = 50.0


class FlightRecorder:
    """Append-only JSONL journal with segment rotation.

    One recorder per process writes
    ``journal-<host>-a<attempt>-p<pid>.<seg>.jsonl`` under `directory`;
    when a segment exceeds ``max_segment_bytes`` a new one opens and
    segments beyond ``max_segments`` are deleted oldest-first (the
    flight-recorder bound — recent evidence survives, ancient evidence
    ages out).  Every record carries the event type, label, BOTH clocks
    (``t_wall``/``t_mono`` at emit — their difference aligns monotonic
    spans onto the wall clock per process), host/attempt identity and
    pid/tid/thread name (the Chrome-trace lanes).  Writes are
    lock-serialized and flushed at least every ``flush_interval_s``
    (per-event flushing costs a syscall per dispatch — the measured
    bulk of the emit path), so a killed process loses at most the last
    interval's tail; :meth:`flush` forces the buffer out for readers.
    """

    def __init__(self, directory: str, *,
                 max_segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 max_segments: int = DEFAULT_MAX_SEGMENTS,
                 flush_interval_s: float = DEFAULT_FLUSH_INTERVAL_SEC,
                 dispatch_events_per_sec: float =
                 DEFAULT_DISPATCH_EVENTS_PER_SEC,
                 host: str | None = None, attempt: int | None = None):
        os.makedirs(directory, exist_ok=True)
        self.directory = os.path.abspath(directory)
        self.host = host or f"host{os.environ.get('FAA_HOST_ID', '0')}"
        self.attempt = int(attempt if attempt is not None
                           else os.environ.get("FAA_ATTEMPT", "1") or 1)
        self.max_segment_bytes = int(max_segment_bytes)
        self.max_segments = max(1, int(max_segments))
        self.flush_interval_s = float(flush_interval_s)
        self._last_flush = time.monotonic()
        self.dispatch_events_per_sec = float(dispatch_events_per_sec)
        # per-label 1 s rate window [window_start, count]; racy updates
        # only ever over/under-journal a slice or two — the registry
        # histogram, not the journal, is the exact record
        self._rate: dict[str, list] = {}
        self._prefix = os.path.join(
            self.directory,
            f"journal-{self.host}-a{self.attempt}-p{os.getpid()}")
        self._lock = threading.Lock()
        self._seq = 0
        # serialization fast path: the identity fields are constant per
        # recorder (and per thread), so they are pre-encoded once — the
        # per-event work is two clock reads plus encoding the caller's
        # payload fields (measured: this halves the span-seam cost)
        self._ident_json = (
            f'"host":{json.dumps(self.host)},"attempt":{self.attempt},'
            f'"pid":{os.getpid()}')
        self._thread_local = threading.local()
        self._label_cache: dict[str, str] = {}
        self._seg = 0
        self._segments: list[str] = []
        self._fh = None
        self._bytes = 0
        self._open_segment()
        # TB bridge (utils/tb_events.py): numeric event fields double as
        # TensorBoard scalar curves for free — <dir>/tb/events.out...
        self._tb = None
        try:
            from fast_autoaugment_tpu_torch.utils.tb_events import TBEventWriter

            self._tb = TBEventWriter(os.path.join(self.directory, "tb"),
                                     f"{self.host}.a{self.attempt}")
        except OSError as e:
            logger.warning("telemetry TB bridge disabled: %s", e)

    # ------------------------------------------------------- internals

    def _open_segment(self) -> None:
        path = f"{self._prefix}.{self._seg:03d}.jsonl"
        self._fh = open(path, "a")
        self._segments.append(path)
        self._bytes = 0
        while len(self._segments) > self.max_segments:
            old = self._segments.pop(0)
            try:
                os.remove(old)
            except OSError as e:
                logger.warning("journal rotation: could not drop %s (%s)",
                               old, e)

    def _rotate_locked(self) -> None:
        self._fh.close()
        self._seg += 1
        self._open_segment()

    # ------------------------------------------------------------- API

    @property
    def segments(self) -> list[str]:
        with self._lock:
            return list(self._segments)

    #: record keys callers may not shadow through **fields
    _RESERVED = frozenset({"type", "label", "t_wall", "t_mono", "host",
                           "attempt", "pid", "tid", "thread", "seq"})
    #: one shared encoder: ``json.dumps(..., default=...)`` builds a
    #: fresh JSONEncoder per call — measurable at span-seam frequency
    _ENCODER = json.JSONEncoder(separators=(",", ":"), default=str)

    def _thread_ident(self) -> str:
        ident = getattr(self._thread_local, "ident", None)
        if ident is None:
            th = threading.current_thread()
            ident = (f'"tid":{threading.get_native_id()},'
                     f'"thread":{json.dumps(th.name)}')
            self._thread_local.ident = ident
        return ident

    def _label_json(self, label) -> str:
        s = self._label_cache.get(label)
        if s is None:
            s = json.dumps(label)
            if len(self._label_cache) < 4096:  # labels are low-cardinality
                self._label_cache[label] = s
        return s

    def emit(self, etype: str, label: str | None = None, **fields) -> None:
        """Append one typed event.  Unknown event types raise — the
        taxonomy (:data:`EVENT_TYPES`) is closed by design."""
        if etype not in EVENT_TYPES:
            raise ValueError(
                f"unknown telemetry event type {etype!r} — the taxonomy "
                f"is {sorted(EVENT_TYPES)} (docs/OBSERVABILITY.md)")
        tw = time.time()
        tm = time.perf_counter()
        if fields:
            if not self._RESERVED.isdisjoint(fields):
                raise ValueError(
                    f"event fields may not shadow the record schema: "
                    f"{sorted(self._RESERVED & set(fields))}")
            payload = "," + self._ENCODER.encode(fields)[1:-1]
        else:
            payload = ""
        head = (f'{{"type":"{etype}","label":{self._label_json(label)},'
                f'"t_wall":{tw!r},"t_mono":{tm!r},{self._ident_json},'
                f'{self._thread_ident()}')
        with self._lock:
            seq = self._seq
            self._seq += 1
            line = f'{head},"seq":{seq}{payload}}}\n'
            self._fh.write(line)
            self._bytes += len(line)
            now = time.monotonic()
            if now - self._last_flush >= self.flush_interval_s:
                self._fh.flush()
                self._last_flush = now
            if self._bytes >= self.max_segment_bytes:
                self._rotate_locked()
        if self._tb is not None and etype not in self._TB_SKIP_TYPES \
                and fields:
            self._tb_scalars({"type": etype, "label": label, "seq": seq,
                              **fields})

    _TB_SKIP = frozenset({"t_wall", "t_mono", "seq", "pid", "tid",
                          "attempt", "t_mono_start", "t_mono_end", "step"})
    #: high-frequency event types the TB bridge skips: dispatch windows
    #: fire per device dispatch (kHz on small programs) and already
    #: live in the faa_dispatch_seconds histogram + the Chrome trace —
    #: a per-dispatch TB scalar write would dominate the span seam cost
    _TB_SKIP_TYPES = frozenset({"dispatch"})

    def _tb_scalars(self, rec: dict) -> None:
        if self._tb is None or rec["type"] in self._TB_SKIP_TYPES:
            return
        step = rec.get("step")
        step = int(step) if isinstance(step, (int, float)) and step >= 0 \
            else rec["seq"]
        tag_base = f"{rec['type']}/{rec.get('label') or 'event'}"
        for k, v in rec.items():
            if k in self._TB_SKIP or k in ("type", "label", "host",
                                           "thread"):
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            try:
                self._tb.add_scalar(f"{tag_base}/{k}", v, step)
            except (OSError, ValueError) as e:
                logger.warning("telemetry TB bridge write failed: %s", e)
                return

    def allow_dispatch_event(self, label: str) -> bool:
        """Token check for one ``dispatch`` journal slice: True while
        `label` is under its per-second budget."""
        budget = self.dispatch_events_per_sec
        if budget <= 0:
            return True
        now = time.monotonic()
        st = self._rate.get(label)
        if st is None or now - st[0] >= 1.0:
            self._rate[label] = [now, 1]
            return True
        if st[1] < budget:
            st[1] += 1
            return True
        return False

    def flush(self) -> None:
        """Force buffered events to disk (readers: faa_status and the
        tests call this via :func:`journal_flush`)."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._last_flush = time.monotonic()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


# --------------------------------------------------------------------------
# process-wide journal configuration (mirrors core/compilecache.py)
# --------------------------------------------------------------------------

_state_lock = threading.Lock()
_recorder: FlightRecorder | None = None


def resolve_telemetry(spec: str | None = None) -> str | None:
    """``--telemetry {off,DIR}`` (or None) -> journal dir or None.
    Unset/``off`` falls back to the :data:`ENV_VAR` handoff — how fleet
    hosts and exit-77 relaunches inherit the shared dir."""
    spec = ("" if spec is None else str(spec)).strip()
    if spec.lower() in ("", "off"):
        env = os.environ.get(ENV_VAR, "").strip()
        if env.lower() in ("", "off"):
            return None
        return env
    return spec


def enable_telemetry(directory: str, **recorder_kw) -> str:
    """Arm the process journal at `directory` (idempotent; re-enabling
    with a different dir closes the old recorder) and export
    :data:`ENV_VAR` for child processes."""
    global _recorder
    directory = os.path.abspath(directory)
    with _state_lock:
        if _recorder is not None and _recorder.directory == directory:
            return directory
        old, _recorder = _recorder, None
    if old is not None:
        logger.warning("telemetry journal re-pointed %s -> %s",
                       old.directory, directory)
        old.close()
    rec = FlightRecorder(directory, **recorder_kw)
    with _state_lock:
        _recorder = rec
    os.environ[ENV_VAR] = directory
    logger.info("telemetry journal enabled at %s (host=%s attempt=%d)",
                directory, rec.host, rec.attempt)
    return directory


def configure_telemetry(spec: str | None = None, **recorder_kw) -> str | None:
    """Resolve `spec` (flag value; None = env only) and arm the journal
    when it names a directory.  Returns the active dir or None."""
    directory = resolve_telemetry(spec)
    if directory:
        return enable_telemetry(directory, **recorder_kw)
    return None


def telemetry_dir() -> str | None:
    with _state_lock:
        return None if _recorder is None else _recorder.directory


def journal_active() -> bool:
    return _recorder is not None


def emit(etype: str, label: str | None = None, **fields) -> None:
    """Emit one journal event — a cheap no-op while the journal is off
    (the defaults-off hot-path cost is this None check)."""
    rec = _recorder
    if rec is None:
        return
    try:
        rec.emit(etype, label, **fields)
    except ValueError:
        raise  # taxonomy violations are caller bugs — never swallowed
    except OSError as e:
        logger.warning("telemetry emit failed (%s) — event dropped", e)


def journal_flush() -> None:
    """Flush the process journal's buffered events (no-op when off)."""
    rec = _recorder
    if rec is not None:
        rec.flush()


def _disable_for_tests() -> None:
    """Close and detach the journal (env side too) — test isolation."""
    global _recorder
    with _state_lock:
        rec, _recorder = _recorder, None
    if rec is not None:
        rec.close()
    os.environ.pop(ENV_VAR, None)


# --------------------------------------------------------------------------
# the span seam
# --------------------------------------------------------------------------


class _DispatchMeter:
    """One-lock fast path for the span seam's per-label registry
    update.  The seam runs once per device dispatch; the generic
    counter+histogram route costs four function calls and three lock
    acquisitions per window, which measurably taxes sub-millisecond
    dispatches — this object updates the SAME registry-visible metrics
    (``faa_dispatches_total`` / ``faa_dispatch_seconds`` /
    ``faa_dispatch_events_suppressed_total``) behind one lock."""

    __slots__ = ("counter", "hist", "suppressed")

    def __init__(self, label: str):
        self.counter = _REGISTRY.counter(
            "faa_dispatches_total",
            "device dispatches through the span seam", label=label)
        self.hist = _REGISTRY.histogram(
            "faa_dispatch_seconds",
            "per-dispatch wall seconds through the span seam",
            label=label)
        self.suppressed = _REGISTRY.counter(
            "faa_dispatch_events_suppressed_total",
            "journal dispatch slices suppressed by the per-label "
            "rate budget (the registry still observed them)",
            label=label)

    def observe(self, dur: float) -> None:
        h = self.hist
        i = bisect.bisect_left(h.buckets, dur)
        with h._lock:
            h._counts[i] += 1
            h._sum += dur
            h._count += 1
        c = self.counter
        with c._lock:
            c._value += 1.0


_DISPATCH_METRICS: dict[str, _DispatchMeter] = {}


def _dispatch_metrics(label: str) -> _DispatchMeter:
    m = _DISPATCH_METRICS.get(label)
    if m is None:
        m = _DispatchMeter(label)
        _DISPATCH_METRICS[label] = m
    return m


def record_dispatch(label: str, t0_mono: float, t1_mono: float, *,
                    etype: str = "dispatch", **fields) -> None:
    """Record one dispatch window: registry histogram + counter always,
    journal event when armed (rate-bounded per label).  `t0_mono`/
    `t1_mono` are :func:`mono` stamps; the journal record's own
    ``t_wall``/``t_mono`` pair (taken at emit) aligns them onto the
    wall clock for cross-host views."""
    dur = t1_mono - t0_mono
    if dur < 0.0:
        dur = 0.0
    meter = _DISPATCH_METRICS.get(label)
    if meter is None:
        meter = _dispatch_metrics(label)
    meter.observe(dur)
    rec = _recorder
    if rec is not None:
        if rec.allow_dispatch_event(label):
            emit(etype, label, t_mono_start=t0_mono, t_mono_end=t1_mono,
                 dur_sec=round(dur, 9), **fields)
        else:
            meter.suppressed.inc()


class _Span:
    """Class-based context manager (a generator CM costs ~3x more per
    entry, and the span seam runs once per device dispatch)."""

    __slots__ = ("label", "etype", "trace", "fields", "t0")

    def __init__(self, label, etype, trace, fields):
        self.label = label
        self.etype = etype
        self.trace = trace
        self.fields = fields

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self.trace is not None:
            self.trace(self.t0, t1)
        record_dispatch(self.label, self.t0, t1, etype=self.etype,
                        **self.fields)
        return False


def span(label: str, *, etype: str = "dispatch", trace=None, **fields):
    """Time one dispatch window through the seam (a ``with`` context).

    `trace` (optional ``(t0, t1)`` callable) keeps feeding the async
    pipeline's :class:`~fast_autoaugment_tpu_torch.search.pipeline.
    DispatchTrace` the exact windows it always consumed — the span seam
    GENERALIZES that recorder instead of replacing it."""
    return _Span(label, etype, trace, fields)


def phase_event(label: str, t0_mono: float, t1_mono: float,
                **fields) -> None:
    """One phase window (``phase`` event + ``faa_phase_seconds_total``
    counter) — the overlap-timeline lanes in the trace export."""
    dur = max(0.0, float(t1_mono) - float(t0_mono))
    _REGISTRY.counter("faa_phase_seconds_total",
                      "cumulative wall seconds per phase",
                      label=label).inc(dur)
    if _recorder is not None:
        emit("phase", label, t_mono_start=float(t0_mono),
             t_mono_end=float(t1_mono), dur_sec=round(dur, 9), **fields)


# --------------------------------------------------------------------------
# Prometheus exposition server (train/search CLIs' --telemetry-port)
# --------------------------------------------------------------------------

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def start_metrics_server(port: int, host: str = "127.0.0.1"):
    """Serve ``GET /metrics`` (read-only registry exposition) on a
    daemon thread.  Returns ``(httpd, bound_port)`` — pass port 0 to
    bind an ephemeral port."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _MetricsHandler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("metrics http: " + fmt, *args)

        def do_GET(self):
            if self.path in ("/metrics", "/"):
                body = _REGISTRY.prometheus_text().encode()
                ctype = PROMETHEUS_CONTENT_TYPE
                code = 200
            elif self.path == "/healthz":
                body = b'{"ok": true}'
                ctype = "application/json"
                code = 200
            else:
                body = b'{"error": "unknown path"}'
                ctype = "application/json"
                code = 404
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    class _Server(ThreadingHTTPServer):
        daemon_threads = True

    httpd = _Server((host, int(port)), _MetricsHandler)
    th = threading.Thread(target=httpd.serve_forever, daemon=True,
                          name="telemetry-metrics")
    th.start()
    bound = httpd.server_address[1]
    logger.info("telemetry /metrics listening on http://%s:%d", host, bound)
    return httpd, bound
