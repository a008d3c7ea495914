"""Deterministic open-loop workload generation + replay: the port's copy
of ``fast_autoaugment_tpu/gameday/workload.py``, over the port's
``serve/wire.py``.

The offered schedule is a pure function of ``(scenario, seed)``:
arrival times come from a seeded non-homogeneous Poisson thinning of
the scenario's rate curve, and every accepted request's fields (wire
lane, cohort, batch, body seed) derive from
``numpy.random.default_rng([seed, request_index])`` — so two runs of
the same ``(scenario, seed)`` offer byte-identical schedules AND
byte-identical request bodies, and :func:`schedule_digest` stamps that
identity into the verdict record.

Replay is OPEN LOOP: the driver fires requests on the schedule's
clock, not the plane's.  When the plane slows down the schedule does
not — backpressure shows up as shed responses, latency, or hangs, all
of which are the verdict engine's evidence, never as a quietly
throttled offered rate.  Requests ride the pooled keep-alive wire
client (``wire.ConnectionPool``) across the raw / npz / shm lanes.

Host-only: numpy, stdlib and the wire client; no device work.  PRNG
keys for the raw and shm lanes are built as ``[0, seed]`` uint32
pairs: the key layout the replicas take (``jax.random.PRNGKey(seed)``
for 32-bit seeds), byte for byte what the JAX package's generator
sends.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import io
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from fast_autoaugment_tpu_torch.core.telemetry import mono
from fast_autoaugment_tpu_torch.serve import wire
from fast_autoaugment_tpu_torch.utils.logging import get_logger

from .scenario import Traffic

__all__ = ["Offered", "build_schedule", "schedule_digest",
           "request_body", "WorkloadReport", "run_workload"]

logger = get_logger("faa_torch.gameday.workload")

#: statuses that count as an EXPLICIT structured rejection (shedding,
#: overload, cold tenant, bad request) — the "fast no" the plane is
#: allowed to answer under stress.  Anything else non-200 is a plane
#: bug; a transport error / timeout is a hang.
SHED_STATUSES = frozenset({400, 408, 413, 429, 503})


@dataclasses.dataclass(frozen=True)
class Offered:
    """One scheduled request (pure data, serializable)."""

    index: int
    t_s: float          # offset from scenario start, seconds
    lane: str           # raw | npz | shm
    tenant: int         # cohort index into the digest list
    batch: int
    body_seed: int      # base seed for the request's image bytes


def _per_request_rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([seed & 0x7FFFFFFF, index])


def build_schedule(traffic: Traffic, seed: int) -> list[Offered]:
    """The full offered schedule for one scenario run (deterministic).

    Arrivals: Poisson thinning at ``traffic.peak_rate`` using the
    ``[seed, 0]`` stream; accepted request ``i`` then draws its lane /
    cohort / body seed from the ``[seed, i+1]`` stream (the
    ``(scenario_seed, request_index)`` contract — request ``i``'s
    fields never depend on how many candidates were thinned away
    before it)."""
    arrivals = np.random.default_rng([seed & 0x7FFFFFFF, 0])
    peak = max(traffic.peak_rate, 1e-6)
    lanes = [name for name, _w in traffic.lanes]
    weights = np.asarray([w for _n, w in traffic.lanes], np.float64)
    weights = weights / weights.sum()
    out: list[Offered] = []
    t = 0.0
    while True:
        t += float(arrivals.exponential(1.0 / peak))
        if t >= traffic.duration_s:
            break
        if float(arrivals.uniform()) * peak > traffic.rate_at(t):
            continue  # thinned: instantaneous rate below peak
        i = len(out)
        rng = _per_request_rng(seed, i + 1)
        lane = lanes[int(rng.choice(len(lanes), p=weights))]
        if traffic.tenants > 1:
            active = int(t // max(traffic.rotate_s, 1e-9)) \
                % traffic.tenants
            if float(rng.uniform()) < 0.8:
                tenant = active  # the rotating cohort's 80% share
            else:
                tenant = int(rng.integers(0, traffic.tenants))
        else:
            tenant = 0
        out.append(Offered(
            index=i, t_s=round(t, 6), lane=lane, tenant=tenant,
            batch=int(traffic.imgs_per_request),
            body_seed=int(rng.integers(0, 2**31 - 1))))
    return out


def _canonical_rows(schedule: list[Offered]) -> list[list]:
    return [[o.index, o.t_s, o.lane, o.tenant, o.batch, o.body_seed]
            for o in schedule]


def schedule_digest(schedule: list[Offered]) -> str:
    """sha256 over the canonical schedule serialization — the byte
    identity the determinism acceptance criterion pins (bodies derive
    from the serialized seeds, so the digest covers them too)."""
    blob = json.dumps(_canonical_rows(schedule),
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def request_body(offered: Offered, image: int
                 ) -> tuple[bytes, dict, np.ndarray | None]:
    """``(body, headers, shm_images)`` for one scheduled request.

    Deterministic in ``offered`` alone.  For the shm lane the images
    come back instead of a body — the caller owns the region lifecycle
    (create / write / request / unlink), because region names are
    process-unique and must not leak into the schedule identity."""
    rng = np.random.default_rng([offered.body_seed, offered.index])
    imgs = rng.integers(0, 256, (offered.batch, image, image, 3),
                        dtype=np.uint8)
    seeds = (np.uint32(offered.body_seed & 0xFFFFFFF)
             + np.arange(offered.batch, dtype=np.uint32))
    if offered.lane == "raw":
        keys = np.stack([np.zeros_like(seeds), seeds], axis=1)
        return (wire.encode_raw(imgs, seeds=keys),
                {"Content-Type": wire.RAW_CONTENT_TYPE}, None)
    if offered.lane == "npz":
        buf = io.BytesIO()
        np.savez(buf, images=imgs, seeds=seeds.astype(np.int64))
        return (buf.getvalue(),
                {"Content-Type": "application/octet-stream"}, None)
    if offered.lane == "shm":
        keys = np.stack([np.zeros_like(seeds), seeds], axis=1)
        return b"", {"Content-Type": wire.SHM_CONTENT_TYPE,
                     "_keys": keys}, imgs.astype(np.float32)
    raise ValueError(f"unknown lane: {offered.lane!r}")


@dataclasses.dataclass
class WorkloadReport:
    """Aggregated replay evidence (one scenario run's client view)."""

    offered: int = 0
    completed: int = 0
    ok: int = 0
    shed: int = 0                 # explicit structured rejections
    unexpected_status: int = 0    # non-200 outside SHED_STATUSES
    transport_errors: int = 0     # raised / timed out = a hang
    cancelled: int = 0            # never fired: plane too far behind
    too_late: int = 0             # client slot freed > timeout_s late
    ok_by_tenant: dict = dataclasses.field(default_factory=dict)
    shed_by_status: dict = dataclasses.field(default_factory=dict)
    latencies_ok_s: list = dataclasses.field(default_factory=list)
    max_lateness_s: float = 0.0
    elapsed_s: float = 0.0
    shm_created: int = 0
    shm_leftover: list = dataclasses.field(default_factory=list)
    errors_sample: list = dataclasses.field(default_factory=list)

    def _pctile(self, q: float) -> float | None:
        if not self.latencies_ok_s:
            return None
        xs = sorted(self.latencies_ok_s)
        idx = min(len(xs) - 1, int(q * (len(xs) - 1)))
        return round(xs[idx] * 1e3, 3)

    def to_dict(self) -> dict:
        return {
            "offered": self.offered,
            "completed": self.completed,
            "ok": self.ok,
            "shed": self.shed,
            "unexpected_status": self.unexpected_status,
            "transport_errors": self.transport_errors,
            "cancelled": self.cancelled,
            "too_late": self.too_late,
            "goodput": round(self.ok / self.offered, 4)
            if self.offered else None,
            "ok_by_tenant": dict(self.ok_by_tenant),
            "shed_by_status": dict(self.shed_by_status),
            "p50_ms_ok": self._pctile(0.50),
            "p99_ms_ok": self._pctile(0.99),
            "max_lateness_s": round(self.max_lateness_s, 3),
            "elapsed_s": round(self.elapsed_s, 2),
            "offered_rps": round(self.offered / self.elapsed_s, 2)
            if self.elapsed_s else None,
            "served_rps": round(self.ok / self.elapsed_s, 2)
            if self.elapsed_s else None,
            "shm_created": self.shm_created,
            "shm_leftover": list(self.shm_leftover),
            "errors_sample": list(self.errors_sample[:5]),
        }


def _shm_leftovers(names: list[str]) -> list[str]:
    return [n for n in names
            if os.path.exists(os.path.join("/dev/shm", n))]


def _auto_concurrency(schedule: list[Offered],
                      timeout_s: float) -> int:
    """Client worker-slot budget: the densest ``timeout_s`` window of
    scheduled arrivals, with margin.  Open loop only stays open while
    every request that can legally be in flight at once has a slot —
    size it from the plane's behavior instead and a hung plane
    quietly throttles its own offered load back to whatever it can
    absorb (and then passes its verdict).  Bounded: workers are
    lazily spawned and socket-bound, but 1-core hosts still pay per
    thread."""
    times = [o.t_s for o in schedule]
    lo, densest = 0, 0
    for hi, t in enumerate(times):
        while t - times[lo] > timeout_s:
            lo += 1
        densest = max(densest, hi - lo + 1)
    return max(16, min(256, int(densest * 1.25) + 8))


def run_workload(schedule: list[Offered], host: str, port: int, *,
                 image: int, digests: list[str] | None = None,
                 timeout_s: float = 5.0, concurrency: int | None = None,
                 drain_s: float = 20.0,
                 progress_cb=None, progress_every_s: float = 2.0
                 ) -> WorkloadReport:
    """Replay ``schedule`` against ``host:port`` open loop.

    ``digests`` maps cohort index -> policy digest header (cohort 0
    with no digest list rides headerless on the replica's default
    tenant).  ``progress_cb(offered, completed, ok)`` fires about
    every ``progress_every_s`` from the dispatcher thread — the hook
    the runner uses to journal rolling ``scenario`` progress events.

    The drain is BOUNDED: ``drain_s`` after the last scheduled arrival
    the driver cancels every request that has not even started and
    counts it as hung (``transport_errors``) — a plane so far behind
    that the harness gives up IS a hang, and an unbounded drain would
    let a broken plane stall the verdict instead of failing it.
    """
    if concurrency is None:
        concurrency = _auto_concurrency(schedule, timeout_s)
    pool = wire.ConnectionPool(timeout_s=timeout_s,
                               max_idle_per_key=concurrency)
    report = WorkloadReport(offered=len(schedule))
    lock = threading.Lock()
    shm_names: list[str] = []

    def _fire(offered: Offered, t_sched_mono: float) -> None:
        lateness = max(0.0, mono() - t_sched_mono)
        if lateness > timeout_s:
            # the worker slot for this request only freed up after the
            # request's own timeout budget: every client slot was stuck
            # waiting on the plane.  Firing it late would quietly turn
            # the open loop into a closed loop (a hung plane throttling
            # its own offered load back to whatever it can absorb), so
            # it counts as a hang instead — the evidence the
            # shed_not_hang predicate exists to catch.
            with lock:
                report.completed += 1
                report.too_late += 1
                report.transport_errors += 1
                report.max_lateness_s = max(report.max_lateness_s,
                                            lateness)
                if len(report.errors_sample) < 16:
                    report.errors_sample.append(
                        f"gave up: client slot freed {lateness:.1f}s "
                        f"after schedule (plane hanging)")
            return
        body, headers, shm_imgs = request_body(offered, image)
        headers = dict(headers)
        keys = headers.pop("_keys", None)
        if digests and offered.tenant < len(digests) \
                and digests[offered.tenant]:
            headers["X-FAA-Policy-Digest"] = digests[offered.tenant]
        region = None
        status, err = None, None
        t0 = mono()
        try:
            if shm_imgs is not None:
                region = wire.ShmRegion(shm_imgs.shape, np.float32)
                with lock:
                    shm_names.append(region.name)
                    report.shm_created += 1
                region.write(shm_imgs)
                body = region.request_body(seeds=keys)
            status, _h, _payload = pool.request(
                host, port, "POST", "/augment", body, headers)
        except OSError as e:
            err = f"{type(e).__name__}: {e}"
        finally:
            if region is not None:
                region.close()
        latency = mono() - t0
        with lock:
            report.completed += 1
            report.max_lateness_s = max(report.max_lateness_s, lateness)
            if err is not None:
                report.transport_errors += 1
                if len(report.errors_sample) < 16:
                    report.errors_sample.append(err)
            elif status == 200:
                report.ok += 1
                report.latencies_ok_s.append(latency)
                key = str(offered.tenant)
                report.ok_by_tenant[key] = \
                    report.ok_by_tenant.get(key, 0) + 1
            elif status in SHED_STATUSES:
                report.shed += 1
                key = str(status)
                report.shed_by_status[key] = \
                    report.shed_by_status.get(key, 0) + 1
            else:
                report.unexpected_status += 1
                if len(report.errors_sample) < 16:
                    report.errors_sample.append(f"status {status}")

    t_start = mono()
    next_progress = t_start + progress_every_s
    pacer = threading.Event()
    futures = []
    ex = ThreadPoolExecutor(max_workers=concurrency)
    for offered in schedule:
        t_sched = t_start + offered.t_s
        while True:
            now = mono()
            if now >= t_sched:
                break
            # short sleeps keep the dispatcher responsive to the
            # progress cadence without busy-waiting
            pacer.wait(min(0.05, t_sched - now))
        futures.append(ex.submit(_fire, offered, t_sched))
        if progress_cb is not None and mono() >= next_progress:
            next_progress = mono() + progress_every_s
            with lock:
                progress_cb(offered.index + 1, report.completed,
                            report.ok)
    concurrent.futures.wait(futures, timeout=drain_s)
    n_cancelled = sum(1 for f in futures if f.cancel())
    if n_cancelled:
        with lock:
            report.cancelled = n_cancelled
            report.transport_errors += n_cancelled
            if len(report.errors_sample) < 16:
                report.errors_sample.append(
                    f"cancelled: {n_cancelled} requests never started "
                    f"within drain_s={drain_s}")
    # in-flight stragglers are each bounded by the socket timeout —
    # wait them out so the shm-leftover census below is not racing a
    # live worker that still owns a region
    concurrent.futures.wait(futures, timeout=timeout_s + 5.0)
    ex.shutdown(wait=False)
    report.elapsed_s = max(mono() - t_start, 1e-9)
    pool.close_all()
    report.shm_leftover = _shm_leftovers(shm_names)
    if progress_cb is not None:
        progress_cb(report.offered, report.completed, report.ok)
    return report
