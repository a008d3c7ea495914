"""The serving front door: policy-digest-affinity routing over a
replica fleet.

The port's copy of ``fast_autoaugment_tpu/serve/router.py``: many
policies across many ``serve_cli`` replicas behind ONE address.  The
router is host-only (it imports no torch): it never touches a device,
it decides WHERE device work lands.

Three mechanisms:

- **Replica discovery** (:func:`discover_replicas`): replicas announce
  themselves by writing ``<tag>.json`` records into a shared
  ``--port-dir`` (``serve_cli --port-dir``, the ``--port-file``
  contract generalized), so supervised replica fleets need no static
  port plan — a relaunched replica atomically
  overwrites its record, a drained one removes it.  Static
  ``host:port`` lists are supported for fixed topologies.

- **Digest-affinity routing** (:func:`rendezvous_order`): requests
  carrying ``X-FAA-Policy-Digest`` are routed by RENDEZVOUS (highest-
  random-weight) hashing digest -> replica, so each policy's traffic
  concentrates on the replica(s) already holding that tenant AOT-warm.
  Rendezvous hashing is minimally disruptive by construction: a
  replica joining or leaving moves ONLY the keys that hash to it —
  every other digest keeps its primary, and its tenant stays warm.
  Digest-less requests round-robin across the rotation.

- **Health-aware rotation + bounded failover**: a poll loop probes
  each replica's ``/readyz`` (the readiness surface: draining or
  breaker-open replicas answer 503 while ``/healthz`` stays 200);
  ``eject_after`` consecutive failures remove a replica from rotation,
  ``readmit_after`` consecutive successes re-admit it — hysteresis, so
  a flapping backend does not oscillate per poll.  Each transition is
  a typed ``rotation`` journal event.  Per request, the router tries
  at most ``1 + failover_attempts`` candidates in rendezvous order; an
  upstream 429/503 marks the replica BACKING OFF for its
  ``Retry-After`` (new traffic routes around it until the window
  passes) and fails over; when every candidate is exhausted the last
  upstream answer (Retry-After included) passes through to the client.

The ``FAA_FAULT`` verbs ``replica_down@request=N`` and
``readyz_flap@period=P`` are consulted at the health-poll seam
(``utils/faultinject.py``) so rotation ejection, failover and
degraded-goodput behavior are all deterministically drillable without
killing real processes.
"""

from __future__ import annotations

import errno
import hashlib
import http.client
import json
import os
import threading

from fast_autoaugment_tpu_torch.core import fsfault, telemetry
from fast_autoaugment_tpu_torch.core.telemetry import mono, wall
from fast_autoaugment_tpu_torch.serve import wire
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["Replica", "Router", "BatchForwarder", "rendezvous_order",
           "discover_replicas", "parse_static_replicas"]

logger = get_logger("faa_torch.router")

#: headers the router forwards verbatim to the chosen replica (the
#: deadline-passthrough + tenancy contract); everything else is
#: hop-local
FORWARD_HEADERS = ("X-FAA-Deadline-Ms", "X-FAA-Policy-Digest",
                   "Content-Type")


def rendezvous_order(digest: str, replica_ids: list[str]) -> list[str]:
    """Replica ids ranked by rendezvous (HRW) weight for `digest`.

    ``sha256(digest | replica_id)`` scores each pair; the ranking is a
    pure function of the (digest, id) pairs, so every router instance
    agrees, and a join/leave reshuffles ONLY the keys scored highest on
    the joined/left replica — warm tenants elsewhere stay put."""
    scored = sorted(
        replica_ids,
        key=lambda rid: hashlib.sha256(
            f"{digest}|{rid}".encode()).digest(),
        reverse=True)
    return scored


def parse_static_replicas(spec: str) -> list[dict]:
    """``host:port,host:port`` -> replica records (static topologies)."""
    out = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad replica spec {part!r}: want host:port")
        out.append({"tag": part, "host": host, "port": int(port)})
    return out


def discover_replicas(port_dir: str) -> list[dict] | None:
    """Read every ``<tag>.json`` replica record under `port_dir`
    (written by ``serve_cli --port-dir``).  Unreadable / torn records
    are skipped — the writer is atomic (os.replace), so a skip means a
    writer mid-crash, and the next scan settles it.

    Reads go through the ``FAA_FSFAULT`` seam (``core/fsfault.py``):
    the port dir is a SHARED directory, and on a real remote mount
    listings lag and reads fail transiently.  A failed LISTING returns
    ``None`` — "could not observe the census", which is different from
    "the census is empty": the caller must keep its last-known replica
    table rather than declaring the whole fleet gone (the stale-fs
    game day drills exactly this confusion)."""
    records: list[dict] = []
    try:
        names = fsfault.listdir(port_dir)
    except OSError as e:
        if e.errno in (errno.EIO, errno.ESTALE):
            return None  # transient: census unobservable, not empty
        return records  # missing/unreadable dir: genuinely no records
    for name in names:
        if not name.endswith(".json") or name.startswith("."):
            continue
        path = os.path.join(port_dir, name)
        rec = fsfault.read_json(path)
        if not isinstance(rec, dict):
            continue
        try:
            records.append({
                "tag": str(rec.get("tag") or os.path.splitext(name)[0]),
                "host": str(rec["host"]),
                "port": int(rec["port"]),
                "pid": int(rec.get("pid", 0)),
            })
        except (KeyError, TypeError, ValueError):
            continue
    return records


class Replica:
    """One upstream serving replica's rotation state.  All mutation
    happens under the owning :class:`Router`'s lock."""

    __slots__ = ("tag", "host", "port", "in_rotation", "consecutive_fail",
                 "consecutive_ok", "backoff_until", "forced_down",
                 "last_verdict", "last_reason", "joined_at")

    def __init__(self, tag: str, host: str, port: int):
        self.tag = tag
        self.host = host
        self.port = int(port)
        # a discovered replica starts OUT of rotation and earns its way
        # in through readyz successes — never route at an unproven port
        self.in_rotation = False
        self.consecutive_fail = 0
        self.consecutive_ok = 0
        self.backoff_until = 0.0   # mono() horizon from 429/503 answers
        self.forced_down = False   # latched by replica_down faultinject
        self.last_verdict: bool | None = None
        self.last_reason = "unpolled"
        self.joined_at = wall()

    def snapshot(self) -> dict:
        return {
            "tag": self.tag,
            "addr": f"{self.host}:{self.port}",
            "in_rotation": self.in_rotation,
            "consecutive_fail": self.consecutive_fail,
            "consecutive_ok": self.consecutive_ok,
            "backing_off": self.backoff_until > mono(),
            "forced_down": self.forced_down,
            "last_verdict": self.last_verdict,
            "last_reason": self.last_reason,
        }


class Router:
    """Digest-affinity front door over N serving replicas.

    Handler threads call :meth:`forward`; one poll thread runs
    :meth:`poll_loop`.  The replica table is mutated only under
    ``_lock``; upstream network I/O always happens OUTSIDE it."""

    def __init__(self, *, port_dir: str | None = None,
                 static_replicas: list[dict] | None = None,
                 poll_interval_s: float = 0.5,
                 eject_after: int = 2, readmit_after: int = 1,
                 readyz_timeout_s: float = 2.0,
                 upstream_timeout_s: float = 60.0,
                 failover_attempts: int = 2,
                 batch_window_ms: float = 0.0,
                 batch_max: int = 8,
                 name: str = "router"):
        if not port_dir and not static_replicas:
            raise ValueError("router needs --port-dir or a static "
                             "replica list")
        self.port_dir = port_dir
        self.poll_interval_s = float(poll_interval_s)
        self.eject_after = max(1, int(eject_after))
        self.readmit_after = max(1, int(readmit_after))
        self.readyz_timeout_s = float(readyz_timeout_s)
        self.upstream_timeout_s = float(upstream_timeout_s)
        self.failover_attempts = max(0, int(failover_attempts))
        self.name = str(name)
        # keep-alive upstream plumbing: one pooled connection per
        # (host, port) serves many forwarded requests — the per-request
        # TCP setup tax was a measurable slice of routed latency.  The
        # probe pool is separate so a slow data-plane exchange never
        # holds up a health probe's short timeout.
        self._pool = wire.ConnectionPool(timeout_s=self.upstream_timeout_s)
        self._probe_pool = wire.ConnectionPool(
            timeout_s=self.readyz_timeout_s, max_idle_per_key=1)
        # opt-in pipelined forwarding: batch_window_ms > 0 coalesces
        # concurrent /augment forwards per replica into ONE framed
        # /augment_batch POST per flush (serve/wire.py frames)
        self.batch_forwarder = (
            BatchForwarder(self, window_ms=batch_window_ms,
                           max_per_flush=batch_max)
            if batch_window_ms > 0 else None)
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}
        self._rr = 0                 # round-robin cursor (digest-less)
        self._poll_round = 0
        self._requests_routed = 0    # the replica_down fault coordinate
        # canary split (the control plane's rollout): while armed,
        # requests for the canary digest steer to the canary subset,
        # requests for any OTHER digest steer away from it (those
        # replicas no longer hold the old policy), and digest-less
        # traffic splits deterministically — every `every`-th request
        # lands on the canary arm.  None = historical routing.
        self._canary: dict | None = None
        self._canary_count = 0
        self._stop = threading.Event()
        self._poll_thread: threading.Thread | None = None
        # static replicas are membership by CONFIGURATION: discovery
        # reconciliation never drops them (no port-dir record exists)
        self._static_tags = {rec["tag"] for rec in (static_replicas or [])}
        for rec in (static_replicas or []):
            self._replicas[rec["tag"]] = Replica(rec["tag"], rec["host"],
                                                 rec["port"])
        reg = telemetry.registry()
        self._req_ctr = {o: reg.counter(
            "faa_router_requests_total",
            "requests through the router by outcome",
            outcome=o, router=self.name)
            for o in ("ok", "failover_ok", "upstream_reject",
                      "upstream_error", "no_replica")}
        self._affinity_ctr = {r: reg.counter(
            "faa_router_affinity_total",
            "requests landing on their rendezvous-primary replica "
            "(hit) vs a failover/backoff alternate (miss)",
            result=r, router=self.name) for r in ("hit", "miss")}
        self._failover_ctr = reg.counter(
            "faa_router_failovers_total",
            "upstream attempts beyond the first", router=self.name)
        self._canary_ctr = {a: reg.counter(
            "faa_router_canary_requests_total",
            "requests landing on the canary vs baseline arm while a "
            "canary split is armed", arm=a, router=self.name)
            for a in ("canary", "baseline")}
        self._rotation_gauge = reg.gauge(
            "faa_router_replicas", "replicas currently in rotation",
            state="in_rotation", router=self.name)
        self._known_gauge = reg.gauge(
            "faa_router_replicas", "replicas known to the router",
            state="known", router=self.name)

    # ----------------------------------------------------- discovery

    def refresh_discovery(self) -> None:
        """Reconcile the replica table with the port-dir records: new
        records join (out of rotation until proven ready), removed
        records leave (a drained replica deleted its file; a crashed
        one is ejected by the poll instead)."""
        if not self.port_dir:
            return
        found = discover_replicas(self.port_dir)
        if found is None:
            # the LISTING failed transiently (injected or real EIO /
            # ESTALE past the seam's retries): keep the last-known
            # census instead of declaring the whole fleet departed —
            # ejection of actually-dead replicas is the health poll's
            # job, not the flaky listing's
            logger.warning("router: port-dir listing failed "
                           "transiently; keeping last census")
            return
        recs = {r["tag"]: r for r in found}
        with self._lock:
            for tag, rec in recs.items():
                cur = self._replicas.get(tag)
                if cur is None:
                    self._replicas[tag] = Replica(tag, rec["host"],
                                                  rec["port"])
                    logger.info("router: discovered replica %s at %s:%d",
                                tag, rec["host"], rec["port"])
                elif (cur.host, cur.port) != (rec["host"], rec["port"]):
                    # relaunched on a new port: reset and re-prove
                    self._replicas[tag] = Replica(tag, rec["host"],
                                                  rec["port"])
                    logger.info("router: replica %s moved to %s:%d",
                                tag, rec["host"], rec["port"])
            gone = [t for t in self._replicas
                    if t not in recs and t not in self._static_tags]
            for tag in gone:
                rep = self._replicas.pop(tag)
                if rep.in_rotation:
                    telemetry.emit("rotation", self.name, action="leave",
                                   replica=tag, reason="record_removed")
                logger.info("router: replica %s left (record removed)",
                            tag)
            self._update_gauges_locked()

    def _update_gauges_locked(self) -> None:
        self._known_gauge.set(len(self._replicas))
        self._rotation_gauge.set(
            sum(1 for r in self._replicas.values() if r.in_rotation))

    # -------------------------------------------------- health polling

    def _readyz_verdict(self, rep: Replica) -> tuple[bool, str]:
        """One real readiness probe (no fault interference) over the
        keep-alive probe pool — steady-state polling reuses one
        connection per replica instead of a TCP handshake per round."""
        try:
            status, _, _ = self._probe_pool.request(
                rep.host, rep.port, "GET", "/readyz")
            if status == 200:
                return True, "ok"
            return False, f"readyz {status}"
        except (OSError, http.client.HTTPException) as e:
            return False, f"unreachable: {type(e).__name__}"

    def _fault_victim_locked(self) -> str | None:
        """The deterministic fault target: first known tag in sorted
        order (the FAA_FAULT replica_down/readyz_flap contract)."""
        return min(self._replicas) if self._replicas else None

    def _consult_faults_locked(self) -> tuple[str | None, bool]:
        """The health-poll fault seam: returns (victim_tag,
        victim_down_this_round).  ``replica_down`` latches the victim's
        ``forced_down``; ``readyz_flap`` alternates the victim's
        verdict every P poll rounds."""
        from fast_autoaugment_tpu_torch.utils.faultinject import active_plan

        plan = active_plan()
        if plan is None:
            return None, False
        victim = self._fault_victim_locked()
        if victim is None:
            return None, False
        if plan.replica_down_now(self._requests_routed):
            self._replicas[victim].forced_down = True
            logger.warning("faultinject: replica %s declared DOWN "
                           "(replica_down)", victim)
        period = plan.readyz_flap_period()
        flap_down = (period is not None
                     and ((self._poll_round - 1) // period) % 2 == 1)
        return victim, flap_down

    def poll_once(self) -> None:
        """One health-poll round over every known replica, applying
        the eject/readmit hysteresis and journaling transitions."""
        with self._lock:
            self._poll_round += 1
            victim, flap_down = self._consult_faults_locked()
            targets = list(self._replicas.values())
        transitions = []
        for rep in targets:
            if rep.forced_down or (flap_down and rep.tag == victim):
                ok, reason = False, ("forced_down" if rep.forced_down
                                     else "readyz_flap")
            else:
                ok, reason = self._readyz_verdict(rep)
            with self._lock:
                if rep.tag not in self._replicas:
                    continue  # left the table mid-round
                rep.last_verdict, rep.last_reason = ok, reason
                if ok:
                    rep.consecutive_ok += 1
                    rep.consecutive_fail = 0
                    if not rep.in_rotation \
                            and rep.consecutive_ok >= self.readmit_after:
                        rep.in_rotation = True
                        transitions.append(("readmit", rep.tag, reason))
                else:
                    rep.consecutive_fail += 1
                    rep.consecutive_ok = 0
                    if rep.in_rotation \
                            and rep.consecutive_fail >= self.eject_after:
                        rep.in_rotation = False
                        transitions.append(("eject", rep.tag, reason))
                self._update_gauges_locked()
        for action, tag, reason in transitions:
            logger.warning("router: %s replica %s (%s)", action, tag,
                           reason)
            telemetry.emit("rotation", self.name, action=action,
                           replica=tag, reason=reason,
                           poll_round=self._poll_round)

    def poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.refresh_discovery()
            self.poll_once()

    def start(self) -> "Router":
        """Arm the poll thread after one synchronous discovery+poll
        round (the router answers with a populated table from its
        first request)."""
        self.refresh_discovery()
        self.poll_once()
        if self._poll_thread is None or not self._poll_thread.is_alive():
            self._stop.clear()
            self._poll_thread = threading.Thread(
                target=self.poll_loop, daemon=True, name="router-poll")
            self._poll_thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            # bounded join: a wedged probe must not hang
            # shutdown — the poller is a daemon either way
            self._poll_thread.join(timeout=timeout)
        self._pool.close_all()
        self._probe_pool.close_all()

    # ---------------------------------------------------- canary split

    def set_canary(self, digest: str, tags: list[str],
                   every: int = 2) -> dict:
        """Arm the canary split: `tags` are the replicas serving the
        candidate policy `digest`; every `every`-th digest-less request
        routes to them (a deterministic 1/every traffic share), canary-
        digest requests prefer them, other-digest requests avoid them.
        Re-arming with a DIFFERENT split replaces the previous one;
        re-asserting the SAME split is a no-op that preserves the
        every-Nth counter — a control loop re-POSTs on every gate
        poll, and a counter reset per poll would
        starve the canary arm of digest-less traffic."""
        if not tags:
            raise ValueError("canary split needs at least one replica tag")
        new = {"digest": str(digest),
               "tags": set(str(t) for t in tags),
               "every": max(1, int(every))}
        with self._lock:
            reasserted = self._canary == new
            if not reasserted:
                self._canary = new
                self._canary_count = 0
            snap = dict(self._canary, tags=sorted(self._canary["tags"]))
        if reasserted:
            return snap  # idempotent re-assert: no event spam either
        telemetry.emit("canary", self.name, action="split_set",
                       digest=snap["digest"], replicas=snap["tags"],
                       every=snap["every"])
        logger.info("router: canary split armed: digest=%s replicas=%s "
                    "every=%d", snap["digest"], snap["tags"],
                    snap["every"])
        return snap

    def clear_canary(self) -> None:
        with self._lock:
            was = self._canary
            self._canary = None
        if was is not None:
            telemetry.emit("canary", self.name, action="split_cleared",
                           digest=was["digest"])
            logger.info("router: canary split cleared (digest=%s)",
                        was["digest"])

    def _canary_partition_locked(self, ordered: list,
                                 digest: str | None) -> list:
        """Reorder `ordered` (rendezvous/RR order) per the armed canary
        split; within each arm the incoming order is preserved so
        failover stays deterministic."""
        can = self._canary
        tags = can["tags"]
        on_canary = [r for r in ordered if r.tag in tags]
        off_canary = [r for r in ordered if r.tag not in tags]
        if not on_canary or not off_canary:
            return ordered  # the split degenerated: nothing to steer
        if digest is not None:
            return (on_canary + off_canary
                    if digest == can["digest"]
                    else off_canary + on_canary)
        self._canary_count += 1
        if self._canary_count % can["every"] == 0:
            return on_canary + off_canary
        return off_canary + on_canary

    # --------------------------------------------------------- routing

    def candidates(self, digest: str | None) -> tuple[list[Replica], str | None]:
        """``(candidate_list, primary_tag)``: in-rotation replicas in
        rendezvous order for `digest` (round-robin without one),
        non-backing-off first, truncated to 1 + failover_attempts.
        `primary_tag` is the digest's rendezvous-FIRST in-rotation
        replica BEFORE the backoff reordering — the affinity metric
        counts landings against it, so routing around a cooling
        primary reads as a miss, which it is.  Backing-off replicas
        stay ELIGIBLE as a last resort — when the whole rotation is
        cooling down, the least-recently-rejected answer's Retry-After
        passes through to the client."""
        now = mono()
        with self._lock:
            live = [r for r in self._replicas.values() if r.in_rotation]
            if not live:
                return [], None
            if digest:
                by_tag = {r.tag: r for r in live}
                ordered = [by_tag[t] for t in rendezvous_order(
                    digest, sorted(by_tag))]
            else:
                live.sort(key=lambda r: r.tag)
                self._rr = (self._rr + 1) % len(live)
                ordered = live[self._rr:] + live[:self._rr]
            if self._canary is not None:
                ordered = self._canary_partition_locked(ordered, digest)
            primary_tag = ordered[0].tag
            ready = [r for r in ordered if r.backoff_until <= now]
            cooling = [r for r in ordered if r.backoff_until > now]
            return (ready + cooling)[:1 + self.failover_attempts], \
                primary_tag

    def _upstream(self, rep: Replica, method: str, path: str,
                  body: bytes | None, headers: dict) -> tuple:
        """One upstream attempt over the keep-alive pool; returns
        (status, resp_headers, body) or raises OSError /
        http.client.HTTPException on a transport failure.  A stale
        pooled connection is retried once on a fresh socket inside the
        pool (serve/wire.py ConnectionPool)."""
        return self._pool.request(rep.host, rep.port, method, path,
                                  body=body or b"", headers=headers)

    def _upstream_tag(self, tag: str, method: str, path: str,
                      body: bytes | None, headers: dict) -> tuple:
        """One upstream attempt pinned to a replica TAG (the batched
        flush targets the lane's replica directly — failover for a
        failed flush happens per entry through :meth:`forward`)."""
        with self._lock:
            rep = self._replicas.get(tag)
        if rep is None:
            raise OSError(f"replica {tag} left the table")
        return self._upstream(rep, method, path, body, headers)

    def forward_augment(self, body: bytes | None, headers: dict,
                        digest: str | None) -> tuple:
        """Route one /augment request through the batched forwarder
        when one is armed (``batch_window_ms > 0``), else directly —
        the handler's single entry point for data-plane traffic."""
        if self.batch_forwarder is not None:
            return self.batch_forwarder.submit(body, headers, digest)
        return self.forward("POST", "/augment", body, headers, digest)

    def forward(self, method: str, path: str, body: bytes | None,
                headers: dict, digest: str | None) -> tuple:
        """Route one request: rendezvous candidates, bounded failover
        on 429/503/transport errors honoring ``Retry-After``.  Returns
        ``(status, headers, body, routed_tag)``."""
        with self._lock:
            self._requests_routed += 1
        cands, primary_tag = self.candidates(digest)
        if not cands:
            self._req_ctr["no_replica"].inc()
            return (503, {"Retry-After": "1"},
                    json.dumps({"error": "no replica in rotation",
                                "type": "no_replica"}).encode(), None)
        last = None
        for i, rep in enumerate(cands):
            if i > 0:
                self._failover_ctr.inc()
            try:
                status, rheaders, data = self._upstream(
                    rep, method, path, body, headers)
            except (OSError, http.client.HTTPException) as e:
                logger.warning("router: upstream %s failed: %s",
                               rep.tag, e)
                last = (502, {}, json.dumps(
                    {"error": f"upstream {rep.tag} unreachable: "
                              f"{type(e).__name__}",
                     "type": "upstream_unreachable"}).encode(), rep.tag)
                continue
            if status in (429, 503):
                # honor Retry-After: route new traffic around this
                # replica for the window it asked for, fail THIS
                # request over to the next candidate
                retry_after = _retry_after_s(rheaders)
                with self._lock:
                    if rep.tag in self._replicas:
                        rep.backoff_until = mono() + retry_after
                last = (status, rheaders, data, rep.tag)
                continue
            self._count_routed(rep.tag, primary_tag, i)
            return status, rheaders, data, rep.tag
        # every candidate exhausted: the last upstream answer (with its
        # Retry-After) passes through; transport-only failures read 502
        status = last[0]
        self._req_ctr["upstream_reject" if status in (429, 503)
                      else "upstream_error"].inc()
        self._affinity_ctr["miss"].inc()
        return last

    def _count_routed(self, tag: str, primary_tag: str, attempt: int) -> None:
        self._req_ctr["ok" if attempt == 0 else "failover_ok"].inc()
        self._affinity_ctr["hit" if tag == primary_tag else "miss"].inc()
        with self._lock:
            can = self._canary
        if can is not None:
            self._canary_ctr["canary" if tag in can["tags"]
                             else "baseline"].inc()
        telemetry.registry().counter(
            "faa_router_upstream_requests_total",
            "requests served per upstream replica",
            replica=tag, router=self.name).inc()

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            reps = {t: r.snapshot() for t, r in self._replicas.items()}
            routed = self._requests_routed
            poll_round = self._poll_round
            canary = (None if self._canary is None
                      else dict(self._canary,
                                tags=sorted(self._canary["tags"])))
        hits = int(self._affinity_ctr["hit"].value)
        misses = int(self._affinity_ctr["miss"].value)
        total = hits + misses
        return {
            "router": self.name,
            "port_dir": self.port_dir,
            "connections": self._pool.stats(),
            "batch_forwarding": (None if self.batch_forwarder is None
                                 else self.batch_forwarder.stats()),
            "replicas": reps,
            "in_rotation": sorted(t for t, r in reps.items()
                                  if r["in_rotation"]),
            "requests_routed": routed,
            "poll_round": poll_round,
            "poll_interval_s": self.poll_interval_s,
            "eject_after": self.eject_after,
            "readmit_after": self.readmit_after,
            "failover_attempts": self.failover_attempts,
            "failovers": int(self._failover_ctr.value),
            "affinity": {
                "hits": hits, "misses": misses,
                "hit_rate": round(hits / total, 4) if total else None,
            },
            "outcomes": {o: int(c.value)
                         for o, c in self._req_ctr.items()},
            "canary": canary and {
                **canary,
                "routed": {a: int(c.value)
                           for a, c in self._canary_ctr.items()},
            },
        }


class _BatchEntry:
    """One /augment request parked in a forwarding lane."""

    __slots__ = ("meta", "body", "headers", "digest", "event", "result")

    def __init__(self, meta: dict, body: bytes, headers: dict,
                 digest: str | None):
        self.meta = meta
        self.body = body
        self.headers = headers
        self.digest = digest
        self.event = threading.Event()
        self.result: tuple | None = None


class BatchForwarder:
    """Opt-in pipelined router forwarding: concurrent /augment
    requests headed for the SAME replica coalesce into one framed
    ``/augment_batch`` POST per flush (serve/wire.py frames) instead
    of N singleton POSTs.

    Leader-per-flush model: the first request to open a replica's lane
    becomes the flush leader — it waits ``window_ms`` for followers to
    pile on, drains the lane, ships the frame payload and distributes
    the per-part answers; followers just park on their entry's event.
    A single-entry flush degenerates to the normal :meth:`Router.
    forward` path (no frame overhead), and a FAILED flush falls back
    per entry through the same path, so batched forwarding inherits
    the bounded-failover/backoff semantics instead of reimplementing
    them.  Sub-request ordering within a flush is preserved; replies
    pass through per entry (a part-level 429/503 reaches its own
    client, not the whole batch)."""

    def __init__(self, router: Router, window_ms: float = 2.0,
                 max_per_flush: int = 8):
        self.router = router
        self.window_s = max(0.0, float(window_ms)) / 1e3
        self.max_per_flush = max(1, int(max_per_flush))
        self._lock = threading.Lock()
        self._lanes: dict[str, list[_BatchEntry]] = {}
        reg = telemetry.registry()
        self._flush_ctr = reg.counter(
            "faa_router_batch_flushes_total",
            "framed multi-request flushes shipped upstream",
            router=router.name)
        self._entries_ctr = reg.counter(
            "faa_router_batch_entries_total",
            "requests forwarded through the batched lane",
            router=router.name)
        self._fallback_ctr = reg.counter(
            "faa_router_batch_fallbacks_total",
            "entries that fell back to singleton forwarding after a "
            "failed flush", router=router.name)

    def submit(self, body: bytes, headers: dict,
               digest: str | None) -> tuple:
        """Forward one /augment request through its replica's lane;
        blocks until the answer is in (the handler thread IS the
        client's connection)."""
        cands, _ = self.router.candidates(digest)
        if not cands:
            # no rotation: the direct path owns the structured 503
            return self.router.forward("POST", "/augment", body,
                                       headers, digest)
        tag = cands[0].tag
        meta = {"ctype": headers.get("Content-Type", "")}
        if headers.get("X-FAA-Deadline-Ms") is not None:
            meta["deadline_ms"] = float(headers["X-FAA-Deadline-Ms"])
        if digest is not None:
            meta["digest"] = digest
        entry = _BatchEntry(meta, body, headers, digest)
        self._entries_ctr.inc()
        with self._lock:
            lane = self._lanes.get(tag)
            leader = lane is None
            if leader:
                lane = []
                self._lanes[tag] = lane
            lane.append(entry)
        if not leader:
            # bounded park: window + upstream budget + grace
            if not entry.event.wait(timeout=self.window_s
                                    + self.router.upstream_timeout_s
                                    + 5.0):
                return (502, {}, json.dumps(
                    {"error": "batched flush timed out",
                     "type": "router_batch_timeout"}).encode(), None)
            return entry.result
        # leader: hold the lane open one window (stop-aware so a
        # draining router flushes immediately), then drain and ship
        self.router._stop.wait(self.window_s)
        with self._lock:
            batch = self._lanes.pop(tag, [])
        for lo in range(0, len(batch), self.max_per_flush):
            self._flush(tag, batch[lo:lo + self.max_per_flush])
        return entry.result

    def _flush(self, tag: str, chunk: list[_BatchEntry]) -> None:
        if len(chunk) == 1:
            e = chunk[0]
            e.result = self.router.forward("POST", "/augment", e.body,
                                           e.headers, e.digest)
            e.event.set()
            return
        payload = wire.encode_frames([(e.meta, e.body) for e in chunk])
        try:
            status, _, data = self.router._upstream_tag(
                tag, "POST", "/augment_batch", payload,
                {"Content-Type": wire.FRAME_CONTENT_TYPE,
                 "Content-Length": str(len(payload))})
            parts = (wire.decode_frames(data) if status == 200 else None)
            if parts is not None and len(parts) != len(chunk):
                raise ValueError(
                    f"flush answered {len(parts)} parts for "
                    f"{len(chunk)} entries")
        except (OSError, http.client.HTTPException, ValueError) as exc:
            logger.warning("router: batched flush to %s failed (%s) — "
                           "falling back per entry", tag, exc)
            parts = None
        if parts is None:
            # the singleton path re-routes with failover/backoff
            for e in chunk:
                self._fallback_ctr.inc()
                e.result = self.router.forward("POST", "/augment",
                                               e.body, e.headers,
                                               e.digest)
                e.event.set()
            return
        self._flush_ctr.inc()
        with self.router._lock:
            # the fault coordinate counts every routed request, the
            # batched lane included (forward() does it for fallbacks)
            self.router._requests_routed += len(chunk)
        for e, (meta, pbody) in zip(chunk, parts):
            rheaders = dict(meta.get("headers") or {})
            rheaders["Content-Type"] = meta.get(
                "ctype", "application/octet-stream")
            e.result = (int(meta.get("status", 500)), rheaders,
                        bytes(pbody), tag)
            self.router._count_routed(tag, tag, 0)
            e.event.set()

    def stats(self) -> dict:
        return {"window_ms": self.window_s * 1e3,
                "max_per_flush": self.max_per_flush,
                "entries": int(self._entries_ctr.value),
                "flushes": int(self._flush_ctr.value),
                "fallbacks": int(self._fallback_ctr.value)}


def _retry_after_s(headers: dict) -> float:
    """Parse an upstream ``Retry-After`` (integral seconds; 0.5s floor
    so a malformed/absent header still backs the replica off one
    beat)."""
    for k, v in headers.items():
        if k.lower() == "retry-after":
            try:
                return max(0.5, float(v))
            except (TypeError, ValueError):
                break
    return 0.5
