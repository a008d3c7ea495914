"""Lease-based work reclamation over a shared artifact directory (the
port's copy of ``fast_autoaugment_tpu/launch/workqueue.py``: the same
protocol and the same files, byte for byte, so hosts of both packages can
share one queue).

The resilience layer makes a single run survive faults; this layer makes
the FLEET survive losing a machine.  The search's natural work units —
phase-1 fold trainings, per-fold phase-2 trial searches, phase 3 — are
already resumable from the checkpoint chain + trial log by ANY host that
can see the shared ``save_dir``; this is the ownership protocol, so a
unit abandoned by a dead host is picked up by exactly one survivor.
Podracer-style pods run on preemptible hardware exactly this way
(PAPERS.md: *Podracer architectures* — work units are reclaimable by
survivors, progress lives in shared storage).

Protocol (all state lives under ``<root>/``, assumed on a filesystem
every host mounts — the same assumption the shared ``save_dir``
scatter already makes):

``leases/<unit>.json``
    The lease: ``{unit, owner, attempt, heartbeat, claimed_at}``.
    **Claim** is an atomic ``os.link`` of an owner-unique temp file
    onto the lease path — exactly one linker wins, losers see
    ``FileExistsError``.  **Renewal** rewrites the file (via
    ``write_json_atomic``) with a fresh ``heartbeat`` wall-clock stamp;
    the trainer calls it at dispatch-chunk boundaries and the phase-2
    loop per trial round.  **Reclaim** of a stale lease (heartbeat
    older than ``lease_ttl``) first renames the lease to a
    fence path — ``os.rename`` succeeds for exactly one contender —
    then claims fresh with ``attempt + 1`` and the dead owner recorded.
``done/<unit>.json``
    Completion marker (atomic write): ``{unit, owner, attempt,
    reclaimed_from, info}``.  ``attempt > 1`` is the global
    "this unit was reclaimed" signal any host can read at the end.
    The ``info`` payload doubles as the REWARD-RETURN channel of the
    fleet-search round transport (``search/pipeline.py``): an actor
    host releases a claimed round unit with ``info={"rewards": [...]}``
    (or ``{"error": ...}``) and the learner host reads it back through
    :meth:`WorkQueue.done_info`.
``work/<unit>.json``
    OPTIONAL published payload (:meth:`WorkQueue.publish_unit`): the
    dynamic-unit form of the queue.  The original scatter's units
    (``p1-fold<k>``/``p2-fold<k>``) are known to every host up front;
    round units are MINTED by the learner at ask time, so the payload
    file is both the work description (trial ids + proposals) and the
    discovery surface (:meth:`WorkQueue.open_units` lists payloads
    without done markers — the actor's claim menu).
``hosts/<owner>.json``
    Host-level heartbeat (``beat_host``): consumed by the fleet
    supervisor's wedge detector and by the degraded-mode accounting
    (a host whose beat goes stale and never completes is ``lost``).

Clocks (the skew-proof contract, docs/RESILIENCE.md "Hostile shared
filesystem"): lease staleness is OBSERVER-LOCAL — a lease is stale
when its observed fingerprint (owner, heartbeat stamp, attempt, epoch)
has not CHANGED for ``lease_ttl`` seconds on the OBSERVER'S monotonic
clock.  Cross-host wall stamps are never compared, so arbitrary
per-host clock skew (``FAA_FSFAULT skew@host=...``) cannot produce a
spurious reclaim (a live host whose clock is behind) or an immortal
zombie (a dead host whose last stamp is in the future).  The cost is
that a claimant must WATCH a foreign lease for one TTL before stealing
it — the first claim() observes and declines, a later claim() past the
TTL reclaims.  Host-beat wall stamps are still written (``make
status`` renders them, flagging beats from the observer's future as
skew suspects) but they are accounting, not correctness.

Fencing: every lease carries a monotonically increasing **epoch** (the
fencing token — Lamport's lease-fencing idiom): fresh claim = 1,
every reclaim = previous + 1, renewals carry it forward, and
:meth:`WorkQueue.release` verifies at done-marker post time that this
host still owns the lease at the epoch it claimed.  A robbed zombie's
late release therefore raises :class:`LeaseLostError` instead of
clobbering the reclaimed unit's completion record, no matter how
skewed its clock is.  Old-format leases (no epoch field) reclaim
normally and simply enter the epoch sequence at 2.

A stolen owner discovers the loss at its next renewal
(``LeaseLostError``) and must stop working the unit — both sides write
checkpoints through the same atomic chain, so the worst case of a
slow-but-alive owner racing its reclaimer is duplicated compute, never
corrupted state (writes are idempotent: same seeds, same chain).

Fault injection: ``FAA_FAULT=stale_lease@unit=NAME`` drops renewals
for NAME from the first match onward, driving the reclaim path
deterministically in tests; ``FAA_FSFAULT`` (``core/fsfault.py``)
injects shared-filesystem faults under every read/list/write this
module performs (docs/RESILIENCE.md).
"""

from __future__ import annotations

import os
import time

from fast_autoaugment_tpu_torch.core import fsfault, telemetry
from fast_autoaugment_tpu_torch.utils import faultinject
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["WorkQueue", "LeaseLostError", "DEFAULT_LEASE_TTL_SEC"]

logger = get_logger("faa_torch.workqueue")

DEFAULT_LEASE_TTL_SEC = 60.0


class LeaseLostError(RuntimeError):
    """This host's lease on a unit was reclaimed by another host (it
    missed enough heartbeats to be declared dead).  The worker must
    stop working the unit immediately — a survivor owns it now."""


def _read_json(path: str) -> dict | None:
    # missing, mid-replace, or torn by a dead writer: treated as
    # absent — every writer is atomic, so this is transient (the
    # fsfault seam additionally injects lag/stale/eio/torn here)
    return fsfault.read_json(path)


class _StalenessObserver:
    """Observer-local staleness: a record is stale when its observed
    fingerprint has not changed for `ttl` seconds on THIS process's
    monotonic clock.  Never compares cross-host wall stamps — the
    skew-proof half of the lease contract."""

    def __init__(self):
        self._seen: dict[str, tuple[tuple, float]] = {}

    def unchanged_for(self, key: str, fingerprint: tuple) -> float:
        """Seconds the fingerprint has been observed unchanged (0.0 on
        first sight or on any change)."""
        now = time.monotonic()
        prev = self._seen.get(key)
        if prev is None or prev[0] != fingerprint:
            self._seen[key] = (fingerprint, now)
            return 0.0
        return now - prev[1]

    def forget(self, key: str) -> None:
        self._seen.pop(key, None)


class WorkQueue:
    """One host's handle on the shared lease queue.

    `owner` must be unique per live process chain (the fleet passes
    ``host<id>``; a relaunched process REUSES its dead predecessor's
    owner string and may re-claim its own stale lease without waiting
    out the TTL — the predecessor is guaranteed dead by the supervisor
    before the relaunch)."""

    def __init__(self, root: str, owner: str, *,
                 lease_ttl: float = DEFAULT_LEASE_TTL_SEC):
        self.root = root
        self.owner = str(owner)
        self.lease_ttl = float(lease_ttl)
        self._leases = os.path.join(root, "leases")
        self._done = os.path.join(root, "done")
        self._hosts = os.path.join(root, "hosts")
        self._work = os.path.join(root, "work")
        for d in (self._leases, self._done, self._hosts, self._work):
            os.makedirs(d, exist_ok=True)
        #: units THIS host reclaimed from a dead owner (session-local;
        #: the global view comes from the done markers' attempt counts)
        self.reclaimed_units: list[str] = []
        #: observer-local staleness state (see module docstring)
        self._observer = _StalenessObserver()
        #: unit -> the lease epoch THIS host claimed at (the fencing
        #: token release() verifies at done-marker post time)
        self._held_epochs: dict[str, int] = {}

    def _lease_event(self, action: str, unit: str, **fields) -> None:
        """Registry counter + journal ``lease`` event for one lease
        transition (claim/reclaim/lost/release) — the fleet-status tool
        and the trace export read these (core/telemetry.py)."""
        telemetry.registry().counter(
            "faa_lease_events_total", "workqueue lease transitions",
            action=action).inc()
        telemetry.emit("lease", unit, action=action, owner=self.owner,
                       **fields)

    # -- paths ---------------------------------------------------------
    def _lease_path(self, unit: str) -> str:
        return os.path.join(self._leases, f"{_safe(unit)}.json")

    def _done_path(self, unit: str) -> str:
        return os.path.join(self._done, f"{_safe(unit)}.json")

    def _host_path(self, owner: str) -> str:
        return os.path.join(self._hosts, f"{_safe(owner)}.json")

    def _work_path(self, unit: str) -> str:
        return os.path.join(self._work, f"{_safe(unit)}.json")

    # -- dynamic (published) units --------------------------------------
    def publish_unit(self, unit: str, payload: dict) -> None:
        """Mint a claimable unit with an atomic payload write (the
        round-unit verb of the fleet-search transport).  Idempotent:
        re-publishing after a learner resume rewrites the identical
        payload (same ids, same proposals — the ledger replay is
        deterministic), so claimants can never read a torn or
        half-updated description."""
        fsfault.write_json_atomic(self._work_path(unit),
                                  dict(payload, unit=unit))

    def unit_payload(self, unit: str) -> dict | None:
        """The published payload for `unit`, or None (never torn — the
        writer is atomic)."""
        return _read_json(self._work_path(unit))

    def open_units(self, prefix: str = "") -> list[str]:
        """Published units with NO done marker yet, sorted — the claim
        menu for actor hosts.  A unit under a live foreign lease still
        lists (claim() on it just returns False); a done unit never
        does."""
        try:
            names = fsfault.listdir(self._work)
        except OSError:
            return []
        out = []
        for name in names:
            if not name.endswith(".json"):
                continue
            unit = name[:-5]
            if unit.startswith(prefix) and not self.is_done(unit):
                out.append(unit)
        return out

    # -- host heartbeat ------------------------------------------------
    def beat_host(self, extra: dict | None = None) -> None:
        """Write this host's liveness beat (fleet wedge detector +
        degraded accounting read it).  Stamped through the telemetry
        ``wall()`` seam so the FAA_FSFAULT skew verb drills the
        skewed-heartbeat case."""
        rec = {"owner": self.owner, "heartbeat": telemetry.wall(),
               "pid": os.getpid()}
        if extra:
            rec.update(extra)
        fsfault.write_json_atomic(self._host_path(self.owner), rec)

    def mark_host_done(self, info: dict | None = None) -> None:
        """Terminal host beat: a host that said ``done`` and then goes
        quiet is finished, not lost."""
        self.beat_host(dict(info or {}, done=True))

    # -- lease lifecycle -----------------------------------------------
    @staticmethod
    def _lease_fingerprint(lease: dict) -> tuple:
        """What "the lease changed" means to the observer: any owner /
        heartbeat-stamp / attempt / epoch movement resets staleness.
        The heartbeat VALUE is compared for identity only — never
        against the observer's clock (skew-proof)."""
        return (lease.get("owner"), lease.get("heartbeat"),
                lease.get("attempt"), lease.get("epoch"))

    def claim(self, unit: str) -> bool:
        """Try to take ownership of `unit`.  True = this host owns it
        (fresh claim, its own prior lease, or a stale-lease reclaim);
        False = done already, another host holds a live lease, or a
        foreign lease has not yet been OBSERVED unchanged for the TTL
        (a later claim() past the TTL reclaims it)."""
        if self.is_done(unit):
            return False
        path = self._lease_path(unit)
        lease = _read_json(path)
        if lease is None:
            claimed = self._claim_fresh(unit, attempt=1, epoch=1)
            if claimed:
                self._held_epochs[unit] = 1
                self._lease_event("claim", unit, lease_attempt=1,
                                  lease_epoch=1)
            return claimed
        if lease.get("owner") == self.owner:
            # our own lease (a relaunch of this owner resuming its
            # unit): refresh the heartbeat and carry on at the SAME
            # epoch (the predecessor is guaranteed dead — same owner
            # string means the supervisor relaunched us)
            epoch = int(lease.get("epoch", 1))
            self._write_lease(unit, attempt=int(lease.get("attempt", 1)),
                              epoch=epoch,
                              reclaimed_from=lease.get("reclaimed_from"))
            self._held_epochs[unit] = epoch
            return True
        # foreign lease: observer-local staleness — stale only once WE
        # have watched the fingerprint sit unchanged for a full TTL on
        # OUR monotonic clock (cross-host wall stamps are never
        # compared; arbitrary skew cannot fake liveness or death)
        unchanged = self._observer.unchanged_for(
            f"lease:{unit}", self._lease_fingerprint(lease))
        if unchanged <= self.lease_ttl:
            return False  # live elsewhere (or not yet proven dead)
        # stale: steal under a fence FILE (exactly one linker wins) so
        # the lease path itself never disappears — a remove-then-
        # recreate window would let a racing fresh claim land with
        # attempt=1 and silently drop the reclaim provenance
        if not self._win_steal_fence(unit):
            return False
        fence = self._lease_path(unit) + ".steal"
        try:
            current = _read_json(path)
            if current is None or \
                    current.get("owner") != lease.get("owner") or \
                    current.get("heartbeat") != lease.get("heartbeat"):
                # renewed/released/re-stolen while we raced: not stale
                return False
            dead_owner = lease.get("owner", "?")
            attempt = int(lease.get("attempt", 1)) + 1
            epoch = int(lease.get("epoch", 1)) + 1
            logger.warning(
                "workqueue: RECLAIMING unit %r from %r (lease observed "
                "unchanged %.1fs, ttl %.1fs) — attempt %d epoch %d",
                unit, dead_owner, unchanged, self.lease_ttl, attempt,
                epoch)
            # in-place replace: no absence window for fresh claims
            self._write_lease(unit, attempt=attempt, epoch=epoch,
                              reclaimed_from=dead_owner)
            self._held_epochs[unit] = epoch
            self._observer.forget(f"lease:{unit}")
            self.reclaimed_units.append(unit)
            self._lease_event("reclaim", unit, lease_attempt=attempt,
                              lease_epoch=epoch,
                              reclaimed_from=dead_owner,
                              observed_stale_sec=round(unchanged, 3))
            return True
        finally:
            try:
                os.remove(fence)
            except OSError as e:
                logger.warning("workqueue: fence cleanup failed (%s)", e)

    def _win_steal_fence(self, unit: str) -> bool:
        """Atomically take the per-unit steal fence (``<lease>.steal``).
        A fence left by a stealer that died mid-steal unblocks after
        being OBSERVED unchanged for the TTL (observer-local, like the
        lease itself — a skewed stealer's future stamp cannot wedge
        the unit)."""
        fence = self._lease_path(unit) + ".steal"
        stale = _read_json(fence)
        if stale is not None and self._observer.unchanged_for(
                f"fence:{unit}", (stale.get("owner"), stale.get("at"))
        ) > self.lease_ttl:
            try:
                os.remove(fence)  # dead stealer's leftover
                self._observer.forget(f"fence:{unit}")
            except OSError as e:
                logger.warning("workqueue: stale fence cleanup failed (%s)", e)
        tmp = fence + f".{_safe(self.owner)}.{os.getpid()}"
        fsfault.write_json_atomic(
            tmp, {"owner": self.owner, "at": telemetry.wall()})
        try:
            os.link(tmp, fence)
            return True
        except FileExistsError:
            return False
        except OSError as e:
            logger.warning("workqueue: steal fence failed for %r (%s)",
                           unit, e)
            return False
        finally:
            try:
                os.remove(tmp)
            except OSError as e:
                logger.warning("workqueue: fence tmp cleanup failed (%s)", e)

    def _claim_fresh(self, unit: str, attempt: int, epoch: int,
                     reclaimed_from: str | None = None) -> bool:
        path = self._lease_path(unit)
        tmp = path + f".claim.{_safe(self.owner)}.{os.getpid()}"
        fsfault.write_json_atomic(
            tmp, self._lease_record(unit, attempt, epoch, reclaimed_from))
        try:
            os.link(tmp, path)  # atomic test-and-set
            return True
        except FileExistsError:
            return False
        except OSError as e:
            logger.warning("workqueue: claim link failed for %r (%s)",
                           unit, e)
            return False
        finally:
            try:
                os.remove(tmp)
            except OSError as e:
                logger.warning("workqueue: claim tmp cleanup failed (%s)", e)

    def _lease_record(self, unit: str, attempt: int, epoch: int,
                      reclaimed_from: str | None) -> dict:
        rec = {"unit": unit, "owner": self.owner, "attempt": int(attempt),
               "epoch": int(epoch), "heartbeat": telemetry.wall(),
               "claimed_at": telemetry.wall()}
        if reclaimed_from:
            rec["reclaimed_from"] = reclaimed_from
        return rec

    def _write_lease(self, unit: str, attempt: int, epoch: int,
                     reclaimed_from: str | None = None) -> None:
        fsfault.write_json_atomic(
            self._lease_path(unit),
            self._lease_record(unit, attempt, epoch, reclaimed_from))

    def renew(self, unit: str) -> None:
        """Heartbeat the lease (called at dispatch/round boundaries).
        Raises :class:`LeaseLostError` when another host reclaimed the
        unit — the caller must abandon it."""
        fi = faultinject.active_plan()
        if fi is not None and fi.lease_stale(unit):
            return  # injected wedged-heartbeat: silently drop the beat
        lease = _read_json(self._lease_path(unit))
        if lease is None or lease.get("owner") != self.owner:
            self._lease_event("lost", unit,
                              new_owner=None if lease is None
                              else lease.get("owner"))
            raise LeaseLostError(
                f"lease on {unit!r} is {'gone' if lease is None else 'owned by ' + repr(lease.get('owner'))}"
                f" — this host was declared dead and the unit reclaimed")
        epoch = int(lease.get("epoch", self._held_epochs.get(unit, 1)))
        self._write_lease(unit, attempt=int(lease.get("attempt", 1)),
                          epoch=epoch,
                          reclaimed_from=lease.get("reclaimed_from"))
        self._held_epochs[unit] = epoch

    def release(self, unit: str, info: dict | None = None) -> None:
        """Mark `unit` complete (atomic done marker) and drop the
        lease.  Idempotent for the legitimate owner; the done marker
        records the final owner, attempt count AND lease epoch — the
        global reclaim evidence.

        FENCING (verified at done-marker post time): if another host
        reclaimed the unit — the lease's owner or epoch moved past what
        THIS host claimed — the release raises :class:`LeaseLostError`
        instead of writing, so a robbed zombie's late completion can
        never clobber the reclaimed unit's record, under any clock
        skew."""
        lease = _read_json(self._lease_path(unit))
        held = self._held_epochs.get(unit)
        if lease is not None and lease.get("owner") != self.owner:
            self._lease_event("fenced", unit,
                              new_owner=lease.get("owner"),
                              lease_epoch=lease.get("epoch"))
            raise LeaseLostError(
                f"done-marker post for {unit!r} FENCED: the lease is "
                f"owned by {lease.get('owner')!r} at epoch "
                f"{lease.get('epoch')} (this host claimed epoch {held}) "
                "— the unit was reclaimed; abandoning the late write")
        if lease is not None and held is not None \
                and int(lease.get("epoch", 1)) != held:
            self._lease_event("fenced", unit,
                              lease_epoch=lease.get("epoch"))
            raise LeaseLostError(
                f"done-marker post for {unit!r} FENCED: lease epoch "
                f"{lease.get('epoch')} != claimed epoch {held}")
        existing = _read_json(self._done_path(unit))
        if existing is not None:
            if existing.get("owner") == self.owner:
                return  # idempotent re-release
            if int(existing.get("epoch", 1)) >= (held or 1):
                self._lease_event("fenced", unit,
                                  done_owner=existing.get("owner"),
                                  done_epoch=existing.get("epoch"))
                raise LeaseLostError(
                    f"done-marker post for {unit!r} FENCED: "
                    f"{existing.get('owner')!r} already completed it at "
                    f"epoch {existing.get('epoch')} >= {held or 1}")
        lease = lease or {}
        epoch = int(lease.get("epoch", held or 1))
        rec = {"unit": unit, "owner": self.owner,
               "attempt": int(lease.get("attempt", 1)),
               "epoch": epoch, "completed_at": telemetry.wall()}
        if lease.get("reclaimed_from"):
            rec["reclaimed_from"] = lease["reclaimed_from"]
        if info:
            rec["info"] = info
        fsfault.write_json_atomic(self._done_path(unit), rec)
        self._lease_event("release", unit, lease_attempt=rec["attempt"],
                          lease_epoch=epoch)
        self._held_epochs.pop(unit, None)
        if lease.get("owner") == self.owner:
            try:
                os.remove(self._lease_path(unit))
            except OSError as e:
                logger.warning("workqueue: lease cleanup failed for %r (%s)",
                               unit, e)

    # -- read side -----------------------------------------------------
    def is_done(self, unit: str) -> bool:
        return _read_json(self._done_path(unit)) is not None

    def done_info(self, unit: str) -> dict | None:
        """The completion marker's ``info`` payload (gate exclusions,
        baselines, posted rewards — whatever the finishing host
        stamped), or None."""
        rec = _read_json(self._done_path(unit))
        return None if rec is None else rec.get("info") or {}

    def done_record(self, unit: str) -> dict | None:
        """The FULL completion marker (owner, attempt, completed_at,
        info) — the reward-return reader needs the provenance fields
        the plain ``done_info`` view drops."""
        return _read_json(self._done_path(unit))

    def read_lease(self, unit: str) -> dict | None:
        return _read_json(self._lease_path(unit))

    def known_hosts(self) -> dict[str, dict]:
        out = {}
        try:
            names = fsfault.listdir(self._hosts)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            rec = _read_json(os.path.join(self._hosts, name))
            if rec and rec.get("owner"):
                out[rec["owner"]] = rec
        return out

    def lost_hosts(self) -> list[str]:
        """Hosts whose beat went stale WITHOUT a terminal done beat.
        The caller itself is excluded — a host computing the census is
        self-evidently alive, however long its last compile gap was.

        This census is wall-based ACCOUNTING (who to report as lost),
        not correctness — reclaim decisions use the observer-local
        lease protocol above.  A beat stamped in the observer's future
        (clock skew) counts as |age| so a skewed dead host is still
        reported once its beat stops moving."""
        now = time.time()
        return sorted(
            owner for owner, rec in self.known_hosts().items()
            if owner != self.owner and not rec.get("done")
            and abs(now - float(rec.get("heartbeat", 0.0))) > self.lease_ttl)

    def accounting(self) -> dict:
        """The degraded-mode stamp for ``search_result.json``: global
        reclaim evidence (done markers with attempt > 1) + host
        census.  Any surviving host computes the same answer."""
        reclaimed = []
        try:
            names = fsfault.listdir(self._done)
        except OSError:
            names = []
        for name in names:
            if not name.endswith(".json"):
                continue
            rec = _read_json(os.path.join(self._done, name))
            if rec and int(rec.get("attempt", 1)) > 1:
                reclaimed.append({
                    "unit": rec.get("unit", name[:-5]),
                    "attempt": rec["attempt"],
                    "epoch": int(rec.get("epoch", rec["attempt"])),
                    "finished_by": rec.get("owner"),
                    "reclaimed_from": rec.get("reclaimed_from")})
        lost = self.lost_hosts()
        return {
            "degraded": bool(reclaimed or lost),
            "lost_hosts": lost,
            "reclaimed_units": reclaimed,
            "num_reclaimed_units": len(reclaimed),
        }


def _safe(name: str) -> str:
    """Unit/owner id -> filename (no separators/parent escapes)."""
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in str(name))
