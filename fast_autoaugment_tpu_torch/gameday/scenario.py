"""Composable game-day scenario specs: the port's copy of
``fast_autoaugment_tpu/gameday/scenario.py`` (docs/GAMEDAYS.md), every
dataclass field and every registered value unchanged.

A :class:`Scenario` composes four orthogonal axes:

- a :class:`Traffic` shape — the OFFERED load schedule (open loop: the
  schedule never slows down because the plane did; that is the point);
- a :class:`Plane` topology — replicas / router / autoscaler /
  controller, plus the shedding knobs a broken-config drill disables;
- fault verbs — ``FAA_FAULT`` (process faults, armed in the replicas)
  and ``FAA_FSFAULT`` (shared-FS faults, armed in the router) strings,
  plus an optional :class:`Kill` (SIGKILL a live replica mid-scenario);
- verdict predicates — ``(name, params)`` pairs resolved against
  ``gameday/verdict.py``'s catalog at evaluation time.

Everything here is a frozen dataclass and host-only (no torch, no
subprocess): specs must be constructible and hashable from a unit test
or ``faa_status`` without touching a device.  The runner
(``gameday/runner.py``) is the only layer that turns a spec into
processes.

``expect`` records what the verdict engine is SUPPOSED to say:
``"pass"`` for the real plane, ``"fail"`` for deliberately broken
configurations kept in the suite to prove the engine has teeth (a
verdict harness that cannot fail is not a harness).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["Traffic", "Plane", "Kill", "Scenario", "SCENARIOS",
           "scaled", "suite_names"]


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Offered-load shape.

    ``kind``:

    - ``constant`` — ``base_rps`` for ``duration_s``;
    - ``flash`` — ``base_rps``, then a ramp to ``peak_rps`` over
      ``ramp_s`` starting at ``flash_at_frac * duration_s``, held to
      the end (the 10x-in-seconds flash crowd);
    - ``diurnal`` — a raised-cosine swing between ``base_rps`` and
      ``peak_rps`` with period ``period_s`` (a compressed day).

    ``tenants`` > 1 rotates the cohort mix: the active cohort advances
    every ``rotate_s`` seconds and gets ~80% of the traffic, the rest
    spread uniformly (the LRU-thrash shape).  ``lanes`` weights the
    raw / npz / shm wire-lane mix.
    """

    kind: str = "constant"
    duration_s: float = 20.0
    base_rps: float = 10.0
    peak_rps: float = 100.0
    flash_at_frac: float = 0.4
    ramp_s: float = 2.0
    period_s: float = 10.0
    imgs_per_request: int = 4
    lanes: tuple = (("raw", 0.6), ("npz", 0.2), ("shm", 0.2))
    tenants: int = 1
    rotate_s: float = 5.0

    def rate_at(self, t: float) -> float:
        """Offered requests/second at offset ``t`` (deterministic)."""
        if t < 0 or t >= self.duration_s:
            return 0.0
        if self.kind == "constant":
            return self.base_rps
        if self.kind == "flash":
            t0 = self.flash_at_frac * self.duration_s
            if t < t0:
                return self.base_rps
            frac = min(1.0, (t - t0) / max(self.ramp_s, 1e-9))
            return self.base_rps + frac * (self.peak_rps - self.base_rps)
        if self.kind == "diurnal":
            mid = 0.5 * (self.base_rps + self.peak_rps)
            amp = 0.5 * (self.peak_rps - self.base_rps)
            return mid - amp * math.cos(2 * math.pi * t / self.period_s)
        raise ValueError(f"unknown traffic kind: {self.kind!r}")

    @property
    def peak_rate(self) -> float:
        if self.kind == "constant":
            return self.base_rps
        return max(self.base_rps, self.peak_rps)


@dataclasses.dataclass(frozen=True)
class Plane:
    """Topology + the serve-side robustness knobs.

    ``shedding=False`` is the deliberately-broken configuration: the
    replica queue becomes effectively unbounded and deadlines are
    dropped, so overload turns into hang instead of fast rejection —
    the configuration the ``shed_not_hang`` predicate must catch.
    """

    replicas: int = 2
    router: bool = True
    autoscaler: bool = False
    min_replicas: int = 1
    max_replicas: int = 3
    controller: bool = False
    shedding: bool = True
    queue_depth: int = 16
    deadline_ms: float = 2000.0
    tenant_capacity: int = 0
    policies: int = 1
    shm_ingest: bool = True
    image: int = 8
    shapes: str = "1,4,8"
    max_wait_ms: float = 2.0
    # per-dispatch service-time floor (serve_cli --dispatch-floor-ms):
    # emulates a heavy model so flash-crowd scenarios reach REAL
    # overload deterministically (the values were sized on a 1-core CI
    # host; on the card a dispatch is a graph replay far under the
    # floor, so the floor sets the capacity there too).  Capacity per
    # replica ~= (largest padded shape / imgs_per_request) / floor req/s.
    dispatch_floor_ms: float = 0.0
    # autoscaler watermarks (only read when autoscaler=True)
    high_queue: float = 3.0
    high_shed_rate: float = 2.0
    up_polls: int = 2
    down_polls: int = 8
    cooldown_s: float = 4.0
    poll_interval_s: float = 0.3


@dataclasses.dataclass(frozen=True)
class Kill:
    """SIGKILL a live replica mid-scenario.

    ``target`` is a replica tag (``replica0``) or ``"canary"`` — the
    replica named by the first journaled ``canary`` rollout event (the
    armed-split victim).  The kill fires ``delay_s`` after the trigger:
    the named journal event when ``after_event`` is set, else
    ``at_frac`` of the traffic duration.
    """

    target: str = "replica0"
    after_event: str = ""
    after_action: str = ""
    at_frac: float = 0.5
    delay_s: float = 0.5


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    summary: str
    traffic: Traffic
    plane: Plane
    predicates: tuple = ()
    faults: str = ""
    fsfaults: str = ""
    kill: Kill | None = None
    expect: str = "pass"
    seed: int = 20
    # post-traffic settle: how long the runner keeps the plane up after
    # the last offered request (control-plane decisions land here)
    settle_s: float = 2.0
    # when a controller runs, wait (bounded) for its terminal decision
    decision_timeout_s: float = 90.0


def scaled(scn: Scenario, factor: float) -> Scenario:
    """A time/load-shrunk copy for smoke runs: durations and offered
    rates scale by ``factor`` (< 1), topology / faults / predicates
    that are rate-independent stay put.  Goodput-style predicates are
    ratios, so they survive the shrink unchanged."""
    t = scn.traffic
    traffic = dataclasses.replace(
        t, duration_s=max(3.0, t.duration_s * factor),
        base_rps=max(2.0, t.base_rps * factor),
        peak_rps=max(4.0, t.peak_rps * factor),
        rotate_s=max(1.0, t.rotate_s * factor))
    plane = scn.plane
    if plane.dispatch_floor_ms > 0:
        # offered rates shrank by `factor`, so capacity must shrink
        # with them (floor grows by 1/factor) or the overload the
        # scenario exists to drill never materializes in smoke runs
        plane = dataclasses.replace(
            plane, dispatch_floor_ms=min(
                400.0, plane.dispatch_floor_ms / max(factor, 1e-9)))
    return dataclasses.replace(scn, traffic=traffic, plane=plane,
                               settle_s=min(scn.settle_s, 2.0))


# --------------------------------------------------------------------------
# the named game days.  Offered rates were sized for a 1-core CI host
# where the client, every replica, the router and the controller
# time-slice one core; they stay as they are, so a "10x flash" drills
# the CONTROL structure (shed/scale/failover decisions), not datacenter
# throughput, on the card as on that host.
# --------------------------------------------------------------------------

_COMMON_SAFETY = (
    ("no_shm_leak", {}),
)

SCENARIOS: dict[str, Scenario] = {}


def _register(scn: Scenario) -> Scenario:
    SCENARIOS[scn.name] = scn
    return scn


_register(Scenario(
    name="flash-crowd-10x",
    summary="10x offered-load ramp in seconds against an autoscaled "
            "fleet: shedding keeps answers fast while the autoscaler "
            "grows the fleet with journaled evidence",
    traffic=Traffic(kind="flash", duration_s=30.0, base_rps=8.0,
                    peak_rps=80.0, flash_at_frac=0.4, ramp_s=2.0,
                    imgs_per_request=4),
    plane=Plane(replicas=1, router=True, autoscaler=True,
                min_replicas=1, max_replicas=3, shedding=True,
                dispatch_floor_ms=50.0),
    predicates=(
        ("goodput_floor", {"floor": 0.30}),
        ("shed_not_hang", {"max_hung": 0}),
        ("autoscaler_bounds", {"min_replicas": 1, "max_replicas": 3,
                               "require_scale_up": True}),
    ) + _COMMON_SAFETY,
))

_register(Scenario(
    name="cohort-rotation-lru-thrash",
    summary="cohort mix rotating across more tenant policy digests "
            "than the residency LRU holds: cold digests shed as "
            "structured 503s, background warms land, every cohort is "
            "eventually served",
    traffic=Traffic(kind="constant", duration_s=50.0, base_rps=10.0,
                    imgs_per_request=4, tenants=3, rotate_s=6.0,
                    lanes=(("raw", 0.7), ("npz", 0.3))),
    # sized to keep the warm bill bounded: on the card a background
    # tenant warm captures one CUDA graph per padded shape for the
    # policy (its warm-up call each), so the scenario keeps ONE
    # replica, ONE padded shape (every request is exactly
    # imgs_per_request images), and an LRU of ONE beside the pinned
    # default tenant.  The two cold digests then evict each other on
    # every rotation (real churn), and every re-admit pays one capture
    # again (the kernel libraries stay loaded), so the thrash costs a
    # fraction of a second a warm, not a fresh build per admit.
    plane=Plane(replicas=1, router=True, tenant_capacity=1,
                policies=3, shedding=True, shapes="4"),
    predicates=(
        ("goodput_floor", {"floor": 0.25}),
        ("shed_not_hang", {"max_hung": 0}),
        ("tenant_churn", {"min_admits": 3, "min_evicts": 1}),
        ("all_cohorts_served", {}),
    ) + _COMMON_SAFETY,
))

_register(Scenario(
    name="replica-loss-mid-canary",
    summary="SIGKILL the canary replica during an armed split: the "
            "router ejects it, failover keeps clients whole, and the "
            "crash-resumable control loop still reaches a terminal "
            "promote/rollback in order",
    traffic=Traffic(kind="constant", duration_s=35.0, base_rps=10.0,
                    imgs_per_request=4,
                    lanes=(("raw", 0.7), ("npz", 0.3))),
    plane=Plane(replicas=3, router=True, controller=True,
                shedding=True),
    faults="drift@dispatch=30,shift=60",
    kill=Kill(target="canary", after_event="canary",
              after_action="rollout", delay_s=1.0),
    predicates=(
        ("goodput_floor", {"floor": 0.50}),
        ("max_transport_errors", {"max_errors": 0}),
        ("control_decision", {"require_terminal": True}),
        ("rotation_ejected", {}),
    ) + _COMMON_SAFETY,
))

_register(Scenario(
    name="drift-during-flash-crowd",
    summary="distribution drift arriving inside a flash crowd: the "
            "control loop must detect, canary and decide while the "
            "plane sheds overload",
    traffic=Traffic(kind="flash", duration_s=35.0, base_rps=8.0,
                    peak_rps=48.0, flash_at_frac=0.3, ramp_s=2.0,
                    imgs_per_request=4,
                    lanes=(("raw", 0.7), ("npz", 0.3))),
    plane=Plane(replicas=2, router=True, controller=True,
                shedding=True),
    faults="drift@dispatch=40,shift=60",
    predicates=(
        ("goodput_floor", {"floor": 0.30}),
        ("shed_not_hang", {"max_hung": 0}),
        ("control_decision", {"require_terminal": True}),
    ) + _COMMON_SAFETY,
))

_register(Scenario(
    name="stale-fs-under-load",
    summary="shared-FS lag + seeded transient read errors under the "
            "router's replica discovery while live traffic flows: "
            "hysteresis rides through the flaps, goodput holds",
    traffic=Traffic(kind="diurnal", duration_s=30.0, base_rps=6.0,
                    peak_rps=18.0, period_s=10.0, imgs_per_request=4),
    plane=Plane(replicas=2, router=True, shedding=True),
    fsfaults="lag@dir=replicas,secs=0.4;eio@p=0.05,seed=7",
    predicates=(
        ("goodput_floor", {"floor": 0.80}),
        ("max_transport_errors", {"max_errors": 0}),
        ("fsfault_observed", {"min_injections": 1}),
    ) + _COMMON_SAFETY,
))

# the teeth-proof: the same flash crowd against a replica whose
# shedding is disabled (quasi-unbounded queue, no deadlines, no
# autoscaler rescue).  Overload turns into hang; the verdict engine
# MUST fail it — expect="fail" keeps it in the suite as a standing
# demonstration that the predicates can reject a broken plane.
_register(Scenario(
    name="flash-crowd-10x-noshed",
    summary="BROKEN CONFIG (expected FAIL): the flash crowd against a "
            "single replica with shedding disabled — overload hangs "
            "clients instead of shedding, and the verdict engine "
            "must say so",
    traffic=Traffic(kind="flash", duration_s=24.0, base_rps=8.0,
                    peak_rps=80.0, flash_at_frac=0.3, ramp_s=2.0,
                    imgs_per_request=4),
    # heavier floor than the healthy flash scenario: with no shedding,
    # no deadline and no autoscaler rescue the queue wait must blow
    # PAST the client's socket timeout (not hover under it) so the
    # hang is unambiguous in both full and smoke runs
    plane=Plane(replicas=1, router=True, autoscaler=False,
                shedding=False, dispatch_floor_ms=80.0),
    predicates=(
        ("goodput_floor", {"floor": 0.30}),
        ("shed_not_hang", {"max_hung": 0}),
    ) + _COMMON_SAFETY,
    expect="fail",
))


def suite_names() -> list[str]:
    """The full suite, broken-config demonstrations included, in a
    stable order."""
    return list(SCENARIOS)
