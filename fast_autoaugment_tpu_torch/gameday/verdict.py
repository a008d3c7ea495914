"""Journal-driven pass/fail verdicts for game-day scenarios: the port's
copy of ``fast_autoaugment_tpu/gameday/verdict.py``, the same catalog,
rows and table.

Every predicate is a pure function over an **evidence** dict — the
workload replay report, the run's telemetry journal records, and the
router's scraped stats — and returns a :class:`VerdictRow` with the
observed values INLINE so a failing verdict is self-explaining.
Nothing here talks to a live process: verdicts are recomputable after
the fact from the journal dir alone (the same files ``make status``
and ``make trace`` read), which is what makes them evidence rather
than vibes.

Evidence keys (the runner assembles them; synthetic dicts work too —
the unit tests exercise every predicate without a plane):

- ``report`` — ``WorkloadReport.to_dict()`` (client-side truth);
- ``journal`` — list of telemetry journal records (dicts) from the
  scenario's run dir, time-ordered;
- ``router_stats`` — the router's ``/stats`` JSON, or None;
- ``killed`` — the SIGKILLed replica tag, or None;
- ``tenants`` — cohort digest count offered by the workload.

The catalog (``PREDICATES``) is the extension point documented in
docs/GAMEDAYS.md: a new game day composes existing predicates or
registers a new name here.
"""

from __future__ import annotations

import dataclasses

__all__ = ["VerdictRow", "PREDICATES", "evaluate", "render_table"]


@dataclasses.dataclass
class VerdictRow:
    predicate: str
    ok: bool
    observed: dict
    bound: dict
    detail: str = ""

    def to_dict(self) -> dict:
        return {"predicate": self.predicate, "ok": self.ok,
                "observed": self.observed, "bound": self.bound,
                "detail": self.detail}


def _events(evidence: dict, etype: str, **match) -> list[dict]:
    out = []
    for rec in evidence.get("journal") or []:
        if rec.get("type") != etype:
            continue
        if all(rec.get(k) == v for k, v in match.items()):
            out.append(rec)
    out.sort(key=lambda r: r.get("t_wall") or 0)
    return out


# ------------------------------------------------------------ catalog


def goodput_floor(evidence: dict, *, floor: float) -> VerdictRow:
    """Served-OK over offered stays at or above ``floor`` — the
    load-shaped SLO.  Offered is the SCHEDULE's count (open loop), so
    a hung plane cannot pass by suppressing its own denominator."""
    rep = evidence["report"]
    goodput = (rep["ok"] / rep["offered"]) if rep["offered"] else 0.0
    return VerdictRow(
        "goodput_floor", goodput >= floor,
        {"goodput": round(goodput, 4), "ok": rep["ok"],
         "offered": rep["offered"]},
        {"floor": floor})


def shed_not_hang(evidence: dict, *, max_hung: int = 0,
                  p99_ms_ok: float | None = None) -> VerdictRow:
    """Overload must answer FAST NOs, never silence: every non-served
    request is an explicit structured rejection; transport errors and
    client timeouts (= hangs) stay within ``max_hung``; optionally the
    admitted p99 stays under ``p99_ms_ok``."""
    rep = evidence["report"]
    hung = rep["transport_errors"]
    unexpected = rep["unexpected_status"]
    ok = hung <= max_hung and unexpected == 0
    observed = {"hung": hung, "unexpected_status": unexpected,
                "shed": rep["shed"], "p99_ms_ok": rep.get("p99_ms_ok")}
    bound = {"max_hung": max_hung}
    if p99_ms_ok is not None:
        bound["p99_ms_ok"] = p99_ms_ok
        ok = ok and (rep.get("p99_ms_ok") or 0.0) <= p99_ms_ok
    return VerdictRow("shed_not_hang", ok, observed, bound,
                      detail="" if ok else
                      "requests hung or died instead of shedding")


def max_transport_errors(evidence: dict, *,
                         max_errors: int = 0) -> VerdictRow:
    """Zero dropped in-flight: every offered request got an HTTP
    answer (200 or a structured rejection) — failover and graceful
    drain must hide replica churn from clients."""
    rep = evidence["report"]
    n = rep["transport_errors"]
    return VerdictRow(
        "max_transport_errors", n <= max_errors,
        {"transport_errors": n,
         "errors_sample": rep.get("errors_sample") or []},
        {"max_errors": max_errors})


def affinity_floor(evidence: dict, *, floor: float) -> VerdictRow:
    """Router digest-affinity hit rate stays at or above ``floor``
    (from the router's own ``/stats`` accounting)."""
    stats = evidence.get("router_stats") or {}
    aff = (stats.get("affinity") or {})
    rate = aff.get("hit_rate")
    ok = rate is not None and rate >= floor
    return VerdictRow("affinity_floor", ok,
                      {"hit_rate": rate, "hits": aff.get("hits"),
                       "misses": aff.get("misses")},
                      {"floor": floor})


def autoscaler_bounds(evidence: dict, *, min_replicas: int,
                      max_replicas: int,
                      require_scale_up: bool = False,
                      max_actions: int = 8) -> VerdictRow:
    """Every journaled scale decision lands inside the configured
    fleet bounds, the loop does not flap past ``max_actions``, and —
    for flash scenarios — at least one ``scale_up`` actually fired."""
    ups = _events(evidence, "scale_up")
    downs = _events(evidence, "scale_down")
    after = [e.get("replicas_after") for e in ups + downs
             if e.get("replicas_after") is not None]
    in_bounds = all(min_replicas <= int(n) <= max_replicas
                    for n in after)
    ok = in_bounds and len(ups) + len(downs) <= max_actions
    if require_scale_up:
        ok = ok and len(ups) >= 1
    return VerdictRow(
        "autoscaler_bounds", ok,
        {"scale_ups": len(ups), "scale_downs": len(downs),
         "replicas_after": after},
        {"min_replicas": min_replicas, "max_replicas": max_replicas,
         "require_scale_up": require_scale_up,
         "max_actions": max_actions})


def control_decision(evidence: dict, *,
                     require_terminal: bool = True) -> VerdictRow:
    """The control loop's causal order holds: drift detected before
    the canary rollout, rollout before the terminal promote/rollback,
    and (when required) a terminal decision exists at all."""
    drifts = _events(evidence, "drift")
    rollouts = _events(evidence, "canary", action="rollout")
    terminals = (_events(evidence, "promote")
                 + _events(evidence, "rollback"))
    terminals.sort(key=lambda r: r.get("t_wall") or 0)
    ordered = True
    if drifts and rollouts:
        ordered &= drifts[0]["t_wall"] <= rollouts[0]["t_wall"]
    if rollouts and terminals:
        ordered &= rollouts[0]["t_wall"] <= terminals[-1]["t_wall"]
    ok = ordered and bool(drifts)
    if require_terminal:
        ok = ok and bool(terminals) and bool(rollouts)
    decision = terminals[-1]["type"] if terminals else None
    return VerdictRow(
        "control_decision", ok,
        {"drifts": len(drifts), "rollouts": len(rollouts),
         "decision": decision, "ordered": ordered},
        {"require_terminal": require_terminal},
        detail="" if ok else "missing or out-of-order control events")


def rotation_ejected(evidence: dict, *, tag: str | None = None
                     ) -> VerdictRow:
    """The router journaled an eject for the killed replica (the
    membership evidence must not vanish with the process)."""
    tag = tag or evidence.get("killed")
    ejects = [e for e in _events(evidence, "rotation")
              if e.get("action") == "eject"
              and (tag is None or str(e.get("replica")) == str(tag))]
    return VerdictRow("rotation_ejected", bool(ejects),
                      {"ejects": len(ejects), "replica": tag},
                      {"min_ejects": 1})


def tenant_churn(evidence: dict, *, min_admits: int,
                 min_evicts: int) -> VerdictRow:
    """The residency LRU actually thrashed: cohort rotation produced
    at least ``min_admits`` tenant admits and ``min_evicts`` evicts."""
    admits = [e for e in _events(evidence, "tenant")
              if e.get("action") == "admit"]
    evicts = [e for e in _events(evidence, "tenant")
              if e.get("action") == "evict"]
    ok = len(admits) >= min_admits and len(evicts) >= min_evicts
    return VerdictRow("tenant_churn", ok,
                      {"admits": len(admits), "evicts": len(evicts)},
                      {"min_admits": min_admits,
                       "min_evicts": min_evicts})


def all_cohorts_served(evidence: dict, *, min_ok: int = 1) -> VerdictRow:
    """Every offered cohort eventually got served — cold-tenant 503s
    are allowed (they are sheds), starvation of a whole cohort is
    not."""
    rep = evidence["report"]
    tenants = int(evidence.get("tenants") or 1)
    by_tenant = rep.get("ok_by_tenant") or {}
    starved = [t for t in range(tenants)
               if by_tenant.get(str(t), 0) < min_ok]
    return VerdictRow("all_cohorts_served", not starved,
                      {"ok_by_tenant": by_tenant, "starved": starved},
                      {"tenants": tenants, "min_ok": min_ok})


def fsfault_observed(evidence: dict, *,
                     min_injections: int = 1) -> VerdictRow:
    """The FSFAULT seam actually injected (proof the scenario drilled
    what it claims: surviving faults that never fired proves
    nothing)."""
    n = len(_events(evidence, "fsfault"))
    return VerdictRow("fsfault_observed", n >= min_injections,
                      {"injections": n},
                      {"min_injections": min_injections})


def no_shm_leak(evidence: dict) -> VerdictRow:
    """Every shm region the workload created is gone from /dev/shm by
    scenario end — a flash crowd must not leak segments."""
    rep = evidence["report"]
    leftover = rep.get("shm_leftover") or []
    return VerdictRow("no_shm_leak", not leftover,
                      {"created": rep.get("shm_created", 0),
                       "leftover": leftover},
                      {"max_leftover": 0})


PREDICATES = {
    "goodput_floor": goodput_floor,
    "shed_not_hang": shed_not_hang,
    "max_transport_errors": max_transport_errors,
    "affinity_floor": affinity_floor,
    "autoscaler_bounds": autoscaler_bounds,
    "control_decision": control_decision,
    "rotation_ejected": rotation_ejected,
    "tenant_churn": tenant_churn,
    "all_cohorts_served": all_cohorts_served,
    "fsfault_observed": fsfault_observed,
    "no_shm_leak": no_shm_leak,
}


def evaluate(scenario, evidence: dict, *,
             schedule_digest: str | None = None) -> dict:
    """All of one scenario's predicates over one run's evidence.

    Returns the verdict record: per-predicate rows, the scenario-level
    ``pass`` (every predicate ok), and ``ok_as_expected`` — whether
    the verdict matches the spec's ``expect`` (a broken-config
    scenario is SUPPOSED to fail; the suite is green only when every
    verdict matches its expectation)."""
    rows = []
    for name, params in scenario.predicates:
        fn = PREDICATES.get(name)
        if fn is None:
            rows.append(VerdictRow(name, False, {},
                                   {"error": "unknown predicate"}))
            continue
        try:
            rows.append(fn(evidence, **params))
        except (KeyError, TypeError, ValueError) as e:
            rows.append(VerdictRow(
                name, False, {"error": f"{type(e).__name__}: {e}"},
                dict(params), detail="predicate crashed"))
    passed = all(r.ok for r in rows)
    return {
        "scenario": scenario.name,
        "seed": scenario.seed,
        "schedule_digest": schedule_digest,
        "predicates": [r.to_dict() for r in rows],
        "pass": passed,
        "expect": scenario.expect,
        "ok_as_expected": passed == (scenario.expect == "pass"),
        "report": evidence.get("report"),
    }


def render_table(records: list[dict]) -> str:
    """The human verdict table (one line per scenario + per-predicate
    detail lines for anything that failed unexpectedly)."""
    rows = [["scenario", "verdict", "expected", "goodput", "hung",
             "digest"]]
    for rec in records:
        rep = rec.get("report") or {}
        verdict = "PASS" if rec["pass"] else "FAIL"
        if rec["expect"] == "fail":
            verdict += " (expected-fail)" if not rec["pass"] \
                else " (!! expected FAIL)"
        elif not rec["pass"]:
            verdict += " (!!)"
        rows.append([
            rec["scenario"], verdict, rec["expect"],
            str(rep.get("goodput")), str(rep.get("transport_errors")),
            str(rec.get("schedule_digest"))])
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    lines.insert(1, "  ".join("-" * w for w in widths))
    for rec in records:
        for row in rec["predicates"]:
            mark = "ok" if row["ok"] else "FAIL"
            if not row["ok"] or rec["expect"] == "fail":
                lines.append(
                    f"  {rec['scenario']} :: {row['predicate']}: "
                    f"{mark}  observed={row['observed']} "
                    f"bound={row['bound']}")
    suite_ok = all(r["ok_as_expected"] for r in records)
    lines.append(f"suite: {'GREEN' if suite_ok else 'RED'} "
                 f"({sum(1 for r in records if r['ok_as_expected'])}"
                 f"/{len(records)} verdicts as expected)")
    return "\n".join(lines)
