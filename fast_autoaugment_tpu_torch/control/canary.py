"""Canary rollout + served-quality comparison + the promotion gate.

Stages three and four of the control loop:

- **Rollout** (:class:`CanaryController`): the candidate policy is
  pushed to a ROUTER-SELECTED replica subset — the replicas ranked
  first by rendezvous hashing the candidate's digest
  (``serve/router.py::rendezvous_order``), so when the candidate is
  later promoted, its affinity traffic lands on replicas already
  graph-warm — via each replica's ``POST /reload``.  The reload response
  echoes the resident digest; a mismatch is
  a hard rollout failure, never a silent wrong-policy canary.  The
  router's ``POST /canary`` admin splits traffic deterministically
  between the arms while the comparison runs.

- **Comparison** (:class:`ReplicaQualityScraper` + :func:`compare_arms`):
  each replica's Prometheus ``/metrics`` carries its served-traffic
  gauges (``faa_serve_reward_proxy`` — the ``--traffic-stats``
  surface) and volume counters; the comparator samples both arms and
  scores each by its QUALITY DISTANCE — ``|reward_proxy - target|``
  where the target is the drift monitor's pre-drift baseline mean —
  plus its per-dispatch error evidence.

- **Gate** (:class:`PromotionGate`): a pure hysteresis state machine
  in the ``AutoscalerPolicy`` mold: after ``gate_polls`` comparison
  polls in which both arms saw fresh traffic, the canary PROMOTES when
  its median quality distance is no worse than baseline's by more than
  ``quality_margin`` AND it produced no new dispatch errors; otherwise
  it ROLLS BACK.  Non-inferiority is deliberate: at canary scale the
  candidate must first prove it does no harm — absolute quality
  recovery is judged by the re-baselined drift monitor after
  promotion.
"""

from __future__ import annotations

import json

from fast_autoaugment_tpu_torch.core import telemetry
from fast_autoaugment_tpu_torch.core.telemetry import mono
from fast_autoaugment_tpu_torch.serve.autoscaler import parse_prometheus_text
from fast_autoaugment_tpu_torch.serve.router import rendezvous_order
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["select_canary_replicas", "ReplicaQualityScraper",
           "compare_arms", "PromotionGate", "CanaryController"]

logger = get_logger("faa_torch.control.canary")


def select_canary_replicas(candidate_digest: str, tags: list[str],
                           n_canary: int) -> list[str]:
    """The router-selected canary subset: the first `n_canary` replicas
    in rendezvous order for the CANDIDATE's digest — deterministic
    across every control-plane instance, and exactly the replicas the
    promoted policy's affinity traffic will land on (already warm).
    At least one replica always stays baseline."""
    tags = sorted(set(str(t) for t in tags))
    if len(tags) < 2:
        raise ValueError(
            f"canary rollout needs >= 2 replicas (one must stay "
            f"baseline), got {tags}")
    n = max(1, min(int(n_canary), len(tags) - 1))
    return rendezvous_order(str(candidate_digest), tags)[:n]


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    if n == 0:
        return None
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


class ReplicaQualityScraper:
    """Per-replica quality sample from the Prometheus surface.

    One ``sample(replicas)`` returns, per tag: the served-traffic
    gauges (reward proxy / input moments), cumulative dispatch and
    breaker-fire counts, and the DELTAS since this scraper's previous
    sample — fresh-traffic evidence the gate requires before judging
    an arm (a canary nobody hit proves nothing)."""

    TRAFFIC_GAUGES = ("faa_serve_reward_proxy", "faa_serve_input_mean",
                      "faa_serve_input_std")
    DISPATCHES = "faa_serve_dispatches_total"
    BREAKER_FIRES = "faa_breaker_fires_total"

    def __init__(self, timeout_s: float = 2.0):
        self.timeout_s = float(timeout_s)
        self._prev: dict[str, dict] = {}

    def _scrape_one(self, host: str, port: int) -> str | None:
        import http.client

        try:
            conn = http.client.HTTPConnection(host, port,
                                              timeout=self.timeout_s)
            try:
                conn.request("GET", "/metrics")
                resp = conn.getresponse()
                body = resp.read()
                return body.decode() if resp.status == 200 else None
            finally:
                conn.close()
        except OSError:
            return None

    def sample(self, replicas: list[dict]) -> dict[str, dict]:
        """`replicas`: ``[{tag, host, port}, ...]`` (the port-dir
        census).  Returns ``{tag: row}`` with unreachable replicas
        marked — the gate treats missing arms as not-yet-judgeable."""
        out: dict[str, dict] = {}
        for rec in replicas:
            tag = str(rec["tag"])
            text = self._scrape_one(rec["host"], rec["port"])
            if text is None:
                out[tag] = {"reachable": False}
                continue
            fams = parse_prometheus_text(text)

            def _first(name: str):
                vals = fams.get(name, [])
                return vals[0][1] if vals else None

            row: dict = {"reachable": True}
            for g in self.TRAFFIC_GAUGES:
                short = g[len("faa_serve_"):]
                row[short] = _first(g)
            row["dispatches"] = sum(v for _l, v
                                    in fams.get(self.DISPATCHES, []))
            row["breaker_fires"] = sum(v for _l, v
                                       in fams.get(self.BREAKER_FIRES, []))
            prev = self._prev.get(tag, {})
            row["new_dispatches"] = max(
                0.0, row["dispatches"] - prev.get("dispatches", 0.0))
            row["new_breaker_fires"] = max(
                0.0, row["breaker_fires"] - prev.get("breaker_fires", 0.0))
            self._prev[tag] = row
            out[tag] = row
        return out


def compare_arms(samples: dict[str, dict], canary_tags: list[str],
                 target: float) -> dict:
    """One comparison poll's evidence: per-arm median quality distance
    ``|reward_proxy - target|``, fresh-traffic counts, and new error
    counts.  Pure — no I/O, no clocks."""
    canary_set = set(canary_tags)

    def arm_rows(in_canary: bool):
        return [r for t, r in samples.items()
                if r.get("reachable")
                and (t in canary_set) == in_canary
                and r.get("reward_proxy") is not None]

    def arm_summary(rows):
        return {
            "replicas": len(rows),
            "quality_distance": _median(
                [abs(float(r["reward_proxy"]) - target) for r in rows]),
            "reward_proxy": _median(
                [float(r["reward_proxy"]) for r in rows]),
            "new_dispatches": sum(r.get("new_dispatches", 0.0)
                                  for r in rows),
            "new_errors": sum(r.get("new_breaker_fires", 0.0)
                              for r in rows),
        }

    canary = arm_summary(arm_rows(True))
    baseline = arm_summary(arm_rows(False))
    delta = (None if canary["quality_distance"] is None
             or baseline["quality_distance"] is None
             else canary["quality_distance"] - baseline["quality_distance"])
    return {"canary": canary, "baseline": baseline, "target": target,
            "quality_delta": delta}


class PromotionGate:
    """The pure promote/rollback decision (hysteresis + evidence
    bounds, the ``AutoscalerPolicy`` discipline).

    Feed one :func:`compare_arms` evidence dict per poll; after
    `gate_polls` JUDGEABLE polls (both arms reachable with >=
    `min_arm_dispatches` fresh dispatches) the gate answers
    ``("promote"| "rollback", reason, evidence)``.  Any poll with new
    canary errors rolls back IMMEDIATELY — a broken candidate must not
    keep serving canary traffic for the rest of the window."""

    def __init__(self, *, gate_polls: int = 3,
                 quality_margin: float = 0.05,
                 min_arm_dispatches: float = 1.0,
                 timeout_polls: int = 50):
        self.gate_polls = max(1, int(gate_polls))
        self.quality_margin = float(quality_margin)
        self.min_arm_dispatches = float(min_arm_dispatches)
        self.timeout_polls = max(self.gate_polls, int(timeout_polls))
        self._window: list[dict] = []
        self._polls = 0

    def reset(self) -> None:
        self._window = []
        self._polls = 0

    def decide(self, evidence: dict) -> tuple[str | None, str, dict]:
        """One poll's verdict: ``(action, reason, summary)`` with
        action None while the window is still filling."""
        self._polls += 1
        canary, base = evidence["canary"], evidence["baseline"]
        if canary.get("new_errors", 0) > 0:
            return "rollback", (
                f"canary produced {canary['new_errors']:g} new dispatch "
                f"error(s) — immediate rollback"), self._summary(evidence)
        judgeable = (
            evidence.get("quality_delta") is not None
            and canary.get("new_dispatches", 0) >= self.min_arm_dispatches
            and base.get("new_dispatches", 0) >= self.min_arm_dispatches)
        if judgeable:
            self._window.append(evidence)
        if len(self._window) >= self.gate_polls:
            deltas = [e["quality_delta"] for e in self._window]
            med = _median(deltas)
            summary = self._summary(evidence, med)
            if med <= self.quality_margin:
                return "promote", (
                    f"median quality delta {med:+.6f} within margin "
                    f"{self.quality_margin} over {len(self._window)} "
                    f"judgeable poll(s)"), summary
            return "rollback", (
                f"median quality delta {med:+.6f} exceeds margin "
                f"{self.quality_margin} over {len(self._window)} "
                f"judgeable poll(s)"), summary
        if self._polls >= self.timeout_polls:
            return "rollback", (
                f"gate window never filled ({len(self._window)}/"
                f"{self.gate_polls} judgeable polls in "
                f"{self._polls}) — canary starved of traffic"), \
                self._summary(evidence)
        return None, (f"observing ({len(self._window)}/"
                      f"{self.gate_polls} judgeable polls)"), {}

    def _summary(self, last: dict, med=None) -> dict:
        return {
            "judgeable_polls": len(self._window),
            "total_polls": self._polls,
            "median_quality_delta": med,
            "quality_margin": self.quality_margin,
            "last": last,
        }

    def snapshot(self) -> dict:
        return {
            "gate_polls": self.gate_polls,
            "quality_margin": self.quality_margin,
            "min_arm_dispatches": self.min_arm_dispatches,
            "judgeable_polls": len(self._window),
            "total_polls": self._polls,
        }


class CanaryController:
    """HTTP actuation of rollout / promote / rollback against the
    replica fleet (the port-dir census) and, optionally, the router's
    canary-split admin.

    `reload_fn(host, port, policy_path)` defaults to a real ``POST
    /reload``; tests inject a stub.  Every reload's echoed digest is
    verified against the expected one — the canary comparator must
    never compare against a replica that silently kept the old
    policy."""

    def __init__(self, replicas_fn, *, router_url: str | None = None,
                 reload_fn=None, timeout_s: float = 120.0,
                 name: str = "control"):
        self.replicas_fn = replicas_fn
        self.router_url = router_url
        self.reload_fn = reload_fn or self._http_reload
        self.timeout_s = float(timeout_s)
        self.name = str(name)

    # ------------------------------------------------------------ HTTP

    def _http_reload(self, host: str, port: int, policy_path: str) -> dict:
        import http.client

        body = json.dumps({"policy": policy_path}).encode()
        conn = http.client.HTTPConnection(host, port,
                                          timeout=self.timeout_s)
        try:
            conn.request("POST", "/reload", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    f"reload on {host}:{port} answered {resp.status}: "
                    f"{data[:200]!r}")
            return json.loads(data)
        finally:
            conn.close()

    def _router_canary(self, payload: dict) -> dict | None:
        """POST the split admin; returns the router's parsed echo
        (``{"canary": {...}}``) or None when no router is configured."""
        if not self.router_url:
            return None
        import http.client
        from urllib.parse import urlsplit

        parts = urlsplit(self.router_url if "//" in self.router_url
                         else f"http://{self.router_url}")
        body = json.dumps(payload).encode()
        conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                          timeout=self.timeout_s)
        try:
            conn.request("POST", "/canary", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    f"router canary admin answered {resp.status}: "
                    f"{data[:200]!r}")
            try:
                return json.loads(data)
            except ValueError:
                return None
        finally:
            conn.close()

    # ------------------------------------------------------- actuation

    def _reload_verified(self, rec: dict, policy_path: str,
                         expect_digest: str) -> dict:
        info = self.reload_fn(rec["host"], rec["port"], policy_path)
        echoed = info.get("digest")
        if echoed != expect_digest:
            raise RuntimeError(
                f"replica {rec['tag']} reloaded but echoed digest "
                f"{echoed!r} != expected {expect_digest!r} — refusing "
                "to canary an unverified policy")
        return info

    def rollout(self, policy_path: str, expect_digest: str, *,
                n_canary: int = 1, split_every: int = 2) -> dict:
        """Push the candidate to the router-selected subset and arm the
        traffic split.  Returns ``{"canary": tags, "baseline": tags,
        "replicas": census}``; raises on any verification failure
        (nothing is half-rolled-out: a failed replica aborts before
        the split arms)."""
        census = {str(r["tag"]): r for r in self.replicas_fn()}
        canary_tags = select_canary_replicas(
            expect_digest, list(census), n_canary)
        baseline_tags = sorted(t for t in census if t not in canary_tags)
        t0 = mono()
        for tag in canary_tags:
            info = self._reload_verified(census[tag], policy_path,
                                         expect_digest)
            telemetry.emit("canary", self.name, action="rollout",
                           replica=tag, digest=expect_digest,
                           policy=policy_path,
                           warm_sec=info.get("warm_sec"))
        self._router_canary({"digest": expect_digest,
                             "replicas": canary_tags,
                             "every": split_every})
        logger.info("canary rollout: %s on %s (baseline %s) in %.2fs",
                    expect_digest, canary_tags, baseline_tags,
                    mono() - t0)
        return {"canary": canary_tags, "baseline": baseline_tags,
                "replicas": census}

    def assert_split(self, expect_digest: str, canary_tags: list[str],
                     split_every: int = 2) -> None:
        """Idempotently RE-ASSERT the canary split (called on every
        gate poll): ``POST /canary`` replaces any current split, so a
        router that restarted mid-canary — which would otherwise route
        100%% baseline while the gate kept scoring a phantom canary arm
        — is re-armed within one poll.  The router's echo is verified;
        a digest mismatch (another controller armed a DIFFERENT split)
        raises rather than letting two control planes fight."""
        echo = self._router_canary({"digest": expect_digest,
                                    "replicas": list(canary_tags),
                                    "every": int(split_every)})
        if echo is None:
            return  # no router configured: replica-count split only
        armed = (echo.get("canary") or {})
        if armed.get("digest") != expect_digest:
            raise RuntimeError(
                f"router canary echo mismatch: armed digest "
                f"{armed.get('digest')!r} != expected {expect_digest!r} "
                "— refusing to score a split this controller does not "
                "own")

    def promote(self, policy_path: str, expect_digest: str,
                census: dict, canary_tags: list[str]) -> None:
        """Fleet-wide reload of the candidate (canaries already hold
        it — their reload is an idempotent digest re-verify) and clear
        the split."""
        for tag in sorted(census):
            if tag in canary_tags:
                continue
            self._reload_verified(census[tag], policy_path, expect_digest)
        self._router_canary({"clear": True})

    def rollback(self, baseline_policy: str, baseline_digest: str,
                 census: dict, canary_tags: list[str]) -> None:
        """Reload the BASELINE policy back onto the canary subset and
        clear the split."""
        for tag in canary_tags:
            self._reload_verified(census[tag], baseline_policy,
                                  baseline_digest)
        self._router_canary({"clear": True})
