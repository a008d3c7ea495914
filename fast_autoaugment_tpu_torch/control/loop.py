"""The closed control loop: drift -> re-search -> canary -> promote.

One journaled state machine binding the four stages
this package provides:

1. **watching** — :class:`~fast_autoaugment_tpu_torch.control.drift.
   DriftMonitor` tails the serving fleet's journal; a tripped CUSUM
   emits the typed ``drift`` event and moves the loop on.
2. **research** — `research_fn(verdict)` produces a candidate
   ``final_policy.json`` (+ provenance sidecar).  The production
   implementation is the warm-started top-up search
   (``control/research.py``); drills inject a stub.  A research
   failure journals the error and returns to watching (the fleet keeps
   serving the baseline — reacting to drift must never break serving).
3. **canary** — :class:`~fast_autoaugment_tpu_torch.control.canary.
   CanaryController` pushes the candidate to the rendezvous-selected
   replica subset (digest-verified reloads) and arms the router's
   deterministic traffic split.
4. **observing/gate** — each poll samples both arms' Prometheus
   metrics, feeds :class:`~fast_autoaugment_tpu_torch.control.canary.
   PromotionGate`, and on a verdict PROMOTES fleet-wide or ROLLS the
   canaries back — the decision journaled as a typed ``promote`` /
   ``rollback`` event with the comparison evidence INLINE, exactly
   like the autoscaler's scale events.  Either way the drift
   monitor re-baselines: the post-decision traffic is the new normal.

The loop lives only in the process that runs it (``control_cli``) —
trainers, searchers and replicas are untouched, so "control loop off"
is the historical stream by construction.
"""

from __future__ import annotations

import threading

from fast_autoaugment_tpu_torch.core import telemetry
from fast_autoaugment_tpu_torch.core.telemetry import mono
from fast_autoaugment_tpu_torch.utils.logging import get_logger

from fast_autoaugment_tpu_torch.control.canary import (
    CanaryController,
    PromotionGate,
    ReplicaQualityScraper,
    compare_arms,
)
from fast_autoaugment_tpu_torch.control.drift import DriftMonitor

__all__ = ["ControlLoop"]

logger = get_logger("faa_torch.control.loop")


class ControlLoop:
    """The journaled drift->promote loop (one ``step()`` per poll).

    `research_fn(verdict) -> {"policy": path, "provenance": dict}`
    owns stage two; everything else is wired here.  `baseline_policy`
    / `baseline_digest` are the rollback target — refreshed on every
    promotion (the promoted candidate becomes the next baseline)."""

    def __init__(self, monitor: DriftMonitor, research_fn,
                 canary_ctl: CanaryController, gate: PromotionGate,
                 scraper: ReplicaQualityScraper, *,
                 baseline_policy: str, baseline_digest: str,
                 n_canary: int = 1, split_every: int = 2,
                 poll_interval_s: float = 1.0, name: str = "control"):
        self.monitor = monitor
        self.research_fn = research_fn
        self.canary_ctl = canary_ctl
        self.gate = gate
        self.scraper = scraper
        self.baseline_policy = str(baseline_policy)
        self.baseline_digest = str(baseline_digest)
        self.n_canary = max(1, int(n_canary))
        self.split_every = max(1, int(split_every))
        self.poll_interval_s = float(poll_interval_s)
        self.name = str(name)
        self.state = "watching"
        self._episode: dict | None = None
        #: a reconstructed episode handed in by resume(); adopted by
        #: the NEXT step() so loop state stays single-writer (the
        #: poll thread) — see control/resume.py
        self._pending_resume: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        reg = telemetry.registry()
        self._decision_ctr = {a: reg.counter(
            "faa_control_decisions_total",
            "control-loop gate decisions by action",
            action=a, loop=self.name) for a in ("promote", "rollback")}
        self._episode_ctr = reg.counter(
            "faa_control_episodes_total",
            "drift episodes the loop has entered", loop=self.name)

    # ------------------------------------------------------ the stages

    def _quality_target(self) -> float:
        """The comparator's quality target: the drift monitor's frozen
        PRE-drift reward-proxy baseline (what 'back to baseline
        quality' means), falling back to the episode's first baseline-
        arm observation when the proxy was not a watched metric."""
        det = self.monitor.stats()["detectors"].get("reward_proxy")
        if det and det.get("baseline_mean") is not None:
            return float(det["baseline_mean"])
        return float((self._episode or {}).get("fallback_target") or 0.0)

    def _enter_research(self, verdict: dict) -> None:
        self._episode_ctr.inc()
        self._episode = {"verdict": verdict, "t_detect": mono()}
        self.state = "research"

    def _run_research(self) -> None:
        ep = self._episode
        t0 = mono()
        try:
            candidate = self.research_fn(ep["verdict"])
        except Exception as e:  # noqa: BLE001 — journaled, loop survives
            logger.error("re-search FAILED (%s: %s) — returning to "
                         "watching; the fleet keeps serving the "
                         "baseline", type(e).__name__, e)
            telemetry.emit("mark", self.name, event="research_failed",
                           error=f"{type(e).__name__}: {e}",
                           drift_id=ep["verdict"].get("id"))
            self._finish_episode(rebaseline=False)
            return
        prov = candidate.get("provenance") or {}
        digest = prov.get("policy_digest")
        if not digest:
            from fast_autoaugment_tpu_torch.control.research import (
                policy_file_digest,
            )

            digest = policy_file_digest(candidate["policy"])
        ep.update(candidate=candidate["policy"], digest=digest,
                  provenance=prov, t_candidate=mono())
        # the loop journals the stage transition regardless of HOW the
        # candidate was produced (in-process warm start, a search_cli
        # subprocess, a drill's pre-built policy)
        telemetry.emit("research", self.name,
                       candidate=candidate["policy"], digest=digest,
                       topup_trials=prov.get("topup_trials"),
                       base_dir=prov.get("base_dir"),
                       wall_sec=round(mono() - t0, 3),
                       drift_id=ep["verdict"].get("id"))
        if digest == self.baseline_digest:
            # the re-search reproduced the serving policy (no-drift
            # degenerate case, or the drift was not policy-addressable)
            logger.info("re-search candidate == baseline policy (%s) — "
                        "nothing to canary; re-baselining the monitor",
                        digest)
            telemetry.emit("mark", self.name,
                           event="candidate_is_baseline", digest=digest,
                           drift_id=ep["verdict"].get("id"))
            self._finish_episode(rebaseline=True)
            return
        self.state = "canary"

    def _run_canary_rollout(self) -> None:
        ep = self._episode
        try:
            arms = self.canary_ctl.rollout(
                ep["candidate"], ep["digest"],
                n_canary=self.n_canary, split_every=self.split_every)
        except Exception as e:  # noqa: BLE001 — journaled, loop survives
            logger.error("canary rollout FAILED (%s: %s) — rolling the "
                         "subset back to the baseline",
                         type(e).__name__, e)
            telemetry.emit("mark", self.name, event="rollout_failed",
                           error=f"{type(e).__name__}: {e}",
                           digest=ep.get("digest"))
            self._rollback(reason=f"rollout failed: {e}", evidence={})
            return
        ep.update(arms=arms, t_canary=mono())
        self.gate.reset()
        self.state = "observing"

    def _run_observe(self) -> None:
        ep = self._episode
        # RE-ASSERT the canary split every poll (idempotent POST
        # /canary with echo verification): a router that restarted
        # mid-canary silently routes 100% baseline while the gate
        # keeps scoring a canary arm that no longer exists — one poll
        # later the split is re-armed.  An echo mismatch (a split this
        # controller does not own) rolls back instead of fighting.
        try:
            self.canary_ctl.assert_split(ep["digest"],
                                         ep["arms"]["canary"],
                                         self.split_every)
        except Exception as e:  # noqa: BLE001 — journaled, loop survives
            logger.error("canary split re-assert FAILED (%s: %s) — "
                         "rolling the subset back", type(e).__name__, e)
            telemetry.emit("mark", self.name, event="split_reassert_failed",
                           error=f"{type(e).__name__}: {e}",
                           digest=ep.get("digest"))
            self._rollback(reason=f"canary split re-assert failed: {e}",
                           evidence={})
            return
        census = {str(r["tag"]): r for r in self.canary_ctl.replicas_fn()}
        samples = self.scraper.sample(list(census.values()))
        if "fallback_target" not in ep:
            base_rows = [r for t, r in samples.items()
                         if t not in set(ep["arms"]["canary"])
                         and r.get("reward_proxy") is not None]
            if base_rows:
                ep["fallback_target"] = float(
                    base_rows[0]["reward_proxy"])
        evidence = compare_arms(samples, ep["arms"]["canary"],
                                self._quality_target())
        action, reason, summary = self.gate.decide(evidence)
        if action is None:
            return
        ep["census"] = census
        if action == "promote":
            self._promote(reason, summary)
        else:
            self._rollback(reason=reason, evidence=summary)

    def _promote(self, reason: str, evidence: dict) -> None:
        ep = self._episode
        self.canary_ctl.promote(ep["candidate"], ep["digest"],
                                ep.get("census", {}),
                                ep["arms"]["canary"])
        self._decision_ctr["promote"].inc()
        telemetry.emit(
            "promote", self.name, digest=ep["digest"],
            policy=ep["candidate"], reason=reason,
            drift_id=ep["verdict"].get("id"),
            canary=ep["arms"]["canary"],
            detect_to_promote_sec=round(mono() - ep["t_detect"], 3),
            evidence=evidence)
        logger.warning("PROMOTED %s fleet-wide (%s)", ep["digest"],
                       reason)
        # the promoted candidate is the new baseline for the next
        # episode's rollback target
        self.baseline_policy = ep["candidate"]
        self.baseline_digest = ep["digest"]
        self._finish_episode(rebaseline=True)

    def _rollback(self, *, reason: str, evidence: dict) -> None:
        ep = self._episode
        try:
            self.canary_ctl.rollback(
                self.baseline_policy, self.baseline_digest,
                ep.get("census") or {
                    str(r["tag"]): r for r in self.canary_ctl.replicas_fn()},
                (ep.get("arms") or {}).get("canary", []))
        except Exception as e:  # noqa: BLE001 — journaled, loop survives
            logger.error("rollback actuation failed (%s: %s) — replicas "
                         "may need operator attention",
                         type(e).__name__, e)
        self._decision_ctr["rollback"].inc()
        telemetry.emit(
            "rollback", self.name, digest=ep.get("digest"),
            baseline_digest=self.baseline_digest, reason=reason,
            drift_id=ep["verdict"].get("id"),
            canary=(ep.get("arms") or {}).get("canary", []),
            evidence=evidence)
        logger.warning("ROLLED BACK canary %s (%s)", ep.get("digest"),
                       reason)
        self._finish_episode(rebaseline=True)

    def _finish_episode(self, *, rebaseline: bool) -> None:
        if rebaseline:
            # the post-decision traffic is the new normal: the monitor
            # re-learns its baseline instead of re-tripping forever on
            # a shift the loop already handled
            self.monitor.rebaseline()
        self._episode = None
        self.state = "watching"

    # ---------------------------------------------------------- resume

    def resume(self, episode: dict) -> str:
        """Schedule a reconstructed in-flight episode for adoption
        (``control_cli --resume`` after a controller crash —
        ``control/resume.py`` rebuilt it from the journal WAL).  The
        NEXT step() adopts it, so the poll thread stays the only
        writer of loop state.

        Stages re-enter IDEMPOTENTLY: a ``research``-stage episode
        re-runs the re-search from the journaled verdict; a ``canary``/
        ``observing``-stage episode re-enters at the ROLLOUT — every
        reload is a digest-echoing re-verify and ``POST /canary``
        replaces any dangling split, so replicas already holding the
        candidate re-verify instantly, a router restarted baseline-only
        re-arms, and the gate restarts its window on fresh traffic.  A
        rollout that can no longer succeed rolls the subset back — a
        SIGKILLed controller's dangling canary always terminates in a
        journaled promote or rollback, never a forever-split."""
        verdict = dict(episode.get("verdict") or {})
        stage = ("canary" if episode.get("digest")
                 and str(episode.get("stage")) in ("canary", "observing")
                 else "research")
        with self._lock:
            self._pending_resume = dict(episode, verdict=verdict,
                                        stage=stage)
        telemetry.emit("mark", self.name, event="resume", stage=stage,
                       drift_id=verdict.get("id"),
                       digest=episode.get("digest"))
        logger.warning("control loop RESUMING a dangling %s-stage "
                       "episode (drift %s, candidate digest %s)",
                       stage, verdict.get("id"), episode.get("digest"))
        return stage

    def _adopt_resume(self, pending: dict) -> None:
        """Turn the scheduled episode into live loop state (poll
        thread only)."""
        self._episode_ctr.inc()
        ep = {"verdict": pending["verdict"], "t_detect": mono()}
        if pending["stage"] == "canary":
            ep.update(candidate=pending["candidate"],
                      digest=pending["digest"],
                      provenance=pending.get("provenance") or {},
                      t_candidate=mono())
            self.state = "canary"
        else:
            self.state = "research"
        self._episode = ep

    # ---------------------------------------------------------- driver

    def step(self) -> str:
        """One poll of whatever stage the loop is in; returns the
        state AFTER the step (the drill's observable)."""
        with self._lock:
            if self._pending_resume is not None:
                pending, self._pending_resume = self._pending_resume, None
                self._adopt_resume(pending)
                return self.state
            if self.state == "watching":
                verdict = self.monitor.poll()
                if verdict is not None:
                    self._enter_research(verdict)
            elif self.state == "research":
                self._run_research()
            elif self.state == "canary":
                self._run_canary_rollout()
            elif self.state == "observing":
                self.monitor.poll()  # keep journal offsets advancing
                self._run_observe()
            return self.state

    def loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.step()
            except OSError as e:
                logger.warning("control poll failed: %s", e)

    def start(self) -> "ControlLoop":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self.loop, daemon=True,
                                            name="control-loop")
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            # bounded join (lint R6/R9): the loop is a daemon either way
            self._thread.join(timeout=timeout)

    def stats(self) -> dict:
        with self._lock:
            ep = self._episode
            return {
                "loop": self.name,
                "state": self.state,
                "baseline_policy": self.baseline_policy,
                "baseline_digest": self.baseline_digest,
                "poll_interval_s": self.poll_interval_s,
                "episode": None if ep is None else {
                    "drift_id": ep["verdict"].get("id"),
                    "candidate": ep.get("candidate"),
                    "digest": ep.get("digest"),
                    "canary": (ep.get("arms") or {}).get("canary"),
                },
                "monitor": self.monitor.stats(),
                "gate": self.gate.snapshot(),
                "promotes": int(self._decision_ctr["promote"].value),
                "rollbacks": int(self._decision_ctr["rollback"].value),
            }
