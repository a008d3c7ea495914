"""Async actor/learner search pipeline: TPE math overlapped with the TTA
dispatches (the port's copy of ``fast_autoaugment_tpu/search/pipeline.py``).

One fold's trial budget runs as a streaming ask-tell service:

- a bounded CANDIDATE QUEUE of ready-to-dispatch rounds (policy tensors
  and per-trial keys, built on the host while the device is busy);
- device ACTOR threads that pull rounds and run the ``_FoldEval`` TTA
  evaluations (one CUDA-graph replay per batch on the card; the
  evaluator serializes its evaluations, since they share the fold model
  and the graphs' static buffers, ``search/driver.py``);
- the TPE LEARNER (the calling thread) applies results strictly in
  TRIAL-ID ORDER through the proposal ledger (``tpe.ask_tagged`` /
  ``tell(trial_id, ...)``), with a reorder buffer for rounds that finish
  out of order.

The learner asks round ``r`` right after processing round ``r -
max_inflight`` (``max_inflight = actors + queue_depth``), so every proposal
is a pure function of ``(seed, K, actors, queue_depth)`` whatever the
completion timing; a resume replays the same interleaving from the trial
log (:func:`replay_trial_log`).  With ``actors=1, queue_depth=0`` the
pipeline reproduces the serial scheduler's trial log bit for bit; more
actors reproduce the log of one actor with the same window.

:func:`run_overlapped_phases` overlaps phase-1 fold training (a trainer
thread) with phase-2 search: fold k's trials dispatch while fold k+1
trains.  :class:`DispatchTrace` records each dispatch's window, and
``search_result.json`` stamps its summary under ``pipeline``.

:class:`FleetTransport` takes the candidate queue across hosts: a LEARNER
host publishes each ask round as a leased work unit of
``launch/workqueue.py`` (:class:`_FleetRoundBackend`, the learner loop
unchanged) and ACTOR hosts (:func:`run_fleet_actor`) claim rounds, rebuild
their policy tensors and keys from the payload (:func:`_build_round`; the
keys through the draw source, K7 on the card), run the TTA evaluations on
the published fold checkpoint and post the rewards back.  A round's
rewards depend only on (checkpoint, proposals, id-derived keys), so any
actor computes the same answer, and a SIGKILLed actor's round, reclaimed
through its stale lease, leaves the trial log unchanged.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable

import numpy as np
import torch

from fast_autoaugment_tpu_torch.core import telemetry
from fast_autoaugment_tpu_torch.core.resilience import (
    DispatchHungError,
    PreemptedError,
    preemption_requested,
)
from fast_autoaugment_tpu_torch.core.telemetry import wall
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["DispatchTrace", "replay_trial_log", "run_fold_pipeline",
           "run_overlapped_phases", "resolve_async_pipeline",
           "FleetTransport", "RemoteEvalError", "run_fleet_actor",
           "resolve_search_role", "SEARCH_ROLE_ENV_VAR",
           "FLEET_TRANSPORT_ENV_VAR"]

logger = get_logger("faa_torch.pipeline")

#: learner poll quantum for the results queue — every blocking wait in
#: this module is bounded (lint R7), so preemption and actor failures
#: are noticed within this window
_POLL_SEC = 0.2
#: actor poll quantum for the candidate queue
_ACTOR_POLL_SEC = 0.2
#: bounded-join budget when shutting the actors down (daemon
#: threads: a genuinely wedged dispatch cannot block process exit)
_JOIN_SEC = 5.0
#: on preemption, the overlapped phase-1 trainer gets this long to
#: reach its next dispatch boundary and checkpoint before the process
#: exits 77 — losing that checkpoint is still CORRECT (the resume
#: retrains deterministically) but wastes the fold's progress
_PREEMPT_DRAIN_SEC = 30.0

#: dispatch-gap histogram bucket edges (seconds)
_GAP_BUCKETS = (0.001, 0.01, 0.1, 1.0)


def resolve_async_pipeline(spec) -> bool:
    """``--async-pipeline {off,on}`` (or a bool) to a bool.  Anything
    unrecognized raises — a typo must not silently fall back to the
    serial scheduler."""
    if isinstance(spec, bool):
        return spec
    if spec is None:
        return False
    s = str(spec).strip().lower()
    if s in ("off", "0", "false", ""):
        return False
    if s in ("on", "1", "true"):
        return True
    raise ValueError(f"async_pipeline must be 'off' or 'on', got {spec!r}")


#: per-host role export for fleet-search launches (the fleet launcher's
#: ``--roles`` writes it, ``search_cli --search-role auto`` reads it —
#: the same launcher/worker env handoff as FAA_HOST_ID/FAA_ATTEMPT)
SEARCH_ROLE_ENV_VAR = "FAA_SEARCH_ROLE"
#: shared transport-dir handoff (the fleet launcher's
#: ``--fleet-transport`` exports it, mirroring FAA_COMPILE_CACHE /
#: FAA_TELEMETRY — every host launch AND retry inherits it)
FLEET_TRANSPORT_ENV_VAR = "FAA_FLEET_TRANSPORT"

_SEARCH_ROLES = ("learner", "actor")


def resolve_search_role(spec: str | None) -> str:
    """``--search-role {auto,learner,actor}`` to a concrete role.
    ``auto`` (or None) reads :data:`SEARCH_ROLE_ENV_VAR` and defaults
    to ``learner`` — a plain single-host launch is a learner.  Unknown
    roles raise: a typo'd role must not silently train."""
    s = ("auto" if spec is None else str(spec)).strip().lower()
    if s == "auto":
        s = os.environ.get(SEARCH_ROLE_ENV_VAR, "").strip().lower() \
            or "learner"
    if s not in _SEARCH_ROLES:
        raise ValueError(
            f"search role must be one of {('auto',) + _SEARCH_ROLES}, "
            f"got {spec!r} (env {SEARCH_ROLE_ENV_VAR}="
            f"{os.environ.get(SEARCH_ROLE_ENV_VAR)!r})")
    return s


class DispatchTrace:
    """Thread-safe per-dispatch ``(start, end)`` recorder with named
    segments (one per fold's phase-2 trial loop).

    Actors record concurrently, so busy time is the UNION of the
    recorded windows per segment and a "gap" is an idle interval
    between merged windows — the quantity the async pipeline exists to
    drive to ~0.  :meth:`summary` pools gaps across segments into
    p50/p99 plus a log-bucket histogram and reports the device busy
    fraction sum(busy)/sum(span)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._segments: dict[str, list[tuple[float, float]]] = {}
        self._current: str | None = None

    def begin_segment(self, name: str) -> None:
        with self._lock:
            self._current = name
            self._segments.setdefault(name, [])

    def end_segment(self) -> None:
        with self._lock:
            self._current = None

    def record(self, t0: float, t1: float) -> None:
        """One dispatch window (monotonic seconds).  Ignored outside an
        open segment — phase-1 gate baselines and the audit share the
        evaluator but are not phase-2 dispatch-gap evidence."""
        with self._lock:
            if self._current is not None:
                self._segments[self._current].append((float(t0), float(t1)))

    @staticmethod
    def _merge(windows: list[tuple[float, float]]):
        merged: list[list[float]] = []
        for t0, t1 in sorted(windows):
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return merged

    def summary(self) -> dict | None:
        """Aggregate dispatch-gap statistics, or None when nothing was
        recorded."""
        with self._lock:
            segments = {k: list(v) for k, v in self._segments.items() if v}
        if not segments:
            return None
        busy = span = 0.0
        gaps: list[float] = []
        n = 0
        for windows in segments.values():
            merged = self._merge(windows)
            busy += sum(t1 - t0 for t0, t1 in merged)
            span += merged[-1][1] - merged[0][0]
            gaps.extend(b[0] - a[1] for a, b in zip(merged, merged[1:]))
            n += len(windows)
        gaps_arr = np.asarray(gaps, np.float64)
        hist = {}
        if len(gaps_arr):
            edges = (0.0,) + _GAP_BUCKETS + (float("inf"),)
            for lo, hi in zip(edges, edges[1:]):
                label = (f"<{hi * 1000:g}ms" if hi != float("inf")
                         else f">={lo * 1000:g}ms")
                hist[label] = int(((gaps_arr >= lo) & (gaps_arr < hi)).sum())
        return {
            "num_dispatches": n,
            "num_segments": len(segments),
            "busy_secs": round(busy, 6),
            "span_secs": round(span, 6),
            "device_busy_frac": round(busy / span, 6) if span > 0 else None,
            "num_gaps": len(gaps),
            "gap_p50_ms": (round(float(np.percentile(gaps_arr, 50)) * 1e3, 3)
                           if len(gaps_arr) else None),
            "gap_p99_ms": (round(float(np.percentile(gaps_arr, 99)) * 1e3, 3)
                           if len(gaps_arr) else None),
            "gap_total_secs": round(float(gaps_arr.sum()), 6),
            "gap_hist": hist,
        }


def replay_trial_log(tpe, fold_trials: list, trial_batch: int,
                     num_search: int, max_inflight: int = 1) -> None:
    """Replay a (trial-id-ordered) trial log through the proposal
    ledger so a resumed async search continues EXACTLY where the
    uninterrupted one would be.

    The canonical pipeline schedule asks round ``r`` immediately after
    telling round ``r - max_inflight`` — so the replay re-runs that
    exact ask/tell interleaving: rounds are re-asked (advancing the
    TPE's RNG stream precisely as the original run did — the legacy
    tell-only replay leaves the stream at its seed position, so a
    resumed serial run proposes a DIFFERENT future than an
    uninterrupted one) and told their logged rewards in id order, with
    the in-flight window held at `max_inflight` rounds.  The logged
    proposals are authoritative: they overwrite the regenerated ones
    in the ledger, so a log written under different flags degrades
    gracefully instead of silently diverging.  On return the ledger's
    PENDING trials are the rounds the uninterrupted run had in flight
    at this log state; :func:`run_fold_pipeline` dispatches those
    first (per-trial keys are id-derived, so their rewards are
    bit-identical to the uninterrupted run's)."""
    K = max(1, int(trial_batch))
    M = max(1, int(max_inflight))
    n = len(fold_trials)
    rounds: list[tuple[int, list]] = []
    t = 0
    while t < n:
        k_eff = min(K, num_search - t)
        if k_eff <= 0:  # over-full log (stale num_search): stop
            break
        rounds.append((t, fold_trials[t:t + k_eff]))
        t += k_eff

    def _ask_one_round() -> bool:
        t_base = tpe._next_trial_id
        if t_base >= num_search:
            return False
        tpe.ask_tagged(min(K, num_search - t_base))
        return True

    asked = 0
    for told, (t_base, entries) in enumerate(rounds):
        while asked < told + M and _ask_one_round():
            asked += 1
        for i, entry in enumerate(entries):
            tid = t_base + i
            tpe._pending[tid] = dict(entry[0])
            tpe.tell(tid, float(entry[1]))


class _Round:
    """One ask round, built host-side and ready to dispatch: its trial
    ``ids``, the policy tensor (padded to K candidates for the batched
    step) and the key, or ``[K]`` key stack (lane i's key is
    ``fold_in(key_fold, ids[i])``, the serial scheduler's, so rewards do
    not depend on the schedule)."""

    __slots__ = ("idx", "ids", "proposals", "policies_t", "keys")

    def __init__(self, idx, ids, proposals, policies_t, keys):
        self.idx = idx
        self.ids = ids
        self.proposals = proposals
        self.policies_t = policies_t
        self.keys = keys

    @property
    def t_base(self) -> int:
        return self.ids[0]

    @property
    def k_eff(self) -> int:
        return len(self.ids)


def _build_round(idx, ids, proposals, *, trial_batch, num_policy, num_op,
                 key_fold, draw_source, device) -> _Round:
    from fast_autoaugment_tpu_torch.policies.archive import (
        policy_decoder,
        policy_to_tensor,
    )

    k_eff = len(proposals)
    if trial_batch <= 1:
        policies_t = torch.as_tensor(policy_to_tensor(
            policy_decoder(proposals[0], num_policy, num_op)), device=device)
        keys = draw_source.fold_in(key_fold, ids[0], device)
    else:
        padded = proposals + [proposals[-1]] * (trial_batch - k_eff)
        # padded lanes take the next ids' keys (their results are
        # dropped, exactly like the serial pad)
        key_ids = list(ids) + [ids[-1] + 1 + i
                               for i in range(trial_batch - k_eff)]
        policies_t = torch.as_tensor(np.stack([
            np.asarray(policy_to_tensor(
                policy_decoder(p, num_policy, num_op)), np.float32)
            for p in padded
        ]), device=device)
        keys = [draw_source.fold_in(key_fold, t, device) for t in key_ids]
        keys = torch.stack(keys) if torch.is_tensor(keys[0]) else np.stack(keys)
    return _Round(idx, list(ids), list(proposals), policies_t, keys)


class RemoteEvalError(RuntimeError):
    """A fleet ACTOR host's TTA evaluation failed; the learner rebuilds
    the failure from the reward-return payload.  ``str()`` carries the
    actor's already-formatted ``"Type: message"`` text, so quarantine
    records match the in-process scheduler's byte for byte."""


def _failure_text(exc: BaseException) -> str:
    """The trial log's quarantine error text for a failed evaluation —
    remote failures arrive pre-formatted by the actor host."""
    if isinstance(exc, RemoteEvalError):
        return str(exc)
    return f"{type(exc).__name__}: {exc}"


def _eval_round(evaluator, fold: int, path: str, rnd: _Round,
                trial_batch: int, fi=None):
    """One round's rewards through the shared ``_FoldEval`` machinery (the
    fold checkpoint at `path`): a pure function of (checkpoint, proposals,
    id-derived keys), whichever actor runs it."""
    if fi is not None:
        for t in rnd.ids:
            fi.maybe_kill_trial(t)
            if fi.trial_error_at(t):
                raise RuntimeError(f"injected trial_error at trial {t}")
    if trial_batch <= 1:
        metrics = evaluator.evaluate(fold, path, rnd.policies_t, rnd.keys)
        return [metrics["top1_valid"]]
    metrics_list = evaluator.evaluate_batch(
        fold, path, rnd.policies_t, rnd.keys)[:rnd.k_eff]
    return [m["top1_valid"] for m in metrics_list]


class _ThreadActorBackend:
    """In-process device actor threads and a bounded candidate queue.

    ``submit`` builds the round's device tensors host-side (while the
    device is busy) and enqueues; actor threads pull, evaluate through
    :func:`_eval_round`, and push ``(kind, round, payload)`` results
    for ``poll``."""

    def __init__(self, evaluator, fold: int, path: str, *,
                 actors: int, trial_batch: int, max_inflight: int,
                 num_policy: int, num_op: int, key_fold):
        from fast_autoaugment_tpu_torch.utils import faultinject

        self._evaluator = evaluator
        self._fold = fold
        self._path = path
        self._trial_batch = trial_batch
        self._num_policy, self._num_op = num_policy, num_op
        self._key_fold = key_fold
        self._fi = faultinject.active_plan()
        self._cand_q: queue.Queue = queue.Queue(maxsize=max_inflight)
        self._res_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._actor, daemon=True,
                             name=f"pipeline-actor-{fold}-{i}")
            for i in range(actors)
        ]
        for th in self._threads:
            th.start()

    def _actor(self) -> None:
        while not self._stop.is_set():
            try:
                rnd = self._cand_q.get(timeout=_ACTOR_POLL_SEC)
            except queue.Empty:
                continue
            try:
                rewards = _eval_round(
                    self._evaluator, self._fold, self._path, rnd,
                    self._trial_batch, self._fi)
                # res_q is unbounded: block=False documents (and the
                # lint enforces) that no actor can park here
                self._res_q.put(("ok", rnd, rewards), block=False)
            except (PreemptedError, DispatchHungError) as e:
                # graceful shutdown / wedged backend: every actor
                # stops and the error takes the exit-77 restart path
                self._res_q.put(("fatal", rnd, e), block=False)
                self._stop.set()
                return
            except (ArithmeticError, RuntimeError, ValueError, OSError) as e:
                self._res_q.put(("err", rnd, e), block=False)

    def submit(self, rnd: _Round) -> None:
        rnd = _build_round(
            rnd.idx, rnd.ids, rnd.proposals, trial_batch=self._trial_batch,
            num_policy=self._num_policy, num_op=self._num_op,
            key_fold=self._key_fold, draw_source=self._evaluator.draw_source,
            device=self._evaluator.dev)
        # capacity is accounted by the learner loop, so this put cannot
        # block; the timeout is a belt-and-braces bound, never a wait
        # we expect
        self._cand_q.put(rnd, timeout=60.0)

    def poll(self, timeout: float):
        try:
            return self._res_q.get(timeout=timeout)
        except queue.Empty:
            return None

    def shutdown(self, fatal: BaseException | None) -> None:
        self._stop.set()
        # graceful preemption waits out the in-flight evaluations; a hung
        # dispatch keeps the short budget — the watchdog already
        # declared that thread unrecoverable and exit must not block
        budget = (_PREEMPT_DRAIN_SEC if isinstance(fatal, PreemptedError)
                  else _JOIN_SEC)
        deadline = time.monotonic() + budget
        for th in self._threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        alive = [th.name for th in self._threads if th.is_alive()]
        if alive:
            logger.warning(
                "pipeline fold %d: %d actor thread(s) still running at "
                "shutdown (%s) — daemon threads, in-flight dispatch "
                "results are discarded", self._fold, len(alive),
                ", ".join(alive))


def run_fold_pipeline(
    evaluator,
    fold: int,
    path: str,
    tpe,
    key_fold,
    fold_trials: list,
    *,
    num_search: int,
    trial_batch: int = 1,
    actors: int = 1,
    queue_depth: int = 1,
    num_policy: int,
    num_op: int,
    persist: Callable[[], None],
    record_quarantine: Callable[[int, int, BaseException, float], None],
    on_first_ok: Callable[[], None] | None = None,
    should_stop: Callable[[], BaseException | None] | None = None,
    heartbeat: Callable[[], None] | None = None,
    backend=None,
) -> dict:
    """One fold's full trial budget through the actor/learner pipeline.

    The caller (``search/driver.py``) has already replayed the resumed
    prefix of `fold_trials` through :func:`replay_trial_log`; this
    function evaluates every remaining trial, appends ``(proposal,
    reward)`` entries (plus the serial scheduler's quarantine-marker
    third element on failed rounds) to `fold_trials` IN TRIAL-ID ORDER,
    and calls `persist` after each processed round — the same
    crash-loses-at-most-the-in-flight-work contract as the serial
    scheduler, except the fsync now overlaps device work.

    `record_quarantine(trial_lo, trial_hi, exc, worst)` mirrors the
    serial ``_quarantine`` bookkeeping (the learner computes `worst` —
    the min reward told so far, in id order, so it is deterministic);
    ``PreemptedError``/``DispatchHungError`` from an actor stop the
    actors and re-raise in the calling thread (exit-77 restart path,
    never quarantined).  `should_stop` is polled every learner
    iteration and may return an exception to raise at the next round
    boundary (the phase-overlap scheduler routes trainer-thread
    failures through it); SIGTERM/SIGUSR1 preemption is polled
    directly.

    `backend` selects the dispatch plane: None (default) builds the
    in-process :class:`_ThreadActorBackend` over `actors` device
    threads; a :class:`_FleetRoundBackend` routes the same rounds to
    ACTOR HOSTS over the shared-directory transport instead.  The
    learner loop — ask horizon, reorder buffer, id-order tells,
    persistence — is identical either way, which is why an N-host
    fleet reproduces the single-host trial log bit for bit.

    Returns accounting: rounds processed, trials appended, tell
    reorders observed, and the actor/queue geometry."""
    trial_batch = max(1, int(trial_batch))
    actors = max(1, int(actors))
    queue_depth = max(0, int(queue_depth))
    max_inflight = actors + queue_depth

    if backend is None:
        backend = _ThreadActorBackend(
            evaluator, fold, path, actors=actors,
            trial_batch=trial_batch, max_inflight=max_inflight,
            num_policy=num_policy, num_op=num_op, key_fold=key_fold)

    # ---------------- learner (the calling thread) --------------------
    # replayed-pending trials (the rounds the uninterrupted run had in
    # flight at the resume point) dispatch FIRST, grouped back into
    # their original rounds (round r covers ids [r*K, (r+1)*K))
    initial_rounds: list[list[int]] = tpe.pending_rounds(trial_batch)
    next_round = 0
    inflight = 0
    buffered: dict[int, tuple[str, _Round, object]] = {}
    next_to_process = 0
    rounds_processed = 0
    trials_appended = 0
    # completions that arrived before an earlier round finished: they
    # buffer here and apply in id order, so the TPE itself never sees
    # a reorder — this counter is the stamped out-of-order evidence
    tell_reorders = 0
    first_ok_seen = False
    fatal: BaseException | None = None

    def _ask_next() -> _Round | None:
        """Ask (or adopt the next replayed-pending) round, in strict
        round order — called exactly once per freed in-flight slot, so
        every ask sees the deterministic told/pending horizon.  The
        round is LIGHT (ids + proposals only): the backend decides
        where and when the device tensors get built."""
        nonlocal next_round
        if initial_rounds:
            ids = initial_rounds.pop(0)
            proposals = tpe.round_payload(ids)
        else:
            t_base = tpe._next_trial_id
            if t_base >= num_search:
                return None
            k_eff = min(trial_batch, num_search - t_base)
            tagged = tpe.ask_tagged(k_eff)
            ids = [tid for tid, _p in tagged]
            proposals = [p for _tid, p in tagged]
        rnd = _Round(next_round, list(ids), list(proposals), None, None)
        next_round += 1
        return rnd

    def _submit_one() -> bool:
        nonlocal inflight
        if inflight >= max_inflight:
            return False
        rnd = _ask_next()
        if rnd is None:
            return False
        backend.submit(rnd)
        inflight += 1
        return True

    def _process(kind: str, rnd: _Round, payload) -> None:
        """Apply one completed round: tells in id order, log append,
        persist, heartbeat — then immediately refill ONE slot so every
        ask sees the canonical horizon."""
        nonlocal rounds_processed, trials_appended, first_ok_seen
        if kind == "ok":
            rewards = list(payload)
            failure = None
        else:
            worst = tpe.worst_told()
            record_quarantine(
                rnd.t_base, rnd.t_base + rnd.k_eff, payload, worst)
            rewards = [worst] * rnd.k_eff
            failure = {"quarantined": True,
                       "error": _failure_text(payload)}
        for tid, r in zip(rnd.ids, rewards):
            tpe.tell(tid, r)
            # journal evidence (no-op with telemetry off): one typed
            # event per trial told, in trial-id order like the log
            telemetry.emit("trial", f"fold{fold}", fold=fold, trial=tid,
                           reward=float(r),
                           quarantined=failure is not None)
        fold_trials.extend(
            (p, r) if failure is None else (p, r, failure)
            for p, r in zip(rnd.proposals, rewards))
        trials_appended += rnd.k_eff
        rounds_processed += 1
        persist()
        if heartbeat is not None:
            heartbeat()
        if kind == "ok" and not first_ok_seen:
            first_ok_seen = True
            if on_first_ok is not None:
                on_first_ok()
        best = tpe.best_told
        logger.info(
            "phase2 fold %d trials %d-%d/%d (async round %d, %d in flight):"
            " best_in_round=%.4f best=%.4f",
            fold, rnd.t_base, rnd.t_base + rnd.k_eff - 1, num_search,
            rnd.idx, inflight, max(rewards), best[1] if best else 0.0)

    def _check_stop() -> None:
        nonlocal fatal
        if fatal is None and preemption_requested():
            fatal = PreemptedError(
                f"preempted mid-pipeline (fold {fold}): processed rounds "
                "are persisted; resume replays the trial log")
        if fatal is None and should_stop is not None:
            fatal = should_stop()
        if fatal is not None:
            raise fatal

    try:
        while True:
            _check_stop()
            # keep the in-flight window full (initial fill; afterwards
            # _process refills one slot per completed round)
            while _submit_one():
                pass
            if inflight == 0:
                break  # budget exhausted and everything processed
            item = backend.poll(_POLL_SEC)
            if item is None:
                continue
            kind, rnd, payload = item
            if kind == "fatal":
                fatal = payload
                raise fatal
            if rnd.idx != next_to_process:
                tell_reorders += 1
            buffered[rnd.idx] = (kind, rnd, payload)
            # strict in-order processing with one refill per round:
            # the ask horizon stays a pure function of the geometry
            while next_to_process in buffered:
                k, r, p = buffered.pop(next_to_process)
                inflight -= 1
                _process(k, r, p)
                next_to_process += 1
                _submit_one()
    finally:
        backend.shutdown(fatal)

    return {
        "actors": actors,
        "queue_depth": queue_depth,
        "max_inflight": max_inflight,
        "rounds": rounds_processed,
        "trials": trials_appended,
        "tell_reorders": tell_reorders + tpe.tell_reorders,
    }


class FleetTransport:
    """Cross-host round transport for the fleet search: the in-process
    candidate queue as shared-directory plumbing (the Podracer/MPMD shape
    of PAPERS.md: a learner host drives the proposal ledger while actor
    hosts stream the TTA evaluations).

    The LEARNER host publishes each ask round as a leased work unit
    (trial ids + proposals — a few hundred bytes of JSON); ACTOR hosts
    claim rounds through the lease protocol of ``launch/workqueue.py``,
    rebuild the policy tensors and id-derived keys locally
    (:func:`_build_round` is a pure function of the payload), run the
    shared ``_FoldEval`` TTA evaluations against the published
    gate-cleared fold checkpoint, and post rewards back as done-marker
    ``info`` payloads.  Because every reward is a pure function of
    (checkpoint digest, proposals, id-derived keys), ANY actor computes
    the same answer — which is what lets the lease TTL and the steal
    fence reclaim a SIGKILLed actor's round and still reproduce the
    single-host artifacts bit for bit.

    Layout under ``root`` (a directory every host mounts — the same
    assumption the shared ``save_dir`` already makes)::

        work/p2r-f<fold>-t<t_base>.json   round payloads (the claim menu)
        leases/ done/ hosts/              the lease protocol
        ckpt/fold<k>.json                 checkpoint-published markers
        search_done.json                  the learner's terminal marker

    Round units are keyed by ``t_base`` (the round's first trial id),
    which is stable across learner resumes — a resumed learner
    republishes byte-identical payloads onto the same units and adopts
    any results actors posted while it was down.  Journal evidence:
    typed ``round`` events (``publish``/``claim``/``return``/``apply``)
    carry the transport latencies."""

    UNIT_PREFIX = "p2r-"

    def __init__(self, root: str, owner: str, *,
                 lease_ttl: float | None = None, role: str | None = None):
        from fast_autoaugment_tpu_torch.launch.workqueue import (
            DEFAULT_LEASE_TTL_SEC,
            WorkQueue,
        )

        self.wq = WorkQueue(
            root, owner,
            lease_ttl=DEFAULT_LEASE_TTL_SEC if lease_ttl is None
            else float(lease_ttl))
        self.root = self.wq.root
        self.owner = self.wq.owner
        self.role = role
        self._ckpt_dir = os.path.join(self.root, "ckpt")
        os.makedirs(self._ckpt_dir, exist_ok=True)

    # ------------------------------------------------ identity/liveness
    def beat(self, extra: dict | None = None) -> None:
        """Host liveness beat, stamped with this host's fleet-search
        role."""
        rec = dict(extra or {})
        if self.role:
            rec.setdefault("role", self.role)
        self.wq.beat_host(rec)

    def mark_host_done(self, info: dict | None = None) -> None:
        rec = dict(info or {})
        if self.role:
            rec.setdefault("role", self.role)
        self.wq.mark_host_done(rec)

    def accounting(self) -> dict:
        return self.wq.accounting()

    # ------------------------------------------------------- round units
    @classmethod
    def round_unit(cls, fold: int, t_base: int) -> str:
        """Unit id for the round whose first trial id is `t_base` —
        trial-id keyed, so resumes can never collide two different
        rounds onto one unit (round indices restart at 0 per process;
        trial ids never do)."""
        return f"{cls.UNIT_PREFIX}f{int(fold)}-t{int(t_base):06d}"

    def publish_round(self, fold: int, rnd: _Round, *, key_seed: int,
                      trial_batch: int, num_policy: int,
                      num_op: int) -> str:
        """Mint the round's work unit (atomic payload write) — the
        learner-side cost of handing a round to the fleet is this one
        write, measured into the ``publish`` journal event."""
        unit = self.round_unit(fold, rnd.t_base)
        t0 = telemetry.mono()
        self.wq.publish_unit(unit, {
            "fold": int(fold), "round_idx": int(rnd.idx),
            "t_base": int(rnd.t_base),
            "ids": [int(t) for t in rnd.ids],
            "proposals": rnd.proposals,
            "trial_batch": int(trial_batch),
            "num_policy": int(num_policy), "num_op": int(num_op),
            "key_seed": int(key_seed),
        })
        telemetry.emit("round", unit, action="publish", fold=int(fold),
                       round_idx=int(rnd.idx), t_base=int(rnd.t_base),
                       k=rnd.k_eff,
                       publish_secs=round(telemetry.mono() - t0, 6))
        return unit

    def open_rounds(self) -> list[str]:
        """Published round units with no posted result yet (sorted by
        fold then t_base — zero-padded ids keep the lexicographic order
        numeric)."""
        return self.wq.open_units(self.UNIT_PREFIX)

    def poll_round(self, fold: int, t_base: int):
        """Learner-side result check: ``None`` while the round is in
        flight, else ``("ok", rewards)`` or ``("err", RemoteEvalError)``
        from the done marker an actor posted.  Emits the ``apply``
        journal event with the return->apply latency and the evaluating
        host's identity."""
        unit = self.round_unit(fold, t_base)
        t0 = telemetry.mono()
        rec = self.wq.done_record(unit)
        if rec is None:
            return None
        info = rec.get("info") or {}
        completed = rec.get("completed_at")
        lat_ms = (round((wall() - float(completed)) * 1e3, 3)
                  if isinstance(completed, (int, float)) else None)
        telemetry.emit("round", unit, action="apply", fold=int(fold),
                       t_base=int(t_base),
                       poll_secs=round(telemetry.mono() - t0, 6),
                       return_to_apply_ms=lat_ms,
                       evaluated_by=rec.get("owner"),
                       lease_attempt=int(rec.get("attempt", 1)))
        if "rewards" in info:
            return ("ok", [float(r) for r in info["rewards"]])
        return ("err", RemoteEvalError(
            str(info.get("error")
                or "actor host evaluation failed (no detail posted)")))

    def post_result(self, unit: str, payload: dict, result: dict) -> None:
        """Actor-side reward return: release the unit with the rewards
        (or the failure text) riding the done marker."""
        self.wq.release(unit, info=result)
        telemetry.emit("round", unit, action="return",
                       fold=int(payload.get("fold", -1)),
                       t_base=int(payload.get("t_base", -1)),
                       ok="rewards" in result,
                       eval_secs=result.get("eval_secs"))

    def learner_backend(self, fold: int, *, key_seed: int,
                        trial_batch: int, num_policy: int, num_op: int):
        """The dispatch backend :func:`run_fold_pipeline` plugs in to
        route this fold's rounds over the fleet instead of in-process
        actor threads."""
        return _FleetRoundBackend(
            self, fold, key_seed=key_seed, trial_batch=trial_batch,
            num_policy=num_policy, num_op=num_op)

    # ------------------------------------------- checkpoint publication
    def _ckpt_marker(self, fold: int) -> str:
        return os.path.join(self._ckpt_dir, f"fold{int(fold)}.json")

    def publish_checkpoint(self, fold: int, path: str) -> dict:
        """Announce a gate-cleared fold checkpoint to the fleet: the
        trainer host writes the marker (name + sha256 digest from the
        checkpoint's sidecar) the moment the quality gate clears, after
        the checkpoint's own atomic rename.  The payload itself already
        lives in the shared ``save_dir``."""
        from fast_autoaugment_tpu_torch.core import fsfault
        from fast_autoaugment_tpu_torch.core.checkpoint import read_metadata

        meta = read_metadata(path) or {}
        rec = {"fold": int(fold), "name": os.path.basename(path),
               "digest": meta.get("digest"), "epoch": meta.get("epoch")}
        fsfault.write_json_atomic(self._ckpt_marker(fold), rec)
        telemetry.emit("checkpoint", f"fold{int(fold)}", action="publish",
                       fold=int(fold), digest=rec["digest"])
        return rec

    def checkpoint_record(self, fold: int) -> dict | None:
        from fast_autoaugment_tpu_torch.launch.workqueue import _read_json

        return _read_json(self._ckpt_marker(fold))

    def wait_checkpoint(self, fold: int, local_path: str, *,
                        timeout: float = 900.0, poll_sec: float = 0.5,
                        should_stop=None) -> dict:
        """Actor-side: block until the fold's marker exists AND the
        locally visible sidecar digest matches it (a lagging shared
        filesystem must never evaluate against a half-synced
        checkpoint).  Raises ``TimeoutError`` past `timeout` — the
        actor exits nonzero and its lease-stale rounds go to a
        survivor with a fresher view."""
        from fast_autoaugment_tpu_torch.core.checkpoint import read_metadata

        deadline = time.monotonic() + float(timeout)
        while True:
            rec = self.checkpoint_record(fold)
            if rec is not None:
                meta = read_metadata(local_path) or {}
                if not rec.get("digest") \
                        or meta.get("digest") == rec.get("digest"):
                    return rec
            if preemption_requested():
                raise PreemptedError(
                    f"preempted while waiting for fold {fold}'s published "
                    "checkpoint")
            if should_stop is not None:
                err = should_stop()
                if err is not None:
                    raise err
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fold {fold} checkpoint was not published (or never "
                    f"matched digest {rec and rec.get('digest')!r} "
                    f"locally) within {timeout:.0f}s of claiming its round")
            time.sleep(poll_sec)  # robust: allow — deadline-bounded, preemption-polled publish wait

    # --------------------------------------------------- terminal marker
    @property
    def _search_done_path(self) -> str:
        return os.path.join(self.root, "search_done.json")

    def mark_search_done(self, info: dict | None = None) -> None:
        """The learner's terminal marker: actor hosts drain their idle
        poll and exit 0 once it exists and no open rounds remain."""
        from fast_autoaugment_tpu_torch.core import fsfault

        fsfault.write_json_atomic(self._search_done_path,
                                  dict(info or {}, done=True))
        telemetry.emit("mark", "fleet-search", kind="search_done")

    def search_done(self) -> bool:
        from fast_autoaugment_tpu_torch.launch.workqueue import _read_json

        return _read_json(self._search_done_path) is not None


class _FleetRoundBackend:
    """Learner-side dispatch backend over :class:`FleetTransport`:
    ``submit`` publishes the round as a leased work unit, ``poll``
    scans the outstanding rounds' done markers for posted rewards.
    The learner loop upstream is the thread-backend path's — same ask
    horizon, same reorder buffer, same id-order tells — so the fleet
    reproduces the single-host trial log bit for bit when launched
    with the same ``actors + queue_depth`` window."""

    def __init__(self, transport: FleetTransport, fold: int, *,
                 key_seed: int, trial_batch: int, num_policy: int,
                 num_op: int, poll_quantum: float = 0.05):
        self._transport = transport
        self._fold = int(fold)
        self._key_seed = int(key_seed)
        self._trial_batch = int(trial_batch)
        self._num_policy, self._num_op = int(num_policy), int(num_op)
        self._poll_quantum = float(poll_quantum)
        self._outstanding: dict[int, _Round] = {}

    def submit(self, rnd: _Round) -> None:
        self._transport.publish_round(
            self._fold, rnd, key_seed=self._key_seed,
            trial_batch=self._trial_batch, num_policy=self._num_policy,
            num_op=self._num_op)
        self._outstanding[rnd.idx] = rnd

    def poll(self, timeout: float):
        for idx in sorted(self._outstanding):
            rnd = self._outstanding[idx]
            res = self._transport.poll_round(self._fold, rnd.t_base)
            if res is not None:
                kind, payload = res
                return (kind, self._outstanding.pop(idx), payload)
        # one bounded nap per empty scan (the learner loop re-polls);
        # the scan itself is a handful of stat/read calls, so the
        # learner-side cost per round stays far under the ask() wall
        time.sleep(min(float(timeout), self._poll_quantum))
        return None

    def shutdown(self, fatal: BaseException | None) -> None:
        # nothing to tear down: published rounds STAY in the queue — a
        # resumed learner republishes identical payloads onto the same
        # t_base-keyed units and adopts whatever results actors posted
        # while it was down
        return None


def _load_fold_resilient(evaluator, fold: int, path: str, *,
                         budget_s: float = 60.0) -> None:
    """Digest-verified checkpoint read with bounded backoff: on a
    lagging shared filesystem the published marker can match the
    sidecar while the PAYLOAD is still half-synced (or a read returns
    transient EIO/stale bytes), so the digest check inside
    ``load_checkpoint`` raises — treat that as not-yet-visible and
    retry until the budget, then raise a typed ``TimeoutError`` (the
    actor's loud-exit contract; its rounds go to a survivor with a
    fresher view)."""
    from fast_autoaugment_tpu_torch.core.resilience import CheckpointCorruptError

    deadline = time.monotonic() + float(budget_s)
    delay = 0.1
    while True:
        try:
            return evaluator.load_fold(path)
        except (CheckpointCorruptError, OSError) as e:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fold {fold} checkpoint at {path} never became "
                    f"readable/digest-clean within {budget_s:.0f}s "
                    f"(last error: {type(e).__name__}: {e}) — "
                    "half-synced shared filesystem?") from e
            logger.warning(
                "fleet actor: fold %d checkpoint read failed (%s: %s) "
                "— retrying in %.2fs (visibility lag)", fold,
                type(e).__name__, e, delay)
            time.sleep(delay)  # robust: allow — deadline-bounded visibility-lag retry
            delay = min(1.0, delay * 2)


def run_fleet_actor(evaluator, transport: FleetTransport,
                    fold_ckpt_path: Callable[[int], str], *,
                    trial_batch: int = 1, num_policy: int = 5,
                    num_op: int = 2, poll_sec: float = 0.5,
                    ckpt_timeout: float = 900.0,
                    should_stop: Callable[[], BaseException | None] | None
                    = None) -> dict:
    """One ACTOR host's service loop: claim published rounds off the
    transport, evaluate them with the shared ``_FoldEval`` machinery
    against the published fold checkpoints, post rewards back, repeat
    until the learner marks the search done.

    Each round is rebuilt by :func:`_build_round` on the evaluator's
    device with its draw source (``evaluator.draw_source``,
    ``evaluator.dev``) from ``key_fold = prng_key(key_seed)``: the
    learner's fold key, ``seed * 77 + fold``; on the card its ``fold_in``
    is one K7 launch a key.

    Failure contract: a trial-level evaluation failure posts the
    formatted error (the learner quarantines the round exactly as the
    in-process scheduler would); ``PreemptedError``/``DispatchHungError``
    re-raise — the CLI maps them to exit 77, the claimed lease goes
    stale, and a surviving actor reclaims the round; a ``LeaseLostError``
    mid-round abandons the unit to its new owner (this host was presumed
    dead; duplicate evaluation is safe — rewards are deterministic).  A
    geometry mismatch against the published payload (trial_batch/
    num_policy/num_op) raises ``ValueError`` immediately: that is a launch
    configuration error, not a quarantinable trial failure."""
    from fast_autoaugment_tpu_torch.launch.workqueue import LeaseLostError
    from fast_autoaugment_tpu_torch.search.tta import prng_key
    from fast_autoaugment_tpu_torch.utils import faultinject

    trial_batch = max(1, int(trial_batch))
    fi = faultinject.active_plan()
    loaded: set[int] = set()
    folds_seen: set[int] = set()
    stats = {"rounds_ok": 0, "rounds_err": 0, "lease_lost": 0}
    transport.beat()
    while True:
        if preemption_requested():
            raise PreemptedError(
                "fleet actor preempted — claimed leases go stale and "
                "surviving actors reclaim the in-flight rounds")
        if should_stop is not None:
            err = should_stop()
            if err is not None:
                raise err
        unit = payload = None
        for u in transport.open_rounds():
            p = transport.wq.unit_payload(u)
            if p is not None and transport.wq.claim(u):
                unit, payload = u, p
                break
        if unit is None:
            transport.beat()
            if transport.search_done():
                break
            # TTL-fraction claim poll: the loop's exit is the learner's
            # search_done marker, and each nap stays well under the lease
            # TTL so stale-round reclaims are never starved
            time.sleep(max(0.1, min(poll_sec, transport.wq.lease_ttl / 4.0)))  # robust: allow
            continue
        fold = int(payload["fold"])
        if (int(payload.get("trial_batch", 1)) != trial_batch
                or int(payload.get("num_policy", num_policy)) != num_policy
                or int(payload.get("num_op", num_op)) != num_op):
            raise ValueError(
                f"fleet-actor geometry mismatch on {unit}: learner "
                f"published trial_batch={payload.get('trial_batch')} "
                f"num_policy={payload.get('num_policy')} "
                f"num_op={payload.get('num_op')}; this actor built "
                f"{trial_batch}/{num_policy}/{num_op} — launch actors "
                "with the learner's search flags")
        lease = transport.wq.read_lease(unit) or {}
        telemetry.emit("round", unit, action="claim", fold=fold,
                       t_base=int(payload.get("t_base", -1)),
                       lease_attempt=int(lease.get("attempt", 1)))
        try:
            path = fold_ckpt_path(fold)
            transport.wait_checkpoint(fold, path, timeout=ckpt_timeout,
                                      should_stop=should_stop)
            if fold not in loaded:
                _load_fold_resilient(evaluator, fold, path,
                                     budget_s=min(60.0, float(ckpt_timeout)))
                loaded.add(fold)
            rnd = _build_round(
                int(payload.get("round_idx", 0)),
                [int(t) for t in payload["ids"]],
                [dict(p) for p in payload["proposals"]],
                trial_batch=trial_batch, num_policy=num_policy,
                num_op=num_op, key_fold=prng_key(int(payload["key_seed"])),
                draw_source=evaluator.draw_source, device=evaluator.dev)
            transport.wq.renew(unit)
            t0m = telemetry.mono()
            rewards = _eval_round(evaluator, fold, path, rnd, trial_batch, fi)
            t1m = telemetry.mono()
            transport.wq.renew(unit)
            # the phase-2 lane evidence with THIS host's identity
            telemetry.phase_event(f"phase2-fold{fold}", t0m, t1m,
                                  fold=fold, lane="phase2",
                                  t_base=int(rnd.t_base))
            result = {"rewards": [float(r) for r in rewards],
                      "eval_secs": round(t1m - t0m, 6)}
        except (PreemptedError, DispatchHungError, TimeoutError):
            # exit-77 / loud-exit path: the lease goes stale and a
            # survivor reclaims the round (TimeoutError FIRST — it IS
            # an OSError subclass and must not read as a trial failure)
            raise
        except LeaseLostError as e:
            stats["lease_lost"] += 1
            logger.warning(
                "fleet actor: lost the lease on %s mid-round (%s) — "
                "abandoning it to its new owner", unit, e)
            continue
        except (ArithmeticError, RuntimeError, ValueError, OSError) as e:
            result = {"error": f"{type(e).__name__}: {e}"}
        try:
            transport.post_result(unit, payload, result)
        except LeaseLostError as e:
            # the done-marker post was FENCED (epoch/owner moved): this
            # host was presumed dead and the round reclaimed — the
            # reclaimer posts the same bytes, so abandon, never clobber
            stats["lease_lost"] += 1
            logger.warning(
                "fleet actor: done-marker post for %s fenced off (%s) "
                "— abandoning the round to its reclaimer", unit, e)
            continue
        folds_seen.add(fold)
        ok = "rewards" in result
        stats["rounds_ok" if ok else "rounds_err"] += 1
        transport.beat()
        logger.info(
            "fleet actor %s: %s round %s (fold %d, trials %s)%s",
            transport.owner, "evaluated" if ok else "FAILED", unit, fold,
            payload.get("ids"),
            "" if ok else f" — posted {result['error']!r}")
    return dict(stats, folds=sorted(folds_seen),
                reclaimed_units=list(transport.wq.reclaimed_units))


def run_overlapped_phases(
    fold_list: list[int],
    phase1_fn: Callable[[int], None],
    phase2_fn: Callable[[int], object],
    *,
    poll_sec: float = 0.5,
) -> dict:
    """Overlap phase-1 fold training with phase-2 search: a trainer
    thread runs ``phase1_fn(fold)`` (train + quality gate) fold by
    fold, and the calling thread runs ``phase2_fn(fold)`` the moment
    that fold is ready — fold k's TPE trials dispatch while fold k+1's
    training is still in flight.

    Phase-2 folds still run in fold order, so every artifact (trial
    logs, final policy set) is identical to the sequential schedule —
    only the wall-clock interleaving changes.  A trainer-thread
    exception (including ``PreemptedError`` from a SIGTERM mid-train)
    re-raises HERE, with its original type, at the next poll boundary;
    a phase-2 exception stops the trainer between folds (mid-fold
    training still honors the global preemption flag at dispatch
    boundaries).

    Returns the overlap timeline: per-fold phase-1/phase-2 start/end
    wall times plus the measured overlap seconds — the evidence the
    phase-overlap e2e test asserts on."""
    cond = threading.Condition()
    ready: dict[int, float] = {}
    trainer_error: list[BaseException] = []
    stop = threading.Event()
    timeline: dict = {
        "phase1": {}, "phase2": {},
        "folds": [int(f) for f in fold_list],
    }

    def _trainer():
        for f in fold_list:
            if stop.is_set():
                return
            t0 = wall()
            t0m = telemetry.mono()
            try:
                phase1_fn(f)
            except BaseException as e:
                with cond:
                    trainer_error.append(e)
                    cond.notify_all()
                return
            telemetry.phase_event(f"phase1-fold{f}", t0m, telemetry.mono(),
                                  fold=int(f), lane="phase1")
            with cond:
                timeline["phase1"][str(f)] = {"start": t0,
                                              "end": wall()}
                ready[f] = wall()
                cond.notify_all()
        with cond:
            cond.notify_all()

    th = threading.Thread(target=_trainer, daemon=True,
                          name="phase1-trainer")
    th.start()
    try:
        for f in fold_list:
            with cond:
                while f not in ready and not trainer_error:
                    cond.wait(timeout=poll_sec)
                if trainer_error:
                    raise trainer_error[0]
            t0 = wall()
            t0m = telemetry.mono()
            phase2_fn(f)
            telemetry.phase_event(f"phase2-fold{f}", t0m, telemetry.mono(),
                                  fold=int(f), lane="phase2")
            timeline["phase2"][str(f)] = {"start": t0, "end": wall()}
    except BaseException as e:
        stop.set()
        if isinstance(e, PreemptedError):
            # the trainer polls the same global preemption flag at its
            # dispatch boundaries: give it a bounded window to
            # checkpoint the in-flight fold before exit 77 (its own
            # PreemptedError lands in trainer_error, already raised)
            th.join(timeout=_PREEMPT_DRAIN_SEC)
        raise
    deadline = time.monotonic() + _JOIN_SEC
    th.join(timeout=max(0.0, deadline - time.monotonic()))

    # overlap evidence: seconds during which some fold's phase-2 ran
    # while a LATER fold's phase-1 was still training
    overlap = 0.0
    for f in fold_list:
        p2 = timeline["phase2"].get(str(f))
        if not p2:
            continue
        for g in fold_list:
            if g <= f:
                continue
            p1 = timeline["phase1"].get(str(g))
            if not p1:
                continue
            overlap += max(0.0, min(p2["end"], p1["end"])
                           - max(p2["start"], p1["start"]))
    timeline["overlap_secs"] = round(overlap, 6)
    return timeline
