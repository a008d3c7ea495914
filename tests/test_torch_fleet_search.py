"""The port's fleet search: the cross-host round transport
(``fast_autoaugment_tpu_torch/search/pipeline.py FleetTransport``,
``run_fleet_actor``, ``_FleetRoundBackend``) against the JAX package's and
against the port's own in-process pipeline, and the work-queue search
(``search/driver.py search_policies(work_queue=...)``) against the plain one.

- round payloads byte for byte JAX ``FleetTransport.publish_round``'s, and a
  round published by the JAX learner served by the port's actor;
- the fleet backend (a learner loop over the transport, an actor thread
  serving it) reproduces the thread backend's trial log bit for bit, with
  rewards that depend on each trial's key (the actor rebuilds the key of
  ``key_seed``), and the JAX thread backend's log on the same stub;
- a resumed learner adopts results posted while it was down; a remote
  failure quarantines with the in-process text; a geometry mismatch raises;
- a one-host search through the lease queue (tiny conf, the CPU) equals the
  plain search's trial log and final policy.

Stub evaluators stand in for ``_FoldEval`` (host code, the CPU), as in
``tests/test_fleet_search.py``.
"""

from __future__ import annotations

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu.search import pipeline as jax_pipeline
from fast_autoaugment_tpu.search.tpe import TPE as JaxTPE
from fast_autoaugment_tpu.utils import faultinject as jax_faultinject
from fast_autoaugment_tpu_torch.core.resilience import clear_preemption
from fast_autoaugment_tpu_torch.launch import search_cli as SC
from fast_autoaugment_tpu_torch.launch.workqueue import WorkQueue
from fast_autoaugment_tpu_torch.search.driver import make_search_space
from fast_autoaugment_tpu_torch.search.pipeline import (
    FleetTransport,
    RemoteEvalError,
    _failure_text,
    replay_trial_log,
    resolve_search_role,
    run_fleet_actor,
    run_fold_pipeline,
)
from fast_autoaugment_tpu_torch.search.tpe import TPE
from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws, prng_key
from fast_autoaugment_tpu_torch.utils import faultinject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "confs", "wresnet10x1_shapes.yaml")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("FAA_FAULT", "FAA_SEARCH_ROLE", "FAA_FLEET_TRANSPORT"):
        monkeypatch.delenv(var, raising=False)
    faultinject.reset()
    jax_faultinject.reset()
    clear_preemption()
    yield
    os.environ.pop("FAA_FAULT", None)
    faultinject.reset()
    jax_faultinject.reset()
    clear_preemption()


class _Light:
    """A light round (what the learner submits): ids and proposals."""

    def __init__(self, idx, ids, proposals):
        self.idx, self.ids, self.proposals = idx, list(ids), proposals

    @property
    def t_base(self):
        return self.ids[0]

    @property
    def k_eff(self):
        return len(self.ids)


class _StubEval:
    """``_FoldEval`` stand-in: a lane's reward from its policy tensor and,
    with `keyed`, its key's words (so a wrong key shows)."""

    draw_source = PhiloxDraws()
    dev = torch.device("cpu")

    def __init__(self, keyed: bool = True):
        self.keyed = keyed

    def load_fold(self, path):
        return None

    def _reward(self, lane, key):
        extra = float(np.asarray(key, np.float64).sum()) * 1e-9 if self.keyed else 0.0
        return round((float(np.asarray(lane).sum()) + extra) % 1.0, 6)

    def evaluate(self, fold, path, policy_t, key):
        return {"top1_valid": self._reward(policy_t, key)}

    def evaluate_batch(self, fold, path, policies_t, keys):
        return [{"top1_valid": self._reward(policies_t[i], keys[i])}
                for i in range(int(policies_t.shape[0]))]


class _JaxStubEval:
    """The JAX package's stub of ``tests/test_fleet_search.py``."""

    def load_fold(self, path):
        return None, None

    @staticmethod
    def _reward(lane):
        return round(float(np.asarray(lane).sum()) % 1.0, 6)

    def evaluate_batch(self, fold, params, batch_stats, policies_t, keys):
        return [{"top1_valid": self._reward(policies_t[i])}
                for i in range(int(policies_t.shape[0]))]


def _drive(tmp_path, *, fleet: bool, keyed=True, num_search=8, k=2, actors=2, queue_depth=1,
           seed=11, fold_trials=None):
    """One fold's budget through the thread backend (fleet=False) or the
    transport served by an actor thread (fleet=True); all else the same."""
    tpe = TPE(make_search_space(1, 1), seed=seed, n_startup=4)
    log = list(fold_trials) if fold_trials is not None else []
    replay_trial_log(tpe, log, k, num_search, max_inflight=actors + queue_depth)
    quars = []
    kw = dict(num_search=num_search, trial_batch=k, actors=actors, queue_depth=queue_depth,
              num_policy=1, num_op=1, persist=lambda: None,
              record_quarantine=lambda lo, hi, exc, worst: quars.append(
                  (lo, hi, _failure_text(exc), worst)))
    if not fleet:
        stats = run_fold_pipeline(_StubEval(keyed), 0, "unused", tpe, prng_key(7), log, **kw)
        return log, stats, quars, None
    root = str(tmp_path / "tr")
    learner = FleetTransport(root, "learner0", role="learner")
    learner.publish_checkpoint(0, str(tmp_path / "missing.msgpack"))
    actor_tr = FleetTransport(root, "actor0", role="actor")
    actor_out: list = []

    def _actor():
        try:
            actor_out.append(run_fleet_actor(
                _StubEval(keyed), actor_tr, lambda f: str(tmp_path / "missing.msgpack"),
                trial_batch=k, num_policy=1, num_op=1, poll_sec=0.05))
        except BaseException as e:  # surfaced by the assertions
            actor_out.append(e)

    th = threading.Thread(target=_actor, daemon=True)
    th.start()
    try:
        backend = learner.learner_backend(0, key_seed=7, trial_batch=k, num_policy=1, num_op=1)
        stats = run_fold_pipeline(_StubEval(keyed), 0, "unused", tpe, prng_key(7), log,
                                  backend=backend, **kw)
    finally:
        learner.mark_search_done()
        th.join(timeout=30)
    assert not th.is_alive(), "the actor never drained on search_done"
    return log, stats, quars, actor_out[0] if actor_out else None


def test_fleet_backend_reproduces_thread_backend_bit_for_bit(tmp_path):
    ref, ref_stats, _q, _ = _drive(tmp_path / "a", fleet=False)
    got, stats, quars, actor_stats = _drive(tmp_path / "b", fleet=True)
    assert got == ref and not quars
    assert isinstance(actor_stats, dict), actor_stats
    assert actor_stats["rounds_ok"] == stats["rounds"] == 4 and actor_stats["folds"] == [0]
    assert stats["trials"] == ref_stats["trials"] == 8


def test_fleet_log_equals_the_jax_thread_backend(tmp_path):
    """Policy-only rewards: the port's fleet-driven trial log is the JAX
    package's in-process one, entry for entry."""
    got, _s, _q, _a = _drive(tmp_path, fleet=True, keyed=False)
    jtpe = JaxTPE(make_search_space(1, 1), seed=11, n_startup=4)
    jlog: list = []
    jax_pipeline.run_fold_pipeline(
        _JaxStubEval(), 0, None, None, jtpe, jax.random.PRNGKey(7), jlog, num_search=8,
        trial_batch=2, actors=2, queue_depth=1, num_policy=1, num_op=1, persist=lambda: None,
        record_quarantine=lambda *a: None)
    assert json.dumps(got) == json.dumps(jlog)


def test_fleet_resume_adopts_posted_results(tmp_path):
    full, _s, _q, _ = _drive(tmp_path / "full", fleet=True)
    resumed, _s2, _q2, _ = _drive(tmp_path / "full", fleet=True, fold_trials=full[:2])
    assert resumed == full


def test_fleet_quarantine_matches_in_process_format(tmp_path):
    os.environ["FAA_FAULT"] = "trial_error@trial=2"
    faultinject.reset()
    ref, _s, ref_q, _ = _drive(tmp_path / "a", fleet=False)
    faultinject.reset()
    got, _s2, got_q, actor_stats = _drive(tmp_path / "b", fleet=True)
    assert got == ref
    assert [q[:3] for q in got_q] == [q[:3] for q in ref_q]
    assert "injected trial_error at trial 2" in got_q[0][2]
    assert actor_stats["rounds_err"] == 1
    assert all(m["quarantined"] and "RuntimeError: injected trial_error" in m["error"]
               for _p, _r, m in got[2:4])


def test_actor_geometry_mismatch_raises_loudly(tmp_path):
    learner = FleetTransport(str(tmp_path), "learner0")
    learner.publish_round(0, _Light(0, [0, 1], [{"policy_0_0": 1}, {"policy_0_0": 2}]),
                          key_seed=7, trial_batch=2, num_policy=1, num_op=1)
    with pytest.raises(ValueError, match="geometry mismatch"):
        run_fleet_actor(_StubEval(), FleetTransport(str(tmp_path), "actor0"), lambda f: "/nope",
                        trial_batch=4, num_policy=1, num_op=1, poll_sec=0.05)


# ------------------------------------------------ transport primitives


def test_round_payload_bytes_equal_jax(tmp_path):
    rnd = _Light(3, [6, 7], [{"policy_0_0": 4, "prob_0_0": 0.125, "level_0_0": 0.7},
                             {"policy_0_0": 9, "prob_0_0": 0.5, "level_0_0": 0.0625}])
    units = []
    for name, cls in (("torch", FleetTransport), ("jax", jax_pipeline.FleetTransport)):
        tr = cls(str(tmp_path / name), "learner0", role="learner")
        units.append(tr.publish_round(1, rnd, key_seed=78, trial_batch=2, num_policy=1,
                                      num_op=1))
    assert units[0] == units[1] == FleetTransport.round_unit(1, 6) == "p2r-f1-t000006"
    a, b = (open(tmp_path / n / "work" / f"{units[0]}.json", "rb").read()
            for n in ("torch", "jax"))
    assert a == b
    assert json.loads(a)["key_seed"] == 78 and json.loads(a)["ids"] == [6, 7]


def test_jax_learner_round_served_by_the_port(tmp_path):
    """One directory, two packages: the JAX learner publishes, the port's
    actor claims and posts, the JAX learner reads the rewards; an error
    return reaches JAX as its RemoteEvalError with the port's text."""
    learner = jax_pipeline.FleetTransport(str(tmp_path), "learner0", role="learner")
    actor = FleetTransport(str(tmp_path), "actor0", role="actor")
    unit = learner.publish_round(0, _Light(0, [0, 1], [{"policy_0_0": 1}, {"policy_0_0": 2}]),
                                 key_seed=77, trial_batch=2, num_policy=1, num_op=1)
    assert learner.poll_round(0, 0) is None and actor.open_rounds() == [unit]
    assert actor.wq.claim(unit)
    actor.post_result(unit, actor.wq.unit_payload(unit), {"rewards": [0.5, 0.75]})
    assert learner.poll_round(0, 0) == ("ok", [0.5, 0.75])
    unit2 = learner.publish_round(0, _Light(1, [2, 3], [{"policy_0_0": 1}, {"policy_0_0": 2}]),
                                  key_seed=77, trial_batch=2, num_policy=1, num_op=1)
    assert actor.wq.claim(unit2)
    actor.post_result(unit2, actor.wq.unit_payload(unit2),
                      {"error": "RuntimeError: boom at trial 2"})
    kind, exc = learner.poll_round(0, 2)
    assert kind == "err" and isinstance(exc, jax_pipeline.RemoteEvalError)
    assert jax_pipeline._failure_text(exc) == "RuntimeError: boom at trial 2"
    # and the port's learner reads it the same way
    kind, exc = FleetTransport(str(tmp_path), "learner1").poll_round(0, 2)
    assert kind == "err" and isinstance(exc, RemoteEvalError)
    assert _failure_text(exc) == "RuntimeError: boom at trial 2"
    assert _failure_text(ValueError("x")) == "ValueError: x"


def test_checkpoint_publish_wait_and_digest_gate(tmp_path):
    tr = FleetTransport(str(tmp_path / "tr"), "learner0")
    ckpt = tmp_path / "fold0.msgpack"
    ckpt.write_bytes(b"payload")
    (tmp_path / "fold0.msgpack.meta.json").write_text(json.dumps({"epoch": 3,
                                                                  "digest": "abc123"}))
    rec = tr.publish_checkpoint(0, str(ckpt))
    assert (rec["digest"], rec["epoch"], rec["name"]) == ("abc123", 3, "fold0.msgpack")
    assert tr.wait_checkpoint(0, str(ckpt), timeout=5.0, poll_sec=0.01)["digest"] == "abc123"
    (tmp_path / "fold0.msgpack.meta.json").write_text(json.dumps({"epoch": 3,
                                                                  "digest": "stale"}))
    with pytest.raises(TimeoutError, match="checkpoint"):
        tr.wait_checkpoint(0, str(ckpt), timeout=0.2, poll_sec=0.02)
    with pytest.raises(TimeoutError):
        tr.wait_checkpoint(7, str(ckpt), timeout=0.2, poll_sec=0.02)
    # the JAX actor reads the port's marker
    jtr = jax_pipeline.FleetTransport(str(tmp_path / "tr"), "actor9")
    assert jtr.checkpoint_record(0) == tr.checkpoint_record(0)


def test_search_done_marker_drains_idle_actor(tmp_path):
    tr = FleetTransport(str(tmp_path), "learner0")
    assert not tr.search_done()
    tr.mark_search_done({"num_sub_policies": 4})
    assert tr.search_done()
    actor_tr = FleetTransport(str(tmp_path), "actor0", role="actor")
    stats = run_fleet_actor(object(), actor_tr, lambda f: "/nope", trial_batch=2,
                            num_policy=1, num_op=1, poll_sec=0.05)
    assert stats["rounds_ok"] == 0 and stats["folds"] == []
    assert actor_tr.wq.known_hosts()["actor0"]["role"] == "actor"


def test_resolve_search_role(monkeypatch):
    assert resolve_search_role(None) == resolve_search_role("auto") == "learner"
    assert resolve_search_role("actor") == "actor"
    monkeypatch.setenv("FAA_SEARCH_ROLE", "actor")
    assert resolve_search_role("auto") == "actor"
    assert resolve_search_role("learner") == "learner"
    monkeypatch.setenv("FAA_SEARCH_ROLE", "banana")
    with pytest.raises(ValueError, match="role"):
        resolve_search_role("auto")
    with pytest.raises(ValueError):
        resolve_search_role("trainer")


def test_sigkill_trial_fault_verb_parses_and_gates():
    faults = faultinject.parse_fault_spec("sigkill_trial@trial=2,attempt=1")
    assert faults[0]["kind"] == "sigkill_trial" and faults[0]["trial"] == 2
    assert faults[0]["attempt"] == 1
    with pytest.raises(ValueError):
        faultinject.parse_fault_spec("sigkill_trial@step=2")


# ------------------------------------------------- the work-queue search

ARGS = ["-c", CONF, "--num-fold", "2", "--folds", "1", "--num-search", "2", "--num-policy", "2",
        "--num-top", "2", "--until", "2", "--fold-quality-floor", "off", "--audit-floor", "0",
        "--device", "cpu"]


@pytest.fixture
def two_threads():
    """Torch on 2 threads, put back afterwards: float32 results move with
    the count, and the next file in the same test worker runs on its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_one_host_workqueue_search_equals_the_plain_search(tmp_path, two_threads):
    """One host through the lease queue (the fleet launcher's rank suffix
    included): every unit done once, a clean accounting, and the plain
    search's trial log (per fold) and final policy, byte for byte (one fold
    of two, no audit: the queue's protocol, at a small cost)."""
    plain = SC.main(ARGS + ["--save-dir", str(tmp_path / "plain"), "epoch=1"])
    queued = SC.main(ARGS + ["--save-dir", str(tmp_path / "q"), "--workqueue",
                             str(tmp_path / "wq"), "epoch=1", "--coordinator", "x:1",
                             "--num-hosts", "1", "--host-id", "0"])
    assert queued["final_policy_set"] == plain["final_policy_set"]
    assert (queued["degraded"], queued["lost_hosts"], queued["reclaimed_units"]) == \
        (False, [], [])
    assert queued["resilience"]["fleet"]["num_reclaimed_units"] == 0
    wq = WorkQueue(str(tmp_path / "wq"), "observer")
    assert sorted(os.listdir(tmp_path / "wq" / "done")) == ["p1-fold1.json", "p2-fold1.json"]
    assert wq.done_record("p1-fold1")["owner"] == "host0"
    trials = json.load(open(tmp_path / "plain" / "search_trials.json"))
    assert list(trials) == ["1"] and len(trials["1"]) == 2
    assert not os.path.exists(tmp_path / "q" / "search_trials.json")
    assert open(tmp_path / "q" / "search_trials.fold1.json").read() == json.dumps(trials["1"])
    assert open(tmp_path / "q" / "final_policy.json", "rb").read() == \
        open(tmp_path / "plain" / "final_policy.json", "rb").read()
    assert wq.known_hosts()["host0"]["done"] is True
