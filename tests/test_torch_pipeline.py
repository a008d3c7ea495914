"""The port's async actor/learner pipeline (``search/pipeline.py``) and the
proposal ledger of its TPE copy against the JAX package's, on the CPU.

Bounds: exact.  ``DispatchTrace.summary`` of the same windows is equal;
``run_fold_pipeline`` with a stub evaluator (its reward a fixed function of
the round's policy tensor) and the same TPE seed gives the same proposals,
in the same order, the same trial log and the same accounting as the JAX
function, for one actor in lockstep, two actors with a queue, and batched
rounds, also when the rounds finish out of order; a resume through
``replay_trial_log`` continues the uninterrupted log; ``run_overlapped_phases``
gives the JAX timeline's keys and re-raises a trainer thread's
``PreemptedError`` with its type.  The search itself: ``search_policies``
on ``confs/wresnet10x1_shapes.yaml`` (epoch 1, 2 folds x 4 trials, phases 1
and 2) with ``async_pipeline="on"`` and 2 actors gives bitwise the trial log
and the final policy of ``"off"``.
"""

import json
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

from fast_autoaugment_tpu.core import resilience as JR
from fast_autoaugment_tpu.search import pipeline as JPL
from fast_autoaugment_tpu.search import tpe as JTPE
from fast_autoaugment_tpu_torch.core import resilience as R
from fast_autoaugment_tpu_torch.core.config import load_config
from fast_autoaugment_tpu_torch.search import driver as D
from fast_autoaugment_tpu_torch.search import pipeline as PL
from fast_autoaugment_tpu_torch.search import tpe as TPE
from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws, prng_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "confs", "wresnet10x1_shapes.yaml")
NUM_POLICY, NUM_OP = 2, 2


def _space(mod):
    space = []
    for i in range(NUM_POLICY):
        for j in range(NUM_OP):
            space += [mod.choice(f"policy_{i}_{j}", 15), mod.uniform(f"prob_{i}_{j}", 0, 1),
                      mod.uniform(f"level_{i}_{j}", 0, 1)]
    return space


def _reward(policies) -> float:
    """A fixed, proposal-dependent reward of one candidate's policy tensor."""
    p = np.asarray(policies, np.float64)
    return float(np.round((np.sin(p[..., 0] * 0.7) * p[..., 1] + p[..., 2] ** 2).mean(), 12))


class _StubEval:
    """The evaluator surface the pipelines call; rewards depend on the
    proposals only, and each evaluation sleeps a seeded random time so that
    rounds finish out of order."""

    def __init__(self, jax_api: bool, seed: int = 0):
        self.jax_api = jax_api
        self.rng = random.Random(seed)
        self.lock = threading.Lock()
        self.draw_source, self.dev = PhiloxDraws(), torch.device("cpu")

    def _sleep(self):
        with self.lock:
            t = self.rng.uniform(0.0, 0.02)
        time.sleep(t)

    def evaluate(self, *args):
        policy_t = args[-2]
        self._sleep()
        return {"top1_valid": _reward(policy_t)}

    def evaluate_batch(self, *args):
        policies_t = np.asarray(args[-2])
        self._sleep()
        return [{"top1_valid": _reward(p)} for p in policies_t]


def _run(jax_side: bool, *, num_search, trial_batch, actors, depth, prefix=None, seed=3):
    mod, tmod = (JPL, JTPE) if jax_side else (PL, TPE)
    tpe = tmod.TPE(_space(tmod), seed=seed, n_startup=4)
    fold_trials = [list(e) for e in (prefix or [])]
    mod.replay_trial_log(tpe, fold_trials, trial_batch, num_search, max_inflight=actors + depth)
    evaluator = _StubEval(jax_side, seed=actors * 7 + depth)
    persisted = []
    kw = dict(num_search=num_search, trial_batch=trial_batch, actors=actors, queue_depth=depth,
              num_policy=NUM_POLICY, num_op=NUM_OP,
              persist=lambda: persisted.append(len(fold_trials)),
              record_quarantine=lambda *a: None)
    if jax_side:
        import jax

        stats = mod.run_fold_pipeline(evaluator, 0, {}, {}, tpe, jax.random.PRNGKey(5),
                                      fold_trials, **kw)
    else:
        stats = mod.run_fold_pipeline(evaluator, 0, "unused.msgpack", tpe, prng_key(5),
                                      fold_trials, **kw)
    log = json.loads(json.dumps([[e[0], e[1]] for e in fold_trials]))
    return log, {k: v for k, v in stats.items() if k != "tell_reorders"}, persisted


@pytest.mark.parametrize("trial_batch,actors,depth", [(1, 1, 0), (1, 2, 1), (2, 2, 1)],
                         ids=["lockstep", "two_actors", "batched"])
def test_fold_pipeline_matches_jax(trial_batch, actors, depth):
    mine = _run(False, num_search=10, trial_batch=trial_batch, actors=actors, depth=depth)
    theirs = _run(True, num_search=10, trial_batch=trial_batch, actors=actors, depth=depth)
    assert mine[0] == theirs[0]
    assert mine[1] == theirs[1]
    assert mine[2] == theirs[2]
    assert len(mine[0]) == 10


def test_one_lockstep_actor_is_the_serial_ask_tell_loop():
    log, _, _ = _run(False, num_search=8, trial_batch=1, actors=1, depth=0)
    tpe = TPE.TPE(_space(TPE), seed=3, n_startup=4)
    from fast_autoaugment_tpu_torch.policies.archive import policy_decoder, policy_to_tensor

    serial = []
    for _ in range(8):
        p = tpe.suggest()
        r = _reward(policy_to_tensor(policy_decoder(p, NUM_POLICY, NUM_OP)))
        tpe.tell(p, r)
        serial.append([p, r])
    assert log == json.loads(json.dumps(serial))


def test_resume_replays_the_interleaving():
    """A log cut after 4 trials, replayed through the ledger, continues to the
    uninterrupted pipeline's log (the JAX package's, bit for bit)."""
    whole, _, _ = _run(False, num_search=10, trial_batch=1, actors=2, depth=1)
    resumed, _, _ = _run(False, num_search=10, trial_batch=1, actors=2, depth=1,
                         prefix=whole[:4])
    theirs, _, _ = _run(True, num_search=10, trial_batch=1, actors=2, depth=1, prefix=whole[:4])
    assert resumed == whole == theirs


def test_ledger_matches_jax():
    for mod_pair in ((TPE, JTPE),):
        t_mine, t_theirs = (m.TPE(_space(m), seed=9, n_startup=3) for m in mod_pair)
        for t in (t_mine, t_theirs):
            first = t.ask_tagged(2)
            t.ask_tagged(2)
            t.tell(2, 0.4)  # out of order
            t.tell(0, 0.1)
            t.tell(1, 0.3)
            t.ask_tagged(1)
            assert [tid for tid, _ in first] == [0, 1]
        assert t_mine.pending_ids == t_theirs.pending_ids == [3, 4]
        assert t_mine.pending_rounds(2) == t_theirs.pending_rounds(2)
        assert t_mine.tell_reorders == t_theirs.tell_reorders == 1
        assert t_mine.worst_told() == t_theirs.worst_told() == 0.1
        assert json.dumps(t_mine.best_told) == json.dumps(t_theirs.best_told)
        assert t_mine.round_payload([3, 4]) == t_theirs.round_payload([3, 4])
        with pytest.raises(KeyError):
            t_mine.tell(0, 1.0)


def test_dispatch_trace_summary_matches_jax():
    windows = {"p2-fold0": [(0.0, 0.5), (0.4, 0.9), (1.0, 1.2), (1.25, 1.3), (3.0, 3.0005)],
               "p2-fold1": [(10.0, 10.01), (10.5, 11.0)], "empty": []}
    traces = (PL.DispatchTrace(), JPL.DispatchTrace())
    for tr in traces:
        assert tr.summary() is None
        tr.record(0.0, 1.0)  # outside a segment: ignored
        for seg, ws in windows.items():
            tr.begin_segment(seg)
            for w in ws:
                tr.record(*w)
            tr.end_segment()
    assert traces[0].summary() == traces[1].summary()
    assert traces[0].summary()["num_dispatches"] == 7


def _overlap(mod, err_type, fail_at=None):
    order = []

    def p1(f):
        time.sleep(0.05)
        if f == fail_at:
            raise err_type(f"preempted in fold {f}")
        order.append(("p1", f))

    def p2(f):
        order.append(("p2", f))
        time.sleep(0.08)

    return mod.run_overlapped_phases([0, 1, 2], p1, p2, poll_sec=0.01), order


def test_overlapped_phases_match_jax():
    (mine, order_m), (theirs, order_t) = _overlap(PL, R.PreemptedError), \
        _overlap(JPL, JR.PreemptedError)
    assert set(mine) == set(theirs) == {"phase1", "phase2", "folds", "overlap_secs"}
    assert set(mine["phase1"]) == set(theirs["phase1"]) == {"0", "1", "2"}
    assert all(set(v) == {"start", "end"} for v in mine["phase2"].values())
    assert mine["folds"] == theirs["folds"] == [0, 1, 2]
    assert mine["overlap_secs"] > 0 and theirs["overlap_secs"] > 0
    # phase 2 of a fold never starts before its phase 1 ended
    for o in (order_m, order_t):
        assert o.index(("p1", 1)) < o.index(("p2", 1))
    with pytest.raises(R.PreemptedError):
        _overlap(PL, R.PreemptedError, fail_at=1)
    with pytest.raises(JR.PreemptedError):
        _overlap(JPL, JR.PreemptedError, fail_at=1)


def test_resolve_async_pipeline_matches_jax():
    for spec in ("off", "on", True, False, None, "1", "0", "true", ""):
        assert PL.resolve_async_pipeline(spec) == JPL.resolve_async_pipeline(spec)
    for mod in (PL, JPL):
        with pytest.raises(ValueError):
            mod.resolve_async_pipeline("maybe")


def _search(tmp, name, **kw):
    save = str(tmp / name)
    res = D.search_policies(load_config(CONF, overrides=["epoch=1"]), "", save, cv_num=2,
                            num_policy=2, num_op=2, num_search=4, num_top=1,
                            fold_quality_floor=None, device="cpu", **kw)
    with open(os.path.join(save, "search_trials.json"), "rb") as fh:
        trials = fh.read()
    with open(os.path.join(save, "final_policy.json"), "rb") as fh:
        final = fh.read()
    return res, trials, final


@pytest.fixture
def two_threads():
    """Torch on 2 threads, put back afterwards: float32 results move with
    the count, and the next file in the same test worker runs on its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_search_with_the_pipeline_equals_the_serial_search(tmp_path, two_threads):
    off = _search(tmp_path, "off")
    on = _search(tmp_path, "on", async_pipeline="on", pipeline_actors=2,
                 pipeline_queue_depth=1, watchdog="auto")
    assert on[1] == off[1] and on[2] == off[2]
    pipe = on[0]["pipeline"]
    assert pipe["mode"] == "on" and pipe["actors"] == 2 and pipe["rounds"] == 8
    assert pipe["overlap"]["overlap_secs"] > 0 and set(pipe["overlap"]["phase2"]) == {"0", "1"}
    assert pipe["dispatch_gaps"]["num_dispatches"] > 0
    assert "pipeline" not in off[0]
    for res in (on[0], off[0]):
        assert res["tta_executables"] == res["tta_executables_expected"] == 0
        assert res["tta_executables_first"] == 0
        assert res["watchdog_fires"] == 0 and set(res["compile_cache"]) >= {"hits", "misses"}
    assert on[0]["resilience"]["watchdog"]["mode"] == "auto"
    assert set(on[0]["resilience"]["watchdog"]["ema_sec"]) >= {"tta", "train_dispatch"}
