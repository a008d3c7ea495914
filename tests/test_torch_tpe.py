"""The port's TPE (``fast_autoaugment_tpu_torch/search/tpe.py``), policy
decoding and phase-3 statistics against the JAX package's, on the CPU.

Oracle: the JAX package's ``search/tpe.py``, ``policies/archive.py``,
``search/driver.py draw_random_policy_set`` and ``utils/stats.py``.  Bound:
byte-equal trial logs (``json.dumps`` of every (proposal, reward)) for the
same seed and the same deterministic reward function, 40 trials with
``num_policy`` 5 and ``num_op`` 2 (the search space of the paper: 30
dimensions), far past ``n_startup``; equal decoded policies, equal random
sets, equal t-test dicts.
"""

import json
import math

import numpy as np
import pytest

from fast_autoaugment_tpu.policies import archive as JA
from fast_autoaugment_tpu.search import driver as JD
from fast_autoaugment_tpu.search import tpe as JT
from fast_autoaugment_tpu.utils import stats as JS
from fast_autoaugment_tpu_torch.policies import archive as A
from fast_autoaugment_tpu_torch.search import driver as D
from fast_autoaugment_tpu_torch.search import tpe as T
from fast_autoaugment_tpu_torch.utils import stats as S

NUM_POLICY, NUM_OP, TRIALS = 5, 2, 40


def reward(proposal: dict) -> float:
    """A deterministic reward with structure for the TPE to find: some ops
    pay, high probabilities and mid levels pay."""
    r = 0.0
    for i in range(NUM_POLICY):
        for j in range(NUM_OP):
            op = proposal[f"policy_{i}_{j}"]
            r += (op % 4 == 1) * 0.3 + proposal[f"prob_{i}_{j}"] * 0.2 \
                - abs(proposal[f"level_{i}_{j}"] - 0.4) * 0.5
    return round(r, 12)


def _log_sequential(mod, seed, n_startup):
    tpe = mod.TPE(D.make_search_space(NUM_POLICY, NUM_OP), seed=seed, n_startup=n_startup)
    log = []
    while len(tpe.observations) < TRIALS:
        p = tpe.suggest()
        tpe.tell(p, reward(p))
        log.append((p, reward(p)))
    return json.dumps(log), tpe.best


def _log_batched(mod, seed, n_startup, k):
    tpe = mod.TPE(D.make_search_space(NUM_POLICY, NUM_OP), seed=seed, n_startup=n_startup)
    log = []
    while len(tpe.observations) < TRIALS:
        ps = tpe.ask(min(k, TRIALS - len(tpe.observations)))
        rs = [reward(p) for p in ps]
        tpe.tell_batch(ps, rs)
        log.extend(zip(ps, rs))
    return json.dumps(log), tpe.best


@pytest.mark.parametrize("seed", [0, 1001])
def test_tpe_sequential_trial_log_is_byte_equal(seed):
    n_startup = min(20, max(5, 200 // 4))  # the driver's rule at the default budget
    got, got_best = _log_sequential(T, seed, n_startup)
    want, want_best = _log_sequential(JT, seed, n_startup)
    assert got == want
    assert json.dumps(got_best) == json.dumps(want_best)
    assert len(json.loads(got)) == TRIALS


@pytest.mark.parametrize("k", [1, 4])
def test_tpe_ask_tell_batch_trial_log_is_byte_equal(k):
    got, _ = _log_batched(T, 7, 10, k)
    want, _ = _log_batched(JT, 7, 10, k)
    assert got == want
    if k == 1:  # ask(1) is suggest
        assert got == _log_sequential(T, 7, 10)[0]


def test_search_space_and_decoder_equal_jax():
    assert D.make_search_space(NUM_POLICY, NUM_OP) == [
        T.Dim(d.name, d.kind, d.n, d.low, d.high) for d in
        JD.make_search_space(NUM_POLICY, NUM_OP)]
    tpe = T.TPE(D.make_search_space(NUM_POLICY, NUM_OP), seed=3)
    for _ in range(5):
        p = tpe.suggest()
        assert A.policy_decoder(p, NUM_POLICY, NUM_OP) == JA.policy_decoder(p, NUM_POLICY, NUM_OP)
    subs = [[("Rotate", 0.1, 0.2), ("Invert", 0.3, 0.4)], [("Rotate", 0.9, 0.9),
                                                          ("Invert", 0.0, 0.0)],
            [("Invert", 0.1, 0.2), ("Rotate", 0.3, 0.4)], [("Color", 0.5, 0.5)]]
    assert A.remove_duplicates(subs) == JA.remove_duplicates(subs) == [subs[0], subs[2],
                                                                       subs[3]]


@pytest.mark.parametrize("n,seed", [(1, 7), (8, 31 * 3 + 7), (40, 0)])
def test_draw_random_policy_set_equals_jax(n, seed):
    assert D.draw_random_policy_set(n, NUM_POLICY, NUM_OP, seed) == \
        JD.draw_random_policy_set(n, NUM_POLICY, NUM_OP, seed)
    with pytest.raises(ValueError, match="op-sequence space"):
        D.draw_random_policy_set(20, 1, 1, seed)


@pytest.mark.parametrize("a,b", [([0.5, 0.6, 0.55], [0.4, 0.45, 0.5]),
                                 ([0.1, 0.2], [0.1, 0.2]), ([0.3, 0.4], [0.2, 0.3]),
                                 ([0.9, 0.1, 0.5, 0.4], [0.2, 0.3, 0.6, 0.1])])
def test_paired_t_test_equals_jax(a, b):
    assert S.paired_t_test(a, b) == JS.paired_t_test(a, b)
    for t, df in ((0.7, 1), (2.5, 3), (-1.2, 9)):
        assert math.isclose(S.t_sf(t, df), JS.t_sf(t, df), rel_tol=0, abs_tol=0)
    with pytest.raises(ValueError):
        S.paired_t_test([1.0], [2.0])


def test_quality_floor_equals_jax():
    for floor in ("auto", "off", "none", None, "0.3", 0.45, 0, -1):
        for classes in (10, 100):
            assert D.resolve_quality_floor(floor, classes) == JD.resolve_quality_floor(
                floor, classes)
    assert np.isclose(D.resolve_quality_floor("auto", 10), 0.415)
