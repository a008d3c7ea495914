"""The port's lease queue (``fast_autoaugment_tpu_torch/launch/workqueue.py``)
against the JAX package's copy: claim/renew/steal races, observer-local
stale reclaim, epoch fencing, done markers, host census, the degraded-mode
accounting and the ``stale_lease`` fault (the cases of
``tests/test_workqueue.py``, on the port's queue); the lease, done, work and
host files of the two packages byte for byte under a frozen wall clock; and
the two packages' queues working one directory together.

Host code only: neither module imports JAX or torch.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

from fast_autoaugment_tpu.launch import workqueue as jax_workqueue
from fast_autoaugment_tpu.utils import faultinject as jax_faultinject
from fast_autoaugment_tpu_torch.launch.workqueue import LeaseLostError, WorkQueue
from fast_autoaugment_tpu_torch.utils import faultinject


@pytest.fixture(autouse=True)
def _clean_fault_env():
    saved = os.environ.pop("FAA_FAULT", None)
    faultinject.reset()
    jax_faultinject.reset()
    yield
    os.environ.pop("FAA_FAULT", None)
    if saved is not None:
        os.environ["FAA_FAULT"] = saved
    faultinject.reset()
    jax_faultinject.reset()


def _q(tmp_path, owner, ttl=60.0):
    return WorkQueue(str(tmp_path / "wq"), owner, lease_ttl=ttl)


def _watch_out_ttl(q, unit: str, margin: float = 0.05):
    """Observer-local staleness: the claimant must WATCH the foreign lease
    sit unchanged for a full TTL on its own clock before a reclaim is
    allowed.  The first claim observes (and declines), the wait makes the
    observation stale."""
    assert not q.claim(unit)
    time.sleep(q.lease_ttl + margin)


# ------------------------------------------- the JAX test file's cases


def test_claim_fresh_and_mutual_exclusion(tmp_path):
    a, b = _q(tmp_path, "a"), _q(tmp_path, "b")
    assert a.claim("u1")
    assert not b.claim("u1")
    lease = b.read_lease("u1")
    assert lease["owner"] == "a" and lease["attempt"] == 1 and lease["epoch"] == 1


def test_reclaim_own_lease_after_restart(tmp_path):
    a = _q(tmp_path, "a")
    assert a.claim("u1")
    a2 = _q(tmp_path, "a")  # the relaunched process, same owner tag
    assert a2.claim("u1")   # at once, no TTL wait
    lease = a2.read_lease("u1")
    assert lease["attempt"] == 1 and lease["epoch"] == 1


def test_renew_refreshes_heartbeat(tmp_path):
    a = _q(tmp_path, "a")
    a.claim("u1")
    hb0 = a.read_lease("u1")["heartbeat"]
    time.sleep(0.02)
    a.renew("u1")
    lease = a.read_lease("u1")
    assert lease["heartbeat"] > hb0 and lease["epoch"] == 1


def test_stale_lease_is_reclaimed_with_attempt_and_epoch_bump(tmp_path):
    a, b = _q(tmp_path, "a", ttl=0.15), _q(tmp_path, "b", ttl=0.15)
    assert a.claim("u1")
    _watch_out_ttl(b, "u1")
    assert b.claim("u1")
    lease = b.read_lease("u1")
    assert (lease["owner"], lease["attempt"], lease["epoch"], lease["reclaimed_from"]) == \
        ("b", 2, 2, "a")
    assert b.reclaimed_units == ["u1"]


def test_live_renewals_reset_the_observer_clock(tmp_path):
    a, b = _q(tmp_path, "a", ttl=0.2), _q(tmp_path, "b", ttl=0.2)
    assert a.claim("u1")
    for _ in range(3):
        assert not b.claim("u1")
        time.sleep(0.15)
        a.renew("u1")
    assert not b.claim("u1")


def test_skewed_heartbeat_stamps_cannot_fake_or_hide_death(tmp_path):
    a, b = _q(tmp_path, "a", ttl=0.15), _q(tmp_path, "b", ttl=0.15)
    assert a.claim("u1")
    path = a._lease_path("u1")
    rec = json.load(open(path))
    rec["heartbeat"] += 600.0
    with open(path, "w") as fh:
        json.dump(rec, fh)
    _watch_out_ttl(b, "u1")
    assert b.claim("u1")
    assert b.read_lease("u1")["epoch"] == 2
    a2, c = _q(tmp_path, "a2"), _q(tmp_path, "c")
    assert a2.claim("u2")
    path = a2._lease_path("u2")
    rec = json.load(open(path))
    rec["heartbeat"] -= 600.0
    with open(path, "w") as fh:
        json.dump(rec, fh)
    assert not c.claim("u2")


def test_renew_after_steal_raises_lease_lost(tmp_path):
    a, b = _q(tmp_path, "a", ttl=0.15), _q(tmp_path, "b", ttl=0.15)
    a.claim("u1")
    _watch_out_ttl(b, "u1")
    assert b.claim("u1")
    with pytest.raises(LeaseLostError):
        a.renew("u1")


def test_zombie_release_is_fenced_off(tmp_path):
    a, b = _q(tmp_path, "a", ttl=0.15), _q(tmp_path, "b", ttl=0.15)
    a.claim("u1")
    _watch_out_ttl(b, "u1")
    assert b.claim("u1")
    with pytest.raises(LeaseLostError):
        a.release("u1", info={"rewards": [0.0]})
    assert not a.is_done("u1")
    b.release("u1", info={"rewards": [1.0]})
    done = b.done_record("u1")
    assert done["owner"] == "b" and done["epoch"] == 2 and done["info"] == {"rewards": [1.0]}
    with pytest.raises(LeaseLostError):
        a.release("u1", info={"rewards": [0.0]})
    assert b.done_record("u1")["info"] == {"rewards": [1.0]}


def test_release_writes_done_marker_and_blocks_reclaim(tmp_path):
    a, b = _q(tmp_path, "a"), _q(tmp_path, "b")
    a.claim("u1")
    a.release("u1", info={"baseline": 0.9, "excluded": False})
    assert a.is_done("u1") and b.is_done("u1")
    assert not b.claim("u1")
    assert b.done_info("u1") == {"baseline": 0.9, "excluded": False}
    assert a.read_lease("u1") is None
    assert a.done_record("u1")["epoch"] == 1
    a.release("u1", info={"baseline": 0.9})  # idempotent


def test_old_format_lease_without_epoch_still_reclaims(tmp_path):
    a, b = _q(tmp_path, "a", ttl=0.15), _q(tmp_path, "b", ttl=0.15)
    a.claim("u1")
    path = a._lease_path("u1")
    rec = json.load(open(path))
    del rec["epoch"]
    with open(path, "w") as fh:
        json.dump(rec, fh)
    _watch_out_ttl(b, "u1")
    assert b.claim("u1")
    lease = b.read_lease("u1")
    assert lease["attempt"] == 2 and lease["epoch"] == 2


def _race(queues, unit):
    wins = []
    barrier = threading.Barrier(len(queues))

    def worker(q):
        barrier.wait(timeout=10)
        if q.claim(unit):
            wins.append(q.owner)

    ts = [threading.Thread(target=worker, args=(q,)) for q in queues]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    return wins


def test_claim_race_exactly_one_winner(tmp_path):
    assert len(_race([_q(tmp_path, f"h{i}") for i in range(8)], "u1")) == 1


def test_steal_race_exactly_one_winner(tmp_path):
    dead = _q(tmp_path, "dead", ttl=0.15)
    dead.claim("u1")
    queues = [_q(tmp_path, f"h{i}", ttl=0.15) for i in range(8)]
    for q in queues:
        assert not q.claim("u1")
    time.sleep(0.25)
    wins = _race(queues, "u1")
    assert len(wins) == 1, wins
    lease = queues[0].read_lease("u1")
    assert (lease["owner"], lease["attempt"], lease["epoch"]) == (wins[0], 2, 2)


def test_host_beats_and_lost_census(tmp_path):
    a, b = _q(tmp_path, "a", ttl=0.2), _q(tmp_path, "b", ttl=0.2)
    a.beat_host()
    b.beat_host()
    assert set(a.known_hosts()) == {"a", "b"} and a.lost_hosts() == []
    time.sleep(0.3)
    a.beat_host()
    assert a.lost_hosts() == ["b"]
    b.mark_host_done()
    assert a.lost_hosts() == []


def test_lost_census_never_lists_the_caller(tmp_path):
    a = _q(tmp_path, "a", ttl=0.1)
    a.beat_host()
    time.sleep(0.2)
    assert a.lost_hosts() == []
    assert _q(tmp_path, "b", ttl=0.1).lost_hosts() == ["a"]


def test_accounting_reports_global_reclaims_with_epochs(tmp_path):
    a, b = _q(tmp_path, "a", ttl=0.15), _q(tmp_path, "b", ttl=0.15)
    a.claim("u1")
    _watch_out_ttl(b, "u1")
    b.claim("u1")
    b.release("u1")
    b.claim("u2")
    b.release("u2")
    acct = _q(tmp_path, "c", ttl=0.15).accounting()
    assert acct["degraded"] is True and acct["num_reclaimed_units"] == 1
    rec = acct["reclaimed_units"][0]
    assert (rec["unit"], rec["finished_by"], rec["reclaimed_from"], rec["epoch"]) == \
        ("u1", "b", "a", 2)


def test_accounting_clean_run_not_degraded(tmp_path):
    a = _q(tmp_path, "a")
    a.claim("u1")
    a.release("u1")
    a.mark_host_done()
    assert a.accounting() == {"degraded": False, "lost_hosts": [], "reclaimed_units": [],
                              "num_reclaimed_units": 0}


def test_stale_lease_fault_drops_renewals(tmp_path):
    os.environ["FAA_FAULT"] = "stale_lease@unit=u1"
    faultinject.reset()
    a = _q(tmp_path, "a", ttl=5.0)
    a.claim("u1")
    hb0 = a.read_lease("u1")["heartbeat"]
    time.sleep(0.02)
    a.renew("u1")  # dropped: the injected wedged heartbeat
    assert a.read_lease("u1")["heartbeat"] == hb0
    a.claim("u2")
    time.sleep(0.02)
    a.renew("u2")
    assert a.read_lease("u2")["heartbeat"] > hb0


def test_unit_names_are_sanitized(tmp_path):
    a = _q(tmp_path, "a")
    assert a.claim("../../etc/passwd")
    assert all("/" not in name for name in os.listdir(os.path.join(a.root, "leases")))
    assert a.read_lease("../../etc/passwd")["owner"] == "a"


def test_publish_unit_payload_roundtrip_and_open_menu(tmp_path):
    q = _q(tmp_path, "host0")
    assert q.open_units() == []
    q.publish_unit("p2r-f0-t000000", {"ids": [0, 1], "fold": 0})
    q.publish_unit("p2r-f0-t000002", {"ids": [2, 3], "fold": 0})
    q.publish_unit("other-unit", {"x": 1})
    assert q.unit_payload("p2r-f0-t000000") == {"ids": [0, 1], "fold": 0,
                                                "unit": "p2r-f0-t000000"}
    assert q.unit_payload("missing") is None
    assert q.open_units("p2r-") == ["p2r-f0-t000000", "p2r-f0-t000002"]
    assert q.claim("p2r-f0-t000000")
    q.release("p2r-f0-t000000", info={"rewards": [0.5, 0.25]})
    assert q.open_units("p2r-") == ["p2r-f0-t000002"]
    q.publish_unit("p2r-f0-t000000", {"ids": [0, 1], "fold": 0})  # no resurrection
    assert q.open_units("p2r-") == ["p2r-f0-t000002"]


# --------------------------------------------------- against the JAX copy


@pytest.fixture()
def frozen_wall(monkeypatch):
    """Freeze the wall clock both packages stamp with (``telemetry.wall``
    reads ``time.time``)."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.125)


def _script(q_cls, root):
    """One scripted history on a fresh queue: claims, a renewal, a published
    unit, a release with info, host beats, a done beat."""
    a, b = q_cls(root, "host0"), q_cls(root, "host1")
    assert a.claim("p1-fold0") and a.claim("p1-fold1") and not b.claim("p1-fold0")
    a.renew("p1-fold1")
    a.publish_unit("p2r-f0-t000000", {"fold": 0, "ids": [0], "proposals": [{"p": 0.25}]})
    a.release("p1-fold0", info={"baseline": 0.5, "excluded": False})
    b.claim("p2r-f0-t000000")
    b.release("p2r-f0-t000000", info={"rewards": [0.75], "eval_secs": 0.125})
    a.beat_host({"role": "learner"})
    b.mark_host_done({"rounds_ok": 1})
    return a.accounting()


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_queue_files_byte_equal_to_jax(tmp_path, frozen_wall):
    """Lease, done, work and host files of the same history, byte for byte
    (the host beats carry this process's pid in both)."""
    ours = _script(WorkQueue, str(tmp_path / "torch"))
    theirs = _script(jax_workqueue.WorkQueue, str(tmp_path / "jax"))
    assert ours == theirs
    tree, jax_tree = _tree(tmp_path / "torch"), _tree(tmp_path / "jax")
    assert sorted(tree) == sorted(jax_tree) and tree == jax_tree
    assert {os.path.dirname(k) for k in tree} == {"leases", "done", "work", "hosts"}


def test_queues_of_both_packages_share_one_directory(tmp_path):
    """JAX claims; the port watches it out for a TTL and steals; the port
    releases with info; JAX reads the done marker and sees the reclaim in
    its accounting."""
    root = str(tmp_path / "wq")
    jax_q = jax_workqueue.WorkQueue(root, "jaxhost", lease_ttl=0.15)
    ours = WorkQueue(root, "torchhost", lease_ttl=0.15)
    assert jax_q.claim("p1-fold0")
    assert not ours.claim("p1-fold0")  # live elsewhere (watching starts)
    time.sleep(0.2)
    assert ours.claim("p1-fold0")
    with pytest.raises(jax_workqueue.LeaseLostError):
        jax_q.renew("p1-fold0")  # the robbed JAX host must stop
    ours.release("p1-fold0", info={"baseline": 0.875})
    assert jax_q.done_info("p1-fold0") == {"baseline": 0.875}
    rec = jax_q.done_record("p1-fold0")
    assert (rec["owner"], rec["attempt"], rec["epoch"], rec["reclaimed_from"]) == \
        ("torchhost", 2, 2, "jaxhost")
    assert jax_q.accounting()["reclaimed_units"] == ours.accounting()["reclaimed_units"]
    # and the other way round: the port claims, JAX steals and finishes
    assert ours.claim("p2-fold0")
    assert not jax_q.claim("p2-fold0")
    time.sleep(0.2)
    assert jax_q.claim("p2-fold0")
    with pytest.raises(LeaseLostError):
        ours.release("p2-fold0", info={})  # fenced
    jax_q.release("p2-fold0", info={"num_trials": 4})
    assert ours.done_info("p2-fold0") == {"num_trials": 4}
