"""The port's game days (``fast_autoaugment_tpu_torch/gameday/``,
``launch/gameday_cli.py``) against the JAX package's, on the CPU.

Every case of JAX ``tests/test_gameday.py`` runs on both packages with the
same inputs and holds the outputs equal (the JAX case is named in each
docstring), then asserts what the JAX case asserts.  Beyond them:

- the registry field by field and ``scaled`` of every scenario;
- ``build_schedule``, ``schedule_digest`` and every request body byte-equal
  for all six scenarios at seeds 20 and 21, full and at the smoke factor;
- the generated policies' digests through the port's ``policy_digest``;
- every child process the runner spawns for each scenario: a module of the
  port, the ``--device`` it was given, no ``JAX_PLATFORMS``, the fault plans
  where the JAX runner arms them;
- the CLI's flags, registry listing and provenance stamp against the JAX
  CLI's and ``bench.py``'s;
- one live scenario (``stale-fs-under-load`` at the smoke factor) over two
  of the port's replicas on the CPU behind its router: green, every replica
  reporting its device and launch counters at exit.

Bound: equality of every value, row, record (less its clocks and
envelope) and byte.  The whole smoke suite on the CPU is slow-marked, as
the JAX one is.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from fast_autoaugment_tpu import gameday as JG
from fast_autoaugment_tpu.core import telemetry as JT
from fast_autoaugment_tpu.gameday import runner as jax_runner
from fast_autoaugment_tpu.gameday import verdict as JV
from fast_autoaugment_tpu.gameday import workload as JW
from fast_autoaugment_tpu.launch import gameday_cli as jax_gameday_cli
from fast_autoaugment_tpu.serve import wire as jax_wire
from fast_autoaugment_tpu_torch import gameday as G
from fast_autoaugment_tpu_torch.core import telemetry as T
from fast_autoaugment_tpu_torch.gameday import runner
from fast_autoaugment_tpu_torch.gameday import verdict as V
from fast_autoaugment_tpu_torch.gameday import workload as W
from fast_autoaugment_tpu_torch.launch import gameday_cli
from fast_autoaugment_tpu_torch.serve import wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = 0.4
#: journal-envelope keys and the fields that carry a clock reading
CLOCK_KEYS = {"t_wall", "t_mono", "host", "pid", "tid", "thread", "seq", "attempt"}
#: the (package, its gameday modules) pairs every twin case runs on
PKGS = {"port": (G, V, W), "jax": (JG, JV, JW)}


@pytest.fixture(autouse=True)
def _quiet_telemetry():
    yield
    T._disable_for_tests()
    JT._disable_for_tests()


@pytest.fixture
def two_threads():
    """Torch on 2 threads, put back afterwards: the next file in the same
    test worker runs on its own count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _both(fn):
    """``fn(pkg, verdict, workload)`` on both packages; equal results."""
    got = {k: fn(*mods) for k, mods in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# ------------------------------------------------- schedule identity


def test_schedule_is_deterministic_for_every_scenario():
    """JAX case: ``test_schedule_is_deterministic_for_every_scenario``."""
    for name in G.SCENARIOS:
        def run(pkg, _v, _w):
            scn = pkg.SCENARIOS[name]
            a = pkg.build_schedule(scn.traffic, scn.seed)
            b = pkg.build_schedule(scn.traffic, scn.seed)
            assert a == b, name
            return [dataclasses.astuple(o) for o in a], pkg.schedule_digest(a)
        rows, digest = _both(run)
        assert len(digest) == 16 and len(rows) > 0, name


def test_schedule_digest_tracks_seed_and_traffic():
    """JAX case: ``test_schedule_digest_tracks_seed_and_traffic``."""
    def run(pkg, _v, _w):
        scn = pkg.SCENARIOS["flash-crowd-10x"]
        return (pkg.schedule_digest(pkg.build_schedule(scn.traffic, scn.seed)),
                pkg.schedule_digest(pkg.build_schedule(scn.traffic, scn.seed + 1)),
                pkg.schedule_digest(pkg.build_schedule(dataclasses.replace(
                    scn.traffic, base_rps=scn.traffic.base_rps + 1.0), scn.seed)))
    base, other_seed, other_shape = _both(run)
    assert base != other_seed and base != other_shape


def _body_bytes(wl, offered, image):
    body, headers, imgs = wl.request_body(offered, image)
    keys = headers.get("_keys")
    return (body, {k: v for k, v in headers.items() if k != "_keys"},
            None if keys is None else (keys.dtype.str, keys.tobytes()),
            None if imgs is None else (imgs.dtype.str, imgs.shape, imgs.tobytes()))


def test_request_bodies_are_deterministic_and_decodable():
    """JAX case: ``test_request_bodies_are_deterministic_and_decodable``."""
    def run(pkg, _v, wl):
        scn = pkg.SCENARIOS["flash-crowd-10x"]
        by_lane = {}
        for o in pkg.build_schedule(scn.traffic, scn.seed):
            by_lane.setdefault(o.lane, o)
        assert set(by_lane) == {"raw", "npz", "shm"}
        out = {}
        for lane, o in by_lane.items():
            first, again = _body_bytes(wl, o, 8), _body_bytes(wl, o, 8)
            assert first == again
            _b, h, _imgs = wl.request_body(o, image=8)
            if lane == "shm":
                keys = h["_keys"]
                assert keys.shape == (o.batch, 2)
                assert (keys[:, 0] == 0).all()  # PRNGKey(seed) layout
            else:
                assert first[3] is None
            out[lane] = first
        return out
    bodies = _both(run)
    for mod in (wire, jax_wire):
        imgs, keys = mod.decode_raw(bodies["raw"][0])
        assert imgs.shape == (4, 8, 8, 3) and keys.shape == (4, 2)


def test_rate_curves():
    """JAX case: ``test_rate_curves``."""
    def run(pkg, _v, _w):
        flash = pkg.Traffic(kind="flash", duration_s=10.0, base_rps=5.0, peak_rps=50.0,
                            flash_at_frac=0.5, ramp_s=2.0)
        di = pkg.Traffic(kind="diurnal", duration_s=20.0, base_rps=4.0, peak_rps=12.0,
                         period_s=10.0)
        with pytest.raises(ValueError, match="unknown traffic kind"):
            pkg.Traffic(kind="lunar").rate_at(1.0)
        return ([flash.rate_at(t) for t in (-1.0, 10.0, 1.0, 6.0, 9.0)], flash.peak_rate,
                [di.rate_at(t) for t in np.linspace(-1.0, 21.0, 89)],
                pkg.Traffic(kind="constant", base_rps=7.0).rate_at(1.0))
    flash, peak, diurnal, const = _both(run)
    assert flash[:3] == [0.0, 0.0, 5.0] and flash[3] == pytest.approx(27.5)
    assert flash[4] == 50.0 and peak == 50.0 and const == 7.0
    assert diurnal[4] == pytest.approx(4.0) and diurnal[24] == pytest.approx(12.0)


# ------------------------------------------------- registry + scaling


def _fields(scn) -> dict:
    """A scenario as plain data: its class name and fields, nested."""
    return {"cls": type(scn).__name__, **{f.name: (_fields(v) if dataclasses.is_dataclass(v)
                                                    else v)
                                          for f in dataclasses.fields(scn)
                                          for v in (getattr(scn, f.name),)}}


def test_registry_field_by_field_and_scaled():
    """The registry equals JAX ``SCENARIOS`` field by field (the dataclass
    fields and defaults too), and so does ``scaled`` of every scenario at
    the smoke factor and at 0.1 and 1.0."""
    assert G.suite_names() == JG.suite_names()
    for cls in ("Traffic", "Plane", "Kill", "Scenario"):
        assert [(f.name, f.default) for f in dataclasses.fields(getattr(G, cls))] == \
            [(f.name, f.default) for f in dataclasses.fields(getattr(JG, cls))], cls
    for name in G.suite_names():
        assert _fields(G.SCENARIOS[name]) == _fields(JG.SCENARIOS[name]), name
        for factor in (SMOKE, 0.1, 1.0):
            assert _fields(G.scaled(G.SCENARIOS[name], factor)) == \
                _fields(JG.scaled(JG.SCENARIOS[name], factor)), (name, factor)


def test_registry_has_teeth_and_resolvable_predicates():
    """JAX case: ``test_registry_has_teeth_and_resolvable_predicates``."""
    names = G.suite_names()
    assert len(names) >= 6 and names == list(G.SCENARIOS)
    expects = [G.SCENARIOS[n].expect for n in names]
    assert expects.count("pass") >= 5 and expects.count("fail") >= 1
    assert sorted(V.PREDICATES) == sorted(JV.PREDICATES)
    for name in names:
        for pred, params in G.SCENARIOS[name].predicates:
            assert pred in V.PREDICATES, f"{name}: {pred}"
            assert isinstance(params, dict)


def test_scaled_shrinks_load_and_scales_dispatch_floor():
    """JAX case: ``test_scaled_shrinks_load_and_scales_dispatch_floor``."""
    scn = G.SCENARIOS["flash-crowd-10x"]
    sm = G.scaled(scn, SMOKE)
    assert sm.traffic.duration_s == pytest.approx(scn.traffic.duration_s * SMOKE)
    assert sm.traffic.peak_rps == pytest.approx(scn.traffic.peak_rps * SMOKE)
    assert sm.plane.dispatch_floor_ms == pytest.approx(scn.plane.dispatch_floor_ms / SMOKE)
    assert sm.predicates == scn.predicates
    assert G.scaled(G.SCENARIOS["replica-loss-mid-canary"], SMOKE).plane.dispatch_floor_ms \
        == 0.0


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("seed", [20, 21])
def test_schedules_and_bodies_byte_equal_to_jax(seed, smoke):
    """Every scenario's schedule, digest and every request body (bytes,
    headers, the shm lane's keys and images) byte-equal to the JAX
    generator's at `seed`, full and scaled to the smoke factor."""
    n = 0
    for name in G.suite_names():
        scn, jscn = G.SCENARIOS[name], JG.SCENARIOS[name]
        if smoke:
            scn, jscn = G.scaled(scn, SMOKE), JG.scaled(jscn, SMOKE)
        sched = G.build_schedule(scn.traffic, seed)
        jsched = JG.build_schedule(jscn.traffic, seed)
        assert [dataclasses.astuple(o) for o in sched] == \
            [dataclasses.astuple(o) for o in jsched], name
        assert G.schedule_digest(sched) == JG.schedule_digest(jsched), name
        for o, jo in zip(sched, jsched):
            assert _body_bytes(W, o, scn.plane.image) == _body_bytes(JW, jo, jscn.plane.image)
        n += len(sched)
    assert n > 0


# ------------------------------------------------- verdict predicates


def _report(**kw) -> dict:
    base = {"offered": 100, "completed": 100, "ok": 90, "shed": 10,
            "unexpected_status": 0, "transport_errors": 0,
            "cancelled": 0, "ok_by_tenant": {"0": 90},
            "shed_by_status": {"503": 10}, "p99_ms_ok": 50.0,
            "shm_created": 5, "shm_leftover": [],
            "errors_sample": []}
    base.update(kw)
    return base


def _ev(journal=(), **kw) -> dict:
    ev = {"report": _report(), "journal": list(journal),
          "router_stats": None, "killed": None, "tenants": 1}
    ev.update(kw)
    return ev


def _rec(etype, t, **fields):
    return {"type": etype, "t_wall": t, **fields}


def _rows(name, cases):
    """Each ``(evidence, params)`` of `cases` through predicate `name` of
    both packages: the rows as dicts, equal."""
    def run(_pkg, vd, _w):
        return [vd.PREDICATES[name](ev, **params).to_dict() for ev, params in cases]
    return _both(run)


def _oks(name, cases):
    return [r["ok"] for r in _rows(name, cases)]


def test_goodput_floor():
    """JAX case: ``test_goodput_floor``."""
    assert _oks("goodput_floor", [
        (_ev(), {"floor": 0.9}), (_ev(), {"floor": 0.95}),
        ({"report": _report(offered=0, ok=0)}, {"floor": 0.1})]) == [True, False, False]


def test_shed_not_hang():
    """JAX case: ``test_shed_not_hang``."""
    hung = _ev(report=_report(transport_errors=3))
    assert _oks("shed_not_hang", [
        (_ev(), {}), (hung, {}), (hung, {"max_hung": 3}),
        (_ev(report=_report(unexpected_status=1)), {}),
        (_ev(report=_report(p99_ms_ok=900.0)), {"p99_ms_ok": 500.0})]) == \
        [True, False, True, False, False]


def test_max_transport_errors():
    """JAX case: ``test_max_transport_errors``."""
    bad = _ev(report=_report(transport_errors=2, errors_sample=["timed out"]))
    rows = _rows("max_transport_errors", [(_ev(), {"max_errors": 0}),
                                          (bad, {"max_errors": 1})])
    assert rows[0]["ok"] and not rows[1]["ok"]
    assert rows[1]["observed"]["errors_sample"] == ["timed out"]


def test_affinity_floor():
    """JAX case: ``test_affinity_floor``."""
    stats = {"affinity": {"hits": 80, "misses": 20, "hit_rate": 0.8}}
    assert _oks("affinity_floor", [
        (_ev(router_stats=stats), {"floor": 0.75}), (_ev(router_stats=stats), {"floor": 0.9}),
        (_ev(), {"floor": 0.1})]) == [True, False, False]


def test_autoscaler_bounds():
    """JAX case: ``test_autoscaler_bounds``."""
    j = [_rec("scale_up", 1.0, replicas_after=2), _rec("scale_up", 2.0, replicas_after=3),
         _rec("scale_down", 9.0, replicas_after=2)]
    out = j + [_rec("scale_up", 3.0, replicas_after=7)]
    bounds = {"min_replicas": 1, "max_replicas": 3}
    rows = _rows("autoscaler_bounds", [
        (_ev(journal=j), dict(bounds, require_scale_up=True)), (_ev(journal=out), bounds),
        (_ev(journal=[]), dict(bounds, require_scale_up=True))])
    assert [r["ok"] for r in rows] == [True, False, False]
    assert rows[0]["observed"]["scale_ups"] == 2


def test_control_decision_requires_causal_order():
    """JAX case: ``test_control_decision_requires_causal_order``."""
    good = [_rec("drift", 1.0), _rec("canary", 2.0, action="rollout"), _rec("promote", 8.0)]
    rollback = [_rec("drift", 1.0), _rec("canary", 2.0, action="rollout"),
                _rec("rollback", 8.0)]
    shuffled = [_rec("canary", 1.0, action="rollout"), _rec("drift", 2.0),
                _rec("promote", 8.0)]
    rows = _rows("control_decision", [
        (_ev(journal=good), {}), (_ev(journal=rollback), {}), (_ev(journal=shuffled), {}),
        (_ev(journal=good[:2]), {}), (_ev(journal=good[:2]), {"require_terminal": False})])
    assert [r["ok"] for r in rows] == [True, True, False, False, True]
    assert rows[1]["observed"]["decision"] == "rollback"


def test_rotation_ejected_falls_back_to_killed_tag():
    """JAX case: ``test_rotation_ejected_falls_back_to_killed_tag``."""
    j = [_rec("rotation", 1.0, action="eject", replica="replica2")]
    assert _oks("rotation_ejected", [
        (_ev(journal=j, killed="replica2"), {}), (_ev(journal=j, killed="replica0"), {}),
        (_ev(journal=j), {"tag": "replica2"}), (_ev(), {})]) == [True, False, True, False]


def test_tenant_churn_and_cohort_service():
    """JAX case: ``test_tenant_churn_and_cohort_service``."""
    j = [_rec("tenant", t, action="admit") for t in (1.0, 2.0, 3.0)] \
        + [_rec("tenant", 4.0, action="evict")]
    assert _oks("tenant_churn", [(_ev(journal=j), {"min_admits": 3, "min_evicts": 1}),
                                 (_ev(journal=j), {"min_admits": 4, "min_evicts": 1})]) == \
        [True, False]
    served = _ev(report=_report(ok_by_tenant={"0": 5, "1": 2, "2": 1, "3": 9}), tenants=4)
    starved = _ev(report=_report(ok_by_tenant={"0": 5, "1": 2}), tenants=4)
    rows = _rows("all_cohorts_served", [(served, {}), (starved, {})])
    assert rows[0]["ok"] and not rows[1]["ok"]
    assert rows[1]["observed"]["starved"] == [2, 3]


def test_fsfault_observed_and_no_shm_leak():
    """JAX case: ``test_fsfault_observed_and_no_shm_leak``."""
    j = [_rec("fsfault", 1.0, kind="lag"), _rec("fsfault", 2.0, kind="eio")]
    assert _oks("fsfault_observed", [(_ev(journal=j), {}), (_ev(), {})]) == [True, False]
    assert _oks("no_shm_leak", [(_ev(), {}), (_ev(report=_report(
        shm_leftover=["psm_dead"])), {})]) == [True, False]


# ------------------------------------------------- evaluate + table


def test_evaluate_expected_fail_inverts_suite_greenness():
    """JAX case: ``test_evaluate_expected_fail_inverts_suite_greenness``."""
    def run(pkg, vd, _w):
        scn = pkg.SCENARIOS["flash-crowd-10x-noshed"]
        hung = _ev(report=_report(transport_errors=40, ok=30))
        return (scn.expect, vd.evaluate(scn, hung, schedule_digest="cafe"),
                vd.evaluate(scn, _ev(), schedule_digest="cafe"))
    expect, hung, healthy = _both(run)
    assert expect == "fail"
    assert hung["pass"] is False and hung["ok_as_expected"] is True
    assert healthy["pass"] is True and healthy["ok_as_expected"] is False


def test_evaluate_contains_unknown_and_crashing_predicates():
    """JAX case: ``test_evaluate_contains_unknown_and_crashing_predicates``."""
    def run(pkg, vd, _w):
        scn = dataclasses.replace(pkg.SCENARIOS["stale-fs-under-load"],
                                  predicates=(("no_such_predicate", {}),
                                              ("goodput_floor", {"floor": 0.1})))
        crash = vd.evaluate(dataclasses.replace(
            scn, predicates=(("goodput_floor", {"floor": 0.1}),)), {"journal": []})
        return vd.evaluate(scn, _ev()), crash
    rec, crash = _both(run)
    rows = {r["predicate"]: r for r in rec["predicates"]}
    assert rows["no_such_predicate"]["ok"] is False and rows["goodput_floor"]["ok"] is True
    assert rec["pass"] is False
    assert crash["pass"] is False and crash["predicates"][0]["detail"] == "predicate crashed"


def test_render_table_marks_expectations():
    """JAX case: ``test_render_table_marks_expectations``; both tables
    equal, character for character."""
    def run(pkg, vd, _w):
        scn = pkg.SCENARIOS["flash-crowd-10x-noshed"]
        ok_rec = vd.evaluate(pkg.SCENARIOS["stale-fs-under-load"],
                             _ev(journal=[_rec("fsfault", 1.0, kind="lag")]))
        fail_rec = vd.evaluate(scn, _ev(report=_report(transport_errors=40, ok=30)))
        missed = vd.evaluate(scn, _ev())
        return (vd.render_table([ok_rec, fail_rec]), vd.render_table([ok_rec, missed]),
                vd.render_table([missed]))
    green, red, missed = _both(run)
    assert "FAIL (expected-fail)" in green and "suite:" in green
    assert "RED" in red and "(!! expected FAIL)" in missed


def test_evaluate_and_render_every_scenario_on_synthetic_evidence():
    """``evaluate`` of every registered scenario and ``render_table`` of the
    suite equal to the JAX engine's, on one evidence dict holding every
    kind of event the catalog reads."""
    journal = [_rec("drift", 1.0), _rec("canary", 2.0, action="rollout", replica="replica1"),
               _rec("promote", 9.0), _rec("scale_up", 3.0, replicas_after=2),
               _rec("tenant", 4.0, action="admit"), _rec("tenant", 5.0, action="evict"),
               _rec("rotation", 6.0, action="eject", replica="replica1"),
               _rec("fsfault", 7.0, kind="lag")]
    ev = _ev(journal=journal, killed="replica1", tenants=3,
             report=_report(ok_by_tenant={"0": 50, "1": 30, "2": 10}))

    def run(pkg, vd, _w):
        recs = [vd.evaluate(pkg.SCENARIOS[n], ev, schedule_digest=str(i))
                for i, n in enumerate(pkg.suite_names())]
        return recs, vd.render_table(recs)
    recs, table = _both(run)
    assert len(recs) == 6 and "suite:" in table


def test_scenario_and_verdict_are_journaled_event_types(tmp_path):
    """JAX case: ``test_scenario_and_verdict_are_journaled_event_types``;
    both journals hold the same records."""
    got = {}
    for key, mod, kw in (("port", T, {}), ("jax", JT, {"tb_bridge": False})):
        d = str(tmp_path / key)
        mod.enable_telemetry(d, **kw)
        mod.emit("scenario", "gameday", scenario="x", action="start", seed=1)
        mod.emit("verdict", "gameday", scenario="x", predicate="goodput_floor", ok=True)
        mod.journal_flush()
        mod._disable_for_tests()
        got[key] = _journal_records(d)
    assert got["port"] == got["jax"]
    assert {"scenario", "verdict"} <= {r["type"] for r in got["port"]}


def _journal_records(d):
    out = []
    for path in sorted(glob.glob(os.path.join(d, "**", "journal-*.jsonl"), recursive=True)):
        with open(path) as fh:
            out.extend(json.loads(ln) for ln in fh if ln.strip())
    out.sort(key=lambda r: (r.get("seq") or 0))
    return [{k: v for k, v in r.items() if k not in CLOCK_KEYS} for r in out]


def test_faa_status_gameday_section(tmp_path):
    """JAX case: ``test_faa_status_gameday_section``, without the status
    tool: the game-day lifecycle the tool reads (start, phase, progress,
    kill, verdict, end), emitted through both packages' journals, gives the
    same records."""
    got = {}
    for key, mod, kw in (("port", T, {}), ("jax", JT, {"tb_bridge": False})):
        d = str(tmp_path / key)
        mod.enable_telemetry(d, **kw)
        mod.emit("scenario", "flash-crowd-10x", action="start", seed=20,
                 schedule_digest="ab12", requests=100, traffic="flash", expect="pass")
        mod.emit("scenario", "flash-crowd-10x", action="phase", phase="traffic")
        mod.emit("scenario", "flash-crowd-10x", action="progress", offered=40,
                 completed=30, ok=24)
        mod.emit("scenario", "flash-crowd-10x", action="kill", replica="replica1",
                 victim_pid=4242)
        mod.emit("verdict", "stale-fs-under-load", predicate="goodput_floor", ok=True,
                 observed={"goodput": 0.97}, bound={"floor": 0.8})
        mod.emit("scenario", "stale-fs-under-load", action="end", passed=True,
                 expect="pass", ok_as_expected=True, schedule_digest="cd34", elapsed_s=31.0)
        mod.journal_flush()
        mod._disable_for_tests()
        got[key] = _journal_records(d)
    assert got["port"] == got["jax"] and len(got["port"]) == 6
    kill = next(r for r in got["port"] if r.get("action") == "kill")
    assert kill["replica"] == "replica1" and kill["victim_pid"] == 4242


def test_shed_statuses_are_the_structured_rejections():
    """JAX case: ``test_shed_statuses_are_the_structured_rejections``."""
    assert W.SHED_STATUSES == JW.SHED_STATUSES == {400, 408, 413, 429, 503}
    assert 500 not in W.SHED_STATUSES and 502 not in W.SHED_STATUSES


# ------------------------------------------------- the runner's seams


def test_generated_policies_and_digests_equal_jax(tmp_path):
    """``_policy_spec(i)`` and the files the runner writes equal the JAX
    runner's, and their digests through the port's ``build_policy_tensor``
    and ``policy_digest`` equal the JAX serving stack's, for i = 0..3."""
    for i in range(4):
        assert runner._policy_spec(i) == jax_runner._policy_spec(i)
    paths = runner._write_policies(str(tmp_path / "port"), 4)
    jpaths = jax_runner._write_policies(str(tmp_path / "jax"), 4)
    for p, jp in zip(paths, jpaths):
        with open(p, "rb") as fh, open(jp, "rb") as jfh:
            assert fh.read() == jfh.read()
    digests = runner._policy_digests(paths)
    assert digests == jax_runner._policy_digests(jpaths)
    assert len(set(digests)) == 4 and all(len(d) == 12 for d in digests)


class _FakeProc:
    def __init__(self, argv, env=None, cwd=None):
        self.argv, self.env, self.returncode = list(argv), dict(env or {}), None

    def poll(self):
        return self.returncode

    def send_signal(self, _sig):
        self.returncode = 0

    def wait(self, timeout=None):
        self.returncode = 0 if self.returncode is None else self.returncode
        return self.returncode

    def kill(self):
        self.returncode = -9


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_runner_children_are_port_modules_on_the_device(tmp_path, monkeypatch, device):
    """Every process ``_bring_up`` spawns for each scenario names a module
    of the port; the replicas (and the autoscaler's replica command after
    ``--``) carry ``--device``; no child sees ``JAX_PLATFORMS``; the fault
    plans are armed where the JAX runner arms them (``FAA_FAULT`` on
    replicas and the autoscaler, ``FAA_FSFAULT`` on the router); a
    replica's command is the JAX runner's with the module renamed and
    ``--device`` added."""
    spawned = []

    def popen(argv, env=None, cwd=None):
        spawned.append(_FakeProc(argv, env, cwd))
        return spawned[-1]

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("FAA_FAULT", "ambient")
    monkeypatch.setattr(runner.subprocess, "Popen", popen)
    monkeypatch.setattr(runner, "_wait", lambda *a, **k: 8123)
    for name in G.suite_names():
        scn = G.SCENARIOS[name]
        spawned.clear()
        work = str(tmp_path / name)
        policies = runner._write_policies(os.path.join(work, "policies"),
                                          scn.plane.policies + scn.plane.controller)
        handle = runner._bring_up(scn, work, str(tmp_path / "cc"), policies, device)
        runner._teardown(handle)
        names = [n for n, _p in handle.procs]
        pl = scn.plane
        want = (["autoscaler"] if pl.autoscaler
                else [f"replica{i}" for i in range(pl.replicas)]) + ["router"] \
            + (["controller"] if pl.controller else [])
        assert names == want, name
        for (role, _p), proc in zip(handle.procs, spawned):
            argv, env = proc.argv, proc.env
            assert argv[:2] == [sys.executable, "-m"], (name, role)
            assert argv[2].startswith("fast_autoaugment_tpu_torch."), (name, role, argv[2])
            assert "JAX_PLATFORMS" not in env and "FAA_TELEMETRY" not in env
            fault = scn.faults if role.startswith(("replica", "autoscaler")) else None
            assert env.get("FAA_FAULT") == (fault or None), (name, role)
            assert env.get("FAA_FSFAULT") == ((scn.fsfaults or None) if role == "router"
                                              else None), (name, role)
            rep = argv[argv.index("--") + 1:] if role == "autoscaler" else argv
            if role.startswith(("replica", "autoscaler")):
                assert rep[2] == "fast_autoaugment_tpu_torch.serve.serve_cli"
                assert rep[rep.index("--device") + 1] == device, (name, role)
            else:
                assert "--device" not in argv, (name, role)
        pol_dir = os.path.dirname(policies[0]) if pl.tenant_capacity > 0 else None
        cmd = runner._replica_cmd(scn, policies[0], "tel", "cc", pol_dir, device)
        jcmd = jax_runner._replica_cmd(scn, policies[0], "tel", "cc", pol_dir)
        assert cmd[:2] + cmd[3:5] + cmd[7:] == jcmd[:2] + jcmd[3:]
        assert cmd[5:7] == ["--device", device]
        assert jcmd[2] == "fast_autoaugment_tpu.serve.serve_cli"


# ------------------------------------------------- the CLI


def _flags(parser):
    return {a.dest: (sorted(a.option_strings), a.default) for a in parser._actions}


def test_gameday_cli_flags_listing_and_stamp(capsys):
    """Every JAX flag with its default, plus ``--device`` (``cuda`` by
    default); ``--list`` prints the JAX CLI's listing; an unknown scenario
    exits 2 in both; the provenance stamp has ``bench.py``'s keys and
    shapes."""
    ours, theirs = _flags(gameday_cli.build_parser()), _flags(jax_gameday_cli.build_parser())
    assert ours.pop("device") == (["--device"], "cuda")
    assert ours == theirs
    listings = []
    for mod in (gameday_cli, jax_gameday_cli):
        assert mod.main(["--list"]) == 0
        listings.append(capsys.readouterr().out)
        assert mod.main(["--scenario", "no-such-day"]) == 2
        capsys.readouterr()
    assert listings[0] == listings[1] and len(listings[0].splitlines()) == 6
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    ours = gameday_cli.telemetry_stamp(gameday_cli.host_contention_stamp())
    theirs = bench.telemetry_stamp()
    assert set(ours) == set(theirs) and ours["schema_version"] == theirs["schema_version"]
    for key in ("contention", "watchdog", "compile_cache"):
        assert set(ours[key]) == set(theirs[key]), key
    assert set(gameday_cli.host_contention_stamp()) == set(bench.host_contention_stamp())
    assert ours["watchdog"] == bench.watchdog_stamp(())
    assert gameday_cli.refuse_or_flag_contention({"contended": False}) == {"contended": False}


def test_replica_reports_fail_every_end_but_a_stop_while_starting():
    """A replica without counters is ``never_served`` only when the router
    never admitted it and its scale-down ended it by SIGTERM or SIGKILL;
    a failed start, a crash, an admitted replica's silent end or no exit
    mark at all is ``failed``, with the exit code its supervisor saw."""
    handle = runner._PlaneHandle("w", "t", "p")
    handle.spawned = ["replica0", "replica1"]
    handle.killed = "replica1"

    def mark(event, tag, **kw):
        return {"type": "mark", "event": event, "replica": tag, **kw}

    journal = [mark("serve_exit", "replica0", device="cuda:0", dispatches=3)]
    journal += [{"type": "scale_up", "replica": f"replica{i}"} for i in range(2, 8)]
    journal += [{"type": "rotation", "action": "readmit", "replica": "replica5"},
                mark("replica_exit", "replica2", exit_code=-15, cause="scale_down"),
                mark("replica_exit", "replica3", exit_code=-9, cause="scale_down"),
                mark("replica_exit", "replica4", exit_code=2, cause="exited"),
                mark("replica_exit", "replica5", exit_code=-15, cause="scale_down"),
                mark("replica_exit", "replica6", exit_code=0, cause="scale_down")]
    got = runner._replica_reports(handle, journal, {"replica7": -11})
    assert {t: r["source"] for t, r in got.items()} == {
        "replica0": "serve_exit", "replica1": "killed", "replica2": "never_served",
        "replica3": "never_served", "replica4": "failed", "replica5": "failed",
        "replica6": "failed", "replica7": "failed"}
    assert got["replica0"]["device"] == "cuda:0" and got["replica0"]["dispatches"] == 3
    assert got["replica2"] == {"source": "never_served", "exit_code": -15,
                               "cause": "scale_down"}
    assert got["replica4"] == {"source": "failed", "exit_code": 2, "cause": "exited"}
    assert got["replica7"] == {"source": "failed", "exit_code": -11, "cause": None}
    handle.killed_stats = {"device": "cuda:0", "dispatches": 1}
    assert runner._replica_reports(handle, journal, {})["replica1"]["source"] == \
        "killed_stats"


def test_autoscaled_fleet_journals_how_each_replica_ended(tmp_path):
    """The autoscaler's fleet journals a ``replica_exit`` mark for every
    replica it reaps (``exited``, with its own exit code) or stops
    (``scale_down``, with the SIGTERM that ended it)."""
    from fast_autoaugment_tpu_torch.serve.autoscaler import LocalReplicaFleet

    tel = str(tmp_path / "tel")
    T.enable_telemetry(tel)
    crash = LocalReplicaFleet([sys.executable, "-c", "import sys; sys.exit(2)"],
                              str(tmp_path / "ports"))
    tag = crash.scale_up()
    crash._procs[0][1].wait(timeout=30)
    assert crash.count() == 0
    idle = LocalReplicaFleet([sys.executable, "-c", "import time; time.sleep(60)"],
                             str(tmp_path / "ports"), tag_prefix="idle")
    idle.scale_up()
    assert idle.scale_down(drain_timeout=30) == "idle0" and idle.count() == 0
    T.journal_flush()
    ends = {r["replica"]: (r["exit_code"], r["cause"]) for r in _journal_records(tel)
            if r.get("event") == "replica_exit"}
    assert ends == {tag: (2, "exited"), "idle0": (-15, "scale_down")}


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without CUDA")
def test_cuda_replica_without_a_card_fails_its_scenario(tmp_path):
    """No fallback hides the card: on a host without CUDA, an autoscaled
    ``--device cuda`` replica exits at start, the autoscaler journals its
    exit, and the scenario fails its bring-up at once; the suite is red."""
    result = runner.run_suite(["flash-crowd-10x"], smoke=True, root=str(tmp_path / "gd"),
                              device="cuda")
    rec = result["records"][0]
    assert rec["ok_as_expected"] is False and result["suite_green"] is False
    assert "replica0 exited 2 during bring-up" in rec["error"], rec


# ------------------------------------------------- live on the CPU


def test_live_stale_fs_scenario_on_cpu_replicas(tmp_path, monkeypatch, two_threads):
    """``stale-fs-under-load`` at the smoke factor, live: two of the port's
    ``serve_cli --device cpu`` replicas behind its ``router_cli`` with the
    router's shared-FS faults, the open-loop workload over the raw, npz
    and shm lanes.  Green; the schedule digest is the port's (and the
    JAX generator's); every replica reports its device and launch counters
    at exit (the CPU launches no kernel); the journal holds the lifecycle,
    the verdicts and the injected faults; no shm region is left."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the replicas' torch threads
    root = str(tmp_path / "gd")
    result = runner.run_suite(["stale-fs-under-load"], smoke=True, keep=True, root=root,
                              device="cpu")
    rec = result["records"][0]
    assert rec.get("error") is None, rec
    assert rec["pass"] is True and rec["ok_as_expected"] is True, rec
    assert result["suite_green"] is True and "GREEN" in result["table"]
    assert result["device"] == rec["device"] == "cpu"
    scn = G.scaled(G.SCENARIOS["stale-fs-under-load"], SMOKE)
    assert rec["schedule_digest"] == G.schedule_digest(G.build_schedule(
        scn.traffic, scn.seed)) == JG.schedule_digest(JG.build_schedule(
            JG.scaled(JG.SCENARIOS["stale-fs-under-load"], SMOKE).traffic, scn.seed))
    assert sorted(rec["replicas"]) == ["replica0", "replica1"]
    served = 0
    for tag, r in rec["replicas"].items():
        assert r["source"] == "serve_exit" and r["device"] == "cpu", (tag, r)
        assert set(r["kernel_launches"].values()) == {0}, (tag, r)
        assert r["shapes"] == [1, 4, 8] and r["reloads"] == 0
        served += r["dispatches"]
    assert served >= 1
    assert rec["exit_codes"] == {"router": 0, "replica1": 0, "replica0": 0}
    assert rec["report"]["shm_leftover"] == [] and rec["report"]["shm_created"] >= 1
    assert rec["bring_up_s"] is not None and rec["bring_up_s"] > 0
    types = {r["type"] for r in _journal_records(
        os.path.join(root, "stale-fs-under-load", "telemetry"))}
    assert {"scenario", "verdict", "fsfault", "mark"} <= types


@pytest.mark.slow
def test_smoke_suite_on_cpu_replicas(tmp_path, monkeypatch, two_threads):
    """JAX case: ``test_smoke_suite_passes_healthy_and_fails_broken``, the
    whole registry at the smoke factor over the port's plane on the CPU:
    green, with the broken no-shedding flash crowd failing on cue."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    result = runner.run_suite(None, smoke=True, keep=True, root=str(tmp_path / "gd"),
                              device="cpu")
    by_name = {r["scenario"]: r for r in result["records"]}
    assert sorted(by_name) == sorted(G.suite_names())
    for name, rec in by_name.items():
        assert rec.get("error") is None, rec
        assert rec["ok_as_expected"] is True, (name, rec["predicates"])
        assert rec["report"]["shm_leftover"] == []
    broken = by_name["flash-crowd-10x-noshed"]
    assert broken["pass"] is False
    assert "shed_not_hang" in [r["predicate"] for r in broken["predicates"] if not r["ok"]]
    assert result["suite_green"] is True and "GREEN" in result["table"]
