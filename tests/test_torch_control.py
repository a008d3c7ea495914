"""The port's closed control loop (``fast_autoaugment_tpu_torch/control/``,
``launch/control_cli.py``) against the JAX package's: the ``drift@`` fault
verb, the CUSUM and the journal tail, the drift monitor, the served-traffic
statistics, the provenance sidecar and the policy-file digest, the canary
selection, the arm comparison and the promotion gate, the router's canary
split, the loop's drills and the warm-started top-up.

Each case feeds both packages the same inputs and holds the outputs equal
(the JAX oracle is named in each docstring).  The loop drills run the JAX
loop on its stub transports and the port's loop on real port
``PolicyServer`` replicas on the CPU (reloads swap real appliers) behind an
in-process ``router_cli`` over the port's ``Router`` (the ``/canary`` admin
answered over HTTP); the scraper is the same scripted one for both.
Bound: equality of every state, verdict, journal record (less its clocks
and envelope), payload and byte.  Host code only, apart from the CPU
appliers and the small one-shot search of the warm-start contract.
"""

from __future__ import annotations

import glob
import http.client
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from fast_autoaugment_tpu import control as JC
from fast_autoaugment_tpu.control import research as JR
from fast_autoaugment_tpu.core import telemetry as JT
from fast_autoaugment_tpu.launch import control_cli as jax_control_cli
from fast_autoaugment_tpu.launch import search_cli as jax_search_cli
from fast_autoaugment_tpu.serve import policy_server as jax_policy_server
from fast_autoaugment_tpu.serve import router as jax_router
from fast_autoaugment_tpu.serve import router_cli as jax_router_cli
from fast_autoaugment_tpu.utils import faultinject as jax_faultinject
from fast_autoaugment_tpu_torch import control as C
from fast_autoaugment_tpu_torch.control import research as R
from fast_autoaugment_tpu_torch.core import telemetry as T
from fast_autoaugment_tpu_torch.launch import control_cli, search_cli
from fast_autoaugment_tpu_torch.serve import policy_server, router, router_cli
from fast_autoaugment_tpu_torch.serve.serve_cli import build_policy_tensor
from fast_autoaugment_tpu_torch.utils import faultinject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

IMG = 4
BASE_POLICY = [[["Rotate", 0.5, 0.4], ["Invert", 0.2, 0.0]]]
CAND_POLICY = [[["ShearX", 0.9, 0.1], ["Solarize", 0.3, 0.7]]]
TAGS = ["replica0", "replica1", "replica2"]
#: journal-envelope keys and the fields that carry a clock reading
CLOCK_KEYS = {"t_wall", "t_mono", "host", "pid", "tid", "thread", "seq", "attempt",
              "t_mono_start", "t_mono_end", "dur_sec", "wall_sec", "detect_to_promote_sec",
              "warm_sec", "research_wall_sec", "created_at"}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("FAA_TELEMETRY", "FAA_FAULT", "FAA_ATTEMPT", "FAA_HOST_ID"):
        monkeypatch.delenv(var, raising=False)
    for mod in (faultinject, jax_faultinject):
        mod.reset()
    # the registries are process-wide: the loops' counters share labels
    T.registry()._reset_for_tests()
    JT.registry()._reset_for_tests()
    yield
    T._disable_for_tests()
    JT._disable_for_tests()
    for mod in (faultinject, jax_faultinject):
        mod.reset()


@pytest.fixture()
def journals(tmp_path):
    """Both packages' journals armed, each in a directory of its own (the
    port's keeps its TensorBoard bridge, ``tb/``, beside the segments)."""
    d = {"port": str(tmp_path / "tel_port"), "jax": str(tmp_path / "tel_jax")}
    JT.enable_telemetry(d["jax"], tb_bridge=False)
    T.enable_telemetry(d["port"])
    yield d
    T._disable_for_tests()
    JT._disable_for_tests()


def _records(mod, directory, types=None):
    """A journal's records in emit order, clocks and envelope dropped, paths
    cut to their base names (each package's drill runs in its own dir)."""
    mod.journal_flush()
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "journal-*.jsonl"))):
        with open(path) as fh:
            out.extend(json.loads(ln) for ln in fh if ln.strip())
    out.sort(key=lambda r: r["seq"])
    return [{k: os.path.basename(v) if isinstance(v, str) and os.sep in v else v
             for k, v in r.items() if k not in CLOCK_KEYS} for r in out
            if types is None or r["type"] in types]


def _is_router_split(rec) -> bool:
    """The router's own split events (``Router.set_canary``): only the
    port's drills run a real router."""
    return rec["type"] == "canary" and str(rec.get("action", "")).startswith("split_")


def _both_journals(journals, types, loop_only=False):
    """Both journals' records of `types`, equal; `loop_only` leaves the
    port's router split events out of the comparison."""
    got = {"port": _records(T, journals["port"], types),
           "jax": _records(JT, journals["jax"], types)}
    if loop_only:
        got = {k: [r for r in v if not _is_router_split(r)] for k, v in got.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _write(path, obj):
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return str(path)


# ------------------------------------------------- FAA_FAULT drift verb


def test_drift_verb_parses_and_rejects():
    """JAX oracle: ``tests/test_control.py test_drift_verb_parses_and_rejects``
    (``utils/faultinject.py parse_fault_spec``)."""
    spec = "drift@dispatch=3,shift=40.5"
    assert faultinject.parse_fault_spec(spec) == jax_faultinject.parse_fault_spec(spec)
    assert faultinject.parse_fault_spec(spec)[0] == {"kind": "drift", "dispatch": 3,
                                                     "shift": 40.5, "fired": False}
    for bad, match in (("drift@dispatch=3", "missing"),
                       ("drift@dispatch=3,shift=1,bogus=2", "takes keys")):
        for mod in (faultinject, jax_faultinject):
            with pytest.raises(ValueError, match=match):
                mod.parse_fault_spec(bad)


def test_drift_verb_latches_from_coordinate():
    """JAX oracle: ``test_drift_verb_latches_from_coordinate``."""
    seq = (1, 2, 3, 2, 9)
    got = {}
    for name, mod in (("port", faultinject), ("jax", jax_faultinject)):
        plan = mod.FaultPlan(mod.parse_fault_spec("drift@dispatch=3,shift=40"))
        got[name] = [plan.drift_shift(n) for n in seq]
    assert got["port"] == got["jax"] == [None, None, 40.0, None, 40.0]


def test_drift_verb_attempt_gated(monkeypatch):
    """JAX oracle: ``test_drift_verb_attempt_gated``."""
    got = {}
    for name, mod in (("port", faultinject), ("jax", jax_faultinject)):
        monkeypatch.delenv("FAA_ATTEMPT", raising=False)
        plan = mod.FaultPlan(mod.parse_fault_spec("drift@dispatch=1,shift=10,attempt=2"))
        first = plan.drift_shift(5)
        monkeypatch.setenv("FAA_ATTEMPT", "2")
        got[name] = (first, plan.drift_shift(5))
    assert got["port"] == got["jax"] == (None, 10.0)


# ------------------------------------------------------------ the CUSUM


def _cusum_trace(mod, values, **kw):
    det = mod.CusumMeanShift("m", **kw)
    return [det.update(float(v)) for v in values], det.snapshot()


def test_cusum_stationary_traffic_never_trips():
    """JAX oracle: ``test_cusum_stationary_traffic_never_trips`` (default
    k/h, seeded N(100, 1) streams of 1,000 samples)."""
    for seed in range(5):
        vals = 100.0 + np.random.default_rng(seed).normal(0, 1.0, 1000)
        port, jax = _cusum_trace(C, vals, baseline_n=20), _cusum_trace(JC, vals, baseline_n=20)
        assert port == jax, seed
        assert all(v is None for v in port[0]) and port[1]["baselined"]


def test_cusum_mean_shift_trips_deterministically():
    """JAX oracle: ``test_cusum_mean_shift_trips_deterministically``: the
    trip index and the evidence of a seeded 4-sigma shift."""
    rng = np.random.default_rng(1)
    vals = list(100.0 + rng.normal(0, 1.0, 60)) + list(104.0 + rng.normal(0, 1.0, 60))
    port, jax = (_cusum_trace(m, vals, baseline_n=10, k=0.5, h=8.0) for m in (C, JC))
    assert port == jax
    trips = [(i, ev) for i, ev in enumerate(port[0]) if ev is not None]
    i, ev = trips[0]
    assert ev["direction"] == "up" and i >= 60 and ev["stat"] > ev["threshold"]
    assert abs(ev["baseline_mean"] - 100.0) < 1.5


def test_cusum_detects_downward_shift_and_resets():
    """JAX oracle: ``test_cusum_detects_downward_shift_and_resets``."""
    got = {}
    for name, mod in (("port", C), ("jax", JC)):
        det = mod.CusumMeanShift("m", baseline_n=5, k=0.5, h=4.0)
        trace = [det.update(v) for v in [50.0] * 5 + [50.001] + [40.0] * 50]
        det.reset()
        got[name] = (trace, det.snapshot(), det.baselined, det.samples)
    assert got["port"] == got["jax"]
    # the 40.0 samples after the frozen window trip it downward
    assert next(ev for ev in got["port"][0][6:] if ev)["direction"] == "down"
    assert got["port"][2:] == (False, 0)


# ------------------------------------------ journal reader + monitor


def test_traffic_reader_tails_incrementally(tmp_path):
    """JAX oracle: ``test_traffic_reader_tails_incrementally``: both readers
    tail one journal file through its torn tail and its filtered records;
    ``skip_to_end`` fast-forwards both alike."""
    path = os.path.join(str(tmp_path), "journal-hostX-a1-p1.000.jsonl")

    def rec(seq, mean):
        return json.dumps({"type": "dispatch", "label": "serve_dispatch", "host": "hostX",
                           "pid": 1, "seq": seq, "t_wall": float(seq), "t_mono": float(seq),
                           "input_mean": mean, "reward_proxy": 0.1})

    steps = [None, rec(0, 100.0) + "\n" + rec(1, 101.0) + "\n", None, rec(2, 102.0), "\n",
             json.dumps({"type": "dispatch", "label": "train", "seq": 3, "input_mean": 1})
             + "\n" + json.dumps({"type": "dispatch", "label": "serve_dispatch", "seq": 4})
             + "\n"]
    readers = {"port": C.TrafficSampleReader(str(tmp_path)),
               "jax": JC.TrafficSampleReader(str(tmp_path))}
    polls = {"port": [], "jax": []}
    for text in steps:
        if text is not None:
            with open(path, "a") as fh:
                fh.write(text)
        for name, reader in readers.items():
            polls[name].append([r["seq"] for r in reader.poll()])
    assert polls["port"] == polls["jax"] == [[], [0, 1], [], [], [2], []]
    with open(path, "a") as fh:
        fh.write(rec(5, 103.0) + "\n")
    fresh = {n: (type(r)(str(tmp_path)).skip_to_end(), r.skip_to_end(), r.poll())
             for n, r in readers.items()}
    assert fresh["port"] == fresh["jax"] == (1, 1, [])


def test_drift_monitor_latches_and_rebaselines(journals):
    """JAX oracle: ``test_drift_monitor_latches_and_rebaselines``: the
    verdicts, the latch, the journaled ``drift`` record and the second
    episode after ``rebaseline``."""

    def samples(vals):
        return [{"input_mean": v, "host": "hostX", "seq": i} for i, v in enumerate(vals)]

    script = [samples([100.0, 101.0] * 5), samples([140.0] * 20), samples([140.0] * 20),
              "rebaseline", samples([140.0, 141.0] * 5), samples([100.0] * 20)]
    got = {}
    for name, mod in (("port", C), ("jax", JC)):
        feed: list = []
        mon = mod.DriftMonitor(lambda: feed.pop(0) if feed else [], metrics=("input_mean",),
                               baseline_n=5, cusum_k=0.5, cusum_h=4.0, name="drift-test")
        out = []
        for step in script:
            if step == "rebaseline":
                mon.rebaseline()
                out.append(("rebaseline", mon.latched))
                continue
            feed.append(step)
            out.append((mon.poll(), mon.latched))
        got[name] = (out, mon.stats())
    assert got["port"] == got["jax"]
    verdicts = [v for v, _ in got["port"][0] if isinstance(v, dict)]
    assert [v["direction"] for v in verdicts] == ["up", "down"]
    assert verdicts[0]["id"] != verdicts[1]["id"]
    drift = _both_journals(journals, {"drift"})
    assert len(drift) == 2 and drift[0]["label"] == "drift-test"


# ------------------------------------- serve traffic stats + injection


class Stand:
    """A host-only applier: shifts pixels by `delta` (which policy served a
    batch) and carries a digest like the real applier."""

    def __init__(self, delta=1.0, digest=None):
        self.delta = float(delta)
        self.dispatch = "exact"
        self.max_batch = 8
        self.image, self.channels, self.num_sub = IMG, 3, 1
        self.shapes = (8,)
        self.digest = digest or f"dummy{delta:g}"

    def apply(self, images, keys):
        return np.asarray(images, np.float32) + self.delta


def _images(n, value=100.0):
    return np.full((n, IMG, IMG, 3), value, np.float32)


def _keys(n):
    return np.zeros((n, 2), np.uint32)


def _served(mod, calls, applier=None, **kw):
    srv = mod.PolicyServer(applier or Stand(), max_wait_ms=1, **kw).start()
    try:
        outs = [srv.augment(_images(n, value=v), _keys(n)) for n, v in calls]
    finally:
        srv.stop()
    return srv, outs


def test_traffic_stats_gauges_journal_and_stats(journals):
    """JAX oracle: ``test_traffic_stats_gauges_journal_and_stats``: the
    ``traffic`` block of ``/stats``, the ``serve_dispatch`` journal fields
    the drift monitor reads, and the gauges the canary scraper reads."""
    got = {}
    for name, mod, tel in (("port", policy_server, T), ("jax", jax_policy_server, JT)):
        srv, outs = _served(mod, [(4, 100.0), (4, 200.0)], traffic_stats=True)
        text = tel.registry().prometheus_text()
        got[name] = (srv.stats()["traffic"], [o.tolist() for o in outs],
                     f'faa_serve_reward_proxy{{server="{srv._server_id}"}}' in text)
    assert got["port"] == got["jax"]
    assert got["port"][0]["samples"] == 2 and got["port"][2]
    assert abs(got["port"][0]["reward_proxy"] - 1.0 / 255) < 1e-6
    disp = [r for r in _both_journals(journals, {"dispatch"})
            if r["label"] == "serve_dispatch"]
    assert [d["input_mean"] for d in disp] == [100.0, 200.0]


def test_traffic_stats_off_is_historical_stream(journals):
    """JAX oracle: ``test_traffic_stats_off_is_historical_stream``."""
    for name, mod, tel in (("port", policy_server, T), ("jax", jax_policy_server, JT)):
        srv, _ = _served(mod, [(4, 100.0)])
        assert "traffic" not in srv.stats()
        assert not any(k.startswith("faa_serve_input_mean") and f'server="{srv._server_id}"'
                       in k for k in tel.registry().snapshot()["gauges"]), name
    disp = [r for r in _both_journals(journals, {"dispatch"})
            if r["label"] == "serve_dispatch"]
    assert disp and all("input_mean" not in d for d in disp)


def test_drift_injection_shifts_inputs_and_stats(monkeypatch):
    """JAX oracle: ``test_drift_injection_shifts_inputs_and_stats``: the
    ``drift@dispatch=2,shift=50`` fault shifts dispatch 2 on, latched."""
    got = {}
    for name, mod, fi in (("port", policy_server, faultinject),
                          ("jax", jax_policy_server, jax_faultinject)):
        monkeypatch.setenv("FAA_FAULT", "drift@dispatch=2,shift=50")
        fi.reset()
        srv, outs = _served(mod, [(2, 100.0)] * 3, applier=Stand(delta=0.0),
                            traffic_stats=True)
        got[name] = ([float(o.mean()) for o in outs], srv.stats()["traffic"])
    assert got["port"] == got["jax"]
    assert got["port"][0] == [100.0, 150.0, 150.0]


def test_reload_echoes_digest_and_journal(journals):
    """JAX oracle: ``test_reload_echoes_digest_and_journal``."""
    got = {}
    for name, mod in (("port", policy_server), ("jax", jax_policy_server)):
        srv = mod.PolicyServer(Stand(digest="aaa111"), max_wait_ms=1).start()
        try:
            info = srv.swap_applier(Stand(2.0, digest="bbb222"))
        finally:
            srv.stop()
        got[name] = (info, srv.stats()["policy_digest"])
    assert got["port"] == got["jax"]
    assert got["port"][0]["digest"] == got["port"][1] == "bbb222"
    rel = _both_journals(journals, {"reload"})
    assert rel and rel[-1]["digest"] == "bbb222"


# -------------------------------------------- provenance sidecar


@pytest.mark.parametrize("policy", [BASE_POLICY, CAND_POLICY, "fa_reduced_cifar10"])
def test_provenance_roundtrip_and_digest(tmp_path, monkeypatch, policy):
    """JAX oracle: ``test_provenance_roundtrip_and_digest``:
    ``policy_file_digest`` of one file and the sidecar's bytes are equal to
    JAX's (its clock pinned), and ``serve_cli`` resolves the sidecar."""
    from fast_autoaugment_tpu.policies.archive import load_policy as jax_load_policy

    if isinstance(policy, str):
        policy = [[list(op) for op in sub] for sub in jax_load_policy(policy)]
    monkeypatch.setattr(R, "wall", lambda: 1234.5)
    monkeypatch.setattr(JR, "wall", lambda: 1234.5)
    sides = {}
    for name, mod in (("port", C), ("jax", JC)):
        d = tmp_path / name
        d.mkdir()
        ppath = _write(d / "final_policy.json", policy)
        assert mod.load_provenance(ppath) is None
        side = mod.write_provenance(ppath, {"kind": "test", "topup_trials": 7})
        assert side == mod.provenance_path(ppath)
        assert side.endswith("final_policy.provenance.json")
        sides[name] = (open(side, "rb").read(), mod.policy_file_digest(ppath),
                       mod.load_provenance(ppath))
    assert sides["port"] == sides["jax"]
    prov = sides["port"][2]
    assert prov["kind"] == "test" and prov["topup_trials"] == 7
    assert prov["schema_version"] == 1 and prov["policy_digest"] == sides["port"][1]
    # the digest the replicas echo: the tensor a served policy file builds
    assert policy_server.policy_digest(build_policy_tensor(
        str(tmp_path / "port" / "final_policy.json"))) == prov["policy_digest"]
    from fast_autoaugment_tpu_torch.serve.serve_cli import load_policy_provenance

    assert load_policy_provenance(str(tmp_path / "port" / "final_policy.json")) == prov
    assert load_policy_provenance(str(tmp_path / "none.json")) is None
    assert R.provenance_path("x/p") == JR.provenance_path("x/p") == "x/p.provenance.json"


def test_seed_research_dir_copies_substrate(tmp_path):
    """JAX oracle: ``test_seed_research_dir_copies_substrate``: the same files
    copied, the derived outputs and journal left behind, the same refusals."""
    base = tmp_path / "base"
    base.mkdir()
    for name, text in (("search_trials.json", '{"0": []}'),
                       ("wresnet_cifar10_fold0_ratio0.40.msgpack", "ckpt"), ("audit.json", "{}"),
                       ("final_policy.json", "[]"), ("search_result.json", "{}"),
                       ("journal-host0-a1-p1.000.jsonl", ""), ("x.json.tmp.1", "")):
        (base / name).write_text(text)
    got = {}
    for name, mod in (("port", R), ("jax", JR)):
        out = tmp_path / f"cand_{name}"
        copied = sorted(mod.seed_research_dir(str(base), str(out)))
        errors = []
        for src in (str(out / "missing"), str(tmp_path / "empty")):
            os.makedirs(tmp_path / "empty", exist_ok=True)
            with pytest.raises(ValueError) as e:
                mod.seed_research_dir(src, str(tmp_path / f"y_{name}"))
            errors.append(str(e.value).split(" ")[:3])
        got[name] = (copied, sorted(os.listdir(out)), errors)
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["audit.json", "search_trials.json",
                              "wresnet_cifar10_fold0_ratio0.40.msgpack"]


# ------------------------------------------------ canary selection/gate


def test_select_canary_replicas_deterministic():
    """JAX oracle: ``test_select_canary_replicas_deterministic``, over seeded
    digests and fleets of 2-9 replicas."""
    g = np.random.default_rng(0)
    for _ in range(40):
        tags = [f"replica{int(i)}" for i in g.choice(30, int(g.integers(2, 10)), replace=False)]
        digest = "%012x" % int(g.integers(0, 2**48))
        for n in (1, 2, 99):
            got = C.select_canary_replicas(digest, tags, n)
            assert got == JC.select_canary_replicas(digest, list(reversed(tags)), n)
            assert len(got) == max(1, min(n, len(tags) - 1))
            assert got == router.rendezvous_order(digest, sorted(tags))[:len(got)]
    for mod in (C, JC):
        with pytest.raises(ValueError, match=">= 2 replicas"):
            mod.select_canary_replicas("d", ["only"], 1)


def test_compare_arms_math():
    """JAX oracle: ``test_compare_arms_math``, plus seeded random fleets."""
    samples = {
        "c0": {"reachable": True, "reward_proxy": 0.30, "new_dispatches": 5,
               "new_breaker_fires": 0},
        "b0": {"reachable": True, "reward_proxy": 0.10, "new_dispatches": 6,
               "new_breaker_fires": 0},
        "b1": {"reachable": True, "reward_proxy": 0.20, "new_dispatches": 7,
               "new_breaker_fires": 1},
        "dead": {"reachable": False},
    }
    ev = C.compare_arms(samples, ["c0"], target=0.25)
    assert ev == JC.compare_arms(samples, ["c0"], target=0.25)
    assert abs(ev["baseline"]["quality_distance"] - 0.10) < 1e-9
    assert abs(ev["quality_delta"] - (-0.05)) < 1e-9 and ev["baseline"]["new_errors"] == 1
    g = np.random.default_rng(3)
    for _ in range(50):
        n = int(g.integers(2, 7))
        rows = {f"r{i}": {"reachable": bool(g.random() > 0.1),
                          "reward_proxy": float(g.random()) if g.random() > 0.1 else None,
                          "new_dispatches": float(g.integers(0, 9)),
                          "new_breaker_fires": float(g.integers(0, 2))} for i in range(n)}
        canary = [f"r{i}" for i in range(int(g.integers(1, n)))]
        target = float(g.random())
        assert C.compare_arms(rows, canary, target) == JC.compare_arms(rows, canary, target)


def _evidence(delta, c_disp=5, b_disp=5, c_err=0):
    return {"canary": {"quality_distance": 0.1 + delta, "new_dispatches": c_disp,
                       "new_errors": c_err},
            "baseline": {"quality_distance": 0.1, "new_dispatches": b_disp},
            "quality_delta": delta}


def _gate_run(mod, kw, evidences):
    g = mod.PromotionGate(**kw)
    return [g.decide(e) for e in evidences], g.snapshot()


def test_gate_promotes_within_margin():
    """JAX oracle: ``test_gate_promotes_within_margin``: the decisions, the
    reasons and the evidence summaries."""
    evs = [_evidence(0.01), _evidence(-0.02), _evidence(0.03)]
    port = _gate_run(C, dict(gate_polls=3, quality_margin=0.05), evs)
    assert port == _gate_run(JC, dict(gate_polls=3, quality_margin=0.05), evs)
    action, reason, summary = port[0][-1]
    assert action == "promote" and summary["median_quality_delta"] == 0.01
    assert "within margin" in reason


def test_gate_rolls_back_on_quality_and_errors_and_starvation():
    """JAX oracle: ``test_gate_rolls_back_on_quality_and_errors_and_starvation``."""
    cases = [(dict(gate_polls=2, quality_margin=0.05), [_evidence(0.2), _evidence(0.3)],
              "exceeds margin"),
             (dict(gate_polls=5, quality_margin=0.05), [_evidence(0.0, c_err=2)], "error"),
             (dict(gate_polls=2, quality_margin=0.05, timeout_polls=4),
              [_evidence(0.0, c_disp=0)] * 4, "starved")]
    for kw, evs, word in cases:
        port = _gate_run(C, kw, evs)
        assert port == _gate_run(JC, kw, evs)
        action, reason, _ = port[0][-1]
        assert action == "rollback" and word in reason
        assert all(d[0] is None for d in port[0][:-1])


# ------------------------------------------------- router canary split


def _static_router(mod, n=3, **kw):
    r = mod.Router(static_replicas=[{"tag": f"replica{i}", "host": "h", "port": 1000 + i}
                                    for i in range(n)], **kw)
    for rep in r._replicas.values():
        rep.in_rotation = True
    return r


def test_router_canary_split_is_deterministic(journals):
    """JAX oracle: ``test_router_canary_split_is_deterministic``: the routing
    order for digest-less and digest traffic, the stats and the journal."""
    got = {}
    for name, mod in (("port", router), ("jax", jax_router)):
        r = _static_router(mod)
        r.set_canary("digX", ["replica1"], every=3)
        firsts = [r.candidates(None)[0][0].tag for _ in range(9)]
        orders = {d: [c.tag for c in r.candidates(d)[0]] for d in ("digX", "someother",
                                                                   "third")}
        st = r.stats()["canary"]
        r.clear_canary()
        got[name] = (firsts, orders, st, r.stats()["canary"])
    assert got["port"] == got["jax"]
    assert got["port"][0].count("replica1") == 3
    assert got["port"][1]["digX"][0] == "replica1"
    assert all(o[-1] == "replica1" for d, o in got["port"][1].items() if d != "digX")
    evs = _both_journals(journals, {"canary"})
    assert [e["action"] for e in evs] == ["split_set", "split_cleared"]


def test_router_canary_counts_arms(monkeypatch):
    """JAX oracle: ``test_router_canary_counts_arms``."""
    got = {}
    for name, mod in (("port", router), ("jax", jax_router)):
        r = _static_router(mod)
        r.set_canary("digX", ["replica0"], every=2)
        monkeypatch.setattr(r, "_upstream",
                            lambda rep, method, path, body, headers: (200, {}, b"ok"))
        statuses = [r.forward("POST", "/augment", b"x", {}, None)[0] for _ in range(6)]
        got[name] = (statuses, r.stats()["canary"]["routed"])
    assert got["port"] == got["jax"]
    assert got["port"][1] == {"canary": 3, "baseline": 3}


def _serve_router(mod_cli, r):
    httpd = mod_cli._RouterHTTPServer(("127.0.0.1", 0), mod_cli.make_router_handler(r))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _post_json(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", path, body=json.dumps(body).encode())
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_router_cli_canary_admin_endpoint():
    """JAX oracle: ``test_router_cli_canary_admin_endpoint``: the admin's
    answers (status and body) to the same four requests."""
    bodies = [{"digest": "digZ", "replicas": ["replica2"], "every": 4}, {"clear": True},
              {"replicas": ["replica2"]}, {"digest": "d", "replicas": []}]
    got = {}
    for name, mod, mod_cli in (("port", router, router_cli),
                               ("jax", jax_router, jax_router_cli)):
        httpd = _serve_router(mod_cli, _static_router(mod))
        try:
            got[name] = [_post_json(httpd.server_address[1], "/canary", b) for b in bodies]
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert [s for s, _ in got["port"]] == [s for s, _ in got["jax"]] == [200, 200, 400, 400]
    assert got["port"][:2] == got["jax"][:2]
    assert got["port"][0][1]["canary"]["digest"] == "digZ"


# --------------------------------------------- the loop state machine


class _StubScraper:
    """Feeds a loop scripted per-replica quality rows (both packages)."""

    def __init__(self, script):
        self.script = script
        self.calls = 0

    def sample(self, replicas):
        row = self.script[min(self.calls, len(self.script) - 1)]
        self.calls += 1
        return {str(r["tag"]): dict(row.get(str(r["tag"]), {"reachable": False}))
                for r in replicas}


class PortFleet:
    """Three port ``PolicyServer`` replicas on the CPU and an in-process
    ``router_cli`` over the port's ``Router``: a reload swaps a real
    applier built from the policy file (``serve_cli``'s path), and the
    canary admin is answered over HTTP."""

    def __init__(self, policy_path: str):
        self.servers = {}
        self.replicas = []
        for i, tag in enumerate(TAGS):
            port = 9000 + i
            self.servers[port] = policy_server.PolicyServer(
                self._applier(policy_path), max_wait_ms=1).start()
            self.replicas.append({"tag": tag, "host": "h", "port": port})
        self.router = _static_router(router)
        self.httpd = _serve_router(router_cli, self.router)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.payloads: list[dict] = []

    @staticmethod
    def _applier(path):
        return policy_server.PolicyApplier(build_policy_tensor(path), image=IMG, shapes=(1,),
                                           device="cpu")

    def reload(self, host, port, policy_path):
        return self.servers[port].swap_applier(self._applier(policy_path))

    def digests(self):
        return [self.servers[r["port"]].stats()["policy_digest"] for r in self.replicas]

    def wire(self, ctl):
        """Record every admin payload the controller posts (the real POST
        still goes out)."""
        real = ctl._router_canary

        def post(payload):
            self.payloads.append(dict(payload))
            return real(payload)

        ctl._router_canary = post

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        for srv in self.servers.values():
            srv.stop()


def _policies(tmp_path, name):
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    base, cand = _write(d / "baseline.json", BASE_POLICY), _write(d / "candidate.json",
                                                                   CAND_POLICY)
    return base, cand


def _loop(mod, tmp_path, name, script, research_exc=None):
    """`mod`'s ControlLoop on the drill's policies: JAX on stub transports,
    the port on :class:`PortFleet`.  Returns (loop, feed, observed, fleet)."""
    base, cand = _policies(tmp_path, name)
    mod.write_provenance(cand, {"kind": "test_candidate"})
    observed = {"reloads": [], "router": []}
    fleet = None
    if mod is C:
        fleet = PortFleet(base)

        def reload_fn(host, port, path):
            observed["reloads"].append(os.path.basename(path))
            return fleet.reload(host, port, path)

        ctl = mod.CanaryController(lambda: list(fleet.replicas), reload_fn=reload_fn,
                                   router_url=fleet.url)
        fleet.wire(ctl)
        observed["router"] = fleet.payloads
    else:
        def reload_fn(host, port, path):
            observed["reloads"].append(os.path.basename(path))
            return {"digest": mod.policy_file_digest(path)}

        replicas = [{"tag": t, "host": "h", "port": 9000 + i} for i, t in enumerate(TAGS)]
        ctl = mod.CanaryController(lambda: list(replicas), reload_fn=reload_fn)
        ctl._router_canary = lambda payload: observed["router"].append(payload)
    feed: list = []

    def research_fn(verdict):
        if research_exc is not None:
            raise research_exc
        return {"policy": cand, "provenance": mod.load_provenance(cand)}

    monitor = mod.DriftMonitor(lambda: feed.pop(0) if feed else [],
                               metrics=("input_mean", "reward_proxy"), baseline_n=5,
                               cusum_k=0.5, cusum_h=4.0)
    loop = mod.ControlLoop(monitor, research_fn, ctl,
                           mod.PromotionGate(gate_polls=2, quality_margin=0.05),
                           _StubScraper(script), baseline_policy=base,
                           baseline_digest=mod.policy_file_digest(base), n_canary=1,
                           split_every=2)
    return loop, feed, observed, fleet


def _drift_feed(feed):
    def samples(vals):
        return [{"input_mean": v, "reward_proxy": 0.1, "host": "h", "seq": i}
                for i, v in enumerate(vals)]

    feed.append(samples([100.0, 101.0] * 4))
    feed.append(samples([150.0] * 20))


def _drill(journals, tmp_path, script, steps, research_exc=None):
    """The same drill through both loops: (states, reload targets, router
    payloads, stats less its paths) each, the port's fleet digests after."""
    got, digests = {}, None
    for name, mod in (("port", C), ("jax", JC)):
        loop, feed, observed, fleet = _loop(mod, tmp_path, name, script, research_exc)
        try:
            states = [loop.step()]
            _drift_feed(feed)
            states += [loop.step() for _ in range(steps)]
            st = loop.stats()
            st.pop("baseline_policy")
            got[name] = (states, observed["reloads"], list(observed["router"]), st)
            if fleet is not None:
                digests = fleet.digests()
        finally:
            if fleet is not None:
                fleet.close()
    assert got["port"] == got["jax"]
    return got["port"], digests


def _rows(proxy_of):
    return {t: {"reachable": True, "reward_proxy": proxy_of(t), "new_dispatches": 5,
                "new_breaker_fires": 0, "dispatches": 5, "breaker_fires": 0} for t in TAGS}


def test_control_loop_promotes_end_to_end(journals, tmp_path):
    """JAX oracle: ``test_control_loop_promotes_end_to_end``: watching ->
    research -> canary -> observing -> promote, the rollout on the
    candidate digest's rendezvous prefix, the split armed then cleared, the
    journal's causal chain with its evidence; on the port every replica
    serves the candidate's digest afterwards."""
    cand_digest = R.policy_file_digest(_policies(tmp_path, "digest")[1])
    canary_tag = C.select_canary_replicas(cand_digest, TAGS, 1)[0]
    (states, reloads, payloads, stats), digests = _drill(
        journals, tmp_path, [_rows(lambda t: 0.1)], 6)
    assert states == ["watching", "watching", "research", "canary", "observing", "observing",
                      "watching"]
    assert payloads[0] == {"digest": cand_digest, "replicas": [canary_tag], "every": 2}
    assert payloads[-1] == {"clear": True}
    assert reloads == ["candidate.json"] * 3
    assert stats["baseline_digest"] == cand_digest and stats["promotes"] == 1
    assert not stats["monitor"]["latched"]
    assert digests == [cand_digest] * 3
    chain = _both_journals(journals, {"drift", "research", "canary", "promote"},
                           loop_only=True)
    assert [r["type"] for r in chain] == ["drift", "research", "canary", "promote"]
    splits = [r["action"] for r in _records(T, journals["port"], {"canary"})
              if _is_router_split(r)]
    assert splits == ["split_set", "split_cleared"]
    promote = chain[-1]
    assert promote["digest"] == cand_digest and promote["drift_id"] == chain[0]["id"]
    assert promote["evidence"]["median_quality_delta"] is not None


def test_control_loop_rolls_back_on_bad_quality(journals, tmp_path):
    """JAX oracle: ``test_control_loop_rolls_back_on_bad_quality``: the
    canary's proxy far from the pre-drift target rolls the canary back to
    the baseline policy."""
    base_path, cand_path = _policies(tmp_path, "digest")
    cand_digest = R.policy_file_digest(cand_path)
    canary_tag = C.select_canary_replicas(cand_digest, TAGS, 1)[0]
    (states, reloads, payloads, stats), digests = _drill(
        journals, tmp_path, [_rows(lambda t: 0.9 if t == canary_tag else 0.1)], 6)
    assert states[-1] == "watching" and stats["rollbacks"] == 1
    assert reloads == ["candidate.json", "baseline.json"]
    assert payloads[-1] == {"clear": True}
    assert stats["baseline_digest"] == R.policy_file_digest(base_path)
    assert digests == [R.policy_file_digest(base_path)] * 3
    evs = [r["type"] for r in _both_journals(
        journals, {"drift", "canary", "promote", "rollback"}, loop_only=True)]
    assert evs == ["drift", "canary", "rollback"]


def test_control_loop_survives_research_failure(journals, tmp_path):
    """JAX oracle: ``test_control_loop_survives_research_failure``: the
    ``research_failed`` mark, nothing actuated, the monitor still latched."""
    (states, reloads, payloads, stats), digests = _drill(
        journals, tmp_path, [{}], 3, research_exc=RuntimeError("search exploded"))
    assert states == ["watching", "watching", "research", "watching"]
    assert reloads == [] and payloads == []
    assert stats["monitor"]["latched"] and stats["state"] == "watching"
    marks = [r for r in _both_journals(journals, {"mark"})
             if r.get("event") == "research_failed"]
    assert marks and "search exploded" in marks[0]["error"]


def test_reload_digest_mismatch_aborts_rollout(journals, tmp_path):
    """JAX oracle: ``test_reload_digest_mismatch_aborts_rollout``: a replica
    that answers the reload but echoes another digest aborts the rollout
    (the port's replica keeps its resident policy and echoes it)."""

    def tamper(mod, loop, fleet):
        if fleet is None:
            loop.canary_ctl.reload_fn = lambda host, port, path: {"digest": "wrong!"}
        else:
            loop.canary_ctl.reload_fn = \
                lambda host, port, path: {"digest": fleet.servers[port].stats()["policy_digest"]}

    got = {}
    for name, mod in (("port", C), ("jax", JC)):
        loop, feed, observed, fleet = _loop(mod, tmp_path, name, [_rows(lambda t: 0.1)])
        try:
            tamper(mod, loop, fleet)
            states = [loop.step()]
            _drift_feed(feed)
            states += [loop.step() for _ in range(4)]
            marks = [r for r in _records(T if mod is C else JT, journals[name], {"mark"})
                     if r.get("event") == "rollout_failed"]
            got[name] = (states, loop.stats()["rollbacks"], [m["digest"] for m in marks],
                         ["echoed digest" in m["error"] for m in marks])
        finally:
            if fleet is not None:
                fleet.close()
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (["watching", "watching", "research", "canary", "watching"], 1)


# ---------------------------------- truncated-log warm-start identity


class _StubEval:
    """A deterministic host-only evaluator (reward = the policy tensor's sum
    mod 1), batched-only, for both pipelines."""

    def __init__(self):
        from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

        self.draw_source, self.dev = PhiloxDraws(), torch.device("cpu")

    def evaluate(self, *args):
        raise AssertionError("batched-only stub")

    def evaluate_batch(self, *args):
        policies_t = np.asarray(args[-2])
        return [{"top1_valid": round(float(policies_t[i].sum()) % 1.0, 6)}
                for i in range(int(policies_t.shape[0]))]


def _stub_pipeline_log(jax_side, num_search, k, seed=11, fold_trials=None, max_inflight=1):
    """JAX oracle: ``tests/test_control.py _stub_pipeline_log``, through
    either package's ``replay_trial_log`` and ``run_fold_pipeline``."""
    if jax_side:
        import jax

        from fast_autoaugment_tpu.search.driver import make_search_space
        from fast_autoaugment_tpu.search.pipeline import replay_trial_log, run_fold_pipeline
        from fast_autoaugment_tpu.search.tpe import TPE

        head, key = (None, None), jax.random.PRNGKey(0)
    else:
        from fast_autoaugment_tpu_torch.search.driver import make_search_space
        from fast_autoaugment_tpu_torch.search.pipeline import (
            replay_trial_log,
            run_fold_pipeline,
        )
        from fast_autoaugment_tpu_torch.search.tpe import TPE
        from fast_autoaugment_tpu_torch.search.tta import prng_key

        head, key = (None,), prng_key(0)
    tpe = TPE(make_search_space(1, 1), seed=seed, n_startup=4)
    fold_trials = list(fold_trials or [])
    replay_trial_log(tpe, fold_trials, k, num_search, max_inflight=max_inflight)
    run_fold_pipeline(_StubEval(), 0, *head, tpe, key, fold_trials, num_search=num_search,
                      trial_batch=k, actors=1, queue_depth=0, num_policy=1, num_op=1,
                      persist=lambda: None,
                      record_quarantine=lambda lo, hi, exc, worst: None)
    return json.dumps(fold_trials)


def test_warm_start_from_truncated_log_is_byte_identical():
    """JAX oracle: ``test_warm_start_from_truncated_log_is_byte_identical``:
    a mid-round truncated log replayed and continued gives the
    uninterrupted log, byte for byte, and the same bytes as JAX."""
    full = _stub_pipeline_log(False, 12, 3)
    assert full == _stub_pipeline_log(True, 12, 3)
    assert len(json.loads(full)) == 12
    for cut in (7, 5, 10):
        prefix = json.loads(full)[:cut]
        assert _stub_pipeline_log(False, 12, 3, fold_trials=prefix) == full, cut


def test_warm_start_topup_extends_and_zero_topup_is_identity():
    """JAX oracle: ``test_warm_start_topup_extends_and_zero_topup_is_identity``:
    a zero top-up dispatches nothing; a top-up keeps the base entries byte
    for byte and appends; from a truncated log it converges to the same
    stream; each equal to JAX's."""
    full = _stub_pipeline_log(False, 12, 3)
    for jax_side in (False, True):
        assert _stub_pipeline_log(jax_side, 12, 3, fold_trials=json.loads(full)) == full
    topped = _stub_pipeline_log(False, 18, 3, fold_trials=json.loads(full))
    assert topped == _stub_pipeline_log(True, 18, 3, fold_trials=json.loads(full))
    assert len(json.loads(topped)) == 18
    assert json.dumps(json.loads(topped)[:12]) == full
    assert _stub_pipeline_log(False, 18, 3, fold_trials=json.loads(full)[:7]) == topped


@pytest.fixture
def two_threads():
    """Torch on 2 threads, put back afterwards: float32 results move with
    the count, and the next file in the same test worker runs on its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_warm_started_research_driver_contract(tmp_path, two_threads):
    """JAX oracle: ``tests/test_control_e2e.py
    test_warm_start_topup_driver_contract`` (slow there), on the port's own
    one-shot search at the smallest size (one fold of
    ``confs/wresnet10x1_shapes.yaml``, epoch 1, 2 trials, the CPU): a zero
    top-up reproduces ``final_policy.json`` byte for byte and dispatches no
    trial; a top-up of 2 keeps the base entries byte for byte, stamps
    ``warm_start`` and the drift verdict into the provenance sidecar, whose
    digest is the candidate file's."""
    from fast_autoaugment_tpu_torch.core.config import load_config
    from fast_autoaugment_tpu_torch.search.driver import search_policies

    conf = load_config(os.path.join(REPO, "confs", "wresnet10x1_shapes.yaml"),
                       overrides=["epoch=1"])
    common = dict(cv_num=2, folds=[1], cv_ratio=0.4, num_policy=2, num_op=2, num_search=2,
                  num_top=2, fold_quality_floor=None, seed=0,
                  async_pipeline="on", pipeline_actors=1, pipeline_queue_depth=0,
                  device="cpu")
    base = str(tmp_path / "base")
    r0 = search_policies(conf, str(tmp_path), base, **common)
    assert "warm_start" not in r0
    final_bytes = open(os.path.join(base, "final_policy.json"), "rb").read()
    log0 = json.load(open(os.path.join(base, "search_trials.json")))

    zero = R.warm_started_research(conf, str(tmp_path), base, str(tmp_path / "zero"),
                                   topup_trials=0, **common)
    assert open(zero["policy"], "rb").read() == final_bytes
    assert "warm_start" not in zero["result"] and zero["provenance"]["topup_trials"] == 0
    assert zero["provenance"]["policy_digest"] == \
        R.policy_file_digest(os.path.join(base, "final_policy.json"))
    assert json.load(open(tmp_path / "zero" / "search_trials.json")) == log0

    topped = R.warm_started_research(conf, str(tmp_path), base, str(tmp_path / "top"),
                                     topup_trials=2, drift={"id": "drift-test-1"}, **common)
    log1 = json.load(open(tmp_path / "top" / "search_trials.json"))
    assert len(log1["1"]) == 4 and json.dumps(log1["1"][:2]) == json.dumps(log0["1"])
    ws = topped["result"]["warm_start"]
    assert (ws["base_num_search"], ws["topup_trials"], ws["resumed_trials_per_fold"]) == \
        (2, 2, {"1": 2})
    assert topped["provenance"]["drift"]["id"] == "drift-test-1"
    assert topped["provenance"]["warm_start"] == ws
    assert topped["provenance"]["policy_digest"] == R.policy_file_digest(topped["policy"])


# --------------------------------------------- faa_status + CLI surface


def test_faa_status_control_section(journals):
    """JAX oracle: ``test_faa_status_control_section``: the repository's
    ``tools/faa_status.py`` reads the port's control events exactly as it
    reads JAX's."""
    from faa_status import fleet_status, render_table

    for tel in (T, JT):
        tel.emit("drift", "control", id="drift-1", metric="input_mean", direction="up",
                 stat=9.1, value=150.0, baseline_mean=100.0)
        tel.emit("research", "warm_start", candidate="/c/final_policy.json", digest="abc",
                 topup_trials=25, wall_sec=4.2)
        tel.emit("canary", "control", action="rollout", replica="replica2", digest="abc")
        tel.emit("promote", "control", digest="abc", reason="within margin",
                 drift_id="drift-1", canary=["replica2"], detect_to_promote_sec=3.21,
                 evidence={"median_quality_delta": -0.01, "quality_margin": 0.05})
        tel.journal_flush()
    status = {n: fleet_status(d)["control"] for n, d in journals.items()}

    def strip(ctl):
        return json.loads(json.dumps(ctl, default=str),
                          object_hook=lambda o: {k: v for k, v in o.items()
                                                 if k not in CLOCK_KEYS})

    assert strip(status["port"]) == strip(status["jax"])
    control = status["port"]
    assert control["promotes"] == 1 and control["last_decision"]["action"] == "promote"
    assert control["active_canary"] is None
    table = render_table(fleet_status(journals["port"]))
    assert "PROMOTE abc" in table and "detect->promote 3.21s" in table


def _flags(parser):
    return sorted(s for a in parser._actions for s in a.option_strings)


def test_control_cli_parser_contract(tmp_path):
    """JAX oracle: ``test_control_cli_parser_contract``: every JAX flag with
    its default, the same namespace for the same argv, and the same
    refusals of a missing or doubled research seam."""
    assert _flags(control_cli.build_parser()) == _flags(jax_control_cli.build_parser())
    argv = ["--telemetry", "t", "--port-dir", "p", "--baseline-policy", "b.json",
            "--candidate-policy", "c.json", "--cusum-h", "4", "--gate-polls", "2"]
    assert vars(control_cli.build_parser().parse_args(argv)) == \
        vars(jax_control_cli.build_parser().parse_args(argv))
    args = control_cli.build_parser().parse_args(argv)
    assert args.candidate_policy == "c.json" and args.cusum_h == 4.0
    for bad in (["--telemetry", "t", "--port-dir", "p", "--baseline-policy", "b.json"],
                ["--telemetry", "t", "--port-dir", "p", "--baseline-policy", "b.json",
                 "--research-cmd", "x", "--candidate-policy", "c.json"]):
        for mod in (control_cli, jax_control_cli):
            with pytest.raises(SystemExit):
                mod.main(bad)
    assert "fast_autoaugment_tpu_torch.launch.search_cli" in control_cli.__doc__
    helps = " ".join(a.help or "" for a in control_cli.build_parser()._actions)
    assert "fast_autoaugment_tpu_torch.launch.search_cli" in helps
    assert "fast_autoaugment_tpu." not in control_cli.__doc__ + helps


def test_search_cli_topup_flag():
    """JAX oracle: ``test_search_cli_topup_flag``."""
    for argv in (["-c", "conf.yaml", "--topup-trials", "25"], ["-c", "c.yaml"]):
        assert search_cli.build_parser().parse_args(argv).topup_trials == \
            jax_search_cli.build_parser().parse_args(argv).topup_trials


def test_event_taxonomy_has_control_types():
    """JAX oracle: ``test_event_taxonomy_has_control_types``."""
    for etype in ("drift", "research", "canary", "promote", "rollback", "mark"):
        assert etype in T.EVENT_TYPES and etype in JT.EVENT_TYPES
    assert C.__all__ == JC.__all__
