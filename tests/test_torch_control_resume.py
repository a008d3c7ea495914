"""The port's crash-resumable control loop (``control/resume.py``, the
``resume`` path of ``control/loop.py``, ``control_cli --resume``) against
the JAX package's: the journal-as-WAL reconstruction on the same event
streams and the same torn journal, and the resumed loop's drills.

The JAX drills run on their stub router; the port's run on real port
``PolicyServer`` replicas on the CPU behind an in-process ``router_cli``
(its ``/canary`` admin over HTTP), so a router restart is the real
router losing its split and a reload swaps a real applier.  Bound:
equality of every reconstructed episode, state, admin payload and
journal record (less its clocks and envelope).  Host code only.
"""

from __future__ import annotations

import json
import os

import pytest

from fast_autoaugment_tpu import control as JC
from fast_autoaugment_tpu.core import telemetry as JT
from fast_autoaugment_tpu.launch import control_cli as jax_control_cli
from fast_autoaugment_tpu.utils import faultinject as jax_faultinject
from fast_autoaugment_tpu_torch import control as C
from fast_autoaugment_tpu_torch.control import resume as RS
from fast_autoaugment_tpu_torch.core import telemetry as T
from fast_autoaugment_tpu_torch.launch import control_cli
from fast_autoaugment_tpu_torch.utils import faultinject
from test_torch_control import (
    CAND_POLICY,
    PortFleet,
    _is_router_split,
    _policies,
    _records,
    _write,
)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("FAA_TELEMETRY", "FAA_FAULT", "FAA_HOST_ID"):
        monkeypatch.delenv(var, raising=False)
    for mod in (faultinject, jax_faultinject):
        mod.reset()
    T.registry()._reset_for_tests()
    JT.registry()._reset_for_tests()
    yield
    T._disable_for_tests()
    JT._disable_for_tests()
    for mod in (faultinject, jax_faultinject):
        mod.reset()


@pytest.fixture()
def journals(tmp_path):
    d = {"port": str(tmp_path / "tel_port"), "jax": str(tmp_path / "tel_jax")}
    JT.enable_telemetry(d["jax"], tb_bridge=False)
    T.enable_telemetry(d["port"])
    yield d
    T._disable_for_tests()
    JT._disable_for_tests()


# ------------------------------------------- WAL reconstruction (pure)


def _ev(etype, seq, **fields):
    return {"type": etype, "host": "h0", "pid": 1, "seq": seq, **fields}


def _reconstructed(events):
    got = C.reconstruct_inflight_episode(events)
    assert got == JC.reconstruct_inflight_episode(events)
    return got


def test_clean_wal_reconstructs_nothing():
    """JAX oracle: ``tests/test_control_resume.py
    test_clean_wal_reconstructs_nothing``: promote, rollback and the
    terminal marks close an episode."""
    events = [_ev("drift", 1, id="drift-1", metric="input_mean"),
              _ev("research", 2, candidate="/c.json", digest="abc"),
              _ev("canary", 3, action="rollout", replica="replica1"),
              _ev("promote", 4, digest="abc")]
    assert _reconstructed(events) is None
    for closer in (_ev("rollback", 4), _ev("mark", 4, event="research_failed"),
                   _ev("mark", 4, event="candidate_is_baseline")):
        assert _reconstructed(events[:1] + [closer]) is None
    assert RS.TERMINAL_MARKS == JC.resume.TERMINAL_MARKS
    assert RS.CONTROL_EVENT_TYPES == JC.resume.CONTROL_EVENT_TYPES


def test_dangling_research_stage_reconstructs():
    """JAX oracle: ``test_dangling_research_stage_reconstructs``: the
    verdict without its journal envelope."""
    ep = _reconstructed([_ev("drift", 1, id="drift-1", metric="input_mean", stat=12.0)])
    assert ep["stage"] == "research" and ep["verdict"]["stat"] == 12.0
    assert "seq" not in ep["verdict"] and "host" not in ep["verdict"]


def test_dangling_canary_stage_reconstructs_with_candidate(tmp_path):
    """JAX oracle: ``test_dangling_canary_stage_reconstructs_with_candidate``,
    with the candidate's provenance sidecar on disk (read back alike)."""
    cand = _write(tmp_path / "final_policy.json", CAND_POLICY)
    C.write_provenance(cand, {"kind": "test"})
    for candidate in ("/cand/final_policy.json", cand):
        ep = _reconstructed([_ev("drift", 1, id="drift-1"),
                             _ev("research", 2, candidate=candidate, digest="abc123def456"),
                             _ev("canary", 3, action="rollout", replica="replica1")])
        assert (ep["stage"], ep["candidate"], ep["digest"]) == \
            ("canary", candidate, "abc123def456")
    assert ep["provenance"]["kind"] == "test"


def test_only_the_last_episode_dangles():
    """JAX oracle: ``test_only_the_last_episode_dangles``."""
    ep = _reconstructed([_ev("drift", 1, id="drift-1"),
                         _ev("research", 2, candidate="/c1.json", digest="d1"),
                         _ev("promote", 3, digest="d1"), _ev("drift", 4, id="drift-2"),
                         _ev("research", 5, candidate="/c2.json", digest="d2")])
    assert ep["verdict"]["id"] == "drift-2" and ep["digest"] == "d2"


def test_read_control_events_from_journal_with_torn_tail(tmp_path):
    """JAX oracle: ``test_read_control_events_from_journal_with_torn_tail``:
    both readers on one journal whose writer was killed mid-line."""
    tel = str(tmp_path / "tel")
    os.makedirs(os.path.join(tel, "sub"))
    with open(os.path.join(tel, "journal-0.jsonl"), "w") as fh:
        fh.write(json.dumps(_ev("drift", 1, id="drift-1")) + "\n")
        fh.write(json.dumps(_ev("dispatch", 2)) + "\n")
        fh.write(json.dumps(_ev("research", 3, candidate="/c", digest="d")) + "\n")
        fh.write('{"type": "promote", "seq": 4, "trunc')
    with open(os.path.join(tel, "sub", "journal-1.jsonl"), "w") as fh:
        fh.write(json.dumps({"type": "mark", "host": "h1", "pid": 2, "seq": 1,
                             "event": "resume"}) + "\n")
    events = C.read_control_events(tel)
    assert events == JC.read_control_events(tel)
    assert [e["type"] for e in events] == ["drift", "research", "mark"]
    assert _reconstructed(events)["stage"] == "canary"


# ------------------------------------------------ loop resume (drills)


class _StubRouter:
    """The JAX tests' stateful stub of the ``/canary`` admin."""

    def __init__(self):
        self.split = None
        self.calls = []
        self.echo_override = None

    def __call__(self, payload):
        self.calls.append(dict(payload))
        if self.echo_override is not None:
            return self.echo_override
        if payload.get("clear"):
            self.split = None
            return {"canary": None}
        self.split = {"digest": payload["digest"], "tags": list(payload["replicas"]),
                      "every": payload.get("every", 2)}
        return {"canary": dict(self.split)}


class _Scraper:
    def sample(self, reps):
        return {str(r["tag"]): {"reachable": True, "reward_proxy": 0.1, "new_dispatches": 5,
                                "new_breaker_fires": 0, "dispatches": 5, "breaker_fires": 0}
                for r in reps}


class _Arm:
    """One package's resumable loop: JAX on the stub router, the port on
    :class:`PortFleet`.  `split()` reads the armed split either way, and
    `restart_router()` loses it."""

    def __init__(self, mod, tmp_path, name):
        self.mod = mod
        base, self.cand = _policies(tmp_path, name)
        mod.write_provenance(self.cand, {"kind": "test_candidate"})
        self.cand_digest = mod.policy_file_digest(self.cand)
        self.reloads = []
        self.fleet = None
        if mod is C:
            self.fleet = PortFleet(base)
            ctl = mod.CanaryController(lambda: list(self.fleet.replicas),
                                       reload_fn=self._reload, router_url=self.fleet.url)
            self.fleet.wire(ctl)
            self.calls = self.fleet.payloads
        else:
            replicas = [{"tag": f"replica{i}", "host": "h", "port": 9000 + i}
                        for i in range(3)]
            ctl = mod.CanaryController(lambda: list(replicas), reload_fn=self._reload,
                                       router_url="http://stub")
            self.stub = _StubRouter()
            ctl._router_canary = self.stub
            self.calls = self.stub.calls
        self.loop = mod.ControlLoop(
            mod.DriftMonitor(lambda: [], baseline_n=5),
            lambda verdict: {"policy": self.cand,
                             "provenance": mod.load_provenance(self.cand)},
            ctl, mod.PromotionGate(gate_polls=2, quality_margin=10.0), _Scraper(),
            baseline_policy=base, baseline_digest=mod.policy_file_digest(base), n_canary=1,
            split_every=2)

    def _reload(self, host, port, path):
        self.reloads.append(os.path.basename(path))
        if self.fleet is not None:
            return self.fleet.reload(host, port, path)
        return {"digest": self.mod.policy_file_digest(path)}

    def split(self):
        if self.fleet is None:
            return self.stub.split
        snap = self.fleet.router.stats()["canary"]
        return None if snap is None else {"digest": snap["digest"], "tags": snap["tags"],
                                          "every": snap["every"]}

    def restart_router(self):
        if self.fleet is None:
            self.stub.split = None
        else:
            self.fleet.router.clear_canary()

    def override_echo(self, echo):
        if self.fleet is None:
            self.stub.echo_override = echo
            return
        real = self.loop.canary_ctl._router_canary
        self.loop.canary_ctl._router_canary = lambda payload: (real(payload), echo)[1]

    def close(self):
        if self.fleet is not None:
            self.fleet.close()


def _drive(tmp_path, script):
    """`script(arm)` -> observations, through both packages' arms; equal."""
    got = {}
    for name, mod in (("port", C), ("jax", JC)):
        arm = _Arm(mod, tmp_path, name)
        try:
            obs = script(arm)
            st = arm.loop.stats()
            st.pop("baseline_policy")
            if st["episode"] is not None:  # each package's drill has a dir of its own
                st["episode"]["candidate"] = os.path.basename(st["episode"]["candidate"])
            got[name] = (obs, arm.reloads, list(arm.calls), st,
                         arm.fleet.digests() if arm.fleet is not None else None)
        finally:
            arm.close()
    assert got["port"][:4] == got["jax"][:4]
    return got["port"]


def _journal_equal(journals, types=None):
    """Both journals' loop records, equal: the port's replicas' reload and
    its router's split events are left out (the JAX drills run stubs)."""
    got = {"port": [r for r in _records(T, journals["port"], types)
                    if not _is_router_split(r) and r["type"] != "reload"],
           "jax": _records(JT, journals["jax"], types)}
    assert got["port"] == got["jax"]
    return got["port"]


def test_resume_canary_stage_terminates_in_promote(tmp_path, journals):
    """JAX oracle: ``test_resume_canary_stage_terminates_in_promote``: a
    fresh loop adopts a dangling canary-stage episode, re-runs the rollout
    (digest re-verify, split re-armed) and promotes; the port's three
    replicas end on the candidate's digest."""

    def script(arm):
        episode = {"verdict": {"id": "drift-9", "metric": "input_mean"}, "stage": "canary",
                   "candidate": arm.cand, "digest": arm.cand_digest, "provenance": {}}
        obs = [arm.loop.resume(episode)]
        for _ in range(2):
            obs.append(arm.loop.step())
        obs.append(arm.split())
        obs += [arm.loop.step(), arm.loop.step(), arm.split()]
        return obs

    obs, reloads, calls, stats, digests = _drive(tmp_path, script)
    cand_digest = stats["baseline_digest"]
    assert obs[:3] == ["canary", "canary", "observing"]
    assert obs[3]["digest"] == cand_digest
    assert obs[4:] == ["observing", "watching", None]
    assert digests == [cand_digest] * 3 and stats["promotes"] == 1
    evs = _journal_equal(journals, {"mark", "promote"})
    assert evs[0]["event"] == "resume" and evs[0]["stage"] == "canary"
    assert evs[-1]["digest"] == cand_digest and evs[-1]["drift_id"] == "drift-9"


def test_resume_research_stage_reenters_research(tmp_path, journals):
    """JAX oracle: ``test_resume_research_stage_reenters_research``."""

    def script(arm):
        arm.loop.resume({"verdict": {"id": "drift-7"}, "stage": "research",
                         "candidate": None, "digest": None})
        return [arm.loop.step() for _ in range(3)]

    obs = _drive(tmp_path, script)[0]
    assert obs == ["research", "canary", "observing"]
    _journal_equal(journals, {"mark", "research", "canary"})


def test_router_restart_mid_canary_is_reasserted_every_poll(tmp_path, journals):
    """JAX oracle: ``test_router_restart_mid_canary_is_reasserted_every_poll``:
    the router loses its split; the next gate poll's ``POST /canary``
    re-arms it (on the port, the real router's split)."""

    def script(arm):
        arm.loop.resume({"verdict": {"id": "drift-1"}, "stage": "canary",
                         "candidate": arm.cand, "digest": arm.cand_digest})
        obs = [arm.loop.step(), arm.loop.step()]
        arm.restart_router()
        obs += [arm.split(), arm.loop.step(), arm.split()]
        return obs

    obs, _reloads, calls, _stats, _digests = _drive(tmp_path, script)
    assert obs[:4] == ["canary", "observing", None, "observing"]
    assert obs[4] is not None and obs[4]["digest"] == calls[0]["digest"]
    # every observe poll carried a split (re-)assert admin call
    assert len([c for c in calls if c.get("digest") == obs[4]["digest"]]) >= 2


def test_split_echo_mismatch_rolls_back(tmp_path, journals):
    """JAX oracle: ``test_split_echo_mismatch_rolls_back``: a router echoing
    another controller's digest rolls the canary back (the port's replicas
    back on the baseline)."""

    def script(arm):
        arm.loop.resume({"verdict": {"id": "drift-2"}, "stage": "canary",
                         "candidate": arm.cand, "digest": arm.cand_digest})
        obs = [arm.loop.step(), arm.loop.step()]
        arm.override_echo({"canary": {"digest": "someone-else"}})
        return obs + [arm.loop.step()]

    obs, reloads, _calls, stats, digests = _drive(tmp_path, script)
    assert obs == ["canary", "observing", "watching"] and stats["rollbacks"] == 1
    assert reloads == ["candidate.json", "baseline.json"]
    assert len(set(digests)) == 1 and digests[0] == stats["baseline_digest"]
    assert any(r["type"] == "rollback" for r in _journal_equal(journals))


def test_control_cli_resume_flag_parses():
    """JAX oracle: ``test_control_cli_resume_flag_parses``."""
    for extra, want in (([], False), (["--resume"], True)):
        argv = ["--telemetry", "/t", "--port-dir", "/p", "--baseline-policy", "/b.json",
                "--candidate-policy", "/c.json"] + extra
        assert control_cli.build_parser().parse_args(argv).resume is want
        assert vars(control_cli.build_parser().parse_args(argv)) == \
            vars(jax_control_cli.build_parser().parse_args(argv))
