"""The port's fleet launcher (``fast_autoaugment_tpu_torch/launch/fleet.py``)
against the JAX package's copy: the supervision scenarios of
``tests/test_selfheal_fleet.py`` (elastic completion, teardown, the first
genuine failure, the attempt counter, the heartbeat wedge detector) driven
through both launchers with the same fake remotes, compared by exit code
and by the supervisor's closing line (attempts, lost hosts, wedge kills);
``resolve_roles`` and the environment passthrough; and ``search_cli``'s
rank suffix, accepted under a work queue or a fleet transport and refused
otherwise.

Host code only (local shells in place of ssh); no model runs.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time

import pytest

from fast_autoaugment_tpu.launch import fleet as jax_fleet
from fast_autoaugment_tpu_torch.launch import fleet
from fast_autoaugment_tpu_torch.launch import search_cli as SC

LAUNCHERS = {"torch": (fleet, "faa_torch.fleet"), "jax": (jax_fleet, "faa_tpu.fleet")}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "confs", "wresnet10x1_shapes.yaml")


def _fake_remote(scripts):
    """A local bash script in place of ssh, per host (the wire command is
    ignored: the supervision protocol alone)."""
    return lambda host, wire: ["bash", "-c", scripts[host]]


def _wire_remote(host, wire):
    """The real wire command (plain shell: ``cd ... && ENV... exec cmd``)
    run locally."""
    return ["bash", "-c", wire]


def _run(name, monkeypatch, remote, *args, **kw):
    """Launch through one package's launcher; its exit code and the
    supervisor's closing line (without the package's own logger name)."""
    mod, logger_name = LAUNCHERS[name]
    monkeypatch.setattr(mod, "_remote_argv", remote)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger(logger_name)
    logger.addHandler(handler)
    try:
        code = mod.launch_fleet(*args, **kw)
    finally:
        logger.removeHandler(handler)
    return code, [ln for ln in lines if ln.startswith("fleet done")]


SCENARIOS = {
    "elastic_survivor": ({"a": "exit 5", "b": "sleep 0.3; exit 0"},
                         dict(host_retries=0, elastic=True), 0),
    "teardown": ({"a": "exit 5", "b": "sleep 30; exit 0"},
                 dict(host_retries=0, elastic=False), 5),
    "elastic_all_lost": ({"a": "exit 5", "b": "sleep 0.3; exit 6"},
                         dict(host_retries=0, elastic=True), 5),
    "retries_then_lost": ({"a": "exit 77", "b": "sleep 0.5; exit 0"},
                          dict(host_retries=2, retry_backoff=0.01, elastic=True), 0),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_supervision_equals_jax(scenario, monkeypatch):
    scripts, kw, want = SCENARIOS[scenario]
    got = {}
    for name in LAUNCHERS:
        t0 = time.time()
        got[name] = _run(name, monkeypatch, _fake_remote(scripts), ["a", "b"], ["true"], "x:1",
                         **kw)
        assert time.time() - t0 < 20  # a teardown kills the sleeping host
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == want


def test_attempt_counter_exported_to_each_launch(tmp_path, monkeypatch):
    """FAA_ATTEMPT gates fault specs to one attempt of a process chain: the
    supervisor exports 1, 2, 3 across relaunches, as the JAX one does."""
    logs = {}
    for name in LAUNCHERS:
        log = tmp_path / f"{name}.log"
        code, _ = _run(name, monkeypatch, _wire_remote, ["a"],
                       ["sh", "-c", f'echo "$FAA_ATTEMPT" >> {log}; exit 1'], "x:1",
                       host_retries=2, retry_backoff=0.01)
        assert code == 1
        logs[name] = log.read_text().split()
    assert logs["torch"] == logs["jax"] == ["1", "2", "3"]


def _stale_beat(tmp_path, done: bool) -> str:
    wq = tmp_path / "wq"
    (wq / "hosts").mkdir(parents=True, exist_ok=True)
    rec = {"owner": "host0", "heartbeat": time.time() - 100}
    if done:
        rec["done"] = True
    (wq / "hosts" / "host0.json").write_text(json.dumps(rec))
    return str(wq)


@pytest.mark.parametrize("done", [False, True], ids=["wedged", "done_beat"])
def test_heartbeat_wedge_detector_equals_jax(tmp_path, monkeypatch, done):
    """An ALIVE process whose host beat went stale is wedged beyond the
    in-process watchdog: both supervisors SIGKILL it (and count the kill); a
    terminal ``done`` beat means finished, and the process exits on its own."""
    wq = _stale_beat(tmp_path, done)
    scripts = {"a": "sleep 1; exit 0" if done else "sleep 30; exit 0"}
    got = {}
    for name in LAUNCHERS:
        t0 = time.time()
        got[name] = _run(name, monkeypatch, _fake_remote(scripts), ["a"], ["true"], "x:1",
                         host_retries=0, workqueue_dir=wq, heartbeat_timeout=0.5)
        assert time.time() - t0 < 15
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (0 if done else -signal.SIGKILL)
    assert ("wedged-killed: 1" in got["torch"][1][0]) is not done


def test_roles_are_exported_per_host_and_retry(tmp_path, monkeypatch):
    """--roles exports FAA_SEARCH_ROLE to every launch and retry (a relaunched
    actor stays an actor); --no-rank-args runs the command verbatim."""
    logs = {}
    for name in LAUNCHERS:
        log = tmp_path / f"{name}.log"
        code, _ = _run(name, monkeypatch, _wire_remote, ["a", "b"],
                       ["sh", "-c", f'echo "$FAA_HOST_ID=$FAA_SEARCH_ROLE $#" >> {log}; '
                                    '[ "$FAA_HOST_ID" = 1 ] && exit 1; exit 0'],
                       "x:1", host_retries=1, retry_backoff=0.01, rank_args=False,
                       roles=["learner", "actor"])
        assert code == 1
        logs[name] = sorted(log.read_text().splitlines())
    assert logs["torch"] == logs["jax"] == ["0=learner 0", "1=actor 0", "1=actor 0"]


def test_rank_suffix_appended(tmp_path, monkeypatch):
    log = tmp_path / "argv.log"
    code, _ = _run("torch", monkeypatch, _wire_remote, ["a", "b"],
                   ["sh", "-c", f'echo "$*" >> {log}', "sh"], None)
    assert code == 0
    assert sorted(log.read_text().splitlines()) == [
        "--coordinator a:8476 --num-hosts 2 --host-id 0",
        "--coordinator a:8476 --num-hosts 2 --host-id 1"]


def test_resolve_roles():
    for mod in (fleet, jax_fleet):
        assert mod.resolve_roles(None, 3) == [None, None, None]
        assert mod.resolve_roles("actor", 3) == ["actor"] * 3
        assert mod.resolve_roles("learner,actor,actor", 3) == ["learner", "actor", "actor"]
        with pytest.raises(ValueError, match="roles"):
            mod.resolve_roles("learner,actor", 3)
    assert fleet.expand_hosts("3") == jax_fleet.expand_hosts("3") == ["task1", "task2", "task3"]
    assert fleet.expand_hosts("a, b,") == ["a", "b"]


def test_env_passthrough(tmp_path, monkeypatch):
    """The card's selection takes JAX_PLATFORMS' place; the fleet-sharing
    variables ride every launch AND retry, as in the JAX launcher."""
    assert fleet.DEFAULT_ENV_PASSTHROUGH == ("CUDA_VISIBLE_DEVICES",) + \
        jax_fleet.DEFAULT_ENV_PASSTHROUGH[1:]
    assert jax_fleet.DEFAULT_ENV_PASSTHROUGH[0] == "JAX_PLATFORMS"
    log = tmp_path / "env.log"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("FAA_PIPELINE_TRACE", "1")
    monkeypatch.setenv("FAA_FLEET_TRANSPORT", "/shared/tr")
    code, _ = _run("torch", monkeypatch, _wire_remote, ["a"],
                   ["sh", "-c", f'echo "$CUDA_VISIBLE_DEVICES $FAA_PIPELINE_TRACE '
                                f'$FAA_FLEET_TRANSPORT" >> {log}; exit 1'],
                   "x:1", host_retries=1, retry_backoff=0.01, rank_args=False)
    assert code == 1
    assert log.read_text().splitlines() == ["0 1 /shared/tr"] * 2


def test_fleet_cli(monkeypatch):
    with pytest.raises(SystemExit):  # no command given
        fleet.main(["--hosts", "2", "--elastic", "--workqueue", "/x",
                    "--heartbeat-timeout", "5"])
    with pytest.raises(SystemExit) as e:
        fleet.main(["--hosts", "2", "--roles", "a,b,c", "--", "true"])
    assert e.value.code == 2
    seen = {}
    monkeypatch.setattr(fleet, "launch_fleet", lambda hosts, cmd, coord, **kw: seen.update(
        hosts=hosts, cmd=cmd, **kw) or 0)
    monkeypatch.delenv("FAA_FLEET_TRANSPORT", raising=False)
    with pytest.raises(SystemExit) as e:
        fleet.main(["--hosts", "a,b", "--roles", "learner,actor", "--fleet-transport", "/tr",
                    "--elastic", "--host-retries", "2", "--", "echo", "hi"])
    assert e.value.code == 0
    assert seen["hosts"] == ["a", "b"] and seen["cmd"] == ["echo", "hi"]
    assert seen["roles"] == ["learner", "actor"] and seen["elastic"] and seen["host_retries"] == 2
    assert os.environ.pop("FAA_FLEET_TRANSPORT") == "/tr"


# ------------------------------------------------ search_cli's rank suffix

RANK = ["--coordinator", "x:1", "--num-hosts", "3", "--host-id", "2"]


@pytest.mark.parametrize("mode", ["workqueue", "fleet_transport", "env_transport"])
def test_search_cli_takes_the_rank_suffix_in_fleet_modes(tmp_path, monkeypatch, mode):
    """Under --workqueue or a fleet transport each host is its own job: the
    launcher's suffix is accepted and --host-id names the owner tag; the run
    gets past the flags to the fold check."""
    monkeypatch.delenv("FAA_FLEET_TRANSPORT", raising=False)
    monkeypatch.delenv("FAA_SEARCH_ROLE", raising=False)
    extra = {"workqueue": ["--workqueue", str(tmp_path / "wq")],
             "fleet_transport": ["--fleet-transport", str(tmp_path / "tr")],
             "env_transport": []}[mode]
    if mode == "env_transport":
        monkeypatch.setenv("FAA_FLEET_TRANSPORT", str(tmp_path / "tr"))
    seen = {}
    real = SC.search_policies

    def spy(conf, **kw):
        seen.update(kw)
        return real(conf, **kw)

    monkeypatch.setattr(SC, "search_policies", spy)
    with pytest.raises(ValueError, match="out of range"):
        SC.main(["-c", CONF, "--save-dir", str(tmp_path / "s"), "--device", "cpu",
                 "--folds", "7"] + extra + RANK)
    owner = (seen["work_queue"] or seen["fleet_transport"]).owner
    assert owner == "host2"
    assert (seen["work_queue"] is None) == (mode != "workqueue")


@pytest.mark.parametrize("flag", ["--coordinator", "--num-hosts", "--host-id"])
def test_search_cli_refuses_the_rank_suffix_alone(flag, capsys, monkeypatch):
    monkeypatch.delenv("FAA_FLEET_TRANSPORT", raising=False)
    with pytest.raises(SystemExit) as e:
        SC.main(["-c", CONF, flag, "1", "--device", "cpu"])
    assert e.value.code == 2
    assert "item 10c)" in capsys.readouterr().err


def test_search_cli_fleet_guards(tmp_path, monkeypatch):
    """An actor needs a transport; --workqueue with a transport is a
    contradiction; the env handoff arms the transport and the role."""
    monkeypatch.delenv("FAA_FLEET_TRANSPORT", raising=False)
    monkeypatch.delenv("FAA_SEARCH_ROLE", raising=False)
    p = SC.build_parser()
    args = p.parse_args(["-c", "x.yaml"])
    assert (args.fleet_transport, args.search_role, args.workqueue) == (None, "auto", None)
    assert SC._resolve_fleet_transport(args) == (None, "learner")
    with pytest.raises(SystemExit, match="actor"):
        SC._resolve_fleet_transport(p.parse_args(["-c", "x.yaml", "--search-role", "actor"]))
    monkeypatch.setenv("FAA_FLEET_TRANSPORT", str(tmp_path / "tr"))
    monkeypatch.setenv("FAA_SEARCH_ROLE", "actor")
    transport, role = SC._resolve_fleet_transport(p.parse_args(["-c", "x.yaml"]))
    assert role == "actor" and transport.root == str(tmp_path / "tr")
    monkeypatch.delenv("FAA_SEARCH_ROLE")
    args = p.parse_args(["-c", "x.yaml", "--fleet-transport", str(tmp_path / "tr"),
                         "--workqueue", str(tmp_path / "wq")])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        SC._resolve_fleet_transport(args)
    # and through main: non-zero
    with pytest.raises(SystemExit) as e:
        SC.main(["-c", CONF, "--device", "cpu", "--workqueue", str(tmp_path / "wq")])
    assert e.value.code not in (0, None)
