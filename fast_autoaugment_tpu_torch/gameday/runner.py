"""The game-day runner: spec -> live plane -> workload -> verdicts.

The port's copy of ``fast_autoaugment_tpu/gameday/runner.py``: every
child is a module of this package (``serve.serve_cli``,
``serve.autoscaler``, ``serve.router_cli``, ``launch.control_cli``),
and every replica serves on the ``device`` the caller names
(``serve_cli --device``; ``cuda`` by default).  A replica that cannot
reach its device exits at start, and the scenario fails its bring-up:
no replica serves from the CPU unless the caller asked for the CPU.

One :func:`run_scenario` call owns a full drill lifecycle:

1. **bring-up** — spawn the plane a :class:`~.scenario.Plane` describes
   (serve_cli replicas directly, or autoscaler-owned; router_cli as the
   front door; control_cli in drill mode) into a throwaway workdir,
   every process journaling into ONE telemetry dir;
2. **traffic** — replay the deterministic ``(scenario, seed)`` schedule
   (``gameday/workload.py``) through the router, journaling rolling
   ``scenario`` progress events; an armed :class:`~.scenario.Kill`
   watches the journal and SIGKILLs its victim on cue; when a
   controller is running, a low-rate sustain trickle keeps traffic
   flowing (deterministically seeded chunks) until the terminal
   promote/rollback lands — a quality gate cannot measure a canary
   nobody is sending requests through;
3. **teardown** — SIGTERM newest-first with a shared deadline, SIGKILL
   stragglers, collect exit codes;
4. **verdict** — assemble the evidence (client report + journal +
   router ``/stats`` scrape), run ``gameday/verdict.py``, and journal
   one ``verdict`` event per predicate plus the ``scenario`` end mark —
   so ``make status`` and ``make trace`` can replay the whole drill
   from the journal alone.  The record also carries each replica's
   device and kernel launch counters (``replicas``): the ``serve_exit``
   mark a replica journals when it exits, or, for the replica a
   :class:`~.scenario.Kill` SIGKILLs, its ``/stats`` read just before
   the kill.  A replica that ended without serving, other than one the
   autoscaler stopped while it started, fails the scenario (``error``).

:func:`run_suite` runs a list of named scenarios back to back sharing
one compile cache (the first replica builds or loads the kernel
libraries into it; the rest load them) and renders the verdict table
docs/BENCHMARKS.md pins.

This module owns every filesystem touch of the game-day stack — the
``launch/gameday_cli.py`` front end stays FS-free (faalint F1).
"""

from __future__ import annotations

import dataclasses
import glob
import http.client
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

from fast_autoaugment_tpu_torch.core.telemetry import (
    emit, enable_telemetry, journal_flush, mono)
from fast_autoaugment_tpu_torch.utils.logging import get_logger

from .scenario import SCENARIOS, Scenario, Traffic, scaled, suite_names
from .verdict import evaluate, render_table
from .workload import WorkloadReport, build_schedule, run_workload
from .workload import schedule_digest as _schedule_digest

__all__ = ["run_scenario", "run_suite"]

logger = get_logger("faa_torch.gameday.runner")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: bring-up budget: on the card the first replica of a suite loads (or
#: builds, into the shared compile cache) the kernel libraries, and every
#: replica pays torch's start and one CUDA-graph capture per padded shape
READY_TIMEOUT_S = 300.0
ROUTER_READY_S = 90.0
TEARDOWN_S = 45.0

#: ops pool for generated tenant/candidate policies — names from the
#: repo's op table, mirroring the bench tools' POLICY_A/POLICY_B style
_OPS = ("Rotate", "Invert", "ShearX", "Solarize")


def _policy_spec(i: int) -> list:
    """Deterministic, pairwise-distinct single-sub policy specs."""
    a = _OPS[i % len(_OPS)]
    b = _OPS[(i + 1) % len(_OPS)]
    return [[[a, 0.5 + 0.1 * (i % 3), 0.4],
             [b, 0.3, 0.15 + 0.1 * (i % 4)]]]


def _write_policies(pol_dir: str, n: int) -> list[str]:
    os.makedirs(pol_dir, exist_ok=True)
    paths = []
    for i in range(n):
        path = os.path.join(pol_dir, f"policy{i}.json")
        with open(path, "w") as fh:
            json.dump(_policy_spec(i), fh)
        paths.append(path)
    return paths


def _policy_digests(paths: list[str]) -> list[str]:
    # lazy: pulls in torch — only actual runs pay it, spec/verdict units
    # never do
    from fast_autoaugment_tpu_torch.serve.policy_server import policy_digest
    from fast_autoaugment_tpu_torch.serve.serve_cli import build_policy_tensor
    return [policy_digest(build_policy_tensor(p)) for p in paths]


# ------------------------------------------------------------ plumbing


def _http_get(host: str, port: int, path: str,
              timeout_s: float = 3.0) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as fh:
            rec = json.load(fh)
        return rec if isinstance(rec, dict) else None
    except (OSError, ValueError):
        return None


def _read_journal(tel_dir: str, types: set[str] | None = None
                  ) -> list[dict]:
    """Every journal record under ``tel_dir`` (all hosts' segments),
    time-ordered — the same files ``make trace`` reads."""
    out: list[dict] = []
    pattern = os.path.join(tel_dir, "**", "journal-*.jsonl")
    for path in sorted(glob.glob(pattern, recursive=True)):
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail mid-write: next read wins
                    if types is None or rec.get("type") in types:
                        out.append(rec)
        except OSError:
            continue
    out.sort(key=lambda r: (r.get("t_wall") or 0, r.get("seq") or 0))
    return out


def _wait(predicate, timeout_s: float, interval_s: float = 0.25,
          what: str = "condition"):
    deadline = mono() + timeout_s
    while mono() < deadline:
        val = predicate()
        if val:
            return val
        time.sleep(interval_s)
    raise TimeoutError(f"gameday: timed out waiting for {what} "
                       f"({timeout_s:.0f}s)")


class _PlaneHandle:
    """Live-plane state: spawned processes + where to find them."""

    def __init__(self, workdir: str, tel_dir: str, port_dir: str):
        self.workdir = workdir
        self.tel_dir = tel_dir
        self.port_dir = port_dir
        self.procs: list[tuple[str, subprocess.Popen]] = []
        self.router_port: int | None = None
        self.killed: str | None = None
        self.killed_stats: dict | None = None
        self.spawned: list[str] = []
        self.ready_s: float | None = None

    def alive(self, name: str) -> bool:
        return any(n == name and p.poll() is None for n, p in self.procs)


def _base_env() -> dict:
    env = dict(os.environ)
    # children get EXPLICIT --telemetry flags, scenario-scoped fault
    # plans and an explicit --device; ambient config from the harness
    # must not leak in
    for var in ("FAA_TELEMETRY", "FAA_FAULT", "FAA_FSFAULT",
                "FAA_HOST_ID", "JAX_PLATFORMS"):
        env.pop(var, None)
    return env


def _module_cmd(module: str) -> list[str]:
    return [sys.executable, "-m", f"fast_autoaugment_tpu_torch.{module}"]


def _replica_cmd(scn: Scenario, policy_path: str, tel_dir: str,
                 cc_dir: str, pol_dir: str | None, device: str) -> list[str]:
    pl = scn.plane
    cmd = _module_cmd("serve.serve_cli") + [
           "--policy", policy_path, "--device", device,
           "--image", str(pl.image), "--shapes", pl.shapes,
           "--max-wait-ms", str(pl.max_wait_ms),
           "--telemetry", tel_dir, "--compile-cache", cc_dir,
           "--traffic-stats", "--drain-timeout", "8"]
    if pl.dispatch_floor_ms > 0:
        cmd += ["--dispatch-floor-ms", str(pl.dispatch_floor_ms)]
    if pl.shedding:
        cmd += ["--queue-depth", str(pl.queue_depth),
                "--default-deadline-ms", str(pl.deadline_ms)]
    else:
        # the deliberately-broken configuration: a queue nobody can
        # fill and no deadlines — overload becomes hang, not a fast no
        cmd += ["--queue-depth", "1000000"]
    if pl.shm_ingest:
        cmd += ["--shm-ingest"]
    if pl.tenant_capacity > 0 and pol_dir:
        cmd += ["--tenant-capacity", str(pl.tenant_capacity),
                "--policy-dir", pol_dir]
    return cmd


def _autoscaler_cmd(scn: Scenario, port_dir: str, tel_dir: str,
                    rep_cmd: list[str]) -> list[str]:
    pl = scn.plane
    return _module_cmd("serve.autoscaler") + [
        "--port-dir", port_dir,
        "--min-replicas", str(pl.min_replicas),
        "--max-replicas", str(pl.max_replicas),
        "--high-queue", str(pl.high_queue),
        "--high-shed-rate", str(pl.high_shed_rate),
        "--up-polls", str(pl.up_polls),
        "--down-polls", str(pl.down_polls),
        "--cooldown", str(pl.cooldown_s),
        "--poll-interval", str(pl.poll_interval_s),
        "--telemetry", tel_dir,
        "--", *rep_cmd]


def _router_cmd(port_dir: str, router_file: str, tel_dir: str) -> list[str]:
    return _module_cmd("serve.router_cli") + [
        "--port-dir", port_dir, "--port", "0",
        "--port-file", router_file,
        "--poll-interval", "0.3",
        "--telemetry", tel_dir]


def _controller_cmd(workdir: str, tel_dir: str, port_dir: str,
                    router_port: int, baseline: str,
                    candidate: str) -> list[str]:
    return _module_cmd("launch.control_cli") + [
        "--telemetry", tel_dir, "--port-dir", port_dir,
        "--router-url", f"http://127.0.0.1:{router_port}",
        "--baseline-policy", baseline,
        "--candidate-policy", candidate,
        "--baseline-samples", "10",
        "--cusum-h", "4", "--gate-polls", "2",
        "--quality-margin", "1.0",
        "--poll-interval", "0.2",
        "--reload-timeout", str(int(READY_TIMEOUT_S)),
        "--stats-file", os.path.join(workdir, "control_stats.json")]


def _bring_up(scn: Scenario, workdir: str, cc_dir: str,
              policies: list[str], device: str) -> _PlaneHandle:
    """Spawn the plane and block until it answers: every replica (or
    the autoscaler's minimum fleet) proves ``/readyz``, then the router
    proves it with >= 1 replica in rotation."""
    tel_dir = os.path.join(workdir, "telemetry")
    port_dir = os.path.join(workdir, "replicas")
    os.makedirs(tel_dir, exist_ok=True)
    os.makedirs(port_dir, exist_ok=True)
    handle = _PlaneHandle(workdir, tel_dir, port_dir)
    try:
        return _bring_up_inner(scn, handle, cc_dir, policies, device)
    except BaseException:
        _teardown(handle)  # no orphans on a failed bring-up
        raise


def _bring_up_inner(scn: Scenario, handle: _PlaneHandle, cc_dir: str,
                    policies: list[str], device: str) -> _PlaneHandle:
    pl = scn.plane
    tel_dir, port_dir = handle.tel_dir, handle.port_dir
    workdir = handle.workdir
    pol_dir = os.path.dirname(policies[0])
    env = _base_env()
    rep_cmd = _replica_cmd(scn, policies[0], tel_dir, cc_dir,
                           pol_dir if pl.tenant_capacity > 0 else None,
                           device)
    t0 = mono()

    expected = []
    if pl.autoscaler:
        as_env = dict(env)
        if scn.faults:
            as_env["FAA_FAULT"] = scn.faults  # fleet children inherit
        auto = subprocess.Popen(
            _autoscaler_cmd(scn, port_dir, tel_dir, rep_cmd),
            env=as_env, cwd=_REPO)
        handle.procs.append(("autoscaler", auto))
        expected = [f"replica{i}" for i in range(pl.min_replicas)]
    else:
        for i in range(pl.replicas):
            rep_env = dict(env, FAA_HOST_ID=str(i))
            if scn.faults:
                rep_env["FAA_FAULT"] = scn.faults
            tag = f"replica{i}"
            proc = subprocess.Popen(
                rep_cmd + ["--port", "0", "--port-dir", port_dir,
                           "--host-tag", tag],
                env=rep_env, cwd=_REPO)
            handle.procs.append((tag, proc))
            expected.append(tag)
    handle.spawned = list(expected)

    def _replicas_ready():
        for name, proc in handle.procs:
            if proc.poll() is not None:  # a replica that cannot serve
                raise RuntimeError(     # fails the bring-up at once
                    f"gameday: {name} exited {proc.returncode} during "
                    f"bring-up")
        if pl.autoscaler:  # the autoscaler journals its replicas' ends
            ends = _marks(_read_journal(tel_dir, types={"mark"}),
                          "replica_exit")
            for tag in expected:
                if tag in ends:
                    raise RuntimeError(
                        f"gameday: {tag} exited "
                        f"{ends[tag].get('exit_code')} during bring-up")
        recs = [_read_json(os.path.join(port_dir, f"{t}.json"))
                for t in expected]
        if any(r is None or "port" not in r for r in recs):
            return None
        for rec in recs:
            try:
                status, _ = _http_get(rec.get("host", "127.0.0.1"),
                                      int(rec["port"]), "/readyz")
            except OSError:
                return None
            if status != 200:
                return None
        return recs

    _wait(_replicas_ready, READY_TIMEOUT_S,
          what=f"{len(expected)} replica(s) ready")

    router_file = os.path.join(workdir, "router.port")
    rt_env = dict(env)
    if scn.fsfaults:
        rt_env["FAA_FSFAULT"] = scn.fsfaults  # armed on the ROUTER
    router = subprocess.Popen(_router_cmd(port_dir, router_file, tel_dir),
                              env=rt_env, cwd=_REPO)
    handle.procs.append(("router", router))

    def _router_ready():
        if router.poll() is not None:
            raise RuntimeError("gameday: router died during bring-up")
        try:
            with open(router_file) as fh:
                port = int(fh.read().strip())
        except (OSError, ValueError):
            return None
        try:
            status, _ = _http_get("127.0.0.1", port, "/readyz")
        except OSError:
            return None
        return port if status == 200 else None

    handle.router_port = _wait(_router_ready, ROUTER_READY_S,
                               what="router ready (>=1 in rotation)")

    handle.ready_s = round(mono() - t0, 2)

    if pl.controller:
        candidate = policies[-1]  # one past the tenant set: pre-built
        ctl = subprocess.Popen(
            _controller_cmd(workdir, tel_dir, port_dir, handle.router_port,
                            policies[0], candidate),
            env=env, cwd=_REPO)  # fault plans are serve-side only
        handle.procs.append(("controller", ctl))
    return handle


def _teardown(handle: _PlaneHandle) -> dict:
    """SIGTERM newest-first (controller before router before fleet) so
    supervisors stop reacting before their wards leave; SIGKILL past
    the shared deadline.  Returns ``{name: exit_code}``."""
    for _name, proc in reversed(handle.procs):
        if proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
    deadline = mono() + TEARDOWN_S
    codes: dict[str, int | None] = {}
    for name, proc in reversed(handle.procs):
        budget = max(0.5, deadline - mono())
        try:
            codes[name] = proc.wait(timeout=budget)
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                codes[name] = proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                codes[name] = None
    return codes


#: the fields of a replica's ``serve_exit`` mark (or ``/stats``) kept in
#: the record: its device, its kernel launch counters and what predicts
#: them (graph builds come from the start, the reloads and the tenant
#: admits; one replay a dispatch)
_REPLICA_FIELDS = ("device", "shapes", "num_op", "dispatches", "reloads",
                   "kernel_launches", "kernel_launches_warmup")


def _replica_report(stats: dict, source: str) -> dict:
    out = {k: stats.get(k) for k in _REPLICA_FIELDS}
    out["tenant_admits"] = int((stats.get("tenancy") or {}).get("admits", 0))
    out["source"] = source
    return out


def _stable_stats(host: str, port: int, tries: int = 20) -> dict | None:
    """A replica's ``/stats`` read twice in a row with the same dispatch
    and launch counts, so no dispatch was in flight between its count
    and its launches (None when it never settles or does not answer)."""
    last = None
    for _ in range(tries):
        try:
            status, body = _http_get(host, port, "/stats", timeout_s=2.0)
            cur = json.loads(body.decode()) if status == 200 else None
        except (OSError, ValueError):
            return None
        if cur is None:
            return None
        if last is not None and all(
                cur.get(k) == last.get(k)
                for k in ("dispatches", "kernel_launches", "reloads")):
            return cur
        last = cur
        time.sleep(0.005)
    return None


#: exit codes of a replica its supervisor stopped by signal before it
#: installed its drain handler (SIGTERM) or past the drain's deadline
_STOP_CODES = (-signal.SIGTERM, -signal.SIGKILL)


def _marks(journal: list[dict], event: str) -> dict:
    return {str(e.get("replica")): e for e in journal
            if e.get("type") == "mark" and e.get("event") == event}


def _replica_reports(handle: _PlaneHandle, journal: list[dict],
                     exit_codes: dict) -> dict:
    """``{tag: report}`` for every replica the scenario spawned (the
    direct or minimum fleet and every autoscaler ``scale_up``): the
    ``serve_exit`` mark it journaled, or the killed replica's last stable
    ``/stats`` (``killed`` when it gave none).  A replica with neither is ``never_served`` only when it
    is shown to have been stopped while it started: the router never put
    it in rotation, and the autoscaler's ``replica_exit`` mark says its
    scale-down ended it by SIGTERM or SIGKILL.  Any other end (a failed
    start, a crash, no mark at all) is ``failed``, with the exit code its
    supervisor saw."""
    tags = list(handle.spawned)
    tags += [str(e["replica"]) for e in journal
             if e.get("type") == "scale_up" and e.get("replica")
             and str(e["replica"]) not in tags]
    exits = _marks(journal, "serve_exit")
    ends = _marks(journal, "replica_exit")
    admitted = {str(e.get("replica")) for e in journal
                if e.get("type") == "rotation" and e.get("action") == "readmit"}
    out = {}
    for tag in tags:
        end = ends.get(tag) or {}
        how = {"exit_code": end.get("exit_code", exit_codes.get(tag)),
               "cause": end.get("cause")}
        if tag in exits:
            out[tag] = _replica_report(exits[tag], "serve_exit")
        elif tag == handle.killed:  # the scenario's own SIGKILL
            out[tag] = (_replica_report(handle.killed_stats, "killed_stats")
                        if handle.killed_stats is not None
                        else {"source": "killed", **how})
        elif (tag not in admitted and how["cause"] == "scale_down"
              and how["exit_code"] in _STOP_CODES):
            out[tag] = {"source": "never_served", **how}
        else:
            out[tag] = {"source": "failed", **how}
    return out


def _scrape_router_stats(handle: _PlaneHandle) -> dict | None:
    if handle.router_port is None:
        return None
    try:
        status, body = _http_get("127.0.0.1", handle.router_port,
                                 "/stats", timeout_s=5.0)
        if status == 200:
            return json.loads(body.decode())
    except (OSError, ValueError):
        pass
    return None


class _KillWatcher(threading.Thread):
    """SIGKILL the scenario's victim on cue.

    ``target="canary"`` resolves the victim from the first journaled
    canary rollout event — the replica the armed split just promoted —
    and the pid comes from the victim's own port record (SIGKILL means
    no graceful record removal, so the record outlives the process;
    that is exactly what makes the kill addressable)."""

    def __init__(self, scn: Scenario, handle: _PlaneHandle):
        super().__init__(name="gameday-kill", daemon=True)
        self.scn = scn
        self.handle = handle
        self.stop_evt = threading.Event()

    def run(self) -> None:
        k = self.scn.kill
        tag = k.target
        if k.after_event:
            deadline = (mono() + self.scn.traffic.duration_s
                        + self.scn.decision_timeout_s)
            while mono() < deadline:
                if self.stop_evt.is_set():
                    return
                evs = [e for e in _read_journal(self.handle.tel_dir,
                                                types={k.after_event})
                       if not k.after_action
                       or e.get("action") == k.after_action]
                if evs:
                    if tag == "canary":
                        tag = str(evs[0].get("replica") or tag)
                    break
                self.stop_evt.wait(0.3)
            else:
                return  # trigger never fired: nothing to kill
        else:
            if self.stop_evt.wait(
                    k.at_frac * self.scn.traffic.duration_s):
                return
        if self.stop_evt.wait(k.delay_s):
            return
        rec = _read_json(os.path.join(self.handle.port_dir,
                                      f"{tag}.json"))
        if rec is None or "pid" not in rec:
            logger.warning("gameday: kill target %s has no port "
                           "record; skipping", tag)
            return
        # the victim journals no serve_exit mark: its launch counters
        # are read now, as the last evidence of what it served
        self.handle.killed_stats = _stable_stats(
            rec.get("host", "127.0.0.1"), int(rec["port"]))
        try:
            os.kill(int(rec["pid"]), signal.SIGKILL)
        except (OSError, ValueError) as e:
            logger.warning("gameday: SIGKILL %s failed: %s", tag, e)
            return
        self.handle.killed = tag
        # NOT `pid=` — the journal record schema reserves that field
        # for the emitting process
        emit("scenario", self.scn.name, action="kill", replica=tag,
             victim_pid=int(rec["pid"]))
        logger.warning("gameday: SIGKILLed %s (pid %d)", tag,
                       int(rec["pid"]))


def _merge_report(into: WorkloadReport, other: WorkloadReport) -> None:
    into.offered += other.offered
    into.completed += other.completed
    into.ok += other.ok
    into.shed += other.shed
    into.unexpected_status += other.unexpected_status
    into.transport_errors += other.transport_errors
    into.cancelled += other.cancelled
    into.too_late += other.too_late
    for k, v in other.ok_by_tenant.items():
        into.ok_by_tenant[k] = into.ok_by_tenant.get(k, 0) + v
    for k, v in other.shed_by_status.items():
        into.shed_by_status[k] = into.shed_by_status.get(k, 0) + v
    into.latencies_ok_s.extend(other.latencies_ok_s)
    into.max_lateness_s = max(into.max_lateness_s, other.max_lateness_s)
    into.elapsed_s += other.elapsed_s
    into.shm_created += other.shm_created
    into.shm_leftover.extend(other.shm_leftover)
    into.errors_sample.extend(other.errors_sample)


def _has_terminal(tel_dir: str) -> bool:
    return bool(_read_journal(tel_dir, types={"promote", "rollback"}))


def run_scenario(scn: Scenario, *, workdir: str,
                 compile_cache: str, device: str = "cuda") -> dict:
    """One full drill: bring-up -> traffic (+ kill + sustain) ->
    teardown -> verdict record (see module docstring).  Every replica
    serves on `device` (``serve_cli --device``)."""
    os.makedirs(workdir, exist_ok=True)
    tel_dir = os.path.join(workdir, "telemetry")
    os.makedirs(tel_dir, exist_ok=True)
    # the runner journals INTO the scenario's own dir: scenario marks,
    # progress and verdicts live next to the plane's decision events
    enable_telemetry(tel_dir)

    n_policies = max(scn.plane.policies, 1) + (
        1 if scn.plane.controller else 0)
    policies = _write_policies(os.path.join(workdir, "policies"),
                               n_policies)
    digests = (_policy_digests(policies[:scn.traffic.tenants])
               if scn.traffic.tenants > 1 else None)

    schedule = build_schedule(scn.traffic, scn.seed)
    digest = _schedule_digest(schedule)
    t0 = mono()
    emit("scenario", scn.name, action="start", seed=scn.seed,
         schedule_digest=digest, requests=len(schedule),
         traffic=scn.traffic.kind, expect=scn.expect)
    logger.info("gameday %s: %d requests over %.0fs (digest %s)",
                scn.name, len(schedule), scn.traffic.duration_s, digest)

    handle = _bring_up(scn, workdir, compile_cache, policies, device)
    watcher = None
    router_stats = None
    report = None
    try:
        if scn.kill is not None:
            watcher = _KillWatcher(scn, handle)
            watcher.start()
        emit("scenario", scn.name, action="phase", phase="traffic")

        def _progress(offered, completed, ok):
            emit("scenario", scn.name, action="progress",
                 offered=offered, completed=completed, ok=ok)

        report = run_workload(
            schedule, "127.0.0.1", handle.router_port,
            image=scn.plane.image, digests=digests,
            progress_cb=_progress)

        if scn.plane.controller and not _has_terminal(tel_dir):
            # the quality gate cannot measure a canary nobody sends
            # traffic through: trickle deterministic sustain chunks
            # until the terminal decision (or the bounded timeout)
            emit("scenario", scn.name, action="phase",
                 phase="decision-wait")
            deadline = mono() + scn.decision_timeout_s
            chunk_i = 0
            while mono() < deadline and not _has_terminal(tel_dir) \
                    and handle.alive("controller"):
                chunk_i += 1
                sustain = Traffic(
                    kind="constant", duration_s=4.0,
                    base_rps=scn.traffic.base_rps,
                    imgs_per_request=scn.traffic.imgs_per_request,
                    lanes=scn.traffic.lanes,
                    tenants=scn.traffic.tenants,
                    rotate_s=scn.traffic.rotate_s)
                chunk = build_schedule(sustain,
                                       scn.seed + 7919 * chunk_i)
                _merge_report(report, run_workload(
                    chunk, "127.0.0.1", handle.router_port,
                    image=scn.plane.image, digests=digests,
                    drain_s=10.0))

        time.sleep(scn.settle_s)
        router_stats = _scrape_router_stats(handle)
    finally:
        if watcher is not None:
            watcher.stop_evt.set()
        emit("scenario", scn.name, action="phase", phase="teardown")
        exit_codes = _teardown(handle)

    journal = _read_journal(tel_dir)
    evidence = {
        "report": report.to_dict() if report is not None else {
            "offered": len(schedule), "ok": 0, "shed": 0,
            "unexpected_status": 0, "transport_errors": len(schedule),
            "cancelled": 0, "completed": 0},
        "journal": journal,
        "router_stats": router_stats,
        "killed": handle.killed,
        "tenants": scn.traffic.tenants,
    }
    record = evaluate(scn, evidence, schedule_digest=digest)
    record["killed"] = handle.killed
    record["exit_codes"] = exit_codes
    record["elapsed_s"] = round(mono() - t0, 1)
    record["bring_up_s"] = handle.ready_s
    record["device"] = device
    record["replicas"] = _replica_reports(handle, journal, exit_codes)
    failed = {t: r for t, r in record["replicas"].items()
              if r["source"] == "failed"}
    if failed:
        # a replica that could not serve (no device, a crash, a failed
        # start) fails the scenario, whatever it expected
        record["pass"] = record["ok_as_expected"] = False
        record["error"] = "replica(s) ended without serving: " + ", ".join(
            f"{t} (exit {r['exit_code']}, {r['cause'] or 'no exit mark'})"
            for t, r in sorted(failed.items()))
        logger.error("gameday %s: %s", scn.name, record["error"])
    for row in record["predicates"]:
        emit("verdict", scn.name, predicate=row["predicate"],
             ok=row["ok"], observed=row["observed"],
             bound=row["bound"], detail=row.get("detail") or "")
    emit("scenario", scn.name, action="end", passed=record["pass"],
         expect=scn.expect, ok_as_expected=record["ok_as_expected"],
         schedule_digest=digest, elapsed_s=record["elapsed_s"])
    journal_flush()
    logger.info("gameday %s: %s (expected %s) in %.0fs",
                scn.name, "PASS" if record["pass"] else "FAIL",
                scn.expect, record["elapsed_s"])
    return record


def run_suite(names: list[str] | None = None, *, smoke: bool = False,
              smoke_factor: float = 0.4, seed: int | None = None,
              out: str | None = None, keep: bool = False,
              root: str | None = None, extra: dict | None = None,
              device: str = "cuda") -> dict:
    """Run scenarios back to back, render the verdict table, optionally
    write the suite JSON (``make gameday``).  ``smoke`` runs every
    scenario through :func:`~.scenario.scaled` — same topology, same
    predicates, shrunk load.  Every replica serves on `device`."""
    names = list(names) if names else suite_names()
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise KeyError(f"unknown scenario(s): {', '.join(unknown)} "
                       f"(known: {', '.join(suite_names())})")
    root = root or tempfile.mkdtemp(prefix="faa-gameday-")
    compile_cache = os.path.join(root, "compile-cache")
    os.makedirs(compile_cache, exist_ok=True)
    records = []
    try:
        for name in names:
            scn = SCENARIOS[name]
            if seed is not None:
                scn = dataclasses.replace(scn, seed=int(seed))
            if smoke:
                scn = scaled(scn, smoke_factor)
            try:
                records.append(run_scenario(
                    scn, workdir=os.path.join(root, name),
                    compile_cache=compile_cache, device=device))
            except Exception as e:  # noqa: BLE001 — one crashed drill
                # must not take the rest of the suite (or its verdict
                # table) down with it; a harness crash is NEVER "as
                # expected", even for an expect=fail scenario
                logger.exception("gameday %s: harness crashed", name)
                records.append({
                    "scenario": name, "seed": scn.seed,
                    "schedule_digest": None, "predicates": [],
                    "pass": False, "expect": scn.expect,
                    "ok_as_expected": False,
                    "error": f"{type(e).__name__}: {e}",
                    "report": None,
                })
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    table = render_table(records)
    result = {
        "suite": names,
        "device": device,
        "smoke": bool(smoke),
        "smoke_factor": smoke_factor if smoke else None,
        "seed": seed,
        "suite_green": all(r["ok_as_expected"] for r in records),
        "records": records,
        "table": table,
    }
    if extra:
        result.update(extra)
    if out:
        tmp = f"{out}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(result, fh, indent=2, default=str)
        os.replace(tmp, out)
        logger.info("gameday: suite JSON -> %s", out)
    return result
