"""Multi-host fleet launcher and process supervision (the port's copy of
``fast_autoaugment_tpu/launch/fleet.py``).

Every host runs the SAME command with its ``--host-id``; under
``search_cli --workqueue`` (or ``--fleet-transport``) each host is a
single-process job of its own on its card, sharing only the artifact
directory.  The process hygiene of the reference's ``train_dist.py`` and
its ``safe_shell_exec.py`` supervisor is kept:

- every remote command stays attached to the ``ssh -tt`` pty as its
  controlling terminal, so when the local ssh dies the kernel delivers
  SIGHUP to the remote foreground process group and the tree dies with
  it;
- local SIGINT/SIGTERM (and normal exit) fan out kills to every host;
- remote stdout/stderr is streamed line by line with a ``[host]``
  prefix;
- a host that fails FOR GOOD tears the fleet down and propagates the
  exit code.

Resilience:

- ``--host-retries N`` (default 0 = tear down on the first failure)
  relaunches a failed host up to N times with exponential backoff before
  giving up; a preempted host (exit
  :data:`~fast_autoaugment_tpu_torch.core.resilience.PREEMPTED_EXIT_CODE`,
  77) is explicitly retry-eligible — its training checkpointed before
  exiting, so the relaunch RESUMES rather than restarts;
- the fleet's exit code is the FIRST GENUINE failure: hosts that die
  from the teardown kill do not mask the root cause;
- the final log line reports per-host attempt counts.

Self-healing fleet (the supervisor half of the ``launch/workqueue.py``
lease layer):

- ``--elastic``: a host that fails FOR GOOD no longer tears the fleet
  down — it is declared LOST, the survivors keep running, and (when the
  workers share a ``--workqueue``) they reclaim the dead host's stale
  leases and finish its work units.  The fleet completes with any >= 1
  live host; exit 0 when at least one host succeeded.
- ``--workqueue DIR --heartbeat-timeout S``: the supervisor reads the
  workers' host heartbeats (``DIR/hosts/host<id>.json``, written at
  dispatch/round boundaries).  A process that is ALIVE but whose beat is
  older than S is WEDGED beyond what its in-process watchdog could catch
  — the supervisor SIGKILLs it and the normal retry path relaunches it,
  resuming from the checkpoint chain.
- every supervisor log line carries ``host=<id> attempt=<n>``; each
  launch exports ``FAA_ATTEMPT=<n>`` (fault-injection specs gated to one
  attempt, ``utils/faultinject.py``), ``FAA_HOST_ID`` and, with
  ``--roles``, ``FAA_SEARCH_ROLE``.

    python -m fast_autoaugment_tpu_torch.launch.fleet --hosts a,b,c --elastic \
        --host-retries 2 --workqueue /shared/wq --heartbeat-timeout 120 -- \
        python -m fast_autoaugment_tpu_torch.launch.search_cli \
        -c confs/wresnet40x2_cifar.yaml --dataroot /data --save-dir /shared/search \
        --workqueue /shared/wq --lease-ttl 60 --until 2

    python -m fast_autoaugment_tpu_torch.launch.fleet --hosts a,b,c \
        --roles learner,actor,actor --fleet-transport /shared/tr -- \
        python -m fast_autoaugment_tpu_torch.launch.search_cli \
        -c confs/wresnet40x2_cifar.yaml --dataroot /data --save-dir /shared/search --until 2

``--hosts N`` expands to task1..taskN like the reference
(``train_dist.py:118-121``).
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import threading
import time

from fast_autoaugment_tpu_torch.core.resilience import PREEMPTED_EXIT_CODE
from fast_autoaugment_tpu_torch.utils.logging import get_logger

logger = get_logger("faa_torch.fleet")

__all__ = ["expand_hosts", "launch_fleet", "main", "resolve_roles",
           "DEFAULT_ENV_PASSTHROUGH"]


def expand_hosts(spec: str) -> list[str]:
    """'4' -> [task1..task4]; 'a,b,c' -> [a, b, c] (train_dist.py:118-121)."""
    if spec.isdigit():
        return [f"task{i + 1}" for i in range(int(spec))]
    return [h.strip() for h in spec.split(",") if h.strip()]


def _remote_argv(host: str, wire: str) -> list[str]:
    """The local argv that runs `wire` on `host` (separate function so
    tests can substitute a local shell for ssh)."""
    return ["ssh", "-tt", "-o", "BatchMode=yes", host, wire]


class _Fleet:
    def __init__(self):
        self.procs: set[subprocess.Popen] = set()
        self._lock = threading.Lock()
        # once set, new launches stop and in-flight failures are
        # recorded as teardown-induced rather than root causes
        self.teardown = threading.Event()
        # (monotonic time, host, code) of genuine failures, in order
        self.failures: list[tuple[float, str, int]] = []
        # hosts that eventually exited 0 / were declared lost (elastic)
        self.successes: list[str] = []
        self.lost: list[str] = []
        # wedged processes the heartbeat monitor had to kill
        self.hang_kills = 0

    def track(self, p: subprocess.Popen):
        with self._lock:
            self.procs.add(p)

    def untrack(self, p: subprocess.Popen):
        with self._lock:
            self.procs.discard(p)

    def record_failure(self, host: str, code: int):
        with self._lock:
            self.failures.append((time.monotonic(), host, code))

    def record_success(self, host: str):
        with self._lock:
            self.successes.append(host)

    def record_lost(self, host: str):
        with self._lock:
            self.lost.append(host)

    def kill_all(self, sig=signal.SIGTERM):
        with self._lock:
            procs = list(self.procs)
        for p in procs:
            if p.poll() is None:
                try:
                    # the local ssh runs in its own session; killing it
                    # closes the remote pty, and the kernel HUPs the
                    # remote foreground process group (the command tree
                    # is deliberately NOT setsid-detached from the pty)
                    os.killpg(os.getpgid(p.pid), sig)
                except (ProcessLookupError, PermissionError):
                    pass


def _stream(prefix: str, pipe, out):
    for line in iter(pipe.readline, b""):
        out.write(prefix.encode() + line)
        out.flush()
    pipe.close()


def _heartbeat_age(workqueue_dir: str, host_tag: str) -> float | None:
    """Seconds since the worker's last host beat, None when unknown
    (no beat yet — e.g. still compiling — or unreadable mid-write) or
    when the worker marked itself done (finished, not wedged).  The
    supervisor and its workers share one machine (and one clock), so
    this wall comparison is not a cross-host skew hazard."""
    from fast_autoaugment_tpu_torch.core import fsfault

    path = os.path.join(workqueue_dir, "hosts", f"{host_tag}.json")
    rec = fsfault.read_json(path)
    if rec is None or rec.get("done"):
        return None
    try:
        return max(0.0, time.time() - float(rec["heartbeat"]))
    except (KeyError, TypeError, ValueError):
        return None


def _wait_with_heartbeat(fleet: _Fleet, p: subprocess.Popen, host: str,
                         attempt: int, host_tag: str,
                         workqueue_dir: str | None,
                         heartbeat_timeout: float) -> int:
    """Wait for the process; with a workqueue + timeout configured,
    SIGKILL it when its host beat goes stale — the beyond-the-watchdog
    wedge (the interpreter itself stuck in a rendezvous) that no
    in-process deadline can catch."""
    if not workqueue_dir or heartbeat_timeout <= 0:
        return p.wait()
    while True:
        try:
            return p.wait(timeout=max(0.2, heartbeat_timeout / 4.0))
        except subprocess.TimeoutExpired:
            if fleet.teardown.is_set():
                return p.wait()
            age = _heartbeat_age(workqueue_dir, host_tag)
            if age is not None and age > heartbeat_timeout:
                logger.warning(
                    "host=%s attempt=%d heartbeat %.1fs stale "
                    "(timeout %.1fs) — killing WEDGED process",
                    host, attempt, age, heartbeat_timeout)
                fleet.hang_kills += 1
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                return p.wait()


def _supervise(fleet: _Fleet, host_id: int, host: str, command: list[str],
               coordinator: str, num_hosts: int,
               env_passthrough: tuple[str, ...], host_retries: int,
               retry_backoff: float, attempts_out: dict,
               elastic: bool = False, workqueue_dir: str | None = None,
               heartbeat_timeout: float = 0.0, rank_args: bool = True,
               role: str | None = None):
    """Launch + babysit one host: relaunch on failure (exit 77 included)
    up to `host_retries` times with exponential backoff, SIGKILLing a
    heartbeat-stale (wedged) process first when configured; on final
    failure either tear the fleet down (default) or — ``elastic`` —
    declare the host LOST and let the survivors finish its work.

    ``rank_args=False`` (fleet ``--no-rank-args``) launches the command
    VERBATIM — replica supervision for commands with no multi-controller
    rank surface (e.g. ``serve/serve_cli.py`` policy-serving replicas,
    which would choke on ``--coordinator``); the replica still gets
    ``FAA_HOST_ID``/``FAA_ATTEMPT`` in its environment so host beats
    and attempt-gated fault specs stay addressable."""
    if rank_args:
        remote_cmd = command + [
            "--coordinator", coordinator,
            "--num-hosts", str(num_hosts),
            "--host-id", str(host_id),
        ]
    else:
        remote_cmd = list(command)
    host_tag = f"host{host_id}"
    base_envs = " ".join(
        f"{k}={shlex.quote(os.environ[k])}"
        for k in env_passthrough if k in os.environ
    )
    attempt = 0
    while not fleet.teardown.is_set():
        attempt += 1
        attempts_out[host] = attempt
        # FAA_ATTEMPT gates fault-injection specs to one attempt in the
        # process chain (a relaunch re-reads the same FAA_FAULT);
        # FAA_HOST_ID addresses rank-free replicas (serve host beats);
        # FAA_SEARCH_ROLE is the per-host fleet-search role (--roles),
        # re-exported on every RETRY so a relaunched actor stays an
        # actor
        envs = (f"{base_envs} FAA_ATTEMPT={attempt} "
                f"FAA_HOST_ID={host_id}"
                + (f" FAA_SEARCH_ROLE={shlex.quote(role)}" if role
                   else "")).strip()
        # NO setsid: the remote command must keep the ssh pty as its
        # controlling terminal so pty teardown HUPs the whole foreground
        # group — a setsid-detached tree would never see the hangup and
        # Ctrl-C here would orphan remote training processes
        # (safe_shell_exec.py:98-131 solves the same problem with an
        # explicit signal-forwarding middleman)
        wire = f"cd {shlex.quote(os.getcwd())} && {envs} exec " + " ".join(
            shlex.quote(c) for c in remote_cmd
        )
        full = _remote_argv(host, wire)
        logger.info("host=%s attempt=%d launching: %s", host, attempt,
                    " ".join(full))
        try:
            p = subprocess.Popen(
                full, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                start_new_session=True,
            )
        except FileNotFoundError:
            logger.error("host=%s attempt=%d ssh binary not found — the "
                         "fleet launcher needs an ssh client on the "
                         "controlling host", host, attempt)
            fleet.record_failure(host, 127)
            fleet.teardown.set()
            fleet.kill_all()
            return
        fleet.track(p)
        if fleet.teardown.is_set():
            # we raced the teardown: a sibling failed between our
            # launch check and track(), so its kill_all() missed this
            # process — kill it ourselves or it outlives the fleet
            fleet.kill_all()
        t = threading.Thread(
            target=_stream,
            args=(f"[host={host} attempt={attempt}] ", p.stdout,
                  sys.stdout.buffer),
            daemon=True)
        t.start()
        code = _wait_with_heartbeat(fleet, p, host, attempt, host_tag,
                                    workqueue_dir, heartbeat_timeout)
        t.join(timeout=2)
        fleet.untrack(p)
        if code == 0:
            fleet.record_success(host)
            return
        if fleet.teardown.is_set():
            # killed by (or failed during) teardown: NOT a root cause
            logger.info("host=%s attempt=%d exited %d during teardown",
                        host, attempt, code)
            return
        preempted = code == PREEMPTED_EXIT_CODE
        if attempt <= host_retries:
            delay = retry_backoff * (2 ** (attempt - 1))
            logger.warning(
                "host=%s attempt=%d exited %d (%s) — relaunching in %.1fs "
                "(attempt %d/%d)", host, attempt, code,
                "preempted: resume me" if preempted else "failed",
                delay, attempt, host_retries + 1)
            # interruptible sleep: a teardown elsewhere aborts the retry
            if fleet.teardown.wait(delay):
                return
            continue
        fleet.record_failure(host, code)
        if elastic:
            # degraded-mode completion: survivors keep running and (via
            # the shared workqueue) reclaim this host's stale leases
            fleet.record_lost(host)
            logger.warning(
                "host=%s attempt=%d exited %d (%s) — out of retries; "
                "host LOST, elastic fleet continues degraded (survivors "
                "reclaim its work units)", host, attempt, code,
                "preempted" if preempted else "failed")
            return
        logger.warning("host=%s attempt=%d exited %d (%s) — out of "
                       "retries, tearing down fleet", host, attempt, code,
                       "preempted" if preempted else "failed")
        fleet.teardown.set()
        fleet.kill_all()
        return


#: env vars forwarded to every host launch AND retry by default — the
#: card selection, and the whole fleet-sharing contract for the kernel
#: cache, the telemetry journal, the serial-baseline dispatch trace, and
#: the fleet-search role/transport handoff
DEFAULT_ENV_PASSTHROUGH = ("CUDA_VISIBLE_DEVICES", "FAA_COMPILE_CACHE",
                           "FAA_TELEMETRY", "FAA_PIPELINE_TRACE",
                           "FAA_SEARCH_ROLE", "FAA_FLEET_TRANSPORT")


def resolve_roles(spec: str | None, num_hosts: int) -> list[str | None]:
    """``--roles`` to a per-host role list.  A single role broadcasts;
    otherwise the comma list must match the host count (a silently
    truncated or recycled role plan is exactly the launch bug this
    raises on).  None/'' = no role exports (non-search fleets)."""
    if not spec:
        return [None] * num_hosts
    roles = [r.strip() for r in str(spec).split(",") if r.strip()]
    if len(roles) == 1:
        return roles * num_hosts
    if len(roles) != num_hosts:
        raise ValueError(
            f"--roles names {len(roles)} role(s) for {num_hosts} host(s) "
            "— give one role per host (or a single role to broadcast)")
    return roles


def launch_fleet(hosts: list[str], command: list[str],
                 coordinator: str | None,
                 env_passthrough: tuple[str, ...] = DEFAULT_ENV_PASSTHROUGH,
                 host_retries: int = 0,
                 retry_backoff: float = 1.0,
                 elastic: bool = False,
                 workqueue_dir: str | None = None,
                 heartbeat_timeout: float = 0.0,
                 rank_args: bool = True,
                 roles: list[str | None] | None = None) -> int:
    """Run `command` on every host over SSH; returns the first genuine
    failure's exit code (0 when every host eventually succeeds).

    `host_retries` relaunches a failed host (exponential backoff
    starting at `retry_backoff` seconds) before the failure counts;
    exit 77 (preempted — state checkpointed, docs/RESILIENCE.md) is
    retry-eligible like any failure, and the relaunch resumes from the
    checkpoint.

    `elastic` completes the fleet with any >= 1 live host: a host out
    of retries is declared LOST instead of tearing the fleet down, and
    the exit code is 0 when at least one host succeeded (the workers'
    shared ``--workqueue`` makes the survivors finish the dead host's
    units).  `workqueue_dir` + `heartbeat_timeout` arm the wedge
    detector: an alive process whose host beat under
    ``<dir>/hosts/host<id>.json`` is older than the timeout is
    SIGKILLed and relaunched through the normal retry path.

    `rank_args=False` runs the command verbatim (no
    ``--coordinator/--num-hosts/--host-id`` suffix) — REPLICA
    supervision for rank-free services; each replica still gets
    ``FAA_HOST_ID``/``FAA_ATTEMPT`` exported.  The serving use:
    ``--no-rank-args -- python -m fast_autoaugment_tpu_torch.serve.serve_cli
    --policy … --breaker-exit --heartbeat-dir Q`` gives every serving
    replica breaker-open restart (exit 77 is retry-eligible) and
    wedge-detection for free."""
    fleet = _Fleet()
    coordinator = coordinator or f"{hosts[0]}:8476"
    host_retries = max(0, int(host_retries))
    if roles is None:
        roles = [None] * len(hosts)
    if len(roles) != len(hosts):
        raise ValueError(f"{len(roles)} role(s) for {len(hosts)} host(s)")

    def handler(signum, frame):
        logger.info("signal %d: killing fleet", signum)
        fleet.teardown.set()
        fleet.kill_all(signal.SIGTERM)
        sys.exit(128 + signum)

    prev_int = signal.signal(signal.SIGINT, handler)
    prev_term = signal.signal(signal.SIGTERM, handler)

    attempts: dict[str, int] = {}
    supervisors = []
    for host_id, host in enumerate(hosts):
        t = threading.Thread(
            target=_supervise,
            args=(fleet, host_id, host, command, coordinator, len(hosts),
                  env_passthrough, host_retries, retry_backoff, attempts,
                  elastic, workqueue_dir, heartbeat_timeout, rank_args,
                  roles[host_id]),
            daemon=True,
        )
        t.start()
        supervisors.append(t)
    try:
        for t in supervisors:
            # bounded joins (lint R4): the supervisor threads exit on
            # their own, but an untimed join here would silently hang
            # the whole launcher if one ever wedged
            while t.is_alive():
                t.join(timeout=5.0)
    finally:
        fleet.teardown.set()
        fleet.kill_all()
        # restore whatever handlers the embedding process had (e.g. the
        # resilience preemption handlers when launched in-process)
        signal.signal(signal.SIGINT, prev_int)
        signal.signal(signal.SIGTERM, prev_term)
    # first GENUINE failure wins: teardown-induced exits were never
    # recorded, so a late sibling killed with SIGTERM cannot mask (or
    # be masked by) the root cause
    worst = 0
    if fleet.failures:
        fleet.failures.sort(key=lambda f: f[0])
        _, first_host, worst = fleet.failures[0]
        logger.warning("fleet: first genuine failure on host=%s with exit %d",
                       first_host, worst)
    if elastic and fleet.successes and worst != 0:
        # degraded completion: >= 1 host finished the (shared-queue)
        # work, so the FLEET succeeded even though hosts were lost —
        # the worker stamped degraded/lost_hosts into the result
        logger.warning(
            "fleet: DEGRADED completion — %d host(s) lost (%s), %d "
            "succeeded; exit 0", len(fleet.lost),
            ",".join(fleet.lost) or "-", len(fleet.successes))
        worst = 0
    logger.info(
        "fleet done: exit %d; attempts per host: %s%s%s", worst,
        " ".join(f"{h}={attempts.get(h, 0)}" for h in hosts),
        f"; lost: {','.join(fleet.lost)}" if fleet.lost else "",
        f"; wedged-killed: {fleet.hang_kills}" if fleet.hang_kills else "")
    return worst


def main(argv=None):
    p = argparse.ArgumentParser(description="multi-host launcher")
    p.add_argument("--hosts", required=True, help="N or comma-separated hostnames")
    p.add_argument("--coordinator", default=None, help="addr:port of host 0")
    p.add_argument("--host-retries", type=int, default=0,
                   help="relaunch a failed host up to N times (exponential "
                        "backoff) before tearing down the fleet; exit 77 "
                        "(preempted, checkpointed) is retry-eligible and "
                        "the relaunch RESUMES (docs/RESILIENCE.md)")
    p.add_argument("--retry-backoff", type=float, default=1.0,
                   help="base seconds for the exponential retry backoff")
    p.add_argument("--elastic", action="store_true",
                   help="degraded-mode completion: a host out of retries "
                        "is declared LOST instead of tearing the fleet "
                        "down; survivors keep running (and, with a shared "
                        "--workqueue, reclaim its work units).  Fleet "
                        "exit 0 when >= 1 host succeeds "
                        "(docs/RESILIENCE.md 'Self-healing fleet')")
    p.add_argument("--no-rank-args", action="store_true",
                   help="launch the command VERBATIM (no --coordinator/"
                        "--num-hosts/--host-id suffix): replica "
                        "supervision for rank-free services like the "
                        "serving CLI — retries, --elastic and "
                        "--heartbeat-timeout all apply; each replica "
                        "gets FAA_HOST_ID/FAA_ATTEMPT exported")
    p.add_argument("--workqueue", default=None, metavar="DIR",
                   help="the workers' shared lease-queue dir (pass the "
                        "same DIR to the worker CLI); arms the "
                        "supervisor-side heartbeat wedge detector")
    p.add_argument("--heartbeat-timeout", type=float, default=0.0,
                   help="SIGKILL + relaunch an ALIVE worker whose "
                        "DIR/hosts/host<id>.json beat is older than this "
                        "many seconds — the interpreter-level wedge the "
                        "in-process --watchdog cannot catch.  0 = off")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="shared kernel-library cache: exported to every "
                        "host (and every RETRY — the relaunch loads the "
                        "libraries its predecessor built) as "
                        "FAA_COMPILE_CACHE.  Point it at a directory all "
                        "hosts mount; the worker CLIs pick it up without "
                        "extra flags (core/compilecache.py)")
    p.add_argument("--roles", default=None, metavar="R1,R2,...",
                   help="per-host fleet role (learner/actor for a "
                        "--fleet-transport search; control for a "
                        "control_cli host riding a --no-rank-args "
                        "serving fleet), exported as FAA_SEARCH_ROLE "
                        "to every launch "
                        "AND retry so search_cli --search-role auto "
                        "resolves it.  One role broadcasts to all "
                        "hosts; otherwise the list must match the host "
                        "count.  Example: --roles learner,actor,actor")
    p.add_argument("--fleet-transport", default=None, metavar="DIR",
                   help="shared fleet-search round-transport dir: "
                        "exported to every host (and every retry) as "
                        "FAA_FLEET_TRANSPORT, so the worker CLIs pick "
                        "up the transport without extra flags — the "
                        "same contract as --compile-cache/--telemetry "
                        "(docs/RESILIENCE.md 'Fleet search')")
    p.add_argument("--telemetry", default=None, metavar="DIR",
                   help="shared flight-recorder journal dir: exported to "
                        "every host (and every retry) as FAA_TELEMETRY so "
                        "each worker journals under DIR with its own "
                        "host/attempt identity; tools/faa_status.py "
                        "aggregates the result into one fleet table "
                        "(core/telemetry.py)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="command to run on every host (prefix with --)")
    args = p.parse_args(argv)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        p.error("no command given")
    if args.compile_cache and args.compile_cache.lower() != "off":
        # the env-passthrough list already forwards FAA_COMPILE_CACHE to
        # every host launch (retries included) — setting it here is the
        # whole fleet-sharing contract
        os.environ["FAA_COMPILE_CACHE"] = args.compile_cache
    if args.telemetry and args.telemetry.lower() != "off":
        # same contract as the compile cache: the env-passthrough list
        # forwards FAA_TELEMETRY to every host launch and retry
        os.environ["FAA_TELEMETRY"] = args.telemetry
    if args.fleet_transport and args.fleet_transport.lower() != "off":
        # and again for the fleet-search round transport
        os.environ["FAA_FLEET_TRANSPORT"] = args.fleet_transport
    hosts = expand_hosts(args.hosts)
    try:
        roles = resolve_roles(args.roles, len(hosts))
    except ValueError as e:
        p.error(str(e))
    code = launch_fleet(hosts, command, args.coordinator,
                        host_retries=args.host_retries,
                        retry_backoff=args.retry_backoff,
                        elastic=args.elastic,
                        workqueue_dir=args.workqueue,
                        heartbeat_timeout=args.heartbeat_timeout,
                        rank_args=not args.no_rank_args,
                        roles=roles)
    sys.exit(code)


if __name__ == "__main__":
    main()
