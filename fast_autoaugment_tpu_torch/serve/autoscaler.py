"""Telemetry-driven replica autoscaling — capacity that follows load.

The port's copy of ``fast_autoaugment_tpu/serve/autoscaler.py``: a
journaled control loop scrapes each serving replica's Prometheus
``/metrics`` (queue depth, shed rate, breaker state), compares the
aggregate against high/low watermarks with hysteresis and a cooldown,
and grows or shrinks the replica fleet (spawned replicas are the
port's ``serve_cli --port-dir`` processes the router
discovers; a shrink is a SIGTERM graceful drain — stop admitting,
finish in-flight, remove the discovery record, exit 0 — so scale-down
drops ZERO in-flight requests by construction).

Layering (each piece testable alone):

- :func:`parse_prometheus_text` — the scrape-side inverse of
  ``MetricsRegistry.prometheus_text`` (host-only);
- :class:`ReplicaScraper` — per-replica scrape + counter-delta rate
  derivation (shed counters are cumulative; load is their RATE);
- :class:`AutoscalerPolicy` — the PURE watermark/hysteresis/cooldown
  state machine: ``decide(signal, n_replicas, now)`` -> up/down/None.
  Hysteresis = ``up_polls``/``down_polls`` consecutive breaches before
  acting (one bursty poll never scales); cooldown = a dead time after
  every action so the loop observes the fleet's response before acting
  again (no oscillation);
- :class:`Autoscaler` — the journaled loop: every decision is a typed
  ``scale_up``/``scale_down`` journal event with the metric evidence
  INLINE (queue depth, shed rate, breaker verdict, replica census
  before/after), so the journal shows load -> decision ->
  replica-ready end to end;
- :class:`LocalReplicaFleet` — the process actuator: spawns
  ``serve_cli`` replicas (FAA_HOST_ID/FAA_ATTEMPT exported, fleet
  idiom) and drains the newest on shrink.

Watermark semantics: the
fleet is OVERLOADED when max queue depth >= ``high_queue`` OR the
aggregate shed rate >= ``high_shed_rate`` OR any replica's breaker is
open; it is UNDERLOADED only when every signal sits at/below its low
watermark.  Between the watermarks nothing happens — the dead band is
what makes the loop stable.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading

from fast_autoaugment_tpu_torch.core import telemetry
from fast_autoaugment_tpu_torch.core.telemetry import mono
from fast_autoaugment_tpu_torch.serve.router import discover_replicas
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["parse_prometheus_text", "ReplicaScraper", "AutoscalerPolicy",
           "Autoscaler", "LocalReplicaFleet"]

logger = get_logger("faa_torch.autoscaler")


def parse_prometheus_text(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Text exposition 0.0.4 -> ``{family: [(labels, value), ...]}``.

    The scrape-side inverse of ``MetricsRegistry.prometheus_text``:
    comment lines skipped, label values unescaped enough for our own
    exposition (no embedded quotes in this repo's label values)."""
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:
            continue
        try:
            value = float(value_part)
        except ValueError:
            continue
        labels: dict = {}
        name = name_part
        if "{" in name_part and name_part.endswith("}"):
            name, _, lbl = name_part.partition("{")
            for item in lbl[:-1].split(","):
                if not item:
                    continue
                k, _, v = item.partition("=")
                labels[k.strip()] = v.strip().strip('"')
        out.setdefault(name, []).append((labels, value))
    return out


class ReplicaScraper:
    """Scrape one fleet's replicas and derive the autoscaler signal.

    Counters are cumulative — load is their RATE, so the scraper keeps
    the previous (value, mono) per replica and differentiates.  A
    replica seen for the first time contributes rate 0 for one round
    (no baseline yet), which errs toward stability."""

    #: metric families consumed
    QUEUE_GAUGE = "faa_serve_queue_depth"
    ROBUSTNESS = "faa_serve_robustness_total"
    BREAKER_GAUGE = "faa_breaker_open"

    def __init__(self, port_dir: str, timeout_s: float = 2.0):
        self.port_dir = port_dir
        self.timeout_s = float(timeout_s)
        # tag -> (shed_total, t_mono) baseline for rate derivation
        self._prev_shed: dict[str, tuple[float, float]] = {}

    def _scrape_one(self, host: str, port: int) -> str | None:
        import http.client

        try:
            conn = http.client.HTTPConnection(host, port,
                                              timeout=self.timeout_s)
            try:
                conn.request("GET", "/metrics")
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    return None
                return body.decode()
            finally:
                conn.close()
        except OSError:
            return None

    def scrape(self) -> dict:
        """One scrape round over the port-dir census.  Returns the
        aggregate signal plus per-replica evidence::

            {"replicas": {tag: {queue_depth, shed_rate, breaker_open,
                                reachable}},
             "queue_depth": max-over-replicas,
             "shed_rate": sum-over-replicas (sheds/s),
             "breaker_open": any,
             "reachable": count}
        """
        now = mono()
        per: dict[str, dict] = {}
        # None = transiently unobservable census (fsfault seam): an
        # empty scrape round; hysteresis absorbs the blip
        for rec in discover_replicas(self.port_dir) or []:
            tag = rec["tag"]
            text = self._scrape_one(rec["host"], rec["port"])
            if text is None:
                per[tag] = {"reachable": False, "queue_depth": 0.0,
                            "shed_rate": 0.0, "breaker_open": False}
                continue
            fams = parse_prometheus_text(text)
            qdepth = max((v for _l, v in fams.get(self.QUEUE_GAUGE, [])),
                         default=0.0)
            shed_total = sum(
                v for labels, v in fams.get(self.ROBUSTNESS, [])
                if labels.get("counter") == "shed_overload")
            breaker = any(v > 0
                          for _l, v in fams.get(self.BREAKER_GAUGE, []))
            prev = self._prev_shed.get(tag)
            self._prev_shed[tag] = (shed_total, now)
            if prev is None or now <= prev[1]:
                rate = 0.0
            else:
                rate = max(0.0, (shed_total - prev[0]) / (now - prev[1]))
            per[tag] = {"reachable": True,
                        "queue_depth": float(qdepth),
                        "shed_rate": round(rate, 3),
                        "breaker_open": bool(breaker)}
        reachable = [p for p in per.values() if p["reachable"]]
        return {
            "replicas": per,
            "reachable": len(reachable),
            "queue_depth": max((p["queue_depth"] for p in reachable),
                               default=0.0),
            "shed_rate": round(sum(p["shed_rate"] for p in reachable), 3),
            "breaker_open": any(p["breaker_open"] for p in reachable),
        }


class AutoscalerPolicy:
    """The pure watermark / hysteresis / cooldown state machine.

    ``decide`` consumes one scrape signal and the current replica
    count; it returns ``"up"``, ``"down"`` or ``None`` plus a reason
    string.  No I/O, no clocks of its own (the caller passes ``now``)
    — fully drivable on synthetic metrics in tests."""

    def __init__(self, *, high_queue: float = 8.0, low_queue: float = 1.0,
                 high_shed_rate: float = 1.0, low_shed_rate: float = 0.0,
                 up_polls: int = 2, down_polls: int = 5,
                 cooldown_s: float = 10.0,
                 min_replicas: int = 1, max_replicas: int = 4):
        if low_queue > high_queue:
            raise ValueError(f"low_queue {low_queue} above high_queue "
                             f"{high_queue} — the dead band inverted")
        if low_shed_rate > high_shed_rate:
            raise ValueError(f"low_shed_rate {low_shed_rate} above "
                             f"high_shed_rate {high_shed_rate}")
        if min_replicas > max_replicas:
            raise ValueError(f"min_replicas {min_replicas} > "
                             f"max_replicas {max_replicas}")
        self.high_queue = float(high_queue)
        self.low_queue = float(low_queue)
        self.high_shed_rate = float(high_shed_rate)
        self.low_shed_rate = float(low_shed_rate)
        self.up_polls = max(1, int(up_polls))
        self.down_polls = max(1, int(down_polls))
        self.cooldown_s = float(cooldown_s)
        self.min_replicas = max(0, int(min_replicas))
        self.max_replicas = int(max_replicas)
        self._over_streak = 0
        self._under_streak = 0
        self._cooldown_until = 0.0

    def _classify(self, signal: dict) -> str:
        if (signal.get("queue_depth", 0.0) >= self.high_queue
                or signal.get("shed_rate", 0.0) >= self.high_shed_rate
                or signal.get("breaker_open", False)):
            return "overloaded"
        if (signal.get("queue_depth", 0.0) <= self.low_queue
                and signal.get("shed_rate", 0.0) <= self.low_shed_rate
                and not signal.get("breaker_open", False)):
            return "underloaded"
        return "nominal"

    def decide(self, signal: dict, n_replicas: int,
               now: float) -> tuple[str | None, str]:
        """One poll's verdict.  Streaks accumulate even during the
        cooldown (load evidence is load evidence); ACTING waits for the
        cooldown to pass AND the fleet bounds to allow it."""
        verdict = self._classify(signal)
        if verdict == "overloaded":
            self._over_streak += 1
            self._under_streak = 0
        elif verdict == "underloaded":
            self._under_streak += 1
            self._over_streak = 0
        else:
            self._over_streak = 0
            self._under_streak = 0
        cooling = now < self._cooldown_until
        if (verdict == "overloaded"
                and self._over_streak >= self.up_polls
                and not cooling and n_replicas < self.max_replicas):
            self._over_streak = 0
            self._cooldown_until = now + self.cooldown_s
            return "up", (f"queue_depth={signal.get('queue_depth')} "
                          f"shed_rate={signal.get('shed_rate')} "
                          f"breaker_open={signal.get('breaker_open')} "
                          f">= high watermark for {self.up_polls} polls")
        if (verdict == "underloaded"
                and self._under_streak >= self.down_polls
                and not cooling and n_replicas > self.min_replicas):
            self._under_streak = 0
            self._cooldown_until = now + self.cooldown_s
            return "down", (f"queue_depth={signal.get('queue_depth')} "
                            f"shed_rate={signal.get('shed_rate')} <= low "
                            f"watermark for {self.down_polls} polls")
        return None, verdict

    def snapshot(self) -> dict:
        return {
            "high_queue": self.high_queue, "low_queue": self.low_queue,
            "high_shed_rate": self.high_shed_rate,
            "low_shed_rate": self.low_shed_rate,
            "up_polls": self.up_polls, "down_polls": self.down_polls,
            "cooldown_s": self.cooldown_s,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "over_streak": self._over_streak,
            "under_streak": self._under_streak,
            "cooldown_remaining_s": round(
                max(0.0, self._cooldown_until - mono()), 3),
        }


#: the replica program a :class:`LocalReplicaFleet` runs when its command
#: names none (the command is then the port's ``serve_cli`` arguments)
DEFAULT_REPLICA_CMD = (sys.executable, "-m", "fast_autoaugment_tpu_torch.serve.serve_cli")


def _journal_exit(tag: str, exit_code: int | None, cause: str) -> None:
    """Journal how a replica ended, as its supervisor saw it: a ``mark``
    with ``event="replica_exit"``, its exit code (negative: the signal
    that ended it; None: still running) and ``cause``, ``"scale_down"``
    when the fleet stopped it, ``"exited"`` when it ended on its own.  A
    replica stopped while it started journals nothing itself; this mark
    tells that apart from one that failed to start."""
    if cause != "scale_down":
        logger.warning("fleet: %s exited on its own (exit %s)", tag, exit_code)
    telemetry.emit("mark", f"autoscaler:{tag}", event="replica_exit",
                   replica=tag, exit_code=exit_code, cause=cause)
    telemetry.journal_flush()


class LocalReplicaFleet:
    """The process actuator: serve_cli replicas as supervised local
    subprocesses (each replica gets ``FAA_HOST_ID``/``FAA_ATTEMPT`` and
    announces itself via ``--port-dir``).  A `replica_cmd` that is None
    or starts with an option runs the port's ``serve_cli``
    (:data:`DEFAULT_REPLICA_CMD`) with those arguments.

    ``scale_down`` SIGTERMs the NEWEST replica: serve_cli's graceful
    drain stops admitting, finishes in-flight requests, removes its
    discovery record and exits 0 — zero dropped in-flight requests by
    construction (the serving exit contract).  Every replica's end is
    journaled with its exit code (:func:`_journal_exit`)."""

    def __init__(self, replica_cmd: list[str] | None, port_dir: str, *,
                 extra_env: dict | None = None, tag_prefix: str = "replica"):
        cmd = list(replica_cmd or [])
        if not cmd or cmd[0].startswith("-"):
            cmd = list(DEFAULT_REPLICA_CMD) + cmd
        self.replica_cmd = cmd
        self.port_dir = port_dir
        self.extra_env = dict(extra_env or {})
        self.tag_prefix = tag_prefix
        self._procs: list[tuple[str, subprocess.Popen]] = []
        self._next_id = 0
        self._lock = threading.Lock()

    def _reap_locked(self) -> None:
        live = []
        for tag, p in self._procs:
            if p.poll() is None:
                live.append((tag, p))
            else:  # it ended on its own: a crash, a failed start, a breaker exit
                _journal_exit(tag, p.returncode, "exited")
        self._procs = live

    def count(self) -> int:
        with self._lock:
            self._reap_locked()
            return len(self._procs)

    def scale_up(self) -> str:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            tag = f"{self.tag_prefix}{rid}"
        env = dict(os.environ, **self.extra_env)
        env["FAA_HOST_ID"] = str(rid)
        env.setdefault("FAA_ATTEMPT", "1")
        cmd = self.replica_cmd + ["--port", "0",
                                  "--port-dir", self.port_dir,
                                  "--host-tag", tag]
        logger.info("fleet: launching %s: %s", tag, " ".join(cmd))
        p = subprocess.Popen(cmd, env=env)
        with self._lock:
            self._procs.append((tag, p))
        return tag

    def scale_down(self, drain_timeout: float = 30.0) -> str | None:
        with self._lock:
            self._reap_locked()
            if not self._procs:
                return None
            tag, p = self._procs.pop()  # newest first: LIFO shrink
        logger.info("fleet: draining %s (SIGTERM graceful drain)", tag)
        try:
            p.send_signal(signal.SIGTERM)
            p.wait(timeout=drain_timeout)
        except ProcessLookupError:
            pass
        except subprocess.TimeoutExpired:
            logger.warning("fleet: %s did not drain in %.0fs — killing",
                           tag, drain_timeout)
            p.kill()
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                logger.error("fleet: %s unkillable (zombie)", tag)
        _journal_exit(tag, p.poll(), "scale_down")
        return tag

    def stop_all(self, drain_timeout: float = 10.0) -> None:
        while self.count() > 0:
            self.scale_down(drain_timeout=drain_timeout)


class Autoscaler:
    """The journaled control loop binding scraper -> policy ->
    actuator.  Every scale decision is a typed ``scale_up`` /
    ``scale_down`` journal event with the metric evidence inline, and
    a ``faa_autoscale_decisions_total{action=}`` counter; the replica
    census is the ``faa_autoscale_replicas`` gauge."""

    def __init__(self, scrape_fn, scale_up_fn, scale_down_fn, count_fn,
                 policy: AutoscalerPolicy, *,
                 poll_interval_s: float = 1.0, name: str = "autoscaler"):
        self.scrape_fn = scrape_fn
        self.scale_up_fn = scale_up_fn
        self.scale_down_fn = scale_down_fn
        self.count_fn = count_fn
        self.policy = policy
        self.poll_interval_s = float(poll_interval_s)
        self.name = str(name)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._last_signal: dict = {}
        self._decisions = 0
        reg = telemetry.registry()
        self._decision_ctr = {a: reg.counter(
            "faa_autoscale_decisions_total",
            "autoscaler scale decisions by action",
            action=a, scaler=self.name) for a in ("up", "down")}
        self._replica_gauge = reg.gauge(
            "faa_autoscale_replicas", "replica census the autoscaler "
            "steers", scaler=self.name)

    def step(self) -> str | None:
        """One poll: scrape, decide, act, journal.  Returns the action
        taken (None = hold)."""
        sig = self.scrape_fn()
        n = int(self.count_fn())
        self._replica_gauge.set(n)
        action, reason = self.policy.decide(sig, n, mono())
        with self._lock:
            self._last_signal = sig
        if action is None:
            return None
        evidence = {
            "queue_depth": sig.get("queue_depth"),
            "shed_rate": sig.get("shed_rate"),
            "breaker_open": sig.get("breaker_open"),
            "reachable": sig.get("reachable"),
            "replicas_before": n,
            "reason": reason,
        }
        if action == "up":
            target = self.scale_up_fn()
        else:
            target = self.scale_down_fn()
        after = int(self.count_fn())
        self._decision_ctr[action].inc()
        self._replica_gauge.set(after)
        with self._lock:
            self._decisions += 1
        telemetry.emit("scale_up" if action == "up" else "scale_down",
                       self.name, replica=target,
                       replicas_after=after, **evidence)
        logger.warning("autoscaler: scale_%s -> %s (replicas %d -> %d): %s",
                       action, target, n, after, reason)
        return action

    def loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.step()
            except OSError as e:
                logger.warning("autoscaler poll failed: %s", e)

    def start(self) -> "Autoscaler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self.loop, daemon=True,
                                            name="autoscaler")
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            # bounded join: the loop is a daemon either way
            self._thread.join(timeout=timeout)

    def stats(self) -> dict:
        with self._lock:
            sig = dict(self._last_signal)
            decisions = self._decisions
        return {
            "scaler": self.name,
            "poll_interval_s": self.poll_interval_s,
            "policy": self.policy.snapshot(),
            "last_signal": sig,
            "decisions": decisions,
            "scale_ups": int(self._decision_ctr["up"].value),
            "scale_downs": int(self._decision_ctr["down"].value),
            "replicas": int(self.count_fn()),
        }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="telemetry-driven serving-replica autoscaler",
        epilog="the replica command follows `--`, e.g.: "
               "autoscaler --port-dir /shared/replicas -- python -m "
               "fast_autoaugment_tpu_torch.serve.serve_cli --policy p.json; "
               "a command that starts with an option (-- --policy p.json) "
               "runs the port's serve_cli; the autoscaler appends --port 0 "
               "--port-dir --host-tag per replica")
    p.add_argument("--port-dir", required=True, metavar="DIR",
                   help="shared replica-discovery dir (serve_cli "
                        "--port-dir; the router watches the same dir)")
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=4)
    p.add_argument("--high-queue", type=float, default=8.0,
                   help="queue-depth high watermark (scale up at/above)")
    p.add_argument("--low-queue", type=float, default=1.0,
                   help="queue-depth low watermark (scale down at/below)")
    p.add_argument("--high-shed-rate", type=float, default=1.0,
                   help="sheds/s high watermark across the fleet")
    p.add_argument("--low-shed-rate", type=float, default=0.0,
                   help="sheds/s low watermark")
    p.add_argument("--up-polls", type=int, default=2,
                   help="consecutive overloaded polls before scaling up "
                        "(hysteresis)")
    p.add_argument("--down-polls", type=int, default=5,
                   help="consecutive underloaded polls before scaling "
                        "down (hysteresis — shrink slower than grow)")
    p.add_argument("--cooldown", type=float, default=10.0,
                   help="dead time after any scale action")
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument("--scrape-timeout", type=float, default=2.0)
    p.add_argument("--scale-seconds", type=float, default=0.0,
                   help="exit 0 after this many seconds (bounded "
                        "drills).  0 = run forever")
    p.add_argument("--telemetry", default="off", metavar="{off,DIR}",
                   help="flight-recorder journal dir: scale_up/"
                        "scale_down decisions with evidence inline "
                        "(core/telemetry.py)")
    p.add_argument("replica_cmd", nargs=argparse.REMAINDER,
                   help="replica launch command (prefix with --)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from fast_autoaugment_tpu_torch.core.telemetry import configure_telemetry

    configure_telemetry(args.telemetry)
    cmd = args.replica_cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        build_parser().error("no replica command given (prefix with --)")
    fleet = LocalReplicaFleet(cmd, args.port_dir)
    scraper = ReplicaScraper(args.port_dir, timeout_s=args.scrape_timeout)
    policy = AutoscalerPolicy(
        high_queue=args.high_queue, low_queue=args.low_queue,
        high_shed_rate=args.high_shed_rate,
        low_shed_rate=args.low_shed_rate,
        up_polls=args.up_polls, down_polls=args.down_polls,
        cooldown_s=args.cooldown,
        min_replicas=args.min_replicas, max_replicas=args.max_replicas)
    scaler = Autoscaler(scraper.scrape, fleet.scale_up, fleet.scale_down,
                        fleet.count, policy,
                        poll_interval_s=args.poll_interval)
    # floor the fleet at min_replicas before the loop starts
    while fleet.count() < args.min_replicas:
        fleet.scale_up()
    scaler.start()
    done = threading.Event()

    def shutdown(signum, frame):
        logger.info("signal %d: stopping autoscaler", signum)
        done.set()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    if args.scale_seconds > 0:
        timer = threading.Timer(args.scale_seconds, done.set)
        timer.daemon = True
        timer.start()
    while not done.wait(0.25):
        pass
    scaler.stop()
    fleet.stop_all()
    print(json.dumps(scaler.stats()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
