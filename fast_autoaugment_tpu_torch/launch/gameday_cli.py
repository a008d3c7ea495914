"""``python -m fast_autoaugment_tpu_torch.launch.gameday_cli`` — trace-driven
game days (docs/GAMEDAYS.md) over the port's serving plane.

The port's copy of ``fast_autoaugment_tpu/launch/gameday_cli.py``: a thin
front end over ``gameday/runner.py`` — pick scenarios, run them, print
the verdict table, exit 0 only when the SUITE is green (every verdict
matched its spec's ``expect`` — a broken-config scenario that failed on
cue is green; one that passed is not).  Every JAX flag, plus ``--device``
(``cuda`` by default; ``cpu`` for tests): the device every replica
serves on.

The suite JSON (``--out``) carries the provenance stamps of the JAX
package's ``bench.py`` (contention + ``single_core_caveat``), in the
same keys and shapes, from this module's own copy of those helpers on
the port's compile seam and telemetry registry: a verdict
captured on a contended host is evidence about the HOST, not the plane.

Examples::

    python -m fast_autoaugment_tpu_torch.launch.gameday_cli --list
    python -m fast_autoaugment_tpu_torch.launch.gameday_cli --suite \\
        --out gameday.json
    python -m fast_autoaugment_tpu_torch.launch.gameday_cli --suite --smoke
    python -m fast_autoaugment_tpu_torch.launch.gameday_cli --suite --smoke \\
        --device cpu
    python -m fast_autoaugment_tpu_torch.launch.gameday_cli \\
        --scenario flash-crowd-10x --seed 21
"""

from __future__ import annotations

import argparse
import os
import sys

from fast_autoaugment_tpu_torch.utils.logging import get_logger

logger = get_logger("faa_torch.gameday_cli")

#: version of the :func:`telemetry_stamp` block (the JAX bench's
#: ``TELEMETRY_STAMP_SCHEMA_VERSION``)
TELEMETRY_STAMP_SCHEMA_VERSION = 1


def host_contention_stamp() -> dict:
    """Load provenance at capture start: the 1/5/15-minute load
    averages, the core and process counts, and ``contended`` (a
    pre-existing 1-minute load above 75% of the cores)."""
    stamp: dict = {"cpu_count": os.cpu_count()}
    try:
        la1, la5, la15 = os.getloadavg()
        stamp["loadavg_1m"] = round(la1, 2)
        stamp["loadavg_5m"] = round(la5, 2)
        stamp["loadavg_15m"] = round(la15, 2)
    except OSError:  # not available on this platform
        stamp["loadavg_1m"] = stamp["loadavg_5m"] = stamp["loadavg_15m"] = None
    try:
        stamp["process_count"] = sum(1 for d in os.listdir("/proc") if d.isdigit())
    except OSError:
        stamp["process_count"] = None
    la1 = stamp["loadavg_1m"]
    stamp["contended"] = bool(la1 is not None and la1 > 0.75 * (stamp["cpu_count"] or 1))
    return stamp


def refuse_or_flag_contention(stamp: dict) -> dict:
    """Exit 3 under ``FAA_BENCH_REQUIRE_QUIET`` on a contended host, else
    annotate the stamp."""
    if not stamp.get("contended"):
        return stamp
    msg = (f"host is contended at capture start: loadavg_1m={stamp['loadavg_1m']} on "
           f"{stamp['cpu_count']} core(s), {stamp['process_count']} processes")
    if os.environ.get("FAA_BENCH_REQUIRE_QUIET"):
        logger.error("REFUSING to run (%s); unset FAA_BENCH_REQUIRE_QUIET to capture "
                     "anyway (the artifact would be flagged)", msg)
        sys.exit(3)
    logger.warning("%s — artifact will be flagged contended=true", msg)
    stamp["note"] = ("captured under host contention — timings are unreliable; not an "
                     "official number")
    return stamp


def telemetry_stamp(contention: dict) -> dict:
    """The unified provenance block: ``schema_version``, ``contention``,
    ``watchdog``, ``compile_cache`` and the telemetry registry's
    counters, in the JAX bench's keys and shapes.  A game day observes no
    dispatch walls: no watchdog fired and no deadline was set."""
    from fast_autoaugment_tpu_torch.core import telemetry
    from fast_autoaugment_tpu_torch.core.compilecache import compile_cache_stats

    return {
        "schema_version": TELEMETRY_STAMP_SCHEMA_VERSION,
        "contention": contention,
        "watchdog": {"watchdog_fires": 0, "watchdog_deadline_sec": None},
        "compile_cache": compile_cache_stats(),
        "telemetry_counters": telemetry.registry().counters_snapshot(),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gameday",
        description="deterministic game-day drills with journaled "
                    "verdicts over the live serving plane")
    p.add_argument("--scenario", action="append", default=None,
                   metavar="NAME",
                   help="run one named scenario (repeatable); default "
                        "is the full suite")
    p.add_argument("--suite", action="store_true",
                   help="run the full registered suite, broken-config "
                        "demonstrations included (the default when no "
                        "--scenario is given)")
    p.add_argument("--smoke", action="store_true",
                   help="time/load-shrunk pass over the same topologies "
                        "and predicates (scenario.scaled)")
    p.add_argument("--smoke-factor", type=float, default=0.4,
                   help="load shrink factor for --smoke (default 0.4; "
                        "dispatch floors scale inversely so overload "
                        "scenarios still overload)")
    p.add_argument("--seed", type=int, default=None,
                   help="override every scenario's seed (same "
                        "(scenario, seed) => byte-identical schedule)")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the suite JSON (records + verdict table "
                        "+ provenance stamps) here")
    p.add_argument("--keep", action="store_true",
                   help="keep the per-scenario workdirs (journals, "
                        "policies) for post-mortem instead of deleting")
    p.add_argument("--list", action="store_true",
                   help="list registered scenarios and exit")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the device every replica serves on (serve_cli "
                        "--device); a replica that cannot reach it fails "
                        "its scenario")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from fast_autoaugment_tpu_torch.gameday.scenario import SCENARIOS, suite_names

    if args.list:
        for name in suite_names():
            s = SCENARIOS[name]
            print(f"{name} (expect {s.expect}): {s.summary}")
        return 0

    names = suite_names() if (args.suite or not args.scenario) \
        else list(args.scenario)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(f"unknown scenario(s): {', '.join(unknown)}; "
              f"--list shows the registry", file=sys.stderr)
        return 2

    # provenance stamps ride the suite JSON: a verdict captured on a
    # contended host is evidence about the host, not the plane
    extra = {"single_core_caveat": True}
    contention = refuse_or_flag_contention(host_contention_stamp())
    extra.update(telemetry_stamp(contention))

    from fast_autoaugment_tpu_torch.gameday.runner import run_suite
    result = run_suite(names, smoke=args.smoke,
                       smoke_factor=args.smoke_factor, seed=args.seed,
                       out=args.out, keep=args.keep, extra=extra,
                       device=args.device)
    print(result["table"])
    return 0 if result["suite_green"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
