"""Control-plane CLI — run the closed drift->promote loop against a
live serving fleet of the port's replicas.

    python -m fast_autoaugment_tpu_torch.launch.control_cli \
        --telemetry /shared/run --port-dir /shared/run/replicas \
        --router-url http://127.0.0.1:8780 \
        --baseline-policy search_out/final_policy.json \
        --research-cmd "python -m fast_autoaugment_tpu_torch.launch.search_cli \
            -c confs/wresnet40x2_cifar.yaml --save-dir {out} \
            --num-search 200 --topup-trials 25 --async-pipeline on"

The loop tails the fleet's telemetry journal (replicas run with
``--traffic-stats --telemetry DIR``), raises a typed ``drift`` verdict
when the seeded CUSUM trips, runs the WARM-STARTED re-search command
(``{out}`` is replaced by a fresh candidate dir seeded from
``--base-search-dir``'s trial log + fold checkpoints; the command must
leave ``{out}/final_policy.json``), canaries the candidate onto the
rendezvous-selected replica subset via digest-verified ``POST
/reload``, splits traffic through the router's ``POST /canary`` admin,
and promotes fleet-wide or rolls back on the served-quality delta
gate — every stage a typed journal event in the shared journal.  The
loop itself touches no device: the re-search command and the replicas
it reloads launch the kernels on the card.

Fleet supervision: ``launch/fleet.py --no-rank-args --roles control``
runs this CLI exactly like a serving replica — ``--heartbeat-dir``
writes fleet-schema host beats so ``--heartbeat-timeout`` covers a
wedged controller, and SIGTERM exits 0 after stopping the loop.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import subprocess
import sys
import threading

from fast_autoaugment_tpu_torch.utils.logging import get_logger

logger = get_logger("faa_torch.control_cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="fast-autoaugment (PyTorch port) closed-loop control plane")
    p.add_argument("--telemetry", required=True, metavar="DIR",
                   help="the SHARED flight-recorder journal dir: the "
                        "drift monitor tails the replicas' serve "
                        "dispatch events here, and the loop's own "
                        "drift/research/canary/promote events land in "
                        "the same journal (one causal chain)")
    p.add_argument("--port-dir", required=True, metavar="DIR",
                   help="replica-discovery dir (serve_cli --port-dir): "
                        "the census the canary rollout and fleet-wide "
                        "promotion actuate against")
    p.add_argument("--router-url", default=None,
                   help="router address (host:port or http://...) for "
                        "the POST /canary traffic-split admin; omit to "
                        "rely on replica-count splitting alone")
    p.add_argument("--baseline-policy", required=True,
                   help="the final_policy.json currently serving — the "
                        "rollback target (refreshed on every promotion)")
    # ---------------- re-search seam ---------------------------------
    p.add_argument("--research-cmd", default=None,
                   help="warm-started re-search command; '{out}' is "
                        "replaced by the candidate dir (seeded from "
                        "--base-search-dir), '{base}' by the base dir. "
                        "Must exit 0 leaving {out}/final_policy.json. "
                        "Typically python -m "
                        "fast_autoaugment_tpu_torch.launch.search_cli with "
                        "--topup-trials + --async-pipeline on")
    p.add_argument("--base-search-dir", default=None, metavar="DIR",
                   help="the completed search dir whose trial log + "
                        "fold checkpoints seed each re-search (default: "
                        "the --baseline-policy file's directory)")
    p.add_argument("--candidate-dir", default=None, metavar="DIR",
                   help="where candidate dirs are created (default: "
                        "<base-search-dir>/research); episode i uses "
                        "<candidate-dir>/episode<i>")
    p.add_argument("--candidate-policy", default=None,
                   help="drill mode: a PRE-BUILT candidate policy JSON "
                        "served instead of running --research-cmd "
                        "(mutually exclusive with it)")
    # ---------------- drift monitor ----------------------------------
    p.add_argument("--drift-metrics", default="input_mean,reward_proxy",
                   help="comma list of served-traffic fields to watch "
                        "(the --traffic-stats journal fields)")
    p.add_argument("--baseline-samples", type=int, default=20,
                   help="dispatch samples frozen into the CUSUM "
                        "baseline window")
    p.add_argument("--cusum-k", type=float, default=1.5,
                   help="CUSUM slack in baseline sigmas (absorbs both "
                        "in-band noise AND the frozen window's "
                        "estimation error — see control/drift.py)")
    p.add_argument("--cusum-h", type=float, default=10.0,
                   help="CUSUM decision threshold in sigmas")
    # ---------------- canary + gate ----------------------------------
    p.add_argument("--canary-replicas", type=int, default=1,
                   help="replicas in the canary subset (>= 1 replica "
                        "always stays baseline)")
    p.add_argument("--split-every", type=int, default=2,
                   help="router split: every Nth digest-less request "
                        "routes to the canary arm")
    p.add_argument("--gate-polls", type=int, default=3,
                   help="judgeable comparison polls before the gate "
                        "decides")
    p.add_argument("--quality-margin", type=float, default=0.05,
                   help="non-inferiority bound on the canary-minus-"
                        "baseline median quality distance "
                        "(|reward_proxy - pre-drift baseline|)")
    p.add_argument("--gate-timeout-polls", type=int, default=50,
                   help="polls before a traffic-starved gate window "
                        "rolls back")
    p.add_argument("--min-arm-dispatches", type=float, default=1.0,
                   help="fresh dispatches BOTH arms need per poll for "
                        "it to count as judgeable")
    # ---------------- process ----------------------------------------
    p.add_argument("--resume", action="store_true",
                   help="crash recovery: reconstruct a dangling "
                        "episode from the journal WAL (a controller "
                        "SIGKILLed mid-canary leaves the router split "
                        "armed forever) and re-enter its stage "
                        "idempotently — the episode terminates in a "
                        "journaled promote or rollback.  Pre-crash "
                        "traffic is skipped, never replayed into the "
                        "fresh baseline")
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument("--research-timeout", type=float, default=3600.0,
                   help="wall bound on one --research-cmd run (a wedged "
                        "re-search must not pin the loop forever)")
    p.add_argument("--reload-timeout", type=float, default=300.0,
                   help="per-replica POST /reload bound (covers the "
                        "off-to-the-side CUDA-graph capture)")
    p.add_argument("--control-seconds", type=float, default=0.0,
                   help="exit 0 after this many seconds (bounded "
                        "drills).  0 = run forever")
    p.add_argument("--heartbeat-dir", default=None, metavar="DIR",
                   help="write fleet-schema host beats to DIR/hosts/ so "
                        "fleet --heartbeat-timeout covers a wedged "
                        "controller")
    p.add_argument("--host-tag", default=None,
                   help="host beat tag (default host<FAA_HOST_ID or 0>)")
    p.add_argument("--stats-file", default=None, metavar="PATH",
                   help="write the loop's final stats JSON to PATH on "
                        "exit (drills read it)")
    return p


def _make_research_fn(args):
    """The stage-two seam: a pre-built candidate (drill mode) or the
    --research-cmd subprocess over a freshly seeded candidate dir."""
    from fast_autoaugment_tpu_torch.control.research import (
        seed_research_dir,
        load_provenance,
        policy_file_digest,
        write_provenance,
    )

    base_dir = args.base_search_dir or os.path.dirname(
        os.path.abspath(args.baseline_policy))
    cand_root = args.candidate_dir or os.path.join(base_dir, "research")
    episode = {"n": 0}

    def _stamp(policy_path: str, verdict: dict, extra: dict) -> dict:
        if load_provenance(policy_path) is None:
            write_provenance(policy_path, {
                "kind": extra.get("kind", "control_candidate"),
                "drift": verdict, **extra})
        prov = load_provenance(policy_path)
        if prov is None:  # sidecar write raced/failed: digest directly
            prov = {"policy_digest": policy_file_digest(policy_path)}
        return prov

    def research(verdict: dict) -> dict:
        episode["n"] += 1
        if args.candidate_policy:
            prov = _stamp(args.candidate_policy, verdict,
                          {"kind": "prebuilt_candidate"})
            return {"policy": args.candidate_policy, "provenance": prov}
        out_dir = os.path.join(cand_root, f"episode{episode['n']}")
        seeded = seed_research_dir(base_dir, out_dir)
        cmd = args.research_cmd.replace("{out}", out_dir) \
                               .replace("{base}", base_dir)
        logger.info("re-search episode %d: %s", episode["n"], cmd)
        proc = subprocess.run(shlex.split(cmd), cwd=os.getcwd(),
                              timeout=args.research_timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"research command exited {proc.returncode}")
        policy_path = os.path.join(out_dir, "final_policy.json")
        if not os.path.exists(policy_path):
            raise RuntimeError(
                f"research command left no {policy_path}")
        prov = _stamp(policy_path, verdict,
                      {"kind": "warm_started_research",
                       "base_dir": os.path.abspath(base_dir),
                       "seeded_files": seeded,
                       "episode": episode["n"]})
        return {"policy": policy_path, "provenance": prov}

    return research


def _beat_loop(stop: threading.Event, beat_dir: str, tag: str,
               interval_s: float) -> None:
    from fast_autoaugment_tpu_torch.serve.serve_cli import _write_beat

    host_dir = os.path.join(beat_dir, "hosts")
    os.makedirs(host_dir, exist_ok=True)
    path = os.path.join(host_dir, f"{tag}.json")
    while not stop.wait(interval_s):
        try:
            _write_beat(path, tag)
        except OSError as e:
            logger.warning("host beat write failed: %s", e)
    try:
        _write_beat(path, tag, done=True)
    except OSError as e:
        logger.warning("final host beat write failed: %s", e)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if bool(args.research_cmd) == bool(args.candidate_policy):
        build_parser().error(
            "give exactly one of --research-cmd / --candidate-policy")
    from fast_autoaugment_tpu_torch.core.telemetry import configure_telemetry
    from fast_autoaugment_tpu_torch.control import (
        CanaryController,
        ControlLoop,
        DriftMonitor,
        PromotionGate,
        ReplicaQualityScraper,
        TrafficSampleReader,
    )
    from fast_autoaugment_tpu_torch.control.research import policy_file_digest
    from fast_autoaugment_tpu_torch.serve.router import discover_replicas

    configure_telemetry(args.telemetry)
    metrics = tuple(m.strip() for m in args.drift_metrics.split(",")
                    if m.strip())
    reader = TrafficSampleReader(args.telemetry, fields=metrics)
    monitor = DriftMonitor(reader.poll, metrics=metrics,
                           baseline_n=args.baseline_samples,
                           cusum_k=args.cusum_k, cusum_h=args.cusum_h)
    canary_ctl = CanaryController(
        lambda: discover_replicas(args.port_dir) or [],
        router_url=args.router_url, timeout_s=args.reload_timeout)
    gate = PromotionGate(gate_polls=args.gate_polls,
                         quality_margin=args.quality_margin,
                         min_arm_dispatches=args.min_arm_dispatches,
                         timeout_polls=args.gate_timeout_polls)
    loop = ControlLoop(
        monitor, _make_research_fn(args), canary_ctl, gate,
        ReplicaQualityScraper(),
        baseline_policy=args.baseline_policy,
        baseline_digest=policy_file_digest(args.baseline_policy),
        n_canary=args.canary_replicas, split_every=args.split_every,
        poll_interval_s=args.poll_interval)
    if args.resume:
        from fast_autoaugment_tpu_torch.control.resume import (
            read_control_events,
            reconstruct_inflight_episode,
        )

        # never replay the pre-crash episode's drifted traffic into a
        # fresh baseline — the WAL (not the sample stream) carries the
        # in-flight state across the crash
        skipped = reader.skip_to_end()
        episode = reconstruct_inflight_episode(
            read_control_events(args.telemetry))
        if episode is not None:
            logger.warning(
                "--resume: dangling %s-stage episode reconstructed "
                "from the journal (%d segment(s) fast-forwarded) — "
                "re-entering", episode["stage"], skipped)
            loop.resume(episode)
        else:
            logger.info("--resume: journal WAL is clean (%d segment(s) "
                        "fast-forwarded) — watching", skipped)
    loop.start()
    logger.info("control loop watching %s (replicas via %s, baseline "
                "%s)", args.telemetry, args.port_dir,
                loop.baseline_digest)

    done = threading.Event()

    def shutdown(signum, frame):
        logger.info("signal %d: stopping control loop", signum)
        done.set()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    if args.heartbeat_dir:
        tag = args.host_tag or f"host{os.environ.get('FAA_HOST_ID', '0')}"
        threading.Thread(target=_beat_loop,
                         args=(done, args.heartbeat_dir, tag, 1.0),
                         daemon=True, name="host-beat").start()
    if args.control_seconds > 0:
        timer = threading.Timer(args.control_seconds, done.set)
        timer.daemon = True
        timer.start()
    while not done.wait(0.25):
        pass
    loop.stop()
    stats = loop.stats()
    if args.stats_file:
        from fast_autoaugment_tpu_torch.control.research import (
            _write_json_atomic,
        )

        _write_json_atomic(args.stats_file, stats)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
