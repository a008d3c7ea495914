"""Policy-search CLI: the three phases on the card
(``fast_autoaugment_tpu/launch/search_cli.py``, reference
``search.py:137-312``).

    python -m fast_autoaugment_tpu_torch.launch.search_cli \\
        -c confs/wresnet40x2_cifar.yaml --dataroot /data --save-dir search_out

Phases 1 and 2 are ``search/driver.py search_policies``; phase 3
(``--until 3``, the default) retrains on the full train set with the
default augmentation and with the found policies (and, with
``--phase3-random``, with the random control set), ``--num-result-per-cv``
runs each, seed-major, each run's model saved to
``{save_dir}/final_{mode}_{run}.msgpack``.  Per-seed ``top1_test`` values,
their mean and spread and the paired t-tests go into
``search_result.json``, which is rewritten after every run.  Rerunning the
same command resumes: complete fold checkpoints are not trained again,
complete trial logs dispatch no trial, and a complete phase-3 run only
evaluates its checkpoint.

``device_hours_total`` is wall time x 1 device (``tpu_hours_total`` is
the same number under the JAX artifact's key); ``backend`` says which
device it was.  The run is on ``cuda`` unless ``--device cpu`` asks for
the CPU (the plain versions of the kernels); without a GPU it exits
non-zero.

Every preset of ``confs/`` runs, the ImageNet ones from JPEG files under
``--dataroot`` (``train/`` and ``val/``, one ``<wnid>/`` folder a class, and
``train_cls.txt``/``val_cls.txt`` listings when present): phase 1 trains on
the host feed, each step one CUDA-graph replay, and phase 2 streams each
fold's held-out crops through the native loader (libjpeg, or nvJPEG on a
host without libjpeg; it raises on the card when neither builds).

The runtime flags are the JAX CLI's: ``--async-pipeline on``
(``--pipeline-actors N``, ``--pipeline-queue-depth D``), ``--watchdog
{off,auto,SECONDS}``, ``--divergence-retries R``, ``--compile-cache DIR``,
``--telemetry DIR`` and ``--telemetry-port P`` (``GET /metrics`` while the
search runs).  A preemption (SIGTERM/SIGUSR1, honoured at the next
dispatch or epoch boundary with a checkpoint) or a hung dispatch exits
:data:`~fast_autoaugment_tpu_torch.core.resilience.PREEMPTED_EXIT_CODE`
(77): rerunning the same command resumes.

The fleet flags are the JAX CLI's too.  ``--workqueue DIR`` (``--lease-ttl``,
``--host-tag``) scatters the folds' phase-1 and phase-2 units and phase 3
across peer hosts through the lease queue of ``launch/workqueue.py``: a dead
host's units are reclaimed and finished by the survivors, and
``search_result.json`` says so (``degraded``, ``lost_hosts``,
``reclaimed_units``).  ``--fleet-transport DIR`` (``--search-role
{auto,learner,actor}``, ``--ckpt-publish-timeout``; or the
``FAA_FLEET_TRANSPORT`` and ``FAA_SEARCH_ROLE`` handoff of
``launch/fleet.py``) runs phase 2 as a learner host publishing TPE rounds
and actor hosts scoring them (``search/pipeline.py FleetTransport``).  Under
either, every host is a single-process job of its own, and the fleet
launcher's ``--coordinator``, ``--num-hosts`` and ``--host-id`` are
accepted (``--host-id`` names the default owner tag ``host<id>``); without
them those three stay refused (ROADMAP Queue 1 item 10c, one job across
hosts).  The JAX CLI's other flags for machinery that is not ported are
refused with the ROADMAP item that ports them; argparse refuses the rest.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Callable

import numpy as np
from torch.profiler import record_function

from fast_autoaugment_tpu_torch.core import telemetry
from fast_autoaugment_tpu_torch.core.config import load_config
from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.core.resilience import (
    PREEMPTED_EXIT_CODE,
    DispatchHungError,
    PreemptedError,
    install_signal_handlers,
)
from fast_autoaugment_tpu_torch.search.driver import (
    search_actor,
    search_policies,
    write_json_atomic,
)
from fast_autoaugment_tpu_torch.train.trainer import HOST_STEPS, train_and_eval
from fast_autoaugment_tpu_torch.utils.logging import get_logger
from fast_autoaugment_tpu_torch.utils.stats import paired_t_test

__all__ = ["build_parser", "main", "parse_args", "random_arm_skip_reason", "require_device",
           "add_runtime_flags", "run_with_exit_contract", "UNPORTED_FLAGS", "RANK_FLAGS"]

logger = get_logger("faa_torch.search_cli")

#: the JAX CLIs' flags for machinery the port does not have yet, by the
#: ROADMAP Queue 1 item that ports it
UNPORTED_FLAGS = {
    "--fold-stack": "10b", "--coordinator": "10c", "--num-hosts": "10c", "--host-id": "10c",
}
#: the fleet launcher's rank suffix: search_cli takes it under --workqueue
#: or a fleet transport (each host its own job), refuses it otherwise
RANK_FLAGS = ("--coordinator", "--num-hosts", "--host-id")


def parse_args(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """`parser`'s arguments; a flag of :data:`UNPORTED_FLAGS` exits with
    the ROADMAP item that ports it, any other unknown argument as argparse
    does."""
    args, rest = parser.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            parser.error(f"{flag} is not ported yet (ROADMAP Queue 1 item "
                         f"{UNPORTED_FLAGS[flag]})")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    return args


def require_device(device: str, prog: str) -> None:
    """Exit non-zero, naming the missing device, when `device` is not there."""
    try:
        resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(f"{prog}: {e}") from None


def _quality_floor_arg(value: str) -> str:
    """``--fold-quality-floor``: 'auto', 'off'/'none', or a finite float."""
    if value.lower() in ("auto", "off", "none"):
        return value.lower()
    try:
        f = float(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected 'auto', 'off' or a float, got {value!r}")
    if not math.isfinite(f):
        raise argparse.ArgumentTypeError(f"expected a finite float, got {value!r}")
    return value


def _watchdog_arg(value: str) -> str:
    """``--watchdog``: 'off', 'auto', or a positive finite deadline in seconds."""
    v = value.lower()
    if v in ("off", "auto"):
        return v
    try:
        f = float(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected 'off', 'auto' or SECONDS, got {value!r}")
    if not math.isfinite(f) or f <= 0:
        raise argparse.ArgumentTypeError(f"expected a positive finite deadline, got {value!r}")
    return value


def add_runtime_flags(p: argparse.ArgumentParser) -> None:
    """The runtime seams' flags of both CLIs (the JAX CLIs' names)."""
    p.add_argument("--divergence-retries", type=int, default=0,
                   help="on a NaN/inf epoch loss, roll back to the newest intact epoch "
                        "checkpoint and replay with retry-folded randomness up to R times "
                        "before raising.  0 (default) = raise at once")
    p.add_argument("--watchdog", default="off", type=_watchdog_arg,
                   help="deadline-guard every dispatch (train dispatches, eval replays, TTA "
                        "and audit evaluations; waits for the device on each): one that "
                        "blows its deadline is HUNG and the run exits 77.  'off' (default), "
                        "'auto' (20 x the label's EMA, at least 10 s) or SECONDS")
    p.add_argument("--compile-cache", default="off", metavar="{off,DIR}",
                   help="build the CUDA kernel libraries into DIR and load them from there: "
                        "a second process on DIR (an exit-77 resume) builds nothing.  Default: "
                        "the inherited FAA_COMPILE_CACHE, else the package's _build directory")
    p.add_argument("--telemetry", default="off", metavar="{off,DIR}",
                   help="flight-recorder journal: typed dispatch/compile/checkpoint/trial/"
                        "phase events as JSONL under DIR.  Default: the inherited "
                        "FAA_TELEMETRY, else off")
    p.add_argument("--telemetry-port", type=int, default=0,
                   help="serve GET /metrics (Prometheus text of the telemetry registry) on "
                        "this port while the run lasts.  0 = off")


def run_with_exit_contract(args, prog: str, run: Callable[[], dict]) -> dict:
    """Run `run` with the preemption handlers installed, the journal armed
    and ``/metrics`` served as `args` ask; a preemption or a hung dispatch
    exits 77 (resume me)."""
    install_signal_handlers()
    telemetry.configure_telemetry(args.telemetry)
    httpd = None
    if args.telemetry_port:
        httpd, _port = telemetry.start_metrics_server(args.telemetry_port)
    try:
        return run()
    except PreemptedError as e:
        logger.warning("preempted (%s) - exiting %d; rerunning the same command resumes", e,
                       PREEMPTED_EXIT_CODE)
        telemetry.emit("preempt", prog, kind="preempted", exit_code=PREEMPTED_EXIT_CODE)
        raise SystemExit(PREEMPTED_EXIT_CODE)
    except DispatchHungError as e:
        logger.error("dispatch HUNG (%s) - exiting %d; the rerun resumes from the newest "
                     "checkpoint link", e, PREEMPTED_EXIT_CODE)
        telemetry.emit("preempt", prog, kind="dispatch_hung", label_detail=e.label,
                       exit_code=PREEMPTED_EXIT_CODE)
        raise SystemExit(PREEMPTED_EXIT_CODE)
    finally:
        telemetry.journal_flush()
        if httpd is not None:
            httpd.shutdown()


def random_arm_skip_reason(result: dict) -> str | None:
    """Why a requested ``--phase3-random`` arm cannot run, or None."""
    if result.get("random_policy_set"):
        return None
    drawn = int(result.get("num_sub_policies_random_drawn") or 0)
    dropped = int(result.get("num_sub_policies_random_dropped") or 0)
    if drawn and dropped >= drawn:
        return f"all {drawn} drawn random sub-policies were dropped by the audit"
    if drawn:
        return f"random set empty after audit ({drawn} drawn, {dropped} recorded dropped)"
    return "no random policy set was drawn (search ended before the random-control step)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="fast-autoaugment policy search on the card (PyTorch port)",
        epilog="Not ported yet (ROADMAP Queue 1 item): " + ", ".join(
            f"{f} ({i})" for f, i in UNPORTED_FLAGS.items()
            if f not in RANK_FLAGS) + "; " + ", ".join(RANK_FLAGS)
        + " without --workqueue or a fleet transport (10c)")
    p.add_argument("-c", "--conf", required=True)
    p.add_argument("--dataroot", default="./data",
                   help=("data folder: CIFAR's pickle batches, SVHN's .mat files, CIFAR-10.1's "
                         ".npy files, or ImageNet's train/ and val/ folders of <wnid>/ JPEG "
                         "folders (with train_cls.txt/val_cls.txt listings when present), "
                         "read from disk and decoded per batch by the native loader"))
    p.add_argument("--save-dir", default="search_out")
    p.add_argument("--num-fold", type=int, default=5, help="K (reference cv_num=5)")
    p.add_argument("--cv-ratio", type=float, default=0.4)
    p.add_argument("--num-policy", type=int, default=5)
    p.add_argument("--num-op", type=int, default=2)
    p.add_argument("--num-search", type=int, default=200)
    p.add_argument("--topup-trials", type=int, default=0,
                   help="extend a finished --save-dir's per-fold trial budget by this many "
                        "trials (resume replays the trial log, only the top-up dispatches)")
    p.add_argument("--num-top", type=int, default=10)
    p.add_argument("--trial-batch", type=int, default=1,
                   help="K TPE trials per round, evaluated in one pass per batch "
                        "(constant-liar proposals); 1 = the sequential loop")
    p.add_argument("--async-pipeline", default="off", choices=("off", "on"),
                   help="phase 2 as the actor/learner pipeline (actor threads evaluate "
                        "ready-built rounds while the TPE learner proposes; results apply in "
                        "trial-id order) with phase-1 training overlapped on a trainer "
                        "thread.  The trial log is the serial one for the same window; 'on' "
                        "with --pipeline-actors 1 --pipeline-queue-depth 0 is the serial "
                        "trial log bit for bit")
    p.add_argument("--pipeline-actors", type=int, default=1,
                   help="actor threads per fold under --async-pipeline on")
    p.add_argument("--pipeline-queue-depth", type=int, default=1,
                   help="rounds proposed ahead of the actors (the window is actors + depth "
                        "rounds; pending rounds enter the posterior as constant liars)")
    p.add_argument("--aug-dispatch", default="exact", choices=("exact", "grouped"),
                   help="policy sampling for phase-2 TTA, the audit and phase-3 retrains: "
                        "per image (exact) or per chunk of --aug-groups (grouped)")
    p.add_argument("--aug-groups", type=int, default=8)
    p.add_argument("--device-cache", default="auto", choices=("auto", "on", "off"),
                   help="device-resident data path for phase-1 fold pretraining, gate "
                        "retrains and phase-3 retrains: upload the in-memory dataset once, "
                        "gather batches by index inside the dispatch (a CUDA graph of the "
                        "step on the card).  'auto' (default) = on for in-memory single-host "
                        "datasets, the host feed's training bit for bit (on the card under "
                        "deterministic cuDNN); 'on' errors where auto would fall back")
    p.add_argument("--host-step", default="graph", choices=HOST_STEPS,
                   help="the host feed's train step (--device-cache off, and every lazy "
                        "dataset): 'graph' (default) replays one CUDA graph of the step on "
                        "the card, 'eager' runs it eagerly, the reference the graph equals "
                        "bit for bit under deterministic cuDNN (the CPU always runs it "
                        "eagerly)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="N train steps per dispatch over the device cache (needs "
                        "--device-cache auto/on): one upload of N index rows, then N replays "
                        "of the step's CUDA graph on the card.  1 (default) = one dispatch "
                        "per step; N > 1 uploads less often, the same training bit for bit")
    p.add_argument("--num-result-per-cv", type=int, default=5,
                   help="phase-3 retrains per mode (reference search.py:270)")
    p.add_argument("--until", type=int, default=3, help="run phases up to this number (1-3)")
    p.add_argument("--folds", default=None, help="comma-separated fold subset")
    p.add_argument("--smoke-test", action="store_true")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fold-quality-floor", default="auto", type=_quality_floor_arg,
                   help="fold-oracle gate: 'auto' (default) = chance + 0.35 * (1 - chance), "
                        "a float, or 'off'")
    p.add_argument("--fold-retrain-tries", type=int, default=2)
    p.add_argument("--phase1-epochs", type=int, default=None,
                   help="override conf['epoch'] for phase-1 fold pretraining")
    p.add_argument("--phase3-random", action="store_true",
                   help="add the random-policy control arm to phase 3")
    p.add_argument("--ckpt-keep", type=int, default=2,
                   help="restore-chain depth of every checkpoint the search writes")
    p.add_argument("--ckpt-every-dispatch", type=int, default=0,
                   help="mid-epoch snapshot every M dispatch chunks in phase-3 retrains "
                        "(device-cache path; bit-identical dispatch-boundary resume).  "
                        "0 = off")
    p.add_argument("--audit-floor", type=float, default=0.95,
                   help="drop selected sub-policies whose own mean-over-draws fold accuracy "
                        "is below floor x baseline (<= 0 turns the audit off)")
    add_runtime_flags(p)
    p.add_argument("--fleet-transport", default=None, metavar="DIR",
                   help="fleet search: the async pipeline's candidate queue as a round "
                        "transport under DIR (a directory every host mounts).  The LEARNER "
                        "host trains the phase-1 folds, publishes each gate-cleared "
                        "checkpoint and the TPE rounds as leased work units; ACTOR hosts "
                        "claim rounds, run the TTA evaluations and post the rewards back.  "
                        "The fleet gives the single-host --async-pipeline artifacts bit for "
                        "bit with the same flags; a dead actor's rounds are reclaimed "
                        "through the lease TTL.  Default: the inherited FAA_FLEET_TRANSPORT "
                        "(the fleet launcher's --fleet-transport); 'off' or unset = one host")
    p.add_argument("--search-role", default="auto", choices=("auto", "learner", "actor"),
                   help="this host's role in a --fleet-transport search: 'auto' (default) "
                        "reads FAA_SEARCH_ROLE (the fleet launcher's --roles) and falls back "
                        "to 'learner'; 'actor' trains nothing and runs no TPE: it serves "
                        "published rounds until the learner marks the search done, then "
                        "exits 0")
    p.add_argument("--ckpt-publish-timeout", type=float, default=900.0,
                   help="actor hosts: seconds to wait for a claimed round's fold checkpoint "
                        "to be published (and its digest to match here) before exiting")
    p.add_argument("--workqueue", default=None, metavar="DIR",
                   help="elastic multi-host scatter: claim phase-1 fold trainings, per-fold "
                        "phase-2 searches and phase 3 off a lease queue under DIR (a "
                        "directory every host mounts), renewing leases at dispatch and trial "
                        "boundaries and RECLAIMING units whose lease went stale: a dead "
                        "host's fold is finished by a survivor, and search_result.json stamps "
                        "degraded/lost_hosts/reclaimed_units")
    p.add_argument("--lease-ttl", type=float, default=60.0,
                   help="seconds a lease must be seen unchanged before survivors may reclaim "
                        "its unit (must dominate the longest gap between renewals)")
    p.add_argument("--host-tag", default=None,
                   help="this host's stable owner id in the --workqueue or the transport "
                        "(default: host<--host-id> under the fleet launcher, else host<pid>); "
                        "a relaunch REUSES its predecessor's tag and resumes its own leases "
                        "at once")
    # the fleet launcher's rank suffix (accepted under --workqueue or a fleet
    # transport: --host-id names the default --host-tag)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--num-hosts", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--host-id", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) or cpu (the plain versions of the kernels)")
    p.add_argument("override", nargs="*", help="dotted conf overrides key=value")
    return p


def _transport_spec(args) -> str:
    """The round-transport directory: ``--fleet-transport``, else the
    ``FAA_FLEET_TRANSPORT`` handoff; '' when off."""
    from fast_autoaugment_tpu_torch.search.pipeline import FLEET_TRANSPORT_ENV_VAR

    spec = (args.fleet_transport or "").strip()
    if spec.lower() in ("", "off"):
        spec = os.environ.get(FLEET_TRANSPORT_ENV_VAR, "").strip()
    return "" if spec.lower() in ("", "off") else spec


def _check_rank_args(parser: argparse.ArgumentParser, args) -> None:
    """The rank suffix is the fleet launcher's: each host of a work queue or
    a round transport is its own job, so it only names the host there.  One
    job across hosts is item 10c."""
    if args.workqueue or _transport_spec(args):
        return
    for flag in RANK_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            parser.error(f"{flag} is not ported yet (ROADMAP Queue 1 item "
                         f"{UNPORTED_FLAGS[flag]})")


def _owner_tag(args) -> str:
    """Stable owner id for lease-holding layers: --host-tag, then
    host<--host-id> (the fleet launcher's per-host identity — a relaunch
    reclaims its own leases immediately), then host<pid>."""
    return args.host_tag or (f"host{args.host_id}" if args.host_id is not None
                             else f"host{os.getpid()}")


def _build_workqueue(args):
    """The shared lease queue (or None)."""
    if not args.workqueue:
        return None
    from fast_autoaugment_tpu_torch.launch.workqueue import WorkQueue

    tag = _owner_tag(args)
    wq = WorkQueue(args.workqueue, tag, lease_ttl=args.lease_ttl)
    logger.info("workqueue: owner=%s root=%s lease_ttl=%.1fs", tag, args.workqueue,
                args.lease_ttl)
    return wq


def _resolve_fleet_transport(args):
    """``(transport, role)``: the cross-host round transport (or None) and
    this host's resolved role.  The directory falls back to the
    FAA_FLEET_TRANSPORT handoff (the fleet launcher exports it to every host
    launch and retry)."""
    from fast_autoaugment_tpu_torch.search.pipeline import FleetTransport, resolve_search_role

    role = resolve_search_role(args.search_role)
    spec = _transport_spec(args)
    if not spec:
        if role == "actor":
            raise SystemExit("search_cli: --search-role actor needs a --fleet-transport DIR "
                             "(or the FAA_FLEET_TRANSPORT handoff) - an actor host without a "
                             "transport has nothing to serve")
        return None, role
    if args.workqueue:
        raise SystemExit("search_cli: --fleet-transport and --workqueue are mutually exclusive "
                         "(rounds-over-hosts vs folds-over-hosts)")
    transport = FleetTransport(spec, _owner_tag(args), lease_ttl=args.lease_ttl, role=role)
    logger.info("fleet transport: role=%s owner=%s root=%s lease_ttl=%.1fs", role,
                transport.owner, spec, args.lease_ttl)
    return transport, role


def _run_actor(args, conf, transport, draw_source) -> dict:
    """The --search-role actor main path: serve published rounds until the
    learner marks the search done; write no search artifacts."""
    stats = search_actor(
        conf, dataroot=args.dataroot, save_dir=args.save_dir, fleet_transport=transport,
        cv_num=args.num_fold, cv_ratio=args.cv_ratio, num_policy=args.num_policy,
        num_op=args.num_op, trial_batch=args.trial_batch, seed=args.seed,
        aug_dispatch=args.aug_dispatch, aug_groups=args.aug_groups, watchdog=args.watchdog,
        compile_cache=args.compile_cache, telemetry_spec=args.telemetry,
        ckpt_timeout=args.ckpt_publish_timeout, device=args.device, draw_source=draw_source)
    transport.mark_host_done({"rounds_ok": stats["rounds_ok"],
                              "rounds_err": stats["rounds_err"]})
    return stats


def main(argv=None, *, draw_source=None) -> dict:
    """Run the CLI; returns the result dict that ``search_result.json``
    holds (with the policy sets).  `draw_source` replaces the port's Philox
    draws (tests replay the JAX key tree with it)."""
    parser = build_parser()
    args = parse_args(parser, argv)
    _check_rank_args(parser, args)
    require_device(args.device, "search_cli")
    conf = load_config(args.conf, overrides=args.override)
    return run_with_exit_contract(args, "search_cli", lambda: _run(args, conf, draw_source))


def _run(args, conf, draw_source) -> dict:
    t_start = time.time()
    transport, role = _resolve_fleet_transport(args)
    if role == "actor":
        return _run_actor(args, conf, transport, draw_source)
    work_queue = _build_workqueue(args)
    result = search_policies(
        conf, dataroot=args.dataroot, save_dir=args.save_dir, cv_num=args.num_fold,
        cv_ratio=args.cv_ratio, num_policy=args.num_policy, num_op=args.num_op,
        num_search=args.num_search, num_top=args.num_top, smoke_test=args.smoke_test,
        resume=not args.no_resume, until=args.until,
        folds=[int(f) for f in args.folds.split(",")] if args.folds else None,
        seed=args.seed, fold_quality_floor=args.fold_quality_floor,
        fold_retrain_tries=args.fold_retrain_tries, phase1_epochs=args.phase1_epochs,
        audit_floor=args.audit_floor if args.audit_floor > 0 else None,
        random_control=args.phase3_random, trial_batch=args.trial_batch,
        aug_dispatch=args.aug_dispatch, aug_groups=args.aug_groups, ckpt_keep=args.ckpt_keep,
        device_cache=args.device_cache, steps_per_dispatch=args.steps_per_dispatch,
        host_step=args.host_step,
        topup_trials=args.topup_trials, divergence_retries=args.divergence_retries,
        watchdog=args.watchdog, compile_cache=args.compile_cache,
        async_pipeline=args.async_pipeline, pipeline_actors=args.pipeline_actors,
        pipeline_queue_depth=args.pipeline_queue_depth, telemetry_spec=args.telemetry,
        work_queue=work_queue, fleet_transport=transport, device=args.device,
        draw_source=draw_source)
    final_policy_set = result["final_policy_set"]
    random_policy_set = result.get("random_policy_set") or []
    logger.info("final policy set: %d sub-policies", len(final_policy_set))
    if args.phase3_random:
        skip_reason = random_arm_skip_reason(result)
        if skip_reason is not None:
            logger.warning("--phase3-random was requested but the RANDOM CONTROL ARM WILL NOT "
                           "RUN: %s; phase 3 compares default and augment only", skip_reason)
            result["random_arm_skipped"] = True
            result["random_arm_skip_reason"] = skip_reason

    def persist() -> dict:
        """(Re)write search_result.json: after every phase-3 run, so a killed
        process still leaves the per-seed values to date."""
        hours = (time.time() - t_start) / 3600.0  # one device
        result["device_hours_total"] = hours
        result["tpu_hours_total"] = hours  # the JAX artifact's key; `backend` says the device
        write_json_atomic(os.path.join(args.save_dir, "search_result.json"),
                          {k: v for k, v in result.items()
                           if k not in ("final_policy_set", "random_policy_set")})
        return result

    if args.until < 3 or not final_policy_set:
        if work_queue is not None:
            work_queue.mark_host_done()
        if transport is not None:
            transport.mark_host_done()
        return persist()

    phase3_hb = None
    if transport is not None:
        # the learner retrains alone (the actors drained on search_done),
        # but its host beat must stay fresh for the fleet's wedge detector
        phase3_hb = transport.beat
    if work_queue is not None:
        # phase 3 is one unit: exactly one host runs the retrains (a stale
        # lease lets a survivor reclaim them; per-run checkpoints make the
        # rerun resume)
        if not work_queue.claim("phase3"):
            logger.info("workqueue: phase 3 is owned elsewhere (or done) - this host is "
                        "finished; the owner persists the final result")
            work_queue.mark_host_done()
            return persist()

        def phase3_hb():
            work_queue.renew("phase3")
            work_queue.beat_host()

    # phase 3: full retrains, default vs augmented (search.py:264-312), plus
    # the random arm; runs pair by seed (the same data and init), so the
    # per-seed values carry paired t-tests
    num_runs = 1 if args.smoke_test else args.num_result_per_cv
    seeds = [args.seed + run for run in range(num_runs)]
    modes = [("default", "default"), ("augment", final_policy_set)]
    if args.phase3_random and random_policy_set:
        modes.append(("random", random_policy_set))
    outcomes: dict[str, list[float]] = {name: [] for name, _ in modes}
    phase3: dict = {"num_runs": num_runs, "seeds": seeds}
    result["phase3"] = phase3

    def update_stats():
        for name, _aug in modes:
            vals = outcomes[name]
            if vals:
                phase3[name] = {"per_seed": vals, "mean": float(np.mean(vals)),
                                "std": float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0}
        for a, b in (("augment", "default"), ("augment", "random"), ("random", "default")):
            n = min(len(outcomes.get(a, [])), len(outcomes.get(b, [])))
            if n > 1:
                phase3[f"paired_{a}_minus_{b}"] = paired_t_test(outcomes[a][:n],
                                                                outcomes[b][:n])
        if outcomes["default"]:
            result["top1_test_default_mean"] = float(np.mean(outcomes["default"]))
        if outcomes["augment"]:
            result["top1_test_augment_mean"] = float(np.mean(outcomes["augment"]))

    # seed-major: every completed seed adds one paired observation to all arms
    with record_function("search.phase3"):
        for run in range(num_runs):
            for mode, aug in modes:
                res = train_and_eval(
                    conf.replace(aug=aug), args.dataroot, test_ratio=0.0,
                    save_path=os.path.join(args.save_dir, f"final_{mode}_{run}.msgpack"),
                    metric="last", seed=seeds[run], aug_dispatch=args.aug_dispatch,
                    aug_groups=args.aug_groups, ckpt_keep=args.ckpt_keep,
                    device_cache=args.device_cache, steps_per_dispatch=args.steps_per_dispatch,
                    host_step=args.host_step,
                    checkpoint_every_dispatch=args.ckpt_every_dispatch,
                    divergence_retries=args.divergence_retries, watchdog=args.watchdog,
                    heartbeat=phase3_hb, compile_cache=args.compile_cache, device=args.device,
                    draw_source=draw_source)
                outcomes[mode].append(float(res.get("top1_test", 0.0)))
                logger.info("phase3 %s run %d: top1_test=%.4f", mode, run, outcomes[mode][-1])
                update_stats()
                persist()
    summary = " vs ".join("%s %.4f+-%.4f" % (name, phase3[name]["mean"], phase3[name]["std"])
                          for name, _ in modes if name in phase3)
    logger.info("phase3 (n=%d): %s", num_runs, summary)
    if work_queue is not None:
        work_queue.release("phase3", info={"num_runs": num_runs})
        work_queue.mark_host_done()
    if transport is not None:
        transport.mark_host_done()
    persist()
    logger.info("search complete: %.3f device-hours on %s (%s)", result["device_hours_total"],
                result["backend"], result["device_kind"])
    return result


if __name__ == "__main__":
    main()
