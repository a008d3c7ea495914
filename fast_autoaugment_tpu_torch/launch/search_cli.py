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
non-zero.  The JAX CLI's flags for machinery that is not ported are
refused with the ROADMAP item that ports them; argparse refuses the rest.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
from torch.profiler import record_function

from fast_autoaugment_tpu_torch.core.config import load_config
from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.search.driver import search_policies, write_json_atomic
from fast_autoaugment_tpu_torch.train.trainer import train_and_eval
from fast_autoaugment_tpu_torch.utils.logging import get_logger
from fast_autoaugment_tpu_torch.utils.stats import paired_t_test

__all__ = ["build_parser", "main", "parse_args", "random_arm_skip_reason", "require_device",
           "UNPORTED_FLAGS"]

logger = get_logger("faa_torch.search_cli")

#: the JAX CLIs' flags for machinery the port does not have yet, by the
#: ROADMAP Queue 1 item that ports it
UNPORTED_FLAGS = {
    "--fold-stack": "10", "--device-cache": "10", "--steps-per-dispatch": "10",
    "--ckpt-every-dispatch": "10", "--coordinator": "10", "--num-hosts": "10",
    "--host-id": "10",
    "--async-pipeline": "12", "--pipeline-actors": "12", "--pipeline-queue-depth": "12",
    "--divergence-retries": "12", "--watchdog": "12", "--compile-cache": "12",
    "--telemetry": "12", "--telemetry-port": "12",
    "--fleet-transport": "13", "--search-role": "13", "--ckpt-publish-timeout": "13",
    "--workqueue": "13", "--lease-ttl": "13", "--host-tag": "13",
}


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
            f"{f} ({i})" for f, i in UNPORTED_FLAGS.items()))
    p.add_argument("-c", "--conf", required=True)
    p.add_argument("--dataroot", default="./data")
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
    p.add_argument("--aug-dispatch", default="exact", choices=("exact", "grouped"),
                   help="policy sampling for phase-2 TTA, the audit and phase-3 retrains: "
                        "per image (exact) or per chunk of --aug-groups (grouped)")
    p.add_argument("--aug-groups", type=int, default=8)
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
    p.add_argument("--audit-floor", type=float, default=0.95,
                   help="drop selected sub-policies whose own mean-over-draws fold accuracy "
                        "is below floor x baseline (<= 0 turns the audit off)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) or cpu (the plain versions of the kernels)")
    p.add_argument("override", nargs="*", help="dotted conf overrides key=value")
    return p


def main(argv=None, *, draw_source=None) -> dict:
    """Run the CLI; returns the result dict that ``search_result.json``
    holds (with the policy sets).  `draw_source` replaces the port's Philox
    draws (tests replay the JAX key tree with it)."""
    args = parse_args(build_parser(), argv)
    require_device(args.device, "search_cli")
    conf = load_config(args.conf, overrides=args.override)
    t_start = time.time()
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
        topup_trials=args.topup_trials, device=args.device, draw_source=draw_source)
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
        return persist()

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
                    aug_groups=args.aug_groups, ckpt_keep=args.ckpt_keep, device=args.device,
                    draw_source=draw_source)
                outcomes[mode].append(float(res.get("top1_test", 0.0)))
                logger.info("phase3 %s run %d: top1_test=%.4f", mode, run, outcomes[mode][-1])
                update_stats()
                persist()
    summary = " vs ".join("%s %.4f+-%.4f" % (name, phase3[name]["mean"], phase3[name]["std"])
                          for name, _ in modes if name in phase3)
    logger.info("phase3 (n=%d): %s", num_runs, summary)
    persist()
    logger.info("search complete: %.3f device-hours on %s (%s)", result["device_hours_total"],
                result["backend"], result["device_kind"])
    return result


if __name__ == "__main__":
    main()
