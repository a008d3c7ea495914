"""Training CLI: one ``train_and_eval`` run on the card
(``fast_autoaugment_tpu/launch/train_cli.py``, reference ``train.py:325-356``).

    python -m fast_autoaugment_tpu_torch.launch.train_cli -c confs/wresnet40x2_cifar.yaml \\
        --dataroot /data --save ckpt/wrn.msgpack --tag wrn40x2

Every preset of ``confs/`` runs: the ImageNet ones read JPEG files under
``--dataroot`` (``train/`` and ``val/``, one ``<wnid>/`` folder a class, with
``train_cls.txt``/``val_cls.txt`` listings when present), decoded per batch
by the native loader in a prefetch thread, and each host-fed step is one
CUDA-graph replay; SVHN reads ``{train,extra,test}_32x32.mat``.

``--save`` writes the checkpoint in the JAX package's format and resumes
from it; ``--only-eval`` evaluates a saved checkpoint.  The run is on
``cuda`` unless ``--device cpu`` asks for the CPU (the plain versions of
the kernels); without a GPU it exits non-zero.  The runtime flags
(``--watchdog``, ``--divergence-retries``, ``--compile-cache``,
``--telemetry``, ``--telemetry-port``) and the exit-77 contract are
``search_cli``'s.  The JAX CLI's flags for machinery that is not ported are
refused with the ROADMAP item that ports them; argparse refuses the rest.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

from fast_autoaugment_tpu_torch.core.config import load_config
from fast_autoaugment_tpu_torch.launch.search_cli import (
    UNPORTED_FLAGS,
    add_runtime_flags,
    parse_args,
    require_device,
    run_with_exit_contract,
)
from fast_autoaugment_tpu_torch.train.trainer import HOST_STEPS, train_and_eval
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["build_parser", "main"]

logger = get_logger("faa_torch.train_cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="fast-autoaugment trainer on the card (PyTorch port)",
        epilog="Not ported yet (ROADMAP Queue 1 item): " + ", ".join(
            f"{f} ({i})" for f, i in UNPORTED_FLAGS.items()))
    p.add_argument("-c", "--conf", required=True, help="YAML preset (confs/*.yaml)")
    p.add_argument("--dataroot", default="./data",
                   help=("data folder: CIFAR's pickle batches, SVHN's .mat files, CIFAR-10.1's "
                         ".npy files, or ImageNet's train/ and val/ folders of <wnid>/ JPEG "
                         "folders (with train_cls.txt/val_cls.txt listings when present), "
                         "read from disk and decoded per batch by the native loader"))
    p.add_argument("--save", default="", help="checkpoint path (.msgpack)")
    p.add_argument("--tag", default="", help="also log to train_{tag}.log")
    p.add_argument("--cv-ratio", type=float, default=0.0)
    p.add_argument("--cv", type=int, default=0, help="CV resample index")
    p.add_argument("--only-eval", action="store_true")
    p.add_argument("--evaluation-interval", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--aug-dispatch", default="exact", choices=("exact", "grouped"))
    p.add_argument("--aug-groups", type=int, default=8)
    p.add_argument("--device-cache", default="auto", choices=("auto", "on", "off"),
                   help="device-resident data path: upload the in-memory dataset to the "
                        "card once and gather batches by index INSIDE the dispatch (a CUDA "
                        "graph of the step) - no per-step host image copy.  'auto' (default) "
                        "enables it for in-memory datasets on a single host (the host feed's "
                        "training bit for bit, on the card under deterministic cuDNN); lazy "
                        "ImageNet datasets keep the host feed (a CUDA-graph replay a step, "
                        "batches decoded in a prefetch thread); 'on' errors where auto would "
                        "fall back")
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
    p.add_argument("--ckpt-keep", type=int, default=2,
                   help="restore-chain depth (path, path.prev, ...)")
    p.add_argument("--ckpt-every-dispatch", type=int, default=0,
                   help="checkpoint every M dispatch chunks MID-epoch (device-cache path "
                        "only; resumable bit-identically from the exact dispatch "
                        "boundary).  0 (default) = checkpoint at evaluation epochs only")
    add_runtime_flags(p)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) or cpu (the plain versions of the kernels)")
    p.add_argument("override", nargs="*", help="dotted conf overrides key=value")
    return p


def main(argv=None) -> dict:
    args = parse_args(build_parser(), argv)
    require_device(args.device, "train_cli")
    conf = load_config(args.conf, overrides=args.override)
    if args.tag:
        handler = logging.FileHandler(f"train_{args.tag}.log")
        handler.setFormatter(logger.handlers[0].formatter)
        logger.addHandler(handler)
    if args.only_eval and not args.save:
        raise SystemExit("train_cli: --only-eval requires --save (reference train.py:337)")
    t0 = time.time()
    result = run_with_exit_contract(args, "train_cli", lambda: train_and_eval(
        conf, args.dataroot, test_ratio=args.cv_ratio, cv_fold=args.cv,
        save_path=args.save or None, only_eval=args.only_eval,
        evaluation_interval=args.evaluation_interval, metric="last", seed=args.seed,
        aug_dispatch=args.aug_dispatch, aug_groups=args.aug_groups, ckpt_keep=args.ckpt_keep,
        device_cache=args.device_cache, steps_per_dispatch=args.steps_per_dispatch,
        host_step=args.host_step,
        checkpoint_every_dispatch=args.ckpt_every_dispatch,
        divergence_retries=args.divergence_retries, watchdog=args.watchdog,
        compile_cache=args.compile_cache, device=args.device))
    elapsed = time.time() - t0
    logger.info("done %s: %s", args.tag, json.dumps(
        {k: round(v, 5) if isinstance(v, float) else v for k, v in result.items()}))
    logger.info("elapsed: %.1f s (%.2f h)", elapsed, elapsed / 3600.0)
    return result


if __name__ == "__main__":
    main()
