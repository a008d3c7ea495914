"""The epoch loop ``train_and_eval`` (``fast_autoaugment_tpu/train/trainer.py``),
on the host-fed sequential path.

It keeps the JAX trainer's contract (reference ``train.py:110-322``): build
the data, model, schedule and optimizer from a config; run the epoch loop
with evaluation every ``evaluation_interval`` epochs and at the last; track
the best metric; report progress to a callback (the search's hook,
``train.py:289-303``); and return the reference-shaped result dict
(``{loss,top1,top5}_{train,valid,test}``, ``num_{valid,test}``, ``epoch``,
``best_valid_top1``, ``best_test_top1``, ``elapsed_sec``).

Each batch is uploaded to the device and goes through one
:func:`~fast_autoaugment_tpu_torch.train.steps.make_train_step` call; the
metric sums stay on the device until the epoch ends.  The ImageNet wiring
(``:342-410``: the ImageNet train stack as the step's augment function,
normalization for eval) is here, but ImageNet data is not:
``load_dataset`` raises for it until the lazy loader is ported (ROADMAP
Queue 1 item 11).

Arguments whose machinery is not ported raise and name the ROADMAP item
that ports it: checkpoints (``save_path``, ``only_eval``; item 6), the
device cache and multistep dispatch (``device_cache="on"``,
``steps_per_dispatch > 1``; item 10), the watchdog, the compile cache and
divergence retries (item 12).  The entry point runs on ``cuda`` unless the
caller passes ``device="cpu"`` (the plain versions of the kernels; for
tests).
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.core.metrics import Accumulator
from fast_autoaugment_tpu_torch.data.datasets import cv_split, load_dataset
from fast_autoaugment_tpu_torch.data.pipeline import BatchIterator
from fast_autoaugment_tpu_torch.models import get_model, num_class
from fast_autoaugment_tpu_torch.ops.optim import build_optimizer
from fast_autoaugment_tpu_torch.ops.preprocess_imagenet import imagenet_eval_batch
from fast_autoaugment_tpu_torch.ops.schedules import build_schedule
from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
from fast_autoaugment_tpu_torch.train.steps import (
    create_train_state,
    imagenet_augment_fn,
    make_eval_step,
    make_train_step,
    swapped_weights,
)
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["AUG_ALIASES", "resolve_policy_tensor", "train_and_eval"]

logger = get_logger("faa_torch.train")

# conf-name -> archive-name mapping (reference data.py:91-106)
AUG_ALIASES = {
    "fa_reduced_imagenet": "fa_resnet50_rimagenet",
    "arsaug": "arsaug_policy",
    "autoaug_cifar10": "autoaug_paper_cifar10",
    "autoaug_extend": "autoaug_policy",
}


def resolve_policy_tensor(aug: Any) -> np.ndarray | None:
    """conf['aug'] -> ``[num_sub, num_op, 3]`` float32 policy tensor, or None
    for 'default'.  Accepts an archive name (or its conf alias), or an
    explicit list of sub-policies (the search's decoded candidates)."""
    if aug in (None, "default"):
        return None
    if isinstance(aug, str):
        return policy_to_tensor(load_policy(AUG_ALIASES.get(aug, aug)))
    return policy_to_tensor([list(map(tuple, sub)) for sub in aug])


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def _upload(x: np.ndarray, y: np.ndarray, dev: torch.device):
    return (torch.from_numpy(np.ascontiguousarray(x)).to(dev, non_blocking=True),
            torch.from_numpy(np.asarray(y, np.int64)).to(dev, non_blocking=True))


def _run_eval(eval_step, batches, dev: torch.device) -> dict:
    acc = Accumulator()
    for x, y, m in batches:
        xs, ys = _upload(x, y, dev)
        acc.add_dict(eval_step(xs, ys, torch.from_numpy(m).to(dev)))
    return acc.normalize()


def train_and_eval(conf, dataroot: str, *, test_ratio: float = 0.0, cv_fold: int = 0,
                   reporter: Callable | None = None, metric: str = "last",
                   save_path: str | None = None, only_eval: bool = False,
                   evaluation_interval: int = 5, target_lb: int = -1, seed: int = 0,
                   aug_dispatch: str = "exact", aug_groups: int = 8,
                   device_cache: str = "auto", steps_per_dispatch: int = 1,
                   divergence_retries: int = 0, watchdog="off", heartbeat: Callable | None = None,
                   compile_cache: str = "off", device="cuda", draw_source=None) -> dict:
    """Train one model under `conf` and evaluate it.

    Returns the reference-shaped result dict.  `metric` in {'last', 'train',
    'valid', 'test'} selects what "best" means (reference
    ``train.py:286-303``).  ``aug_dispatch``/``aug_groups`` pick the policy
    sampler ("exact": per image; "grouped": per chunk).  `heartbeat`
    (callable) runs at every epoch boundary.  The model's weights are drawn
    from `seed`, and the augmentation's randomness from the key whose
    words are those of ``jax.random.PRNGKey(seed)``, through `draw_source`
    (the port's Philox draws by default).
    ``device_cache="auto"`` means the host-fed path here, the only one
    ported."""
    if save_path is not None or only_eval:
        _refuse("checkpoints (save_path, only_eval)", "6")
    if device_cache in (True, 1, "on"):
        _refuse("the device-resident dataset cache (device_cache='on')", "10")
    if device_cache not in ("auto", "off", False, None, 0, "0"):
        raise ValueError(f"unknown device-cache mode {device_cache!r}: use auto/on/off")
    if int(steps_per_dispatch) != 1:
        _refuse(f"multistep dispatch (steps_per_dispatch={steps_per_dispatch})", "10")
    if watchdog not in ("off", None, False, 0):
        _refuse("the dispatch watchdog", "12")
    if compile_cache not in ("off", None, ""):
        _refuse("the compile cache", "12")
    if int(divergence_retries) > 0:
        _refuse("divergence retries (they roll back to checkpoints)", "12")
    if metric not in ("last", "train", "valid", "test"):
        raise ValueError(f"unknown metric {metric!r}: use last/train/valid/test")
    dev = resolve_device(device)

    dataset_name = conf["dataset"]
    num_classes = num_class(dataset_name)
    total_train, testset = load_dataset(dataset_name, dataroot)
    if test_ratio > 0.0:
        train_idx, valid_idx = cv_split(total_train.labels, test_ratio, cv_fold)
        if target_lb >= 0:  # single-class restriction (reference data.py:199-201)
            train_idx = train_idx[total_train.labels[train_idx] == target_lb]
            valid_idx = valid_idx[total_train.labels[valid_idx] == target_lb]
    else:
        train_idx, valid_idx = np.arange(len(total_train)), np.array([], np.int64)
    train_it = BatchIterator(total_train, train_idx)
    valid_it = BatchIterator(total_train, valid_idx)
    test_it = BatchIterator(testset)
    if metric == "valid" and len(valid_it) == 0:
        raise ValueError("metric='valid' with an empty validation split (test_ratio=0): "
                         "pass metric='last'/'train'/'test' or a test_ratio > 0")
    if metric == "test" and len(test_it) == 0:
        raise ValueError("metric='test' with an empty test split")

    is_imagenet = dataset_name.endswith("imagenet")
    global_batch = int(conf["batch"])
    if len(train_idx) < global_batch:
        raise ValueError(
            f"training set has {len(train_idx)} examples < batch {global_batch}: every "
            "epoch would be empty (train batches drop the last partial batch, reference "
            "data.py:215)")
    steps_per_epoch = max(1, len(train_idx) // global_batch)
    epochs = int(conf["epoch"])

    model_conf = dict(conf["model"], dataset=dataset_name)
    model_conf.setdefault("precision", conf.get("precision", "f32"))
    model = get_model(model_conf, num_classes, device=dev, seed=seed)
    lr_fn = build_schedule(conf, steps_per_epoch)
    optimizer_conf = conf["optimizer"]
    ema_mu = float(optimizer_conf.get("ema", 0.0) or 0.0)
    optimizer = build_optimizer(optimizer_conf, lr_fn)
    state = create_train_state(model, optimizer, use_ema=ema_mu > 0.0)

    policy = resolve_policy_tensor(conf.get("aug", "default"))
    use_policy = policy is not None
    cutout = int(conf.get("cutout", 0) or 0)
    lb_smooth = float(conf.get("lb_smooth", 0.0) or 0.0)
    if is_imagenet:
        augment_fn = imagenet_augment_fn(cutout, use_policy, aug_dispatch, aug_groups)
        eval_preprocess = imagenet_eval_batch
    else:
        augment_fn, eval_preprocess = None, None
    train_step = make_train_step(
        model, optimizer, num_classes=num_classes,
        mixup_alpha=float(conf.get("mixup", 0.0) or 0.0), lb_smooth=lb_smooth, ema_mu=ema_mu,
        cutout_length=cutout, use_policy=use_policy, augment_fn=augment_fn,
        aug_dispatch=aug_dispatch, aug_groups=aug_groups, draw_source=draw_source)
    eval_step = make_eval_step(model, num_classes=num_classes, lb_smooth=lb_smooth,
                               preprocess_fn=eval_preprocess)
    pol = torch.as_tensor(policy if use_policy else np.zeros((1, 1, 3), np.float32),
                          device=dev)
    key = np.asarray([(int(seed) >> 32) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF],
                     np.uint32)  # the words of jax.random.PRNGKey(seed)
    if draw_source is None:
        key = torch.as_tensor(key.astype(np.int64), device=dev)

    def evaluate() -> dict:
        # empty splits are skipped, not reported as zeros (the reference
        # only evaluates real splits, train.py:272-280)
        out = {}
        for split, it in (("valid", valid_it), ("test", test_it)):
            if len(it) == 0:
                continue
            norm = _run_eval(eval_step, it.eval_epoch(global_batch), dev)
            out[split] = norm
            if state.ema is not None:
                with swapped_weights(model, state.ema):
                    norm_ema = _run_eval(eval_step, it.eval_epoch(global_batch), dev)
                # with EMA on, the reported numbers are the EMA model's
                # (reference train.py:277-280); the raw ones stay under _raw
                out[split + "_raw"], out[split + "_ema"], out[split] = norm, norm_ema, norm_ema
        return out

    result: dict = {"epoch": 0}
    best_metric = -1e9
    t_start = time.time()
    for epoch in range(1, epochs + 1):
        acc = Accumulator()
        for x, y in train_it.train_epoch(global_batch, epoch, seed=seed):
            xs, ys = _upload(x, y, dev)
            state, metrics = train_step(state, xs, ys, pol, key)
            acc.add_dict(metrics)
        if heartbeat is not None:
            heartbeat()
        train_metrics = acc.normalize()
        if not np.isfinite(train_metrics["loss"]):
            raise RuntimeError("loss is NaN — training diverged (reference train.py:259)")
        ema_interval = int(optimizer_conf.get("ema_interval", -1) or -1)
        if state.ema is not None and ema_interval > 0 and epoch % ema_interval == 0:
            logger.info("ema synced into model at epoch %d", epoch)  # train.py:262-270
            with torch.no_grad():
                for k, v in model.state_dict(keep_vars=True).items():
                    if k in state.ema:
                        v.copy_(state.ema[k])
        logger.info("[train %3d/%3d] loss=%.4f top1=%.4f lr=%.5f", epoch, epochs,
                    train_metrics["loss"], train_metrics["top1"], lr_fn(state.step - 1))
        result.update({f"{k}_train": v for k, v in train_metrics.items() if k != "num"})
        result["epoch"] = epoch

        if epoch % evaluation_interval == 0 or epoch == epochs:
            evals = evaluate()
            for split, m in evals.items():
                for k, v in m.items():
                    result[f"{k}_{split}"] = v
                logger.info("[%s %3d/%3d] %s", split, epoch, epochs,
                            {k: round(float(v), 4) for k, v in m.items()})
            if metric == "last":
                cur = float(epoch)
            elif metric == "train":
                cur = train_metrics["top1"]
            else:
                cur = evals.get(metric, {}).get("top1", 0.0)
            if cur >= best_metric:
                best_metric = cur
                result["best_valid_top1"] = evals.get("valid", {}).get("top1", 0.0)
                result["best_test_top1"] = evals.get("test", {}).get("top1", 0.0)
            if reporter is not None:
                reporter(loss_valid=evals.get("valid", {}).get("loss", 0.0),
                         top1_valid=evals.get("valid", {}).get("top1", 0.0),
                         loss_train=train_metrics["loss"], top1_train=train_metrics["top1"],
                         epoch=epoch)
    result["elapsed_sec"] = time.time() - t_start
    return result
