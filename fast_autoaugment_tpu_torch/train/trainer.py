"""The epoch loop ``train_and_eval`` (``fast_autoaugment_tpu/train/trainer.py``),
on the sequential path, device-resident or host-fed.

It keeps the JAX trainer's contract (reference ``train.py:110-322``): build
the data, model, schedule and optimizer from a config; run the epoch loop
with evaluation every ``evaluation_interval`` epochs and at the last; track
the best metric; report progress to a callback (the search's hook,
``train.py:289-303``); and return the reference-shaped result dict
(``{loss,top1,top5}_{train,valid,test}``, ``num_{valid,test}``, ``epoch``,
``best_valid_top1``, ``best_test_top1``, ``elapsed_sec``).

Two data paths, as in the JAX package (``:367-375``, ``:601-760``):

- the device cache (``device_cache="auto"``, the default, for every
  in-memory dataset; ``"on"`` raises where it cannot serve):
  the train set is put on the device once (``data/pipeline.py
  DeviceCache``); each epoch uploads only its :func:`train_index_matrix`
  (the host path's shuffle), cut by :func:`split_dispatch_chunks` into
  dispatches of ``steps_per_dispatch`` (N) steps and one remainder, each a
  :func:`~fast_autoaugment_tpu_torch.train.steps.make_multistep_train_step`
  call: on the card one upload and a CUDA-graph replay a step (one graph
  of a single step per run), on the CPU a loop of N steps, which is how
  the tests run it.  The train metrics add up on the device in one
  float32 chain over the epoch and are read once at its end;
- the host feed (``device_cache="off"``, and every lazy dataset): the
  epoch's batches are made (for a lazy dataset, decoded) in a prefetch
  worker thread that stages each into pinned host memory
  (``data/pipeline.py prefetch``, ``stage_batch``; JAX ``:733-745``), and each
  is one :func:`~fast_autoaugment_tpu_torch.train.steps.make_graphed_train_step`
  call: on the card one copy into the captured graph's static buffers and
  one replay, on the CPU the eager step; the metric sums stay on the device
  until the epoch ends.  ``host_step="eager"`` runs the eager step on the
  card too: the reference that the graph is held to.

The state, the metrics and the result are those of the host feed at every
N, bit for bit on the CPU, and on the card under deterministic cuDNN
(``torch.backends.cudnn.deterministic``; the graph is captured under it
whatever the caller's flags).  An in-memory split is put on the device at
its first evaluation and summed there (``make_replay_eval_step``,
``:135-175``); a lazy split is evaluated as a stream, batch by batch through
the prefetch worker (JAX ``_run_eval``, ``:118-131``), so ImageNet's val set
is never held on the card.

The ImageNet wiring (``:342-410``): the image side is ``conf["imgsize"]`` or
the model's input size; a lazy split is decoded with
``random_crop_box`` boxes for training and ``center_crop_box`` boxes for
evaluation (``ops/preprocess_imagenet.py``), by the native loader on the
card (``decoder="native"``: it raises where it cannot be built, nothing
drops to PIL) and as ``"auto"`` picks on the CPU; the ImageNet train stack
is the step's augment function and normalization the eval's.  The result of
a lazy run has ``loader``: the decoder, the images decoded, those that
failed (zero-filled) and the seconds spent decoding.

Checkpoints (``:447-522``, ``:836-850``): with ``save_path`` the state is
saved at each new best metric in the JAX package's format
(``core/checkpoint.py``, with ``epoch``, ``step`` and ``metrics`` in the
sidecar and a restore chain of ``ckpt_keep`` links), and the scalar logs
``{save_path}_{train,valid,test}.jsonl`` are written beside it.  On the
cache path ``checkpoint_every_dispatch`` (M) also saves every M dispatches
mid-epoch, with the JAX ``in_epoch`` record (epoch, dispatch position,
the metric sums so far).  A run resumes from the newest intact link: at
the epoch after it, or, on the cache path, at the dispatch position of an
``in_epoch`` link (the host feed and an inconsistent record walk back to an
epoch-boundary link, ``:466-497``); a run whose link is at the last epoch
turns into an evaluation (``only_eval``).  A checkpoint with the reference
importer's ``imported_from`` record (weights, BatchNorm statistics, maybe
an EMA; no optimizer state) resumes leniently, as in the JAX trainer
(``:466-510``): its fields over a fresh state, the step at the resume
epoch, the EMA seeded from the imported weights when the file has none.

The runtime seams, as in the JAX trainer (``:158-215``, ``:618-877``):

- every train dispatch, host-fed step and eval replay goes through
  :func:`_monitored_dispatch`: the dispatch guard of the search pipeline,
  the telemetry span seam, and the watchdog when ``watchdog`` is ``auto``
  or seconds (``core/watchdog.py``; a fired deadline raises
  ``DispatchHungError``); the ``hang``/``slow`` fault verbs are consulted
  there;
- preemption: SIGTERM/SIGUSR1 set a flag (``core/resilience.py``) that the
  loop reads at every dispatch boundary of the cache path (a mid-epoch
  ``in_epoch`` link with ``preempted: true``) and at every epoch boundary
  (an epoch link with ``preempted: true``), then raises
  ``PreemptedError``; the resume is bitwise the uninterrupted run;
- ``divergence_retries`` R: a non-finite epoch loss rolls back to the
  newest intact epoch-boundary link and replays with retry-folded
  randomness (the step key ``fold_in(key, 1_000_003 * r)``, the shuffle
  seed ``seed + 1_000_003 * r``) up to R times; with r = 0 every draw is
  the run's own; the result records the retries taken
  (``divergence_retries_used``);
- ``compile_cache`` points the kernels' build at a directory
  (``core/compilecache.py``).

The entry point runs on ``cuda`` unless the caller passes ``device="cpu"``
(the plain versions of the kernels; for tests).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from fast_autoaugment_tpu_torch.core import telemetry
from fast_autoaugment_tpu_torch.core.checkpoint import (
    lenient_merge,
    load_checkpoint_chain,
    save_checkpoint,
)
from fast_autoaugment_tpu_torch.core.compilecache import configure_compile_cache
from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.core.metrics import Accumulator
from fast_autoaugment_tpu_torch.core.resilience import (
    PREEMPTED_EXIT_CODE,
    PreemptedError,
    install_signal_handlers,
    preemption_requested,
)
from fast_autoaugment_tpu_torch.core.watchdog import dispatch_enqueue_guard, resolve_watchdog
from fast_autoaugment_tpu_torch.data.datasets import cv_split, load_dataset
from fast_autoaugment_tpu_torch.data.pipeline import (
    BatchIterator,
    DecodeStats,
    DeviceCache,
    prefetch,
    resolve_device_cache,
    split_dispatch_chunks,
    stage_batch,
    train_index_matrix,
)
from fast_autoaugment_tpu_torch.models import get_model, input_image_size, num_class
from fast_autoaugment_tpu_torch.ops.optim import build_optimizer, ema_tensors
from fast_autoaugment_tpu_torch.ops.preprocess_imagenet import (
    center_crop_box,
    imagenet_eval_batch,
    random_crop_box,
)
from fast_autoaugment_tpu_torch.ops.schedules import build_schedule
from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws, prng_key
from fast_autoaugment_tpu_torch.train.steps import (
    METRIC_KEYS,
    create_train_state,
    imagenet_augment_fn,
    make_eval_step,
    make_graphed_train_step,
    make_multistep_train_step,
    make_replay_eval_step,
    make_train_step,
    make_train_step_body,
    swapped_weights,
)
from fast_autoaugment_tpu_torch.utils import faultinject
from fast_autoaugment_tpu_torch.utils.interop import load_flax_train_state, train_state_to_flax
from fast_autoaugment_tpu_torch.utils.logging import get_logger, make_writers

__all__ = ["AUG_ALIASES", "HOST_STEPS", "resolve_policy_tensor", "train_and_eval"]

logger = get_logger("faa_torch.train")

#: the host feed's train step: a CUDA-graph replay on the card, or eager
HOST_STEPS = ("graph", "eager")

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


@torch.no_grad()
def _imported_fixups(state, meta: dict, step: int) -> None:
    """A run resumed from an imported checkpoint (JAX ``train/trainer.py:
    496-507``): the step placed at the resume epoch, so the schedule goes on
    from its tail, not back at warmup; without an EMA in the file, the
    shadow seeded from the imported weights, never from random init."""
    state.step = int(step)
    if state.ema is not None and not meta.get("has_ema"):
        for name, t in ema_tensors(state.model).items():
            state.ema[name].copy_(t)


def _stacked_eval_splits(it: BatchIterator, batch: int, dev: torch.device) -> list:
    """One eval epoch as device-resident stacks grouped by shape
    (``{"x": [S, B, H, W, C], "y": [S, B], "m": [S, B]}``; a padded last
    batch of another size is a second group), placed once and reused by
    every evaluation."""
    groups: dict = {}
    for x, y, m in it.eval_epoch(batch):
        groups.setdefault(x.shape, []).append((x, y, m))
    return [{"x": torch.as_tensor(np.stack([x for x, _, _ in g]), device=dev),
             "y": torch.as_tensor(np.stack([np.asarray(y, np.int64) for _, y, _ in g]),
                                  device=dev),
             "m": torch.as_tensor(np.stack([m for _, _, m in g]), device=dev)}
            for g in groups.values()]


def _monitored_dispatch(wd, label: str, fi, step: int, fn, *args):
    """One dispatch through the watchdog and the telemetry span seam (JAX
    ``train/trainer.py:180-215``).  With the watchdog off and no injected
    ``hang``/``slow`` fault it is the direct call under the dispatch guard,
    with no wait (the span times the enqueue); otherwise it runs
    deadline-guarded and waits for the device (``core/watchdog.py``)."""
    inject = fi.dispatch_delay(step) if fi is not None else None
    if inject is None and not wd.enabled:
        t0 = telemetry.mono()
        with dispatch_enqueue_guard():
            out = fn(*args)
        telemetry.record_dispatch(label, t0, telemetry.mono(), step=step, blocking=False)
        return out
    delay = 0.0
    if inject is not None:
        kind, val = inject
        # slow = a straggler at F x the label's EMA (F seconds before any
        # observation); hang = forever
        delay = val if kind == "hang" else val * (wd.ema(label) or 1.0)
    t0 = telemetry.mono()
    out = wd.run(label, fn, *args, inject_delay=delay)
    telemetry.record_dispatch(label, t0, telemetry.mono(), step=step, blocking=True)
    return out


def _run_eval(eval_step, groups: list, wd, step: int) -> dict:
    """One device-summed pass per shape group, each a watched dispatch
    (label ``replay_eval``); the groups' sums chain on the device in float32
    and are read once."""
    acc = Accumulator()
    for g in groups:
        acc.add_dict(_monitored_dispatch(wd, "replay_eval", None, step, eval_step,
                                         g["x"], g["y"], g["m"]))
    return acc.normalize()


def _stream_eval(eval_step, it: BatchIterator, batch: int, dev: torch.device, wd,
                 step: int) -> dict:
    """A lazy split evaluated batch by batch: each decoded and staged in the
    prefetch worker, copied to the device and summed there by one watched
    dispatch (label ``eval``); the sums are read once."""
    acc = Accumulator()
    for x, y, m in prefetch(it.eval_epoch(batch),
                            transform=functools.partial(stage_batch, device=dev)):
        acc.add_dict(_monitored_dispatch(wd, "eval", None, step, eval_step,
                                         x.to(dev, non_blocking=True),
                                         y.to(dev, non_blocking=True),
                                         m.to(dev, non_blocking=True)))
    return acc.normalize()


def _save_in_epoch(save_path, state, optimizer, sums, *, epoch, pos, steps_per_epoch,
                   retries, ckpt_keep) -> None:
    """A mid-epoch link at dispatch position `pos` (JAX ``:700-725``)."""
    read = dict(zip(METRIC_KEYS, sums.tolist()))
    save_checkpoint(save_path, train_state_to_flax(state, optimizer), {
        "epoch": epoch - 1, "step": (epoch - 1) * steps_per_epoch + pos,
        "preempted": preemption_requested(),
        "in_epoch": {"epoch": epoch, "pos": pos, "sums": read, "retries": retries}},
        keep=ckpt_keep)


def _cache_epoch(state, cache: DeviceCache, mat: np.ndarray, multi_step: Callable, pol,
                 key, sums: torch.Tensor, epoch: int, steps_per_epoch: int,
                 steps_per_dispatch: int, checkpoint_every: int, heartbeat, save_path,
                 ckpt_keep: int, optimizer, resume_pos: int, resume_sums, wd, fi,
                 retries: int) -> dict:
    """One epoch of the device-cache path from dispatch position
    `resume_pos` (with the metric sums saved there); returns the epoch's
    normalized train metrics.  Every dispatch boundary is a resume point:
    the periodic snapshot (`checkpoint_every`) and a preemption request
    save an ``in_epoch`` link there, and the request raises
    ``PreemptedError``."""
    sums.zero_()
    if resume_pos and resume_sums:
        sums.copy_(torch.tensor([np.float32(resume_sums.get(k, 0.0)) for k in METRIC_KEYS]))
    pos = resume_pos
    for di, n in enumerate(split_dispatch_chunks(len(mat) - pos, steps_per_dispatch)):
        _monitored_dispatch(wd, "train_dispatch", fi, (epoch - 1) * steps_per_epoch + pos + n,
                            multi_step, state, cache.images, cache.labels, mat[pos:pos + n],
                            pol, key, sums)
        pos += n
        if heartbeat is not None:
            heartbeat()
        if fi is not None:
            fi.maybe_signal((epoch - 1) * steps_per_epoch + pos)
        periodic = checkpoint_every and (di + 1) % checkpoint_every == 0
        if pos < len(mat) and (preemption_requested() or periodic):
            if save_path:
                _save_in_epoch(save_path, state, optimizer, sums, epoch=epoch, pos=pos,
                               steps_per_epoch=steps_per_epoch, retries=retries,
                               ckpt_keep=ckpt_keep)
            if preemption_requested():
                logger.warning("preempted at epoch %d dispatch boundary (position %d/%d) - "
                               "checkpointed, exit %d means 'resume me'", epoch, pos, len(mat),
                               PREEMPTED_EXIT_CODE)
                raise PreemptedError(f"preempted mid-epoch {epoch} at dispatch position {pos}")
    acc = Accumulator()
    acc.add_dict(dict(zip(METRIC_KEYS, sums.tolist())))
    return acc.normalize()


def train_and_eval(conf, dataroot: str, *, test_ratio: float = 0.0, cv_fold: int = 0,
                   reporter: Callable | None = None, metric: str = "last",
                   save_path: str | None = None, only_eval: bool = False,
                   evaluation_interval: int = 5, target_lb: int = -1, seed: int = 0,
                   aug_dispatch: str = "exact", aug_groups: int = 8,
                   device_cache: str = "auto", steps_per_dispatch: int = 1,
                   divergence_retries: int = 0, ckpt_keep: int = 2,
                   checkpoint_every_dispatch: int = 0, watchdog="off",
                   heartbeat: Callable | None = None,
                   compile_cache: str = "off", device="cuda", draw_source=None,
                   host_step: str = "graph") -> dict:
    """Train one model under `conf` and evaluate it.

    Returns the reference-shaped result dict.  `metric` in {'last', 'train',
    'valid', 'test'} selects what "best" means (reference
    ``train.py:286-303``).  ``aug_dispatch``/``aug_groups`` pick the policy
    sampler ("exact": per image; "grouped": per chunk).  `heartbeat`
    (callable) runs at every epoch boundary.  The model's weights are drawn
    from `seed`, and the augmentation's randomness from the key whose
    words are those of ``jax.random.PRNGKey(seed)``, through `draw_source`
    (the port's Philox draws by default).  ``device_cache`` ("auto", "on",
    "off"), ``steps_per_dispatch`` (N, needs the cache) and
    ``checkpoint_every_dispatch`` (M, cache path only) pick the data path of
    the module docstring, and ``host_step`` (:data:`HOST_STEPS`) the host
    feed's step: ``"graph"`` (a CUDA-graph replay on the card) or
    ``"eager"``; `save_path`, `only_eval` and `ckpt_keep` are its
    checkpoint options; ``watchdog`` (``"off"``, ``"auto"``, seconds, or a
    shared ``DispatchWatchdog``), ``divergence_retries`` and
    ``compile_cache`` are the runtime seams of the module docstring."""
    if host_step not in HOST_STEPS:
        raise ValueError(f"host_step must be one of {HOST_STEPS}, got {host_step!r}")
    configure_compile_cache(compile_cache)
    wd = resolve_watchdog(watchdog)
    divergence_retries = max(0, int(divergence_retries))
    # flag-setting SIGTERM/SIGUSR1 handlers (main thread only; another
    # thread reads the process-wide flag)
    install_signal_handlers()
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
    use_cache = resolve_device_cache(device_cache, total_train)
    steps_per_dispatch = int(steps_per_dispatch)
    if steps_per_dispatch > 1 and not use_cache:
        raise ValueError(
            f"steps_per_dispatch={steps_per_dispatch} needs the device cache (in-dispatch batch "
            f"gather); it is {'off' if device_cache == 'off' else 'unavailable (lazy dataset)'} "
            "here - use --device-cache auto/on with an in-memory dataset")
    checkpoint_every_dispatch = max(0, int(checkpoint_every_dispatch))
    is_imagenet = dataset_name.endswith("imagenet")
    # conf['imgsize'] overrides the model's input size (the reference
    # evaluates ResNet-200 at 320 px, README.md:44-46)
    image = int(conf.get("imgsize", 0) or 0) or input_image_size(dataset_name,
                                                                 conf["model"]["type"])
    it_kw = {}
    if is_imagenet:
        it_kw = dict(train_box_fn=lambda rng, w, h: random_crop_box(rng, w, h, image),
                     eval_box_fn=lambda rng, w, h: center_crop_box(w, h, image))
    it_kw.update(imgsize=image, decoder="native" if dev.type == "cuda" else "auto",
                 stats=DecodeStats())
    train_it = BatchIterator(total_train, train_idx, **it_kw)
    valid_it = BatchIterator(total_train, valid_idx, **it_kw)
    test_it = BatchIterator(testset, **it_kw)
    global_batch = int(conf["batch"])
    if not only_eval and len(train_idx) < global_batch:
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
    step_kw = dict(num_classes=num_classes, mixup_alpha=float(conf.get("mixup", 0.0) or 0.0),
                   lb_smooth=lb_smooth, ema_mu=ema_mu, cutout_length=cutout,
                   use_policy=use_policy, augment_fn=augment_fn, aug_dispatch=aug_dispatch,
                   aug_groups=aug_groups, draw_source=draw_source)
    eval_kw = dict(num_classes=num_classes, lb_smooth=lb_smooth, preprocess_fn=eval_preprocess)
    if use_cache:
        multi_step = make_multistep_train_step(make_train_step_body(model, optimizer, **step_kw),
                                               steps_per_dispatch=steps_per_dispatch,
                                               beat=heartbeat)
    else:
        make_step = make_train_step if host_step == "eager" else make_graphed_train_step
        train_step = make_step(model, optimizer, **step_kw)
    eval_step = make_replay_eval_step(model, **eval_kw)
    stream_eval_step = make_eval_step(model, **eval_kw)
    eval_splits: dict[str, list] = {}  # each split put on the device at its first evaluation
    pol = torch.as_tensor(policy if use_policy else np.zeros((1, 1, 3), np.float32),
                          device=dev)
    key = prng_key(seed)
    src = draw_source or PhiloxDraws()
    if draw_source is None:
        key = torch.as_tensor(key.astype(np.int64), device=dev)

    def eval_split(split: str, it: BatchIterator) -> dict:
        if it.dataset.lazy:
            return _stream_eval(stream_eval_step, it, global_batch, dev, wd, int(state.step))
        if split not in eval_splits:
            eval_splits[split] = _stacked_eval_splits(it, global_batch, dev)
        return _run_eval(eval_step, eval_splits[split], wd, int(state.step))

    def evaluate() -> dict:
        # empty splits are skipped, not reported as zeros (the reference
        # only evaluates real splits, train.py:272-280)
        out = {}
        for split, it in (("valid", valid_it), ("test", test_it)):
            if len(it) == 0:
                continue
            norm = eval_split(split, it)
            out[split] = norm
            if state.ema is not None:
                with swapped_weights(model, state.ema):
                    norm_ema = eval_split(split, it)
                # with EMA on, the reported numbers are the EMA model's
                # (reference train.py:277-280); the raw ones stay under _raw
                out[split + "_raw"], out[split + "_ema"], out[split] = norm, norm_ema, norm_ema
        return out

    ckpt_keep = max(1, int(ckpt_keep))
    epoch_start = 1
    resume_pos, resume_sums = 0, None  # a mid-epoch link's dispatch position and sums
    retries_done = 0  # divergence retries taken (they fold the randomness)
    restored = None
    if save_path:
        # mid-epoch links resume only where the dispatch position can be
        # fast-forwarded (the cache's index feed); the host feed walks back
        # to an epoch-boundary link
        restored = load_checkpoint_chain(
            save_path, keep=ckpt_keep,
            accept=None if use_cache else (lambda m: "in_epoch" not in m))
        if restored is not None and "in_epoch" in restored[1]:
            rec = restored[1]["in_epoch"]
            if not isinstance(rec, dict) or \
                    int(rec.get("epoch", -1)) != int(restored[1].get("epoch", 0)) + 1:
                logger.warning("inconsistent mid-epoch record in %s - falling back to an "
                               "epoch-boundary chain link", restored[2])
                restored = load_checkpoint_chain(save_path, keep=ckpt_keep,
                                                 accept=lambda m: "in_epoch" not in m)
    if restored is not None:
        tree, meta, used_path = restored
        epoch_start = int(meta.get("epoch", 0)) + 1
        if meta.get("imported_from"):
            # the reference importer's file holds no optimizer state: its
            # fields merge onto the fresh state's tree
            tree = lenient_merge(train_state_to_flax(state, optimizer), tree)
            load_flax_train_state(tree, state, optimizer)
            _imported_fixups(state, meta, (epoch_start - 1) * steps_per_epoch)
        else:
            load_flax_train_state(tree, state, optimizer)
        if meta.get("in_epoch"):
            resume_pos = int(meta["in_epoch"]["pos"])
            resume_sums = meta["in_epoch"].get("sums") or {}
            retries_done = int(meta["in_epoch"].get("retries", 0))
            logger.info("resuming mid-epoch: epoch %d from dispatch position %d (%s)",
                        epoch_start, resume_pos, used_path)
        logger.info("resumed %s at epoch %d", used_path, epoch_start - 1)
        if epoch_start > epochs:
            only_eval = True
    elif only_eval and save_path:
        raise FileNotFoundError(f"only_eval requires a checkpoint at {save_path}")

    result: dict = {"epoch": epoch_start - 1}
    if only_eval:
        for split, m in evaluate().items():
            for k, v in m.items():
                result[f"{k}_{split}"] = v
        return result
    # eval-only runs never consult `metric` (the JAX trainer's order)
    if metric not in ("last", "train", "valid", "test"):
        raise ValueError(f"unknown metric {metric!r}: use last/train/valid/test")
    if metric == "valid" and len(valid_it) == 0:
        raise ValueError("metric='valid' with an empty validation split (test_ratio=0): "
                         "pass metric='last'/'train'/'test' or a test_ratio > 0")
    if metric == "test" and len(test_it) == 0:
        raise ValueError("metric='test' with an empty test split")

    # line-buffered: what a run logs is on disk even if it stops early
    writers = make_writers(os.path.dirname(save_path) if save_path else None,
                           os.path.basename(save_path or "run"))
    best_metric = -1e9
    if use_cache:
        cache = DeviceCache(total_train, dev)
        logger.info("device cache: %d examples (%.1f MiB uint8) resident, steps_per_dispatch=%d",
                    cache.num_examples, cache.nbytes / 2**20, steps_per_dispatch)
        # the epoch's metric chain, in place: a graph reads this buffer
        epoch_sums = torch.zeros(len(METRIC_KEYS), device=dev)
    t_start = time.time()
    # the step key a graph reads stays one tensor; a retry copies its folded
    # key into it
    key_live = key.clone() if torch.is_tensor(key) else key
    # while, not for: divergence recovery rolls `epoch` back
    epoch = epoch_start
    while epoch <= epochs:
        fi = faultinject.active_plan()
        # retry-folded randomness after a rollback; retries_done == 0 is the
        # run's own stream
        if retries_done:
            key_epoch = src.fold_in(key, 1_000_003 * retries_done, dev)
            seed_epoch = seed + 1_000_003 * retries_done
        else:
            key_epoch, seed_epoch = key, seed
        if torch.is_tensor(key_live):
            key_live.copy_(torch.as_tensor(key_epoch, device=dev))
        else:
            key_live = key_epoch
        if use_cache:
            train_metrics = _cache_epoch(
                state, cache, train_index_matrix(train_idx, global_batch, epoch, seed=seed_epoch),
                multi_step, pol, key_live, epoch_sums, epoch, steps_per_epoch,
                steps_per_dispatch, checkpoint_every_dispatch, heartbeat, save_path, ckpt_keep,
                optimizer, resume_pos if epoch == epoch_start else 0, resume_sums, wd, fi,
                retries_done)
        else:
            acc = Accumulator()
            batches = prefetch(train_it.train_epoch(global_batch, epoch, seed=seed_epoch),
                               transform=functools.partial(stage_batch, device=dev))
            for bi, (xs, ys) in enumerate(batches):
                step_no = (epoch - 1) * steps_per_epoch + bi + 1
                state, metrics = _monitored_dispatch(wd, "train_step", fi, step_no, train_step,
                                                     state, xs, ys, pol, key_live)
                acc.add_dict(metrics)
                if fi is not None:
                    fi.maybe_signal(step_no)
            train_metrics = acc.normalize()
        resume_pos, resume_sums = 0, None  # consumed by the first epoch
        if heartbeat is not None:
            heartbeat()
        if fi is not None and fi.nan_loss_in((epoch - 1) * steps_per_epoch,
                                             epoch * steps_per_epoch):
            train_metrics["loss"] = float("nan")  # injected at the seam
        if not np.isfinite(train_metrics["loss"]):
            # divergence recovery: roll back to the newest intact
            # epoch-boundary link and replay with retry-folded randomness
            if retries_done < divergence_retries and save_path:
                rolled = load_checkpoint_chain(save_path, keep=ckpt_keep,
                                               accept=lambda m: "in_epoch" not in m)
                if rolled is not None:
                    retries_done += 1
                    tree, meta_rb, used_rb = rolled
                    load_flax_train_state(tree, state, optimizer)
                    rollback_epoch = int(meta_rb.get("epoch", 0)) + 1
                    logger.warning("divergence: non-finite loss at epoch %d - rolled back to "
                                   "%s (replaying from epoch %d), retry %d/%d with "
                                   "retry-folded randomness", epoch, used_rb, rollback_epoch,
                                   retries_done, divergence_retries)
                    epoch = rollback_epoch
                    continue
                logger.error("divergence: retries remain but no intact rollback checkpoint "
                             "under %s - re-raising", save_path)
            raise RuntimeError("loss is NaN — training diverged (reference train.py:259)")
        ema_interval = int(optimizer_conf.get("ema_interval", -1) or -1)
        if state.ema is not None and ema_interval > 0 and epoch % ema_interval == 0:
            logger.info("ema synced into model at epoch %d", epoch)  # train.py:262-270
            with torch.no_grad():
                for k, v in model.state_dict(keep_vars=True).items():
                    if k in state.ema:
                        v.copy_(state.ema[k])
        for k in ("loss", "top1", "top5"):
            writers[0].add_scalar(k, train_metrics[k], epoch)
        logger.info("[train %3d/%3d] loss=%.4f top1=%.4f lr=%.5f", epoch, epochs,
                    train_metrics["loss"], train_metrics["top1"], lr_fn(state.step - 1))
        result.update({f"{k}_train": v for k, v in train_metrics.items() if k != "num"})
        result["epoch"] = epoch

        if epoch % evaluation_interval == 0 or epoch == epochs:
            evals = evaluate()
            for split, m in evals.items():
                suffix = next((x for x in ("_ema", "_raw") if split.endswith(x)), "")
                for k in ("loss", "top1", "top5"):
                    writers[1 if split.startswith("valid") else 2].add_scalar(
                        k + suffix, m.get(k, 0.0), epoch)
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
                if save_path:
                    save_checkpoint(save_path, train_state_to_flax(state, optimizer), {
                        "epoch": epoch, "step": int(state.step),
                        "metrics": {k: float(v) for k, v in result.items()
                                    if isinstance(v, (int, float))}}, keep=ckpt_keep)
            if reporter is not None:
                reporter(loss_valid=evals.get("valid", {}).get("loss", 0.0),
                         top1_valid=evals.get("valid", {}).get("top1", 0.0),
                         loss_train=train_metrics["loss"], top1_train=train_metrics["top1"],
                         epoch=epoch)
        # graceful preemption at the epoch boundary (the host feed's only
        # safe point): checkpoint the completed epoch and raise
        if preemption_requested():
            if save_path:
                save_checkpoint(save_path, train_state_to_flax(state, optimizer), {
                    "epoch": epoch, "step": int(state.step), "preempted": True,
                    "metrics": {k: float(v) for k, v in result.items()
                                if isinstance(v, (int, float))}}, keep=ckpt_keep)
            logger.warning("preempted at epoch %d boundary - checkpointed, exit %d means "
                           "'resume me'", epoch, PREEMPTED_EXIT_CODE)
            raise PreemptedError(f"preempted after epoch {epoch}")
        epoch += 1
    if retries_done:
        result["divergence_retries_used"] = retries_done
    if total_train.lazy:
        result["loader"] = train_it.stats.snapshot()
    result["elapsed_sec"] = time.time() - t_start
    for w in writers:
        w.close()
    return result
