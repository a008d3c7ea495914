"""The train and eval steps (``fast_autoaugment_tpu/train/steps.py``), on the
sequential path.

One train step is the reference's per-batch loop body (``train.py:35-107``):
the augmentation stack (the policy kernel, then the CIFAR or ImageNet stack
kernel), the model forward in train mode and the backward through autograd
(cuDNN convolutions), ``smooth_cross_entropy``, the optimizer chain of
``ops/optim.py`` (masked weight decay, global-norm clip, SGD-nesterov at
``lr(count)``), the EMA, and the metric sums (``loss * batch``, top-1 and
top-5 counts, ``num``) as 0-dim float32 tensors left on the device.

Randomness comes from a draw source (the port's Philox one by default,
``search/tta.py PhiloxDraws``).  The key tree is the JAX step's
(``:137-196``): step s's key is ``fold_in(key, s)``, split into
``(key_aug, key_model)``; ``key_aug`` makes the augmentation's draws, and
``key_model`` splits into ``(key_mix, key_shake, key_drop)``: mixup's Beta
scalar and permutation (``mixup_alpha > 0``: the augmented batch is mixed
and the loss is ``mixup_cross_entropy``), and the model's noise
(``ops/shake.py``: ShakeShake, ShakeDrop and drop-connect from
``key_shake``, dropout from ``key_drop``), which a model with noise sites
takes as ``model(x, noise=...)``.  A step draws all of these with one call
of the draw source's ``step_draws`` (``search/tta.py``): on the card one
launch (the key chain from the step's scalars, the augment function's record,
the noise and mixup), on the CPU the chain of the source's own calls.

The JAX step is a pure function of its state; here the state holds the
model, and a step updates the model's parameters and BatchNorm statistics,
the optimizer state and the EMA shadow in place (no second copy of the
weights), then returns the state with ``step + 1``.

A step's device work is :class:`StepBody`: it reads the step's counter,
learning rate and EMA coefficients from a small device tensor
(:meth:`StepBody.scalars`, made on the host from the state's counts), so
nothing in it depends on a Python value that changes from step to step.
:func:`make_train_step` runs one body per call, eagerly;
:func:`make_graphed_train_step` (the trainer's host-fed path) replays one
CUDA graph of it a step on ``cuda``, over static buffers that each batch is
copied into.
:func:`make_multistep_train_step` (``:381-469``) runs N bodies per dispatch
over a device-resident dataset (``data/pipeline.py DeviceCache``), each
gathering its batch by index: on the CPU as a loop, on ``cuda`` as N
replays of one CUDA graph of a single step, with the staged index rows
and scalars as its only inputs that change.  Step t of a
dispatch draws the keys the host loop's t-th step would, so the two paths
give the same bits.  :func:`make_replay_eval_step` (``:523-555``)
evaluates a split held on the device and sums it there.  The fold-stacked
variants are ROADMAP Queue 1 item 10b.

Each stage of a step runs in a ``torch.profiler.record_function`` range
(``train.sampler``, ``train.augment``, ``train.model``,
``train.optimizer``), so a profiler trace of the host-fed path splits the
step by stage; a graph replay has no host ranges, and a trace of it is
split by kernel name.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from fast_autoaugment_tpu_torch.core import compilecache
from fast_autoaugment_tpu_torch.core.metrics import (
    mixup_batch,
    mixup_cross_entropy,
    smooth_cross_entropy,
    top_k_correct,
)
from fast_autoaugment_tpu_torch.core.watchdog import capture_guard
from fast_autoaugment_tpu_torch.models.layers import at_least_float32
from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.ops.optim import (
    OptState,
    Optimizer,
    ema_apply,
    ema_coefficients,
    ema_tensors,
    init_ema,
    non_bn_mask,
)
from fast_autoaugment_tpu_torch.ops.preprocess import cifar_eval_batch, cifar_train_batch
from fast_autoaugment_tpu_torch.ops.preprocess_imagenet import imagenet_train_batch
from fast_autoaugment_tpu_torch.ops.shake import noise_layout, noise_sites
from fast_autoaugment_tpu_torch.search.tta import DrawRecord, PhiloxDraws, check_aug_dispatch

__all__ = ["TrainState", "create_train_state", "cifar_augment_fn", "imagenet_augment_fn",
           "StepBody", "make_train_step_body", "make_train_step", "make_graphed_train_step",
           "make_multistep_train_step",
           "make_eval_step", "make_replay_eval_step", "swapped_weights", "METRIC_KEYS"]

#: the metric sums of a step, in the order of a sums buffer
METRIC_KEYS = ("loss", "top1", "top5", "num")


@dataclass
class TrainState:
    """``step`` (the number of steps taken), the model (its parameters and
    BatchNorm statistics), the optimizer's state and the EMA shadow (a dict
    by ``state_dict`` name, or None)."""

    step: int
    model: torch.nn.Module
    opt_state: OptState
    ema: dict[str, torch.Tensor] | None


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       use_ema: bool) -> TrainState:
    """Step 0: the optimizer's state for the model's parameters, and an EMA
    shadow that is a distinct copy of the weights when `use_ema`."""
    return TrainState(step=0, model=model,
                      opt_state=optimizer.init(list(model.parameters())),
                      ema=init_ema(model) if use_ema else None)


def _augment_fn(record: Callable, apply: Callable) -> Callable:
    """An ``augment_fn(images, policy, key, draw_source)`` made of its two
    halves, which it carries as attributes: ``record(images, policy)``, the
    :class:`~fast_autoaugment_tpu_torch.search.tta.DrawRecord` it draws from
    `key`, and ``apply(images, policy, draws)``, which augments with those
    draws.  The train step draws the record with the step's other draws
    (``step_draws``) and calls ``apply``; other callers call the function."""

    def augment_fn(images, policy, key, draw_source):
        with record_function("train.sampler"):
            d = record(images, policy).draw(draw_source, key, images.device)
        return apply(images, policy, d)

    augment_fn.record, augment_fn.apply = record, apply
    return augment_fn


def cifar_augment_fn(cutout_length: int, use_policy: bool = True, aug_dispatch: str = "exact",
                     aug_groups: int = 8) -> Callable:
    """The CIFAR/SVHN train stack as an ``augment_fn(images, policy, key,
    draw_source)``: the draws of one ``cifar_train_batch`` call from `key`,
    then the policy (when `use_policy`) and crop/flip/normalize/cutout."""
    check_aug_dispatch(aug_dispatch)

    def record(images, policy) -> DrawRecord:
        b, h, w = (int(v) for v in images.shape[:3])
        return DrawRecord(False, b, h, w, (int(policy.shape[0]) if use_policy else 1,
                                           int(policy.shape[1])), aug_dispatch, aug_groups)

    def apply(images, policy, d):
        with record_function("train.augment"):
            if not use_policy:
                return cifar_train_batch(images, d.crop, cutout_length=cutout_length)
            return cifar_train_batch(images, d.crop, policy=policy, sub_idx=d.sub_idx,
                                     policy_draws=d.policy, cutout_length=cutout_length)

    return _augment_fn(record, apply)


def imagenet_augment_fn(cutout_length: int, use_policy: bool = True,
                        aug_dispatch: str = "exact", aug_groups: int = 8) -> Callable:
    """The ImageNet train stack as an ``augment_fn(images, policy, key,
    draw_source)``, wired as the JAX trainer wires ``imagenet_train_batch``
    (``train/trainer.py:404-410``): the policy when `use_policy`, then
    flip, ColorJitter, lighting, normalize and cutout."""
    check_aug_dispatch(aug_dispatch)

    def record(images, policy) -> DrawRecord:
        b, h, w = (int(v) for v in images.shape[:3])
        shape = (int(policy.shape[0]), int(policy.shape[1])) if use_policy else None
        return DrawRecord(True, b, h, w, shape, aug_dispatch, aug_groups)

    def apply(images, policy, d):
        with record_function("train.augment"):
            return imagenet_train_batch(images, d, policy=policy if use_policy else None,
                                        cutout_length=cutout_length)

    return _augment_fn(record, apply)


class StepBody:
    """One train step's device work: ``body(state, images_u8, labels, policy,
    key, scalars) -> metric_sums``.  It updates the state's tensors in place
    and leaves its host counts alone; ``scalars`` is a float64 ``[4]``
    tensor on the device, (step, ``lr(count)``, EMA ``mu_t``, ``1 - mu_t``)
    of :meth:`scalars` (all exact in float64)."""

    def __init__(self, fn: Callable, optimizer: Optimizer, ema_mu: float):
        self.fn, self.optimizer, self.ema_mu = fn, optimizer, float(ema_mu)

    def __call__(self, state, images, labels, policy, key, scalars):
        return self.fn(state, images, labels, policy, key, scalars)

    def scalars(self, step: int, count: int, n: int = 1) -> np.ndarray:
        """The ``[n, 4]`` float64 scalars of steps ``step .. step + n - 1``
        (optimizer counts from `count`); the EMA's step is 1-based."""
        out = np.zeros((n, 4), np.float64)
        for t in range(n):
            mu_t, rest = ema_coefficients(self.ema_mu, step + t + 1) if self.ema_mu > 0.0 \
                else (0.0, 1.0)
            out[t] = (step + t, self.optimizer.lr_at(count + t), mu_t, rest)
        return out


def make_train_step_body(model: torch.nn.Module, optimizer: Optimizer, *, num_classes: int,
                         mixup_alpha: float = 0.0, lb_smooth: float = 0.0, ema_mu: float = 0.0,
                         cutout_length: int = 16, use_policy: bool = True,
                         augment_fn: Callable | None = None, aug_dispatch: str = "exact",
                         aug_groups: int = 8, draw_source=None) -> StepBody:
    """The :class:`StepBody` of :func:`make_train_step` (same arguments)."""
    src = draw_source or PhiloxDraws()
    sites = noise_sites(model)
    if augment_fn is None:
        augment_fn = cifar_augment_fn(cutout_length, use_policy, aug_dispatch, aug_groups)
    # an augment_fn made of a record and its application (cifar_augment_fn,
    # imagenet_augment_fn) has its record drawn with the step's other draws
    record_of, apply = getattr(augment_fn, "record", None), getattr(augment_fn, "apply", None)
    params = list(model.parameters())
    mask = non_bn_mask(model)
    topk = min(5, num_classes)
    layouts: dict[int, object] = {}  # batch -> the sites' NoiseLayout, worked out once

    def body(state: TrainState, images, labels, policy, key, scalars):
        if state.model is not model:
            raise ValueError("the state holds another model than the step was built for")
        model.train()
        dev = images.device
        b = int(images.shape[0])
        if sites and b not in layouts:
            layouts[b] = noise_layout(sites, b)
        record = record_of(images, policy) if record_of is not None else None
        with record_function("train.sampler"):
            d = src.step_draws(key, scalars, sites=sites, batch=b, alpha=mixup_alpha,
                               record=record, layout=layouts.get(b))
        noise, lam, perm = d.noise, d.lam, d.perm
        x = apply(images, policy, d.draws) if record is not None \
            else augment_fn(images, policy, d.key_aug, src)
        labels = labels.to(device=dev, dtype=torch.int64)
        with record_function("train.model"):
            if lam is not None:
                x, labels_a, labels_b, lam = mixup_batch(x, labels, lam, perm)
            logits = at_least_float32(model(x, noise=noise) if sites else model(x))
            if lam is not None:
                loss = mixup_cross_entropy(logits, labels_a, labels_b, lam, lb_smooth)
            else:
                loss = smooth_cross_entropy(logits, labels, lb_smooth)
            grads = list(torch.autograd.grad(loss, params))
        with record_function("train.optimizer"):
            coefficients = scalars[1:].to(torch.float32)
            optimizer.update(params, grads, state.opt_state, mask, coefficients[0])
            if state.ema is not None and ema_mu > 0.0:
                ema_apply(state.ema, ema_tensors(model), coefficients[1:])
            with torch.no_grad():
                batch = labels.shape[0]
                return {
                    "loss": loss.detach() * batch,
                    "top1": top_k_correct(logits, labels, 1).to(torch.float32),
                    "top5": top_k_correct(logits, labels, topk).to(torch.float32),
                    "num": torch.full((), float(batch), device=dev),
                }

    return StepBody(body, optimizer, ema_mu)


def make_train_step(model: torch.nn.Module, optimizer: Optimizer, *, num_classes: int,
                    mixup_alpha: float = 0.0, lb_smooth: float = 0.0, ema_mu: float = 0.0,
                    cutout_length: int = 16, use_policy: bool = True,
                    augment_fn: Callable | None = None, aug_dispatch: str = "exact",
                    aug_groups: int = 8, draw_source=None) -> Callable:
    """Build the train step: ``step_fn(state, images_u8, labels, policy,
    key) -> (state, metric_sums)``.

    `images_u8` is ``[B, H, W, 3]`` uint8, `labels` ``[B]`` integers and
    `policy` ``[num_sub, num_op, 3]`` float32, all on the model's device;
    `key` is a key of the draw source.  `augment_fn(images, policy, key,
    draw_source) -> [B, 3, H, W]` defaults to the CIFAR/SVHN stack
    (:func:`cifar_augment_fn` with ``aug_dispatch``/``aug_groups``); pass
    :func:`imagenet_augment_fn` for that family.  A custom `augment_fn`
    owns its own dispatch and draws from the ``key_aug`` it is given.  A
    model with noise sites gets its noise from ``key_shake`` and
    ``key_drop``, mixup its draws from ``key_mix``: all of a step's draws
    come from one call of the draw source's ``step_draws``
    (``search/tta.py step_draws``)."""
    body = make_train_step_body(
        model, optimizer, num_classes=num_classes, mixup_alpha=mixup_alpha,
        lb_smooth=lb_smooth, ema_mu=ema_mu, cutout_length=cutout_length, use_policy=use_policy,
        augment_fn=augment_fn, aug_dispatch=aug_dispatch, aug_groups=aug_groups,
        draw_source=draw_source)

    def step_fn(state: TrainState, images, labels, policy, key):
        dev = policy.device
        scalars = torch.from_numpy(body.scalars(state.step, state.opt_state.count)[0])
        metrics = body(state, images.to(dev, non_blocking=True),
                       labels.to(dev, non_blocking=True), policy, key,
                       scalars.to(dev, non_blocking=True))
        state.step += 1
        state.opt_state.count += 1
        return state, metrics

    return step_fn


def make_graphed_train_step(model: torch.nn.Module, optimizer: Optimizer, **kw) -> Callable:
    """:func:`make_train_step` (same arguments and call) whose steps, on a
    model on ``cuda``, replay one CUDA graph of the step
    (:class:`_GraphedStep`): one copy of the batch into static buffers and
    one replay a step, with the eager step's bits under deterministic cuDNN.
    For a model on the CPU it returns :func:`make_train_step`'s step.  The
    graph reads the draw source's key as a device tensor, so a draw source
    that works on the host (a test's replayed JAX draws) needs the eager
    step."""
    if next(model.parameters()).device.type != "cuda":
        return make_train_step(model, optimizer, **kw)
    graphed = _GraphedStep(make_train_step_body(model, optimizer, **kw))

    def step_fn(state: TrainState, images, labels, policy, key):
        metrics = graphed(state, images, labels, policy, key)
        state.step += 1
        state.opt_state.count += 1
        return state, metrics

    return step_fn


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a step updates in place."""
    opt = state.opt_state
    out = list(state.model.state_dict(keep_vars=True).values())
    out += list(opt.trace) + list(opt.ms) + list(opt.mom)
    return out + (list(state.ema.values()) if state.ema is not None else [])


class _GraphedDispatch:
    """One train step captured once as a CUDA graph, replayed once per step.

    A dispatch of n steps uploads its index rows and scalars into static
    device buffers of `capacity` rows and resets a device row counter; each
    replay gathers row ``counter`` of both, runs the step and advances the
    counter, so the n replays are the n steps without a host value between
    them.  The first call runs one step on a side stream to warm cuDNN,
    cuBLAS, autograd and the kernels' one-time set-up, puts every state
    tensor and the sums back as they were, calls `beat` (if any) and
    captures (deterministic cuDNN, no autotuning).  The tensors the graph reads (state, cache,
    policy, key, sums) must be the same objects at every call.  Capture or
    replay failures raise."""

    def __init__(self, run: Callable, capacity: int, beat: Callable | None = None):
        self.run, self.capacity, self.beat = run, capacity, beat
        self.graph = None

    @staticmethod
    def _refs(state, tensors) -> tuple:
        return tuple(t.data_ptr() for t in list(tensors) + _state_tensors(state))

    def __call__(self, state, cache_images, cache_labels, idx, policy, key, scalars, sums):
        dev = cache_images.device
        reads = (cache_images, cache_labels, policy, key, sums)
        if self.graph is None:
            self.idx = torch.zeros((self.capacity, int(idx.shape[1])), dtype=torch.int64,
                                   device=dev)
            self.scalars = torch.zeros((self.capacity, 4), dtype=torch.float64, device=dev)
            self.row = torch.zeros(1, dtype=torch.int64, device=dev)
            self._stage(idx, scalars)
            with compilecache.timed_first("train_dispatch"), capture_guard():
                self._capture(state, *reads)
            self.refs = self._refs(state, reads)
        elif self._refs(state, reads) != self.refs:
            raise ValueError("a graphed dispatch was called with other tensors than it "
                             "captured")
        self._stage(idx, scalars)
        for _ in range(len(idx)):
            self.graph.replay()
        _kernels.count_replays(self.tally, len(idx))

    def _stage(self, idx, scalars) -> None:
        n = len(idx)
        self.idx[:n].copy_(torch.from_numpy(np.ascontiguousarray(idx, np.int64)),
                           non_blocking=True)
        self.scalars[:n].copy_(torch.from_numpy(scalars), non_blocking=True)
        self.row.zero_()

    def _step(self, state, cache_images, cache_labels, policy, key, sums) -> None:
        self.run(state, cache_images, cache_labels, self.idx.index_select(0, self.row), policy,
                 key, self.scalars.index_select(0, self.row), sums)
        self.row.add_(1)

    def _capture(self, state, *reads) -> None:
        self.graph, self.tally, _ = _capture_step(state, lambda: self._step(state, *reads),
                                                  [reads[-1]], beat=self.beat)


def _capture_step(state: TrainState, step: Callable, extra: list[torch.Tensor],
                  beat: Callable | None = None) -> tuple:
    """Capture ``step()`` (one train step over static tensors) as a CUDA
    graph: a warm-up call on a side stream (cuDNN's and cuBLAS's plans,
    autograd, the kernels' one-time set-up), every state tensor and `extra`
    put back as they were, then `beat` (if any) once the warm-up has
    finished on the card, so a caller's lease is renewed between the two
    halves of a first dispatch, then the capture, under deterministic cuDNN
    without autotuning whatever the caller's flags, ``thread_local`` (other
    threads, the prefetch worker or the search pipeline's actors, may launch
    and synchronize meanwhile) and under ``capture_guard``.  Returns
    ``(graph, tally, out)``: the graph, the launches it recorded
    (:func:`_kernels.counting_capture`) and the captured call's outputs,
    which every replay rewrites."""
    live = _state_tensors(state) + list(extra)
    dev = live[0].device
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    with torch.no_grad():
        saved = [t.detach().clone() for t in live]
    side.wait_stream(main)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        with torch.cuda.stream(side):
            step()
        main.wait_stream(side)
        with torch.no_grad():
            for t, v in zip(live, saved):
                t.copy_(v)
        del saved
        side.wait_stream(main)
        if beat is not None:
            side.synchronize()
            beat()
        graph = torch.cuda.CUDAGraph()
        with _kernels.counting_capture() as tally, \
                torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            out = step()
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    main.wait_stream(side)
    return graph, tally, out


class _GraphedStep:
    """The host-fed train step captured once as a CUDA graph, replayed once
    a step.

    Static device buffers hold the batch (``x``, ``y``) and the step's
    scalars (:meth:`StepBody.scalars`: the step counter the key is folded
    with, the learning rate, the EMA's coefficients); a step is one copy of
    the batch into them (from pinned host memory the copy is asynchronous),
    one of the scalars, and one replay.  The graph is captured at the first
    call (:func:`_capture_step`); the tensors it reads besides its buffers
    (the state, the policy, the key) must be the same objects at every call,
    and every batch must have the first one's shape and dtype.  Each call
    returns the step's metric sums as tensors of their own.  Capture or
    replay failures raise."""

    def __init__(self, body: StepBody):
        self.body = body
        self.graph = None

    def __call__(self, state, images, labels, policy, key) -> dict:
        dev = policy.device
        scalars = torch.from_numpy(self.body.scalars(state.step, state.opt_state.count)[0])
        if self.graph is None:
            self.x = torch.empty(images.shape, dtype=images.dtype, device=dev)
            self.y = torch.empty(labels.shape, dtype=labels.dtype, device=dev)
            self.scalars = torch.empty(4, dtype=torch.float64, device=dev)
            self._stage(images, labels, scalars)
            with compilecache.timed_first("train_step"), capture_guard():
                self.graph, self.tally, self.out = _capture_step(
                    state, lambda: self.body(state, self.x, self.y, policy, key, self.scalars),
                    [])
            self.refs = self._refs(state, policy, key)
        elif self._refs(state, policy, key) != self.refs:
            raise ValueError("a graphed train step was called with other tensors than it "
                             "captured")
        elif (images.shape, images.dtype, labels.shape, labels.dtype) != \
                (self.x.shape, self.x.dtype, self.y.shape, self.y.dtype):
            raise ValueError(f"a graphed train step captured batches of {tuple(self.x.shape)} "
                             f"{self.x.dtype}, got {tuple(images.shape)} {images.dtype}")
        self._stage(images, labels, scalars)
        self.graph.replay()
        _kernels.count_replays(self.tally)
        with torch.no_grad():
            return {k: v.clone() for k, v in self.out.items()}

    @staticmethod
    def _refs(state, policy, key) -> tuple:
        reads = [policy] + ([key] if torch.is_tensor(key) else [])
        return tuple(t.data_ptr() for t in reads + _state_tensors(state))

    def _stage(self, images, labels, scalars) -> None:
        self.x.copy_(images, non_blocking=True)
        self.y.copy_(labels, non_blocking=True)
        self.scalars.copy_(scalars, non_blocking=True)


def make_multistep_train_step(body: StepBody, *, steps_per_dispatch: int,
                              beat: Callable | None = None) -> Callable:
    """Up to N train steps per dispatch over a device-resident dataset:
    ``fn(state, cache_images, cache_labels, idx [n, B], policy, key,
    sums=None) -> (state, metric_sums)``, ``1 <= n <= N`` (an epoch's
    remainder is a shorter dispatch).

    Step t gathers batch ``idx[t]`` (host int64 indices) from the cache
    (``cache_images [M, H, W, 3]`` uint8, ``cache_labels [M]`` int64) and
    runs `body` (:func:`make_train_step_body`) with the scalars of step
    ``state.step + t``, so it draws the keys the host loop's step would.
    The metric sums of the n steps are added to `sums` in step order (a
    float32 ``[4]`` buffer in :data:`METRIC_KEYS` order, updated in place,
    so a caller that passes one buffer per epoch continues one chain across
    dispatches: the host-fed path's, bit for bit), or to a zero buffer when
    `sums` is None; they come back as a dict of views of it.

    On ``cuda`` each step is a replay of one CUDA graph of a single step
    (:class:`_GraphedDispatch`), captured at the first call: a dispatch is
    one upload of its rows and n replays, and a call with `sums` None uses a
    buffer of its own, overwritten by the next call; `beat` (a lease's
    renewal) runs between the capture's warm-up step and the capture.  On the
    CPU the n steps run as a loop."""
    n_max = int(steps_per_dispatch)
    if n_max < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {n_max}")

    def run(state, cache_images, cache_labels, idx, policy, key, scalars, sums):
        for t in range(idx.shape[0]):
            images = torch.index_select(cache_images, 0, idx[t])
            labels = torch.index_select(cache_labels, 0, idx[t])
            m = body(state, images, labels, policy, key, scalars[t])
            with torch.no_grad():
                sums.add_(torch.stack([m[k] for k in METRIC_KEYS]))

    graph = _GraphedDispatch(run, n_max, beat)
    own: list[torch.Tensor] = []  # the card's sums buffer of calls without `sums`

    def multi_fn(state, cache_images, cache_labels, idx, policy, key, sums=None):
        n = int(idx.shape[0])
        if not 1 <= n <= n_max:
            raise ValueError(f"idx has {n} rows for a dispatch of at most {n_max} steps")
        dev = cache_images.device
        scalars = body.scalars(state.step, state.opt_state.count, n)
        if dev.type == "cuda":
            if sums is None:
                if not own:
                    own.append(torch.zeros(len(METRIC_KEYS), device=dev))
                sums = own[0]
                sums.zero_()
            graph(state, cache_images, cache_labels, idx, policy, key, scalars, sums)
        else:
            if sums is None:
                sums = torch.zeros(len(METRIC_KEYS), device=dev)
            run(state, cache_images, cache_labels,
                torch.as_tensor(np.asarray(idx, np.int64), device=dev), policy, key,
                torch.from_numpy(scalars).to(dev), sums)
        state.step += n
        state.opt_state.count += n
        return state, {k: sums[i] for i, k in enumerate(METRIC_KEYS)}

    return multi_fn


def make_eval_step(model: torch.nn.Module, *, num_classes: int, lb_smooth: float = 0.0,
                   preprocess_fn: Callable | None = None) -> Callable:
    """Build the eval step: ``fn(images_u8, labels, mask) -> metric_sums``
    (``loss``, ``top1``, ``top5``, ``num`` as sums over the samples whose
    `mask` is 1), with the model in eval mode.  `preprocess_fn` defaults to
    the CIFAR eval stack (normalization).  The weights are the model's: to
    evaluate an EMA shadow, run inside :func:`swapped_weights`."""
    preprocess_fn = preprocess_fn or cifar_eval_batch
    topk = min(5, num_classes)

    @torch.no_grad()
    def eval_fn(images, labels, mask):
        model.eval()
        logits = model(preprocess_fn(images)).to(torch.float32)
        labels = labels.to(torch.int64)
        nll = smooth_cross_entropy(logits, labels, lb_smooth, reduce_mean=False)
        top1 = torch.topk(logits, 1, dim=-1).indices == labels[:, None]
        top5 = torch.topk(logits, topk, dim=-1).indices == labels[:, None]
        return {
            "loss": (nll * mask).sum(),
            "top1": (top1.any(dim=-1) * mask).sum().to(torch.float32),
            "top5": (top5.any(dim=-1) * mask).sum().to(torch.float32),
            "num": mask.sum().to(torch.float32),
        }

    return eval_fn


def make_replay_eval_step(model: torch.nn.Module, *, num_classes: int, lb_smooth: float = 0.0,
                          preprocess_fn: Callable | None = None) -> Callable:
    """Whole-split evaluation over batches held on the device:
    ``fn(images [S, B, H, W, C], labels [S, B], masks [S, B]) -> metric_sums``,
    the :func:`make_eval_step` sums of the S batches added in order on the
    device (the host-fed path's chain), so one host read per split."""
    eval_fn = make_eval_step(model, num_classes=num_classes, lb_smooth=lb_smooth,
                             preprocess_fn=preprocess_fn)

    def replay_fn(images, labels, masks):
        sums = None
        for s in range(images.shape[0]):
            m = eval_fn(images[s], labels[s], masks[s])
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        return sums

    return replay_fn


@contextlib.contextmanager
def swapped_weights(model: torch.nn.Module, weights: dict[str, torch.Tensor]):
    """Run the block with `weights` (an EMA shadow) in the model, then put
    the model's own back."""
    live = ema_tensors(model)
    saved = {k: v.detach().clone() for k, v in live.items()}
    with torch.no_grad():
        for k, v in live.items():
            v.copy_(weights[k])
    try:
        yield model
    finally:
        with torch.no_grad():
            for k, v in live.items():
                v.copy_(saved[k])
