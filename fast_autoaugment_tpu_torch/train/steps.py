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
takes as ``model(x, noise=...)``.

The JAX step is a pure function of its state; here the state holds the
model, and a step updates the model's parameters and BatchNorm statistics,
the optimizer state and the EMA shadow in place (no second copy of the
weights), then returns the state with ``step + 1``.  The fold-stacked,
multistep and replay variants are ROADMAP Queue 1 item 10.

Each stage of a step runs in a ``torch.profiler.record_function`` range
(``train.sampler``, ``train.augment``, ``train.model``,
``train.optimizer``), so a profiler trace splits the step by stage.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch
from torch.profiler import record_function

from fast_autoaugment_tpu_torch.core.metrics import (
    mixup_batch,
    mixup_cross_entropy,
    smooth_cross_entropy,
    top_k_correct,
)
from fast_autoaugment_tpu_torch.models.layers import at_least_float32
from fast_autoaugment_tpu_torch.ops.optim import (
    OptState,
    Optimizer,
    ema_tensors,
    ema_update,
    init_ema,
    non_bn_mask,
)
from fast_autoaugment_tpu_torch.ops.preprocess import cifar_eval_batch, cifar_train_batch
from fast_autoaugment_tpu_torch.ops.preprocess_imagenet import imagenet_train_batch
from fast_autoaugment_tpu_torch.ops.shake import noise_sites
from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws, check_aug_dispatch

__all__ = ["TrainState", "create_train_state", "cifar_augment_fn", "imagenet_augment_fn",
           "make_train_step", "make_eval_step", "swapped_weights"]

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


def cifar_augment_fn(cutout_length: int, use_policy: bool = True, aug_dispatch: str = "exact",
                     aug_groups: int = 8) -> Callable:
    """The CIFAR/SVHN train stack as an ``augment_fn(images, policy, key,
    draw_source)``: the draws of one ``cifar_train_batch`` call from `key`,
    then the policy (when `use_policy`) and crop/flip/normalize/cutout."""
    check_aug_dispatch(aug_dispatch)

    def augment_fn(images, policy, key, draw_source):
        b, h, w = (int(v) for v in images.shape[:3])
        with record_function("train.sampler"):
            d = draw_source.draws(key, batch=b,
                                  num_sub=int(policy.shape[0]) if use_policy else 1,
                                  num_op=int(policy.shape[1]),
                                  height=h, width=w, dispatch=aug_dispatch, groups=aug_groups,
                                  device=images.device)
        with record_function("train.augment"):
            if not use_policy:
                return cifar_train_batch(images, d.crop, cutout_length=cutout_length)
            return cifar_train_batch(images, d.crop, policy=policy, sub_idx=d.sub_idx,
                                     policy_draws=d.policy, cutout_length=cutout_length)

    return augment_fn


def imagenet_augment_fn(cutout_length: int, use_policy: bool = True,
                        aug_dispatch: str = "exact", aug_groups: int = 8) -> Callable:
    """The ImageNet train stack as an ``augment_fn(images, policy, key,
    draw_source)``, wired as the JAX trainer wires ``imagenet_train_batch``
    (``train/trainer.py:404-410``): the policy when `use_policy`, then
    flip, ColorJitter, lighting, normalize and cutout."""
    check_aug_dispatch(aug_dispatch)

    def augment_fn(images, policy, key, draw_source):
        b, h, w = (int(v) for v in images.shape[:3])
        shape = (int(policy.shape[0]), int(policy.shape[1])) if use_policy else None
        with record_function("train.sampler"):
            d = draw_source.imagenet_draws(key, batch=b, policy_shape=shape, height=h, width=w,
                                           dispatch=aug_dispatch, groups=aug_groups,
                                           device=images.device)
        with record_function("train.augment"):
            return imagenet_train_batch(images, d, policy=policy if use_policy else None,
                                        cutout_length=cutout_length)

    return augment_fn


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
    owns its own dispatch.  A model with noise sites gets its noise from
    ``key_shake`` and ``key_drop`` of the draw source
    (``draw_source.model_noise``), mixup its draws from ``key_mix``
    (``draw_source.mixup_draws``)."""
    src = draw_source or PhiloxDraws()
    sites = noise_sites(model)
    if augment_fn is None:
        augment_fn = cifar_augment_fn(cutout_length, use_policy, aug_dispatch, aug_groups)
    params = list(model.parameters())
    mask = non_bn_mask(model)
    topk = min(5, num_classes)

    def step_fn(state: TrainState, images, labels, policy, key):
        if state.model is not model:
            raise ValueError("the state holds another model than the step was built for")
        model.train()
        dev = images.device
        b = int(images.shape[0])
        noise = lam = None
        with record_function("train.sampler"):
            key_aug, key_model = src.split(src.fold_in(key, state.step, dev), 2, dev)
            if sites or mixup_alpha > 0.0:
                key_mix, key_shake, key_drop = src.split(key_model, 3, dev)
            if sites:
                noise = src.model_noise(sites, b, key_shake, key_drop, dev)
            if mixup_alpha > 0.0:
                lam, perm = src.mixup_draws(key_mix, b, mixup_alpha, dev)
        x = augment_fn(images, policy, key_aug, src)
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
            optimizer.step(params, grads, state.opt_state, mask)
            state.step += 1
            if state.ema is not None and ema_mu > 0.0:
                ema_update(state.ema, ema_tensors(model), ema_mu, state.step)  # 1-based
            with torch.no_grad():
                batch = labels.shape[0]
                metrics = {
                    "loss": loss.detach() * batch,
                    "top1": top_k_correct(logits, labels, 1).to(torch.float32),
                    "top5": top_k_correct(logits, labels, topk).to(torch.float32),
                    "num": torch.full((), float(batch), device=dev),
                }
        return state, metrics

    return step_fn


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
