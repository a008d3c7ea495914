"""Learning-rate schedules as plain functions of the step
(``fast_autoaugment_tpu/ops/schedules.py``).

The reference steps its torch schedulers once per batch with a fractional
epoch (``train.py:90-91``), so every schedule here is a function of the
fractional epoch ``t = step / steps_per_epoch`` (reference
``train.py:158-174``, ``lr_scheduler.py:6-27``):

- cosine: ``base * (1 + cos(pi t / T)) / 2`` (CosineAnnealingLR, eta_min 0);
- resnet step: x0.1 at {30, 60, 80} for 90 epochs, {90, 180, 240} for 270;
- efficientnet: ``0.97 ** floor((t + warmup) / 2.4)``;
- the gradual warmup wrapper: linear ``base -> base * multiplier`` over
  ``warmup_epoch``, then the inner schedule shifted by ``-warmup_epoch``
  and scaled by the multiplier.

The arithmetic is float32, one numpy operation at a time, in the form XLA
compiles the JAX package's schedule into: a division by a constant is a
multiplication by its float32 reciprocal (``step * f32(1 / steps_per_epoch)``),
``pi * t / T`` is ``t * f32(pi / T)``, and a power is float64 ``pow`` rounded
to float32.  So a step's rate is the float32 value the JAX step multiplies
by, except where XLA's own float32 cosine is one ulp from the correctly
rounded one (``tests/test_torch_optim.py`` states the bound).  The functions
run on the host: the optimizer reads the rate as a Python float.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

__all__ = ["cosine", "multistep", "exponential_efficientnet", "warmup_wrap", "build_schedule"]

Schedule = Callable  # t (fractional epoch, float32) -> lr (float32)

_F = np.float32


def _recip(c: float) -> np.float32:
    """The float32 reciprocal XLA multiplies by for a division by `c`."""
    return _F(1.0) / _F(c)


def _cos(x) -> np.float32:
    return _F(np.cos(np.float64(x)))


def _pow(base: float, exponent) -> np.float32:
    return _F(np.power(np.float64(_F(base)), np.float64(exponent)))


def cosine(base_lr: float, total_epochs: float) -> Schedule:
    def fn(t):
        return _F(base_lr) * (_F(1.0) + _cos(_F(t) * (_F(np.pi) / _F(total_epochs)))) / _F(2.0)

    return fn


def multistep(base_lr: float, milestones: Sequence[float], gamma: float = 0.1) -> Schedule:
    ms = np.asarray(milestones, np.float32)

    def fn(t):
        count = _F(np.sum(_F(t) >= ms))
        return _F(base_lr) * _pow(gamma, count)

    return fn


def exponential_efficientnet(base_lr: float, warmup_epoch: float) -> Schedule:
    """LambdaLR ``0.97 ** int((x + warmup_epoch) / 2.4)`` (``train.py:163-164``)
    where x is the post-warmup shifted epoch."""

    def fn(t_shifted):
        k = np.floor((_F(t_shifted) + _F(warmup_epoch)) * _recip(2.4))
        return _F(base_lr) * _pow(0.97, k)

    return fn


def warmup_wrap(inner: Schedule, base_lr: float, multiplier: float, warmup_epoch: float,
                inner_base_scale: bool = True) -> Schedule:
    """GradualWarmupScheduler semantics: for ``t <= warmup_epoch``,
    ``base * ((multiplier - 1) * t / warmup + 1)``; after it
    ``multiplier * inner(t - warmup_epoch)``."""

    def fn(t):
        t = _F(t)
        if t <= _F(warmup_epoch):
            return _F(base_lr) * (_F(multiplier - 1.0) * t * _recip(warmup_epoch) + _F(1.0))
        after = inner(t - _F(warmup_epoch))
        return _F(multiplier) * after if inner_base_scale else after

    return fn


def build_schedule(conf: Any, steps_per_epoch: int, world_lr_scale: float = 1.0) -> Callable:
    """``lr(step)`` from the conf schema ``{lr, epoch, lr_schedule{type,
    warmup{multiplier, epoch}}}``, a function of the 0-based optimizer
    step that returns a Python float (a float32 value).  `world_lr_scale`
    is the linear scaling by data-parallel world size (``train.py:117``)."""
    base_lr = float(conf["lr"]) * world_lr_scale
    total_epochs = float(conf["epoch"])
    sched_conf = conf.get("lr_schedule", {}) or {}
    kind = sched_conf.get("type", "cosine") if hasattr(sched_conf, "get") else "cosine"
    warmup = sched_conf.get("warmup", None) if hasattr(sched_conf, "get") else None
    warmup_epoch = float(warmup["epoch"]) if warmup else 0.0

    if kind == "cosine":
        inner = cosine(base_lr, total_epochs)
    elif kind == "resnet":
        if int(total_epochs) == 90:
            inner = multistep(base_lr, (30, 60, 80))
        elif int(total_epochs) == 270:
            inner = multistep(base_lr, (90, 180, 240))
        else:
            raise ValueError(f"invalid epoch={total_epochs} for resnet schedule")
    elif kind == "efficientnet":
        inner = exponential_efficientnet(base_lr, warmup_epoch)
    else:
        raise ValueError(f"invalid lr_schedule {kind!r}")

    if warmup and warmup_epoch > 0:
        epoch_fn = warmup_wrap(inner, base_lr, float(warmup["multiplier"]), warmup_epoch)
    else:
        epoch_fn = inner

    def lr_at_step(step) -> float:
        return float(epoch_fn(_F(step) * _recip(steps_per_epoch)))

    return lr_at_step
