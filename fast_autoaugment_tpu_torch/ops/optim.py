"""Optimizers, weight decay, clipping and EMA over lists of tensors
(``fast_autoaugment_tpu/ops/optim.py``).

The JAX package builds an optax chain (``build_optimizer``, ``:110``) that
reproduces the reference's update (``train.py:47-93``):

1. ``add_decayed_weights(decay)`` on every parameter that is not a
   BatchNorm scale or bias (the gradient of the reference's manual L2 term
   ``decay/2 * sum(p**2)``, ``train.py:40,61``);
2. ``clip_by_global_norm(clip)`` when ``clip > 0`` (default 5.0), after the
   decay is folded in (``train.py:63-65``);
3. ``trace(momentum, nesterov)`` and ``-lr(count)`` (torch-semantics SGD
   with Nesterov momentum), or :func:`rmsprop_tf`.

:class:`Optimizer` is that chain as plain functions over the lists of a
model's parameters and gradients (``torch._foreach_*``), one float32
operation at a time in optax's order.  It keeps its own step count, from
which it reads the learning rate, as optax's ``scale_by_learning_rate``
does: :meth:`Optimizer.step` reads it on the host and hands it to
:meth:`Optimizer.update` as a 0-dim float32 tensor on the parameters'
device, the form a captured CUDA graph reads at replay time (the graph's
dispatcher stages each step's rate into such a tensor itself).
``torch.optim.SGD`` is not used: it folds its weight decay in
before any clip, and decays every parameter it is given, where the chain
masks BatchNorm's.  Unlike optax the update is in place: the parameters,
the gradient lists (which the caller hands over) and the optimizer state
are overwritten, so a step allocates no second copy of the model.

The non-BN mask is keyed on the port's modules: a parameter is decayed
unless it belongs to a :class:`~fast_autoaugment_tpu_torch.models.layers.
BatchNorm` (the JAX package keys on "bn" in the module path, which names
the same parameters in every ported model).

EMA (reference ``common.py:28-51``): a shadow of the parameters and
BatchNorm statistics with TF warmup ``mu_t = min(mu, (1+step)/(10+step))``,
computed on the host (:func:`ema_coefficients`) and applied from a device
tensor (:func:`ema_apply`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

__all__ = ["non_bn_mask", "OptState", "Optimizer", "build_optimizer", "rmsprop_tf",
           "init_ema", "ema_coefficients", "ema_apply", "ema_update", "ema_tensors"]


def non_bn_mask(model: nn.Module) -> list[bool]:
    """One flag per parameter of ``model.parameters()``: True where weight
    decay applies, False for the scale and bias of BatchNorm layers."""
    bn_params = {id(p) for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
                 for p in m.parameters(recurse=False)}
    return [id(p) not in bn_params for p in model.parameters()]


@dataclass
class OptState:
    """The chain's state: its step count and the momentum trace (SGD), or
    the mean square and momentum buffers (RMSprop)."""

    count: int = 0
    trace: list[torch.Tensor] = field(default_factory=list)
    ms: list[torch.Tensor] = field(default_factory=list)
    mom: list[torch.Tensor] = field(default_factory=list)


class Optimizer:
    """Weight decay -> clip -> core update, the JAX chain's order.

    ``kind`` is ``"sgd"`` (``momentum``, ``nesterov``) or ``"rmsprop"``
    (:func:`rmsprop_tf`).  ``lr`` is a function of the optimizer's 0-based
    count, or a constant."""

    def __init__(self, kind: str, lr: Callable[[int], float] | float, *, decay: float = 0.0,
                 clip: float = 5.0, momentum: float = 0.9, nesterov: bool = True,
                 alpha: float = 0.9, eps: float = 1e-3):
        if kind not in ("sgd", "rmsprop"):
            raise ValueError(f"invalid optimizer type {kind!r}")
        self.kind, self.lr = kind, lr
        self.decay, self.clip = float(decay), float(clip)
        self.momentum, self.nesterov = float(momentum), bool(nesterov)
        self.alpha, self.eps = float(alpha), float(eps)

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init(self, params: list[torch.Tensor]) -> OptState:
        if self.kind == "sgd":
            return OptState(trace=[torch.zeros_like(p) for p in params])
        return OptState(ms=[torch.ones_like(p) for p in params],
                        mom=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: OptState,
             decay_mask: list[bool]) -> OptState:
        """Update `params` in place from `grads` (overwritten) and `state`
        (updated in place and returned) at ``lr(state.count)``, and count
        the step."""
        lr = torch.tensor(self.lr_at(state.count), dtype=torch.float32)  # a float32 value
        self.update(params, grads, state, decay_mask, lr.to(params[0].device, non_blocking=True))
        state.count += 1
        return state

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: OptState,
               decay_mask: list[bool], lr: torch.Tensor) -> None:
        """The chain's update at the rate `lr` (a 0-dim float32 tensor on the
        parameters' device), in place, with device work only: the step count
        is the caller's (:meth:`step` advances it)."""
        if self.decay > 0:  # add_decayed_weights, masked
            decayed = [i for i, m in enumerate(decay_mask) if m]
            if decayed:
                scaled = torch._foreach_mul([params[i] for i in decayed], self.decay)
                torch._foreach_add_([grads[i] for i in decayed], scaled)
        if self.clip > 0:  # clip_by_global_norm: g if |g| < clip else g / |g| * clip
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            clipped = torch._foreach_div(grads, norm)
            torch._foreach_mul_(clipped, self.clip)
            keep = norm < self.clip
            for g, c in zip(grads, clipped):
                torch.where(keep, g, c, out=g)
        if self.kind == "sgd":
            # trace: t <- g + m * t; nesterov update g + m * t
            torch._foreach_mul_(state.trace, self.momentum)
            torch._foreach_add_(state.trace, grads)
            if self.nesterov:
                upd = torch._foreach_mul(state.trace, self.momentum)
                torch._foreach_add_(upd, grads)
            else:
                upd = [t.clone() for t in state.trace]
            torch._foreach_mul_(upd, torch.neg(lr))
        else:
            upd = _rmsprop_update(grads, state, lr, self.alpha, self.momentum, self.eps)
        torch._foreach_add_(params, upd)


def _rmsprop_update(grads, state: OptState, lr: torch.Tensor, alpha: float, momentum: float,
                    eps: float) -> list[torch.Tensor]:
    # ms <- ms + (g^2 - ms) * (1 - alpha)
    d = torch._foreach_mul(grads, grads)
    torch._foreach_sub_(d, state.ms)
    torch._foreach_mul_(d, 1.0 - alpha)
    torch._foreach_add_(state.ms, d)
    # mom <- momentum * mom + lr * g / sqrt(ms + eps)
    den = torch._foreach_add(state.ms, eps)
    torch._foreach_sqrt_(den)
    step = torch._foreach_mul(grads, lr)
    torch._foreach_div_(step, den)
    torch._foreach_mul_(state.mom, momentum)
    torch._foreach_add_(state.mom, step)
    return torch._foreach_neg(state.mom)


def rmsprop_tf(learning_rate: Callable[[int], float] | float, alpha: float = 0.9,
               momentum: float = 0.9, eps: float = 1e-3) -> Optimizer:
    """TF-semantics RMSprop (reference ``tf_port/rmsprop.py:75-100``), with
    no decay or clip: ``ms <- ms + (g^2 - ms) * (1 - alpha)`` (ms starts at
    ones), ``mom <- momentum * mom + lr * g / sqrt(ms + eps)``, update
    ``-mom``."""
    return Optimizer("rmsprop", learning_rate, clip=0.0, momentum=momentum, alpha=alpha,
                     eps=eps)


def build_optimizer(optimizer_conf: Any, learning_rate: Callable[[int], float]) -> Optimizer:
    """The chain from the conf schema ``optimizer{type, decay, (momentum),
    (nesterov), (clip)}``."""
    kind = optimizer_conf["type"]
    decay = float(optimizer_conf.get("decay", 0.0))
    clip = float(optimizer_conf.get("clip", 5.0))
    if kind == "sgd":
        return Optimizer("sgd", learning_rate, decay=decay, clip=clip,
                         momentum=float(optimizer_conf.get("momentum", 0.9)),
                         nesterov=bool(optimizer_conf.get("nesterov", True)))
    if kind == "rmsprop":
        return Optimizer("rmsprop", learning_rate, decay=decay, clip=clip, momentum=0.9,
                         alpha=0.9, eps=1e-3)
    raise ValueError(f"invalid optimizer type {kind!r}")


def ema_tensors(model: nn.Module) -> dict[str, torch.Tensor]:
    """The tensors an EMA shadows: every parameter and the BatchNorm running
    statistics (the JAX ``{"params", "batch_stats"}``), by ``state_dict``
    name, as views of the model's own tensors."""
    return {k: v for k, v in model.state_dict(keep_vars=True).items()
            if not k.endswith("num_batches_tracked")}


def init_ema(model: nn.Module) -> dict[str, torch.Tensor]:
    """A shadow: a copy of :func:`ema_tensors`."""
    return {k: v.detach().clone() for k, v in ema_tensors(model).items()}


def ema_coefficients(mu: float, step: int) -> tuple[float, float]:
    """``(mu_t, 1 - mu_t)`` with TF warmup ``mu_t = min(mu, (1 + step) /
    (10 + step))`` in float32 (reference ``common.py:39-51``); `step` is the
    1-based global step (``train.py:70``)."""
    s = np.float32(step)
    mu_t = np.float32(min(np.float32(mu), (np.float32(1.0) + s) / (np.float32(10.0) + s)))
    return float(mu_t), float(np.float32(1.0) - mu_t)


@torch.no_grad()
def ema_apply(shadow: dict[str, torch.Tensor], new: dict[str, torch.Tensor],
              coefficients: torch.Tensor) -> dict[str, torch.Tensor]:
    """``shadow <- (1 - mu_t) * new + mu_t * shadow`` in place, with
    ``coefficients`` a float32 tensor ``[mu_t, 1 - mu_t]`` on the shadow's
    device (:func:`ema_coefficients`), each product and the sum rounded to
    float32 on its own."""
    keys = list(shadow)
    a = torch._foreach_mul([new[k].detach() for k in keys], coefficients[1])
    b = torch._foreach_mul([shadow[k] for k in keys], coefficients[0])
    torch._foreach_add_(a, b)
    for k, v in zip(keys, a):
        shadow[k].copy_(v)
    return shadow


def ema_update(shadow: dict[str, torch.Tensor], new: dict[str, torch.Tensor], mu: float,
               step: int) -> dict[str, torch.Tensor]:
    """:func:`ema_apply` with the coefficients of 1-based `step`."""
    dev = next(iter(shadow.values())).device
    coefficients = torch.tensor(ema_coefficients(mu, step), dtype=torch.float32)
    return ema_apply(shadow, new, coefficients.to(dev, non_blocking=True))
