"""Shared layers and initializers (``fast_autoaugment_tpu/models/layers.py``).

The reference WideResNet inherits PyTorch's *default* parameter init (its
custom ``conv_init`` is commented out, ``wideresnet.py:66``): conv and
linear weights and biases ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``
(kaiming-uniform with ``a = sqrt(5)``).  :func:`torch_default_init_`
applies it explicitly, from a ``torch.Generator``, so a seed fixes the
weights.  ImageNet ResNet draws its convolutions He-normal with fan-out
(``resnet.py:126-132``): :func:`he_normal_fanout_`.

BatchNorm keeps the torch momentum convention (``momentum`` is the weight
of the NEW batch statistic), ``eps = 1e-5`` and statistics in at least
float32 (:func:`at_least_float32`: float32 for float32 and narrower inputs,
float64 for a float64 model, which the tests use as an exact oracle).  In
train mode it normalizes with the batch mean and the *biased* batch
variance and updates its running statistics with those same two values,
as the JAX package's flax ``BatchNorm`` does
(``running = (1 - momentum) * running + momentum * batch``).
``nn.BatchNorm2d`` would put the unbiased variance into ``running_var``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["BatchNorm", "at_least_float32", "global_avg_pool", "torch_default_init_",
           "he_normal_fanout_"]


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, or in its own type where that is wider."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW (any memory format) with statistics in at least
    float32: the input is normalized in float32 (or wider) and the output
    cast back to the input's type.  Train mode updates ``running_mean`` and ``running_var``
    with the batch mean and biased variance (flax's rule) and counts the
    update in ``num_batches_tracked``."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = at_least_float32(x)
        if not self.training:
            dt = x32.dtype
            return F.batch_norm(x32, self.running_mean.to(dt), self.running_var.to(dt),
                                self.weight.to(dt), self.bias.to(dt), False, 0.0,
                                self.eps).to(x.dtype)
        # F.batch_norm updates the running buffers in its own kernel, with
        # the UNBIASED variance: (1 - m) * rv + m * var * n / (n - 1).  The
        # flax rule wants the biased one, so that [C]-sized result is
        # rescaled; the activations are not read a second time.  It goes to
        # a copy: autograd keeps the tensor it was given for the backward.
        n = x32.numel() // x32.shape[1]
        var = self.running_var.clone()
        out = F.batch_norm(x32, self.running_mean, var, self.weight.to(x32.dtype),
                           self.bias.to(x32.dtype), True, self.momentum, self.eps)
        with torch.no_grad():
            kept = self.running_var * (1.0 - self.momentum)
            self.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
            self.num_batches_tracked.add_(1)
        return out.to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW global average pool -> ``[N, C]``."""
    return x.mean(dim=(2, 3))


@torch.no_grad()
def torch_default_init_(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """PyTorch's default init for every conv and linear layer of `module`
    (weight and bias ``U(+-1/sqrt(fan_in))``), BatchNorm at scale 1, bias 0,
    running mean 0 and variance 1; drawn from `generator` on the CPU, in the
    order of ``module.modules()``, then copied to each parameter's device."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
            for p in (m.weight, m.bias):
                if p is not None:
                    u = torch.empty(p.shape, dtype=torch.float32).uniform_(
                        -bound, bound, generator=generator)
                    p.copy_(u)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module


@torch.no_grad()
def he_normal_fanout_(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """He-normal fan-out for every conv of `module`: ``N(0, 2 / fan_out)``
    with ``fan_out = k * k * out_channels`` (the JAX package's
    ``he_normal_fanout``, reference ``resnet.py:126-132``); drawn from
    `generator` on the CPU in the order of ``module.modules()``.  Other
    layers are left as they are."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            w = torch.empty(m.weight.shape, dtype=torch.float32).normal_(
                0.0, math.sqrt(2.0 / fan_out), generator=generator)
            m.weight.copy_(w)
    return module
