"""Shared layers and initializers (``fast_autoaugment_tpu/models/layers.py``).

The reference WideResNet inherits PyTorch's *default* parameter init (its
custom ``conv_init`` is commented out, ``wideresnet.py:66``): conv and
linear weights and biases ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``
(kaiming-uniform with ``a = sqrt(5)``).  :func:`torch_default_init_`
applies it explicitly, from a ``torch.Generator``, so a seed fixes the
weights.  He-normal fan-out waits for ResNet (ROADMAP item 9).

BatchNorm keeps the torch momentum convention (``momentum`` is the weight
of the NEW batch statistic), ``eps = 1e-5`` and float32 statistics.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["BatchNorm", "global_avg_pool", "torch_default_init_"]


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW (any memory format) with statistics in float32:
    the input is normalized in float32 and the output cast back to the
    input's type."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.float32)).to(x.dtype)


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
