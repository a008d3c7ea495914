"""WideResNet (WRN-d-k) in PyTorch (``fast_autoaugment_tpu/models/wideresnet.py``).

Pre-activation wide basic blocks with conv bias, BatchNorm with torch
momentum 0.9 (reference ``wideresnet.py:24``), a 1x1-conv shortcut on a
change of shape, global average pooling and a float32 dense head; dropout
is 0 in every configuration the repo runs, so it is left out.  The
parameter names are the reference's torch names (``conv1``,
``layer{s}.{i}.bn1``, ``shortcut.0``, ``bn1``, ``linear``), so the JAX
package's importer (``utils/interop.py _import_wideresnet``) reads this
model's ``state_dict`` as it reads a reference checkpoint.

The model takes ``[N, 3, H, W]`` in any memory format; the port runs it in
``channels_last`` (NHWC in memory, the JAX package's layout and cuDNN's
fast one on Hopper).
"""

from __future__ import annotations

import torch
from torch import nn

from fast_autoaugment_tpu_torch.models.layers import BatchNorm, at_least_float32, global_avg_pool

__all__ = ["WideBasic", "WideResNet"]

_BN_MOMENTUM = 0.9  # torch convention, reference wideresnet.py:24


def _conv(in_features: int, features: int, kernel: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(in_features, features, kernel, stride=stride,
                     padding=kernel // 2, bias=True)


class WideBasic(nn.Module):
    """Pre-activation wide basic block (reference ``wideresnet.py:21-41``)."""

    def __init__(self, in_features: int, features: int, stride: int):
        super().__init__()
        self.bn1 = BatchNorm(in_features, momentum=_BN_MOMENTUM)
        self.conv1 = _conv(in_features, features, 3, 1)
        self.bn2 = BatchNorm(features, momentum=_BN_MOMENTUM)
        self.conv2 = _conv(features, features, 3, stride)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_features != features:
            self.shortcut = nn.Sequential(_conv(in_features, features, 1, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(torch.relu(self.bn1(x)))
        out = self.conv2(torch.relu(self.bn2(out)))
        return out + self.shortcut(x)


class WideResNet(nn.Module):
    """WRN-depth-widen_factor; depth = 6n + 4 (reference ``wideresnet.py:44-85``)."""

    def __init__(self, depth: int, widen_factor: int, num_classes: int,
                 in_channels: int = 3):
        super().__init__()
        if (depth - 4) % 6 != 0:
            raise ValueError(f"WideResNet depth must be 6n+4, got {depth}")
        n = (depth - 4) // 6
        k = widen_factor
        stages = (16, 16 * k, 32 * k, 64 * k)
        self.conv1 = _conv(in_channels, stages[0], 3, 1)
        in_features = stages[0]
        for stage, (features, stride) in enumerate(zip(stages[1:], (1, 2, 2)), start=1):
            blocks = []
            for i in range(n):
                blocks.append(WideBasic(in_features, features, stride if i == 0 else 1))
                in_features = features
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
        self.bn1 = BatchNorm(stages[3], momentum=_BN_MOMENTUM)
        self.linear = nn.Linear(stages[3], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        out = self.layer3(self.layer2(self.layer1(out)))
        out = global_avg_pool(torch.relu(self.bn1(out)))
        return self.linear(at_least_float32(out))
