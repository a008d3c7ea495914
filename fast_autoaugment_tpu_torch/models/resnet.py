"""ResNet (CIFAR and ImageNet variants) in PyTorch (``fast_autoaugment_tpu/models/resnet.py``).

The torchvision-style pre-2016 ResNet of the reference
(``networks/resnet.py:13-180``): BasicBlock and Bottleneck, a CIFAR stem
(3x3, 16 planes, three stages) for depth 6n+2 (basic) or 9n+2
(bottleneck), and an ImageNet stem (7x7/2, max-pool 3x3/2 with padding 1,
four stages) for depths 18, 34, 50, 101, 152 and 200.  Convolutions have no
bias and are drawn He-normal with fan-out; BatchNorm starts at scale 1 and
bias 0 with torch momentum 0.1 (the JAX package's default); the shortcut
of a block that changes shape is a 1x1 convolution and a BatchNorm; the
dense head keeps PyTorch's default init, as the reference's does.

The parameter names are the reference's torch names (``conv1``, ``bn1``,
``layer{s}.{i}.conv{k}``, ``layer{s}.{i}.bn{k}``, ``layer{s}.{i}.downsample.0``
and ``.1``, ``fc``), so the JAX package's importer
(``utils/interop.py _import_resnet``) reads this model's ``state_dict`` as
it reads a reference checkpoint.  The model takes ``[N, 3, H, W]`` in any
memory format; the port runs it in ``channels_last``.
"""

from __future__ import annotations

import torch
from torch import nn

from fast_autoaugment_tpu_torch.models.layers import BatchNorm, at_least_float32, global_avg_pool

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "IMAGENET_LAYERS"]

IMAGENET_LAYERS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}


def _conv(in_features: int, features: int, kernel: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(in_features, features, kernel, stride=stride, padding=kernel // 2,
                     bias=False)


def _downsample(in_features: int, features: int, stride: int) -> nn.Sequential | None:
    if stride == 1 and in_features == features:
        return None
    return nn.Sequential(_conv(in_features, features, 1, stride), BatchNorm(features))


class BasicBlock(nn.Module):
    """Two 3x3 convolutions (reference ``resnet.py:13-45``)."""

    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_features, features, 3, stride)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3, 1)
        self.bn2 = BatchNorm(features)
        self.downsample = _downsample(in_features, features, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1, 3x3 (strided), 1x1 to 4x the width (reference ``resnet.py:48-86``)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        out_features = features * self.expansion
        self.conv1 = _conv(in_features, features, 1, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNorm(features)
        self.conv3 = _conv(features, out_features, 1, 1)
        self.bn3 = BatchNorm(out_features)
        self.downsample = _downsample(in_features, out_features, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNet(nn.Module):
    """``dataset`` ``"cifar"`` (depth 6n+2 basic, or 9n+2 with
    ``bottleneck``) or ``"imagenet"`` (depth in :data:`IMAGENET_LAYERS`)."""

    def __init__(self, dataset: str, depth: int, num_classes: int, bottleneck: bool = False):
        super().__init__()
        if dataset.startswith("cifar") or dataset == "svhn":
            per, kind = (9, "bottleneck") if bottleneck else (6, "basic")
            if depth < per + 2 or (depth - 2) % per:
                raise ValueError(f"CIFAR ResNet depth must be {per}n+2, got {depth}")
            counts, widths = ((depth - 2) // per,) * 3, (16, 32, 64)
            self.conv1 = _conv(3, 16, 3, 1)
            self.bn1 = BatchNorm(16)
            self.maxpool = None
            in_features = 16
        elif dataset == "imagenet":
            if depth not in IMAGENET_LAYERS:
                raise ValueError(f"ImageNet ResNet depth must be one of "
                                 f"{sorted(IMAGENET_LAYERS)}, got {depth}")
            kind, counts = IMAGENET_LAYERS[depth]
            widths = (64, 128, 256, 512)
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            self.bn1 = BatchNorm(64)
            # pads with -inf, as flax's max_pool does
            self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
            in_features = 64
        else:
            raise ValueError(f"unknown dataset {dataset!r}")
        block = Bottleneck if kind == "bottleneck" else BasicBlock
        for stage, (width, count) in enumerate(zip(widths, counts)):
            blocks = []
            for i in range(count):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(in_features, width, stride))
                in_features = width * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(widths)
        self.fc = nn.Linear(in_features, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        if self.maxpool is not None:
            out = self.maxpool(out)
        for stage in range(1, self.num_stages + 1):
            out = getattr(self, f"layer{stage}")(out)
        return self.fc(at_least_float32(global_avg_pool(out)))
