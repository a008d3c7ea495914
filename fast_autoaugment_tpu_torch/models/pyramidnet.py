"""PyramidNet with ShakeDrop (``fast_autoaugment_tpu/models/pyramidnet.py``).

The reference ``networks/pyramidnet.py:15-248``: additive pyramidal width
growth (``addrate = alpha / (3 n)``), BN-led basic or bottleneck blocks,
per-block ShakeDrop death rates rising linearly to 0.5
(``pyramidnet.py:135``), average-pool downsampling and zero-channel-padded
shortcut adds.  The widths accumulate as floats and round per block, as the
reference's do (:func:`pyramidnet_plan`, a copy of the JAX package's).

Module names are the flax ones (``conv1``, ``bn1``, ``block{idx}`` with
``bn{k}``, ``conv{k}`` and ``shake_drop``, ``bn_final``, ``fc``), so
``utils/interop.py`` maps the two trees name for name.  Convolutions are
drawn He-normal with fan-out, the dense head is flax's default.  The model
takes ``[N, 3, H, W]`` in any memory format and, in train mode, its noise:
``model(x, noise=...)`` (``ops/shake.py``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from fast_autoaugment_tpu_torch.models.layers import (
    BatchNorm,
    at_least_float32,
    global_avg_pool,
    he_normal_fanout_,
    lecun_normal_,
)
from fast_autoaugment_tpu_torch.ops.shake import ModelNoise, NoiseSite, number_noise_sites

__all__ = ["PyramidNet", "pyramidnet_plan", "init_pyramid_"]


def pyramidnet_plan(depth: int, alpha: float, bottleneck: bool):
    """Per-block ``(width, stride, p_shakedrop)`` and the expansion,
    replicating the reference's float accumulation (``pyramidnet.py:128-214``)."""
    if bottleneck:
        n = (depth - 2) // 9
        expansion = 4
    else:
        n = (depth - 2) // 6
        expansion = 1
    total = 3 * n
    addrate = alpha / (3.0 * n)
    ps = [(0.5 / total) * (i + 1) for i in range(total)]
    plan = []
    featuremap_dim = 16.0
    for stage in range(3):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            featuremap_dim += addrate
            plan.append((int(round(featuremap_dim)), stride, ps.pop(0)))
    assert not ps
    return plan, expansion


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2, bias=False)


def _shortcut_add(x: torch.Tensor, out: torch.Tensor, stride: int) -> torch.Tensor:
    """Average-pool downsampling (2x2, stride 2, ``ceil_mode``: a window at an
    odd edge is divided by its count of real pixels) and zero-channel
    padding of the input, added to the block's output (reference
    ``pyramidnet.py:41-60,98-117``)."""
    shortcut = x
    if stride != 1:
        shortcut = F.avg_pool2d(x, 2, 2, ceil_mode=True, count_include_pad=False)
    pad_c = out.shape[1] - shortcut.shape[1]
    if pad_c > 0:
        shortcut = F.pad(shortcut, (0, 0, 0, 0, 0, pad_c))
    return out + shortcut


class PyramidBasicBlock(nn.Module):
    """BN-conv3-BN-relu-conv3-BN, ShakeDrop (reference ``pyramidnet.py:15-60``)."""

    def __init__(self, in_ch: int, width: int, stride: int, p_shakedrop: float):
        super().__init__()
        self.stride = stride
        self.bn1 = BatchNorm(in_ch)
        self.conv1 = _conv(in_ch, width, 3, stride)
        self.bn2 = BatchNorm(width)
        self.conv2 = _conv(width, width, 3)
        self.bn3 = BatchNorm(width)
        self.shake_drop = NoiseSite("shake_drop", p_shakedrop)

    def forward(self, x: torch.Tensor, noise: ModelNoise | None = None) -> torch.Tensor:
        out = self.conv1(self.bn1(x))
        out = self.conv2(torch.relu(self.bn2(out)))
        out = self.shake_drop(self.bn3(out), noise=noise)
        return _shortcut_add(x, out, self.stride)


class PyramidBottleneck(nn.Module):
    """BN-1x1-BN-relu-3x3-BN-relu-1x1-BN, ShakeDrop (reference
    ``pyramidnet.py:63-118``)."""

    def __init__(self, in_ch: int, width: int, stride: int, p_shakedrop: float,
                 expansion: int = 4):
        super().__init__()
        self.stride = stride
        self.bn1 = BatchNorm(in_ch)
        self.conv1 = _conv(in_ch, width, 1)
        self.bn2 = BatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn3 = BatchNorm(width)
        self.conv3 = _conv(width, width * expansion, 1)
        self.bn4 = BatchNorm(width * expansion)
        self.shake_drop = NoiseSite("shake_drop", p_shakedrop)

    def forward(self, x: torch.Tensor, noise: ModelNoise | None = None) -> torch.Tensor:
        out = self.conv1(self.bn1(x))
        out = self.conv2(torch.relu(self.bn2(out)))
        out = self.conv3(torch.relu(self.bn3(out)))
        out = self.shake_drop(self.bn4(out), noise=noise)
        return _shortcut_add(x, out, self.stride)


class PyramidNet(nn.Module):
    """PyramidNet-{depth} with widening `alpha` for 32x32 inputs (the CIFAR
    stem: a 3x3 convolution to 16 channels and BatchNorm)."""

    def __init__(self, depth: int, alpha: float, num_classes: int, bottleneck: bool = True):
        super().__init__()
        plan, expansion = pyramidnet_plan(depth, alpha, bottleneck)
        self.conv1 = _conv(3, 16, 3)
        self.bn1 = BatchNorm(16)
        in_ch = 16
        for idx, (width, stride, p) in enumerate(plan):
            block = (PyramidBottleneck(in_ch, width, stride, p, expansion) if bottleneck
                     else PyramidBasicBlock(in_ch, width, stride, p))
            self.add_module(f"block{idx}", block)
            in_ch = width * expansion
        self.num_blocks = len(plan)
        self.bn_final = BatchNorm(in_ch)
        self.fc = nn.Linear(in_ch, num_classes)
        number_noise_sites(self)

    def forward(self, x: torch.Tensor, noise: ModelNoise | None = None) -> torch.Tensor:
        out = self.bn1(self.conv1(x))
        for idx in range(self.num_blocks):
            out = getattr(self, f"block{idx}")(out, noise=noise)
        out = global_avg_pool(torch.relu(self.bn_final(out)))
        return self.fc(at_least_float32(out))


@torch.no_grad()
def init_pyramid_(model: PyramidNet, generator: torch.Generator | None = None) -> PyramidNet:
    """The JAX package's init: convolutions He-normal fan-out, BatchNorm at
    scale 1 and bias 0, the head ``lecun_normal``."""
    he_normal_fanout_(model, generator)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    lecun_normal_(model.fc, generator)
    return model
