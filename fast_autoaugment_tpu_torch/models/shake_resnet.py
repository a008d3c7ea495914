"""Shake-Shake ResNet and ResNeXt, 26 layers in 3 stages
(``fast_autoaugment_tpu/models/shake_resnet.py``).

The reference ``networks/shakeshake/shake_resnet.py:12-81`` and
``shake_resnext.py:12-84``: each block computes two parallel branches and
mixes them with ShakeShake (``ops/shake.py``: per-sample forward alpha, a
fresh backward beta; the 0.5 mix in eval mode).  A block that changes the
width adds the two-path ``Shortcut`` (reference ``shakeshake.py:29-48``);
the others add their input.  Convolutions have no bias (the stem's has one,
at 0) and are drawn He-normal with fan-out; the dense head is flax's
default (``lecun_normal``, bias 0).  The reference also registers dead
shortcuts on blocks of equal width (its ``and/or`` slip,
``shake_resnet.py:17``); they are left out, as in the JAX package.

Module names are the flax ones (``c_in``, ``s{stage}_{i}_branch1`` and
``_branch2`` with ``conv{k}``/``bn{k}``, ``s{stage}_{i}_mix``,
``s{stage}_{i}_shortcut`` with ``conv1``, ``conv2``, ``bn``, ``fc_out``), so
``utils/interop.py`` maps the two trees name for name.  The model takes
``[N, 3, H, W]`` in any memory format and, in train mode, its noise:
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

__all__ = ["Shortcut", "ShakeResNet", "ShakeResNeXt", "init_shake_"]


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, groups: int = 1,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2, groups=groups,
                     bias=bias)


class Shortcut(nn.Module):
    """Two strided 1x1 paths (reference ``shakeshake.py:29-48``): path 1
    samples the even pixels, path 2 the image shifted by one pixel (crop the
    first row and column, pad one of zeros at the end); the halves are
    concatenated and normalized.  A 1x1 convolution at stride s is the
    subsampling and the convolution in one."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv1 = _conv(in_ch, out_ch // 2, 1, stride)
        self.conv2 = _conv(in_ch, out_ch // 2, 1, stride)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x)
        h2 = F.pad(h, (-1, 1, -1, 1))  # W then H: crop first, pad last
        return self.bn(torch.cat([self.conv1(h), self.conv2(h2)], dim=1))


class _BranchBasic(nn.Module):
    """relu-conv3-BN-relu-conv3-BN (reference ``shake_resnet.py:29-36``)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv1 = _conv(in_ch, out_ch, 3, stride)
        self.bn1 = BatchNorm(out_ch)
        self.conv2 = _conv(out_ch, out_ch, 3)
        self.bn2 = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(torch.relu(x))))
        return self.bn2(self.conv2(h))


class _BranchBottleneck(nn.Module):
    """1x1, grouped 3x3, 1x1 (reference ``shake_resnext.py:29-38``)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int, cardinality: int, stride: int):
        super().__init__()
        self.conv1 = _conv(in_ch, mid_ch, 1)
        self.bn1 = BatchNorm(mid_ch)
        self.conv2 = _conv(mid_ch, mid_ch, 3, stride, groups=cardinality)
        self.bn2 = BatchNorm(mid_ch)
        self.conv3 = _conv(mid_ch, out_ch, 1)
        self.bn3 = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        return self.bn3(self.conv3(h))


class _ShakeNet(nn.Module):
    """The stem, three stages of shake blocks and the head; subclasses say
    what a branch is."""

    def _build(self, stem: int, stages, n_units: int, num_classes: int, branch) -> None:
        self.c_in = _conv(3, stem, 3, bias=True)
        self.blocks: list[tuple[str, bool]] = []
        in_ch = stem
        for stage, out_ch in enumerate(stages):
            for i in range(n_units):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"s{stage}_{i}"
                self.add_module(f"{name}_branch1", branch(in_ch, stage, stride))
                self.add_module(f"{name}_branch2", branch(in_ch, stage, stride))
                self.add_module(f"{name}_mix", NoiseSite("shake_shake"))
                if in_ch != out_ch:
                    self.add_module(f"{name}_shortcut", Shortcut(in_ch, out_ch, stride))
                self.blocks.append((name, in_ch != out_ch))
                in_ch = out_ch
        self.fc_out = nn.Linear(in_ch, num_classes)
        number_noise_sites(self)

    def forward(self, x: torch.Tensor, noise: ModelNoise | None = None) -> torch.Tensor:
        h = self.c_in(x)
        for name, shortcut in self.blocks:
            h1 = getattr(self, f"{name}_branch1")(h)
            h2 = getattr(self, f"{name}_branch2")(h)
            mixed = getattr(self, f"{name}_mix")(h1, h2, noise=noise)
            h0 = getattr(self, f"{name}_shortcut")(h) if shortcut else h
            h = mixed + h0
        h = global_avg_pool(torch.relu(h))
        return self.fc_out(at_least_float32(h))


class ShakeResNet(_ShakeNet):
    """Shake-Shake-{depth} 2x{w_base}d (reference ``shake_resnet.py:39-81``)."""

    def __init__(self, depth: int, w_base: int, num_classes: int):
        super().__init__()
        chs = (w_base, w_base * 2, w_base * 4)
        self._build(16, chs, (depth - 2) // 6, num_classes,
                    lambda in_ch, stage, stride: _BranchBasic(in_ch, chs[stage], stride))


class ShakeResNeXt(_ShakeNet):
    """Shake-Shake-{depth} 2x{w_base}d ResNeXt of `cardinality` groups
    (reference ``shake_resnext.py:42-84``)."""

    def __init__(self, depth: int, w_base: int, cardinality: int, num_classes: int):
        super().__init__()
        n_chs = (64, 128, 256, 1024)
        mids = [n_chs[s] * (w_base // 64) * cardinality for s in range(3)]
        outs = [n_chs[s] * 4 for s in range(3)]
        self._build(n_chs[0], outs, (depth - 2) // 9, num_classes,
                    lambda in_ch, stage, stride: _BranchBottleneck(
                        in_ch, mids[stage], outs[stage], cardinality, stride))


@torch.no_grad()
def init_shake_(model: _ShakeNet, generator: torch.Generator | None = None) -> _ShakeNet:
    """The JAX package's init: convolutions He-normal fan-out, the stem's
    bias 0, BatchNorm at scale 1 and bias 0, the head ``lecun_normal``."""
    he_normal_fanout_(model, generator)
    model.c_in.bias.zero_()
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    lecun_normal_(model.fc_out, generator)
    return model
