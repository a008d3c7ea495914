"""EfficientNet b0-b7 with optional CondConv experts
(``fast_autoaugment_tpu/models/efficientnet.py``).

The reference ``networks/efficientnet_pytorch/model.py``, ``utils.py`` and
``condconv.py`` as the JAX package builds them: the block-string codec
(``utils.py:186-260``), width and depth scaling (``utils.py:160-183``),
mobile inverted bottlenecks with squeeze-and-excitation on the pre-expansion
width, drop-connect scaled by block index with the reference's semantics
(train: a per-sample keep mask *without* rescaling; eval: scale by ``1 - p``;
``utils.py:92-99``), BatchNorm with eps 1e-3 and torch momentum 0.01,
TensorFlow ``SAME`` padding (:class:`~fast_autoaugment_tpu_torch.models.
layers.Conv2dSame`), dropout before the dense head, and CondConv on the last
three block groups (``utils.py:275-279``).

:class:`CondConv` mixes its experts per sample with the routing weights and
runs every sample's convolution in ONE grouped convolution, with the batch
folded into the groups (input ``[1, B C, H, W]``, kernels ``[B Cout, Cin/g,
k, k]``, ``B g`` groups; the reference's own trick, ``condconv.py:145-167``,
which the JAX package gets from ``vmap``).  It pads symmetrically by
``((s - 1) + (k - 1)) // 2``, as the reference's CondConv does
(``condconv.py:30-33``), not ``SAME``.

Init is TensorFlow's, as in the JAX package: convolutions and experts
``N(0, 2 / fan_out)``, the dense head ``U(+-1/sqrt(fan_out))``, routing
xavier-uniform, biases 0.  Module names are the flax ones (``conv_stem``,
``bn0``, ``block{idx}`` with ``expand_conv``, ``bn0``, ``depthwise_conv``,
``bn1``, ``se_reduce``, ``se_expand``, ``project_conv``, ``bn2``,
``routing_fn``; ``conv_head``, ``bn1``, ``fc``).  The model takes ``[N, 3, H,
W]`` in any memory format and, in train mode, its noise: ``model(x,
noise=...)`` (``ops/shake.py``: each drop-connect and the head's dropout).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from fast_autoaugment_tpu_torch.models.layers import (
    BatchNorm,
    Conv2dSame,
    at_least_float32,
    normal_,
    uniform_,
)
from fast_autoaugment_tpu_torch.ops.shake import ModelNoise, NoiseSite, number_noise_sites

__all__ = ["EfficientNet", "efficientnet_params", "BlockArgs", "decode_block_string",
           "round_filters", "round_repeats", "expand_blocks", "CondConv", "MBConvBlock",
           "init_efficientnet_"]

_BN_MOMENTUM = 0.01  # torch convention: 1 - 0.99 (reference utils.py:282, model.py:37)
_BN_EPS = 1e-3


def efficientnet_params(model_name: str):
    """(width, depth, resolution, dropout) per variant (``utils.py:160-172``)."""
    params = {
        "efficientnet-b0": (1.0, 1.0, 224, 0.2),
        "efficientnet-b1": (1.0, 1.1, 240, 0.2),
        "efficientnet-b2": (1.1, 1.2, 260, 0.3),
        "efficientnet-b3": (1.2, 1.4, 300, 0.3),
        "efficientnet-b4": (1.4, 1.8, 380, 0.4),
        "efficientnet-b5": (1.6, 2.2, 456, 0.4),
        "efficientnet-b6": (1.8, 2.6, 528, 0.5),
        "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    }
    return params[model_name]


@dataclass(frozen=True)
class BlockArgs:
    kernel_size: int
    num_repeat: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    se_ratio: Optional[float]
    stride: int
    id_skip: bool = True
    condconv_num_expert: int = 0


# the seven block groups of the EfficientNet backbone (utils.py:266-271)
_BLOCK_STRINGS = [
    "r1_k3_s11_e1_i32_o16_se0.25",
    "r2_k3_s22_e6_i16_o24_se0.25",
    "r2_k5_s22_e6_i24_o40_se0.25",
    "r3_k3_s22_e6_i40_o80_se0.25",
    "r3_k5_s11_e6_i80_o112_se0.25",
    "r4_k5_s22_e6_i112_o192_se0.25",
    "r1_k3_s11_e6_i192_o320_se0.25",
]


def decode_block_string(block_string: str) -> BlockArgs:
    """Block-string codec (``utils.py:186-216``), e.g. 'r2_k5_s22_e6_i24_o40_se0.25'."""
    options = {}
    for op in block_string.split("_"):
        splits = re.split(r"(\d.*)", op)
        if len(splits) >= 2:
            options[splits[0]] = splits[1]
    if len(options["s"]) not in (1, 2):
        raise ValueError(f"bad stride in block string {block_string!r}")
    return BlockArgs(
        kernel_size=int(options["k"]),
        num_repeat=int(options["r"]),
        input_filters=int(options["i"]),
        output_filters=int(options["o"]),
        expand_ratio=int(options["e"]),
        se_ratio=float(options["se"]) if "se" in options else None,
        stride=int(options["s"][0]),
        id_skip="noskip" not in block_string,
    )


def round_filters(filters: int, width_coefficient: float, divisor: int = 8) -> int:
    """Width scaling with 8-divisibility (``utils.py:55-67``)."""
    if not width_coefficient:
        return filters
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    if not depth_coefficient:
        return repeats
    return int(math.ceil(depth_coefficient * repeats))


def expand_blocks(blocks_args, width_coefficient: float,
                  depth_coefficient: float) -> list[BlockArgs]:
    """Width and depth scaling, with the repeats unrolled into a flat list
    of blocks (``model.py:166-180``)."""
    expanded: list[BlockArgs] = []
    for args in blocks_args:
        args = replace(
            args,
            input_filters=round_filters(args.input_filters, width_coefficient),
            output_filters=round_filters(args.output_filters, width_coefficient),
            num_repeat=round_repeats(args.num_repeat, depth_coefficient),
        )
        expanded.append(args)
        for _ in range(args.num_repeat - 1):
            expanded.append(replace(args, input_filters=args.output_filters, stride=1))
    return expanded


class CondConv(nn.Module):
    """A conditionally parameterized convolution (``condconv.py:86-173``):
    ``experts [E, Cout Cin/g k k]`` (each expert an OIHW kernel, flattened as
    the reference stores it), each sample's kernel the mixture of the experts
    by its routing weights, all samples in one grouped convolution (``g`` is
    1, or ``Cin`` for a depthwise one)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, num_experts: int, stride: int = 1,
                 depthwise: bool = False):
        super().__init__()
        self.groups = in_ch if depthwise else 1
        self.stride, self.kernel, self.out_ch = stride, kernel, out_ch
        self.padding = ((stride - 1) + (kernel - 1)) // 2
        self.kernel_shape = (out_ch, in_ch // self.groups, kernel, kernel)
        self.experts = nn.Parameter(torch.empty(num_experts, math.prod(self.kernel_shape)))

    def forward(self, x: torch.Tensor, routing: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        kernels = (routing @ self.experts).reshape(b * self.out_ch, *self.kernel_shape[1:])
        y = F.conv2d(x.reshape(1, b * c, h, w), kernels, None, self.stride, self.padding, 1,
                     b * self.groups)
        return y.reshape(b, self.out_ch, y.shape[2], y.shape[3])


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-and-excitation
    (``model.py:22-123``), CondConv when ``args.condconv_num_expert > 1``, and
    drop-connect at `drop_connect_rate` on an identity skip."""

    def __init__(self, args: BlockArgs, drop_connect_rate: float = 0.0):
        super().__init__()
        a = self.args = args
        expanded = a.input_filters * a.expand_ratio
        self.condconv = a.condconv_num_expert > 1

        def conv(in_ch, out_ch, kernel, stride=1, depthwise=False):
            if self.condconv:
                return CondConv(in_ch, out_ch, kernel, a.condconv_num_expert, stride, depthwise)
            return Conv2dSame(in_ch, out_ch, kernel, stride, groups=in_ch if depthwise else 1)

        if self.condconv:
            self.routing_fn = nn.Linear(a.input_filters, a.condconv_num_expert)
        if a.expand_ratio != 1:
            self.expand_conv = conv(a.input_filters, expanded, 1)
            self.bn0 = BatchNorm(expanded, momentum=_BN_MOMENTUM, eps=_BN_EPS)
        self.depthwise_conv = conv(expanded, expanded, a.kernel_size, a.stride, depthwise=True)
        self.bn1 = BatchNorm(expanded, momentum=_BN_MOMENTUM, eps=_BN_EPS)
        self.has_se = a.se_ratio is not None and 0 < a.se_ratio <= 1
        if self.has_se:
            squeezed = max(1, int(a.input_filters * a.se_ratio))
            self.se_reduce = Conv2dSame(expanded, squeezed, 1, bias=True)
            self.se_expand = Conv2dSame(squeezed, expanded, 1, bias=True)
        self.project_conv = conv(expanded, a.output_filters, 1)
        self.bn2 = BatchNorm(a.output_filters, momentum=_BN_MOMENTUM, eps=_BN_EPS)
        self.skip = a.id_skip and a.stride == 1 and a.input_filters == a.output_filters
        self.drop_connect = (NoiseSite("drop_connect", drop_connect_rate)
                             if self.skip and drop_connect_rate else None)

    def forward(self, x: torch.Tensor, noise: ModelNoise | None = None) -> torch.Tensor:
        inputs = x
        if self.condconv:
            routing = torch.sigmoid(self.routing_fn(x.mean(dim=(2, 3))))
            conv = lambda m, h: m(h, routing)  # noqa: E731
        else:
            conv = lambda m, h: m(h)  # noqa: E731
        if self.args.expand_ratio != 1:
            x = F.silu(self.bn0(conv(self.expand_conv, x)))
        x = F.silu(self.bn1(conv(self.depthwise_conv, x)))
        if self.has_se:
            se = x.mean(dim=(2, 3), keepdim=True)
            se = self.se_expand(F.silu(self.se_reduce(se)))
            x = torch.sigmoid(se) * x
        x = self.bn2(conv(self.project_conv, x))
        if self.skip:
            if self.drop_connect is not None:
                x = self.drop_connect(x, noise=noise)
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """EfficientNet backbone and head (``model.py:130-257``)."""

    def __init__(self, blocks_args: Sequence[BlockArgs], width_coefficient: float,
                 depth_coefficient: float, dropout_rate: float, num_classes: int,
                 drop_connect_rate: float = 0.2):
        super().__init__()
        w = width_coefficient
        self.blocks_args = tuple(blocks_args)
        self.width_coefficient, self.depth_coefficient = width_coefficient, depth_coefficient
        stem = round_filters(32, w)
        self.conv_stem = Conv2dSame(3, stem, 3, 2)
        self.bn0 = BatchNorm(stem, momentum=_BN_MOMENTUM, eps=_BN_EPS)
        expanded = expand_blocks(self.blocks_args, w, depth_coefficient)
        for idx, args in enumerate(expanded):
            rate = drop_connect_rate * float(idx) / len(expanded)
            self.add_module(f"block{idx}", MBConvBlock(args, rate))
        self.num_blocks = len(expanded)
        head = round_filters(1280, w)
        self.conv_head = Conv2dSame(expanded[-1].output_filters, head, 1)
        self.bn1 = BatchNorm(head, momentum=_BN_MOMENTUM, eps=_BN_EPS)
        self.dropout = NoiseSite("dropout", dropout_rate, width=head) if dropout_rate > 0 else None
        self.fc = nn.Linear(head, num_classes)
        number_noise_sites(self)

    @classmethod
    def from_name(cls, model_name: str, num_classes: int = 1000,
                  condconv_num_expert: int = 0) -> "EfficientNet":
        width, depth, _res, dropout = efficientnet_params(model_name)
        blocks = [decode_block_string(s) for s in _BLOCK_STRINGS]
        if condconv_num_expert > 1:
            # CondConv on the last 3 block groups (utils.py:275-279)
            blocks = blocks[:-3] + [
                replace(b, condconv_num_expert=condconv_num_expert) for b in blocks[-3:]]
        return cls(blocks, width, depth, dropout, num_classes)

    def forward(self, x: torch.Tensor, noise: ModelNoise | None = None) -> torch.Tensor:
        x = F.silu(self.bn0(self.conv_stem(x)))
        for idx in range(self.num_blocks):
            x = getattr(self, f"block{idx}")(x, noise=noise)
        x = F.silu(self.bn1(self.conv_head(x)))
        x = at_least_float32(x.mean(dim=(2, 3)))
        if self.dropout is not None:
            x = self.dropout(x, noise=noise)
        return self.fc(x)


@torch.no_grad()
def init_efficientnet_(model: EfficientNet,
                       generator: torch.Generator | None = None) -> EfficientNet:
    """TensorFlow's init, as the JAX package draws it: every convolution and
    every CondConv expert ``N(0, 2 / fan_out)`` (``fan_out = Cout k k``), the
    dense head ``U(+-1/sqrt(num_classes))``, routing xavier-uniform, biases 0,
    BatchNorm at scale 1 and bias 0."""
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            normal_(m.weight, math.sqrt(2.0 / (m.out_channels * m.kernel_size[0]
                                               * m.kernel_size[1])), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, CondConv):
            for expert in m.experts:
                normal_(expert, math.sqrt(2.0 / (m.out_ch * m.kernel * m.kernel)), generator)
        elif isinstance(m, nn.Linear):
            if name.endswith("routing_fn"):
                uniform_(m.weight, math.sqrt(6.0 / (m.in_features + m.out_features)),
                         generator)
            else:
                uniform_(m.weight, math.sqrt(1.0 / m.out_features), generator)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model
