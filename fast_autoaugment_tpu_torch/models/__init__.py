"""Model registry (``fast_autoaugment_tpu/models/__init__.py``).

String model types map to ``nn.Module``s, every type of the JAX registry:
``wresnet{depth}_{widen}``, ``resnet{depth}``, ``shakeshake26_2x{w}d`` and
``shakeshake26_2x{w}d_next``, ``pyramid`` (``depth``, ``alpha``,
``bottleneck`` from the config) and ``efficientnet-b{0..7}``, with CondConv
experts (``condconv_num_expert`` from the config) only when the type ends in
``-condconv``, as the JAX package reads it.  ``resnet50`` and ``resnet200``
are the ImageNet models whatever the dataset, as in the JAX package; another
depth builds the ImageNet ResNet for an ImageNet dataset and the CIFAR one
(``bottleneck`` from the config) for the others.  Each family's weights are
drawn as the JAX package draws them (PyTorch's default for WideResNet).

Precision is ``f32``: a ``bf16`` precision is a knob of its own
(ROADMAP Queue 1 item 9b) and raises an error that says so.  Under ``f32``
the model runs in true float32 on the card: cuDNN would otherwise run
float32 convolutions in TF32 (``torch.backends.cudnn.allow_tf32`` defaults
to True), so :func:`get_model` turns TF32 off for convolutions and matrix
products.
"""

from __future__ import annotations

import re
from typing import Any

import torch

from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.models.efficientnet import (
    EfficientNet,
    efficientnet_params,
    init_efficientnet_,
)
from fast_autoaugment_tpu_torch.models.layers import he_normal_fanout_, torch_default_init_
from fast_autoaugment_tpu_torch.models.pyramidnet import PyramidNet, init_pyramid_
from fast_autoaugment_tpu_torch.models.resnet import ResNet
from fast_autoaugment_tpu_torch.models.shake_resnet import ShakeResNet, ShakeResNeXt, init_shake_
from fast_autoaugment_tpu_torch.models.wideresnet import WideResNet

__all__ = ["get_model", "num_class", "input_image_size"]


def num_class(dataset: str) -> int:
    """Class count per dataset (reference ``networks/__init__.py:93-103``)."""
    if dataset.startswith("synthetic_shapes"):
        return 10  # glyph task is always 10-class (any _nN train size)
    if dataset.startswith("synthetic"):
        return 100 if dataset.endswith("100") else 10
    return {
        "cifar10": 10,
        "reduced_cifar10": 10,
        "cifar10.1": 10,
        "cifar100": 100,
        "svhn": 10,
        "reduced_svhn": 10,
        "imagenet": 1000,
        "reduced_imagenet": 120,
    }[dataset]


def input_image_size(dataset: str, model_type: str) -> int:
    """Native input resolution for dataset/model."""
    if dataset.endswith("imagenet"):
        if model_type.startswith("efficientnet"):
            return efficientnet_params(model_type.replace("-condconv", ""))[2]
        return 224
    return 32


def _resnet(name: str, conf: Any, num_classes: int) -> ResNet:
    depth = int(name[len("resnet"):])
    dataset = str(conf.get("dataset", "imagenet"))
    if depth in (50, 200) or dataset.endswith("imagenet"):
        return ResNet("imagenet", depth, num_classes)
    return ResNet("cifar", depth, num_classes, bottleneck=bool(conf.get("bottleneck", False)))


def _build(conf: Any, num_classes: int) -> torch.nn.Module:
    """The model of a config mapping (``conf["type"]`` and the fields of its
    family), on the current default device, not initialized."""
    name = conf["type"]
    if name.startswith("wresnet"):
        depth, widen = name[len("wresnet"):].split("_")
        return WideResNet(depth=int(depth), widen_factor=int(widen), num_classes=num_classes)
    if re.fullmatch(r"resnet\d+", name):
        return _resnet(name, conf, num_classes)
    m = re.fullmatch(r"shakeshake26_2x(\d+)d(_next)?", name)
    if m:
        if m.group(2):
            return ShakeResNeXt(26, int(m.group(1)), 4, num_classes)
        return ShakeResNet(26, int(m.group(1)), num_classes)
    if name == "pyramid":
        return PyramidNet(int(conf["depth"]), float(conf["alpha"]), num_classes,
                          bottleneck=bool(conf.get("bottleneck", True)))
    if name.startswith("efficientnet"):
        experts = int(conf.get("condconv_num_expert", 0)) if "condconv" in name else 0
        return EfficientNet.from_name(name.replace("-condconv", ""), num_classes, experts)
    raise ValueError(f"unknown model type {name!r}")


def _init_(model: torch.nn.Module, generator: torch.Generator) -> None:
    if isinstance(model, WideResNet):
        torch_default_init_(model, generator)
    elif isinstance(model, ResNet):
        he_normal_fanout_(torch_default_init_(model, generator), generator)
    elif isinstance(model, (ShakeResNet, ShakeResNeXt)):
        init_shake_(model, generator)
    elif isinstance(model, PyramidNet):
        init_pyramid_(model, generator)
    else:
        init_efficientnet_(model, generator)


def get_model(conf: Any, num_classes: int, *, device="cuda", seed: int = 0) -> torch.nn.Module:
    """Build the model of a config mapping (``conf["type"]``, the fields of
    its family, optional ``conf["precision"]`` and ``conf["dataset"]``) on
    `device`, in ``channels_last``, with weights drawn from a generator seeded
    with `seed` as the JAX package draws each family's.  On the meta device
    nothing is drawn (shapes only)."""
    precision = str(conf.get("precision", "f32") or "f32").lower()
    if precision in ("bf16", "bfloat16"):
        raise NotImplementedError(
            "precision bf16 is not ported yet: the port runs f32 only "
            "(ROADMAP Queue 1 item 9b, the bf16/TF32 precision knob)")
    if precision not in ("f32", "fp32", "float32"):
        raise ValueError(f"unknown precision {precision!r}; use 'f32' or 'bf16'")
    if str(device) == "meta":
        with torch.device("meta"):
            return _build(conf, num_classes)
    dev = resolve_device(device)
    model = _build(conf, num_classes)
    _init_(model, torch.Generator().manual_seed(int(seed)))
    # true float32: no TF32 in cuDNN convolutions or cuBLAS products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return model.to(device=dev, memory_format=torch.channels_last)
