"""Model registry (``fast_autoaugment_tpu/models/__init__.py``).

String model types map to ``nn.Module``s.  Ported so far, at precision
``f32``: the WideResNet family ``wresnet{depth}_{widen}`` and the ResNet
family ``resnet{depth}``.  ``resnet50`` and ``resnet200`` are the ImageNet
models whatever the dataset, as in the JAX package; another depth builds
the ImageNet ResNet for an ImageNet dataset and the CIFAR one (``bottleneck``
from the config) for the others.  The other families (Shake-Shake,
PyramidNet, EfficientNet) are ROADMAP item 9, and a ``bf16`` precision is a
knob of its own that no slice has asked for yet; both raise an error that
says so.

Under ``f32`` the model runs in true float32 on the card: cuDNN would
otherwise run float32 convolutions in TF32
(``torch.backends.cudnn.allow_tf32`` defaults to True), so :func:`get_model`
turns TF32 off for convolutions and matrix products.
"""

from __future__ import annotations

import re
from typing import Any

import torch

from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.models.layers import he_normal_fanout_, torch_default_init_
from fast_autoaugment_tpu_torch.models.resnet import ResNet
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
            raise NotImplementedError(
                "EfficientNet is not ported yet (ROADMAP Queue 1 item 9)")
        return 224
    return 32


def _resnet(name: str, conf: Any, num_classes: int) -> ResNet:
    depth = int(name[len("resnet"):])
    dataset = str(conf.get("dataset", "imagenet"))
    if depth in (50, 200) or dataset.endswith("imagenet"):
        return ResNet("imagenet", depth, num_classes)
    return ResNet("cifar", depth, num_classes, bottleneck=bool(conf.get("bottleneck", False)))


def get_model(conf: Any, num_classes: int, *, device="cuda", seed: int = 0) -> torch.nn.Module:
    """Build the model of a config mapping (``conf["type"]``, optional
    ``conf["precision"]`` and ``conf["dataset"]``) on `device`, in
    ``channels_last``, with weights drawn from a generator seeded with
    `seed`: PyTorch's default init, and He-normal fan-out convolutions for
    ResNet (the init of each reference model)."""
    name = conf["type"]
    precision = str(conf.get("precision", "f32") or "f32").lower()
    if precision in ("bf16", "bfloat16"):
        raise NotImplementedError(
            "precision bf16 is not ported yet: the port runs f32 only "
            "(ROADMAP Queue 1 item 9 lists the precision knob)")
    if precision not in ("f32", "fp32", "float32"):
        raise ValueError(f"unknown precision {precision!r}; use 'f32' or 'bf16'")
    if not (name.startswith("wresnet") or re.fullmatch(r"resnet\d+", name)):
        raise NotImplementedError(
            f"model type {name!r} is not ported yet: wresnet{{depth}}_{{widen}} and "
            f"resnet{{depth}} are (the other families are ROADMAP Queue 1 item 9)")
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(int(seed))
    if name.startswith("wresnet"):
        depth, widen = name[len("wresnet"):].split("_")
        model = WideResNet(depth=int(depth), widen_factor=int(widen), num_classes=num_classes)
        torch_default_init_(model, generator)
    else:
        model = _resnet(name, conf, num_classes)
        he_normal_fanout_(torch_default_init_(model, generator), generator)
    # true float32: no TF32 in cuDNN convolutions or cuBLAS products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return model.to(device=dev, memory_format=torch.channels_last)
