"""JAX (flax) variables -> the port's ``state_dict``.

The inverse of the JAX package's importers
(``fast_autoaugment_tpu/utils/interop.py:100 _import_wideresnet`` and
``:117 _import_resnet``): it
takes a flax variables tree ``{"params", "batch_stats"}`` whose leaves are
numpy arrays (``jax.tree.map(np.asarray, variables)``) and returns the
``state_dict`` of the port's model of the same family, so that both
packages can run the same weights.  Layouts:

- conv kernels HWIO -> OIHW;
- the dense kernel ``[in, out]`` -> ``[out, in]``;
- ``{block}/BatchNorm_0/{scale,bias}`` -> ``{block}.{weight,bias}`` and the
  matching ``batch_stats`` ``{mean,var}`` -> ``running_{mean,var}``
  (``num_batches_tracked`` is 0: eval mode does not read it).

ResNet's blocks map ``layer{s}_{i}/conv{k}`` and ``bn{k}`` to
``layer{s}.{i}.conv{k}`` and ``bn{k}``, and ``downsample_conv`` and
``downsample_bn`` to ``downsample.0`` and ``downsample.1``.  The WideResNet
and ResNet families are ported (ROADMAP item 9 adds the others).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

__all__ = ["flax_to_state_dict"]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


class _Builder:
    def __init__(self, variables: Mapping):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: dict[str, torch.Tensor] = {}

    @staticmethod
    def _node(tree: Mapping, path: list[str]) -> Mapping:
        for part in path:
            tree = tree[part]
        return tree

    def conv(self, flax_path: list[str], torch_name: str) -> None:
        node = self._node(self.params, flax_path)
        self.sd[f"{torch_name}.weight"] = _tensor(np.transpose(node["kernel"], (3, 2, 0, 1)))
        if "bias" in node:
            self.sd[f"{torch_name}.bias"] = _tensor(node["bias"])

    def linear(self, flax_path: list[str], torch_name: str) -> None:
        node = self._node(self.params, flax_path)
        self.sd[f"{torch_name}.weight"] = _tensor(np.transpose(node["kernel"], (1, 0)))
        self.sd[f"{torch_name}.bias"] = _tensor(node["bias"])

    def bn(self, flax_path: list[str], torch_name: str) -> None:
        # the JAX BatchNorm wrapper holds an inner flax BatchNorm_0 module
        p = self._node(self.params, flax_path + ["BatchNorm_0"])
        s = self._node(self.stats, flax_path + ["BatchNorm_0"])
        self.sd[f"{torch_name}.weight"] = _tensor(p["scale"])
        self.sd[f"{torch_name}.bias"] = _tensor(p["bias"])
        self.sd[f"{torch_name}.running_mean"] = _tensor(s["mean"])
        self.sd[f"{torch_name}.running_var"] = _tensor(s["var"])
        self.sd[f"{torch_name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _blocks(params: Mapping) -> list[tuple[int, int]]:
    return sorted((int(m.group(1)), int(m.group(2))) for m in
                  (re.fullmatch(r"layer(\d+)_(\d+)", k) for k in params) if m)


def _wideresnet(variables: Mapping) -> dict[str, torch.Tensor]:
    b = _Builder(variables)
    b.conv(["conv1"], "conv1")
    for stage, i in _blocks(b.params):
        f, t = f"layer{stage}_{i}", f"layer{stage}.{i}"
        b.bn([f, "bn1"], f"{t}.bn1")
        b.conv([f, "conv1"], f"{t}.conv1")
        b.bn([f, "bn2"], f"{t}.bn2")
        b.conv([f, "conv2"], f"{t}.conv2")
        if "shortcut" in b.params[f]:
            b.conv([f, "shortcut"], f"{t}.shortcut.0")
    b.bn(["bn1"], "bn1")
    b.linear(["linear"], "linear")
    return b.sd


def _resnet(variables: Mapping) -> dict[str, torch.Tensor]:
    b = _Builder(variables)
    b.conv(["conv1"], "conv1")
    b.bn(["bn1"], "bn1")
    for stage, i in _blocks(b.params):
        f, t = f"layer{stage}_{i}", f"layer{stage}.{i}"
        for k in (1, 2, 3):
            if f"conv{k}" in b.params[f]:
                b.conv([f, f"conv{k}"], f"{t}.conv{k}")
                b.bn([f, f"bn{k}"], f"{t}.bn{k}")
        if "downsample_conv" in b.params[f]:
            b.conv([f, "downsample_conv"], f"{t}.downsample.0")
            b.bn([f, "downsample_bn"], f"{t}.downsample.1")
    b.linear(["fc"], "fc")
    return b.sd


_CONVERTERS = {"wideresnet": _wideresnet, "resnet": _resnet}


def flax_to_state_dict(variables: Mapping, family: str = "wideresnet") -> dict[str, torch.Tensor]:
    """Convert flax variables (numpy leaves) of a `family` model into the
    port's ``state_dict`` (float32 CPU tensors; ``load_state_dict`` copies
    them to the model's device)."""
    try:
        convert = _CONVERTERS[family]
    except KeyError:
        raise NotImplementedError(
            f"family {family!r} is not ported yet; have {sorted(_CONVERTERS)} "
            f"(ROADMAP Queue 1 item 9)") from None
    return convert(variables)
