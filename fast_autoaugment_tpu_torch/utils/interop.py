"""JAX (flax) variables and train states <-> the port's models and states.

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

One table, :func:`flax_layout`, names the flax place of every tensor of a
port model's ``state_dict``; :func:`flax_to_state_dict` reads through it
(on the model the variables describe, built on the meta device), and on it
:func:`train_state_to_flax` and :func:`load_flax_train_state` map the
port's whole :class:`~fast_autoaugment_tpu_torch.train.steps.TrainState`
to and from the JAX ``TrainState`` pytree (``fast_autoaugment_tpu/train/
steps.py:69-97``), which is what a checkpoint of either package holds:

- ``step``: int32, 0-d;
- ``params``, ``batch_stats``: the flax variables;
- ``opt_state``: the optax chain of ``ops/optim.py build_optimizer``, one
  entry ``"0"``, ``"1"``, ... per link: ``{"inner_state": {}}`` for the
  masked weight decay (when ``decay > 0``), ``{}`` for the clip (when
  ``clip > 0``), then ``{"trace": params-shaped}`` and ``{"count": int32}``
  for SGD, or ``{"step": int32, "ms": ..., "mom": ...}`` for RMSprop;
- ``ema``: ``{"batch_stats", "params"}`` or None.

Every ``dict`` of that pytree is written with its keys sorted: the JAX
package saves states that came out of a jitted step, and jit rebuilds every
dict in sorted key order, so the port's payload is then byte-equal to the
JAX package's.  Reading goes by key and takes any order.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "flax_layout", "tensors_to_flax", "flax_to_tensors",
           "train_state_to_flax", "load_flax_train_state"]


def _blocks(params: Mapping) -> dict[int, int]:
    """``{stage: number of blocks}`` of a flax tree's ``layer{s}_{i}`` modules."""
    counts: dict[int, int] = {}
    for k in params:
        m = re.fullmatch(r"layer(\d+)_(\d+)", k)
        if m:
            stage = int(m.group(1))
            counts[stage] = max(counts.get(stage, 0), int(m.group(2)) + 1)
    return dict(sorted(counts.items()))


def _model_of(params: Mapping, family: str) -> torch.nn.Module:
    """The port's model of `family` whose tensors the flax `params` tree
    holds, built on the meta device (only its names and layers are read)."""
    from fast_autoaugment_tpu_torch.models.resnet import IMAGENET_LAYERS, ResNet
    from fast_autoaugment_tpu_torch.models.wideresnet import WideResNet

    counts = _blocks(params)
    with torch.device("meta"):
        if family == "wideresnet":
            widen = params["layer1_0"]["conv1"]["kernel"].shape[3] // 16
            return WideResNet(6 * counts[1] + 4, widen, params["linear"]["kernel"].shape[1])
        num_classes = params["fc"]["kernel"].shape[1]
        bottleneck = "conv3" in params["layer1_0"]
        if len(counts) == 3:  # the CIFAR ResNet
            return ResNet("cifar", (9 if bottleneck else 6) * counts[1] + 2, num_classes,
                          bottleneck=bottleneck)
        kind = "bottleneck" if bottleneck else "basic"
        depth = next(d for d, layers in IMAGENET_LAYERS.items()
                     if layers == (kind, tuple(counts.values())))
        return ResNet("imagenet", depth, num_classes)


def flax_to_state_dict(variables: Mapping, family: str = "wideresnet") -> dict[str, torch.Tensor]:
    """Convert flax variables (numpy leaves) of a `family` model into the
    port's ``state_dict`` (float32 CPU tensors; ``load_state_dict`` copies
    them to the model's device): :func:`flax_to_tensors` on the
    :func:`flax_layout` of the model the variables describe, with
    BatchNorm's ``num_batches_tracked`` at 0."""
    if family not in ("wideresnet", "resnet"):
        raise NotImplementedError(
            f"family {family!r} is not ported yet; have ['resnet', 'wideresnet'] "
            f"(ROADMAP Queue 1 item 9)")
    model = _model_of(variables["params"], family)
    arrays = flax_to_tensors(variables, flax_layout(model))
    return {name: (torch.from_numpy(arrays[name]) if name in arrays
                   else torch.tensor(0, dtype=torch.int64))
            for name in model.state_dict()}


def _flax_module_path(name: str) -> list[str]:
    """A port module name -> its flax module path: ``layer{s}.{i}`` ->
    ``layer{s}_{i}``, ``shortcut.0`` -> ``shortcut``, ``downsample.0``/``.1``
    -> ``downsample_conv``/``downsample_bn``."""
    parts, out, i = name.split("."), [], 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if re.fullmatch(r"layer\d+", p) and nxt is not None and nxt.isdigit():
            out.append(f"{p}_{nxt}")
            i += 2
        elif p == "shortcut" and nxt == "0":
            out.append("shortcut")
            i += 2
        elif p == "downsample" and nxt in ("0", "1"):
            out.append("downsample_conv" if nxt == "0" else "downsample_bn")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


#: (collection, path, layout) of one state_dict tensor; layout "oihw" is a
#: conv kernel (flax HWIO), "io" the dense kernel (flax [in, out]), "" as is
Place = tuple[str, tuple[str, ...], str]


def flax_layout(model: torch.nn.Module) -> dict[str, Place]:
    """The flax place of every tensor of ``model.state_dict()`` except
    BatchNorm's ``num_batches_tracked``, in ``state_dict`` order."""
    from fast_autoaugment_tpu_torch.models.layers import BatchNorm

    layout: dict[str, Place] = {}
    for name, mod in model.named_modules():
        own = dict(mod.named_parameters(recurse=False))
        own.update(mod.named_buffers(recurse=False))
        if not own:
            continue
        path = tuple(_flax_module_path(name))
        if isinstance(mod, BatchNorm):
            bn = path + ("BatchNorm_0",)
            places = {"weight": ("params", bn + ("scale",), ""),
                      "bias": ("params", bn + ("bias",), ""),
                      "running_mean": ("batch_stats", bn + ("mean",), ""),
                      "running_var": ("batch_stats", bn + ("var",), ""),
                      "num_batches_tracked": None}
        elif isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            kind = "oihw" if isinstance(mod, torch.nn.Conv2d) else "io"
            places = {"weight": ("params", path + ("kernel",), kind),
                      "bias": ("params", path + ("bias",), "")}
        else:
            places = {}
        for attr in own:
            if attr not in places:
                raise NotImplementedError(
                    f"{type(mod).__name__} {name!r} has a tensor {attr!r} with no flax place; "
                    "only the WideResNet and ResNet families are ported (ROADMAP Queue 1 "
                    "item 9)")
            if places[attr] is not None:
                layout[f"{name}.{attr}" if name else attr] = places[attr]
    return layout


def _to_flax_array(t: torch.Tensor, kind: str) -> np.ndarray:
    a = t.detach().to("cpu", torch.float32).numpy()
    if kind == "oihw":
        a = np.transpose(a, (2, 3, 1, 0))
    elif kind == "io":
        a = np.transpose(a, (1, 0))
    return np.ascontiguousarray(a)


def _from_flax_array(a, kind: str) -> np.ndarray:
    a = np.array(a, np.float32)  # a writable copy
    if kind == "oihw":
        a = np.transpose(a, (3, 2, 0, 1))
    elif kind == "io":
        a = np.transpose(a, (1, 0))
    return a


def _sorted_tree(tree):
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def tensors_to_flax(tensors, layout: dict[str, Place],
                    collections: tuple[str, ...] = ("params", "batch_stats")) -> dict:
    """``{name: tensor}`` (a ``state_dict``, an EMA shadow, or the names of
    an optimizer buffer) -> ``{collection: flax tree}`` with numpy leaves
    and sorted keys."""
    out: dict = {c: {} for c in collections}
    for name, t in tensors.items():
        coll, path, kind = layout[name]
        node = out[coll]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _to_flax_array(t, kind)
    return _sorted_tree(out)


def flax_to_tensors(tree: Mapping, layout: dict[str, Place], names=None) -> dict[str, np.ndarray]:
    """The inverse of :func:`tensors_to_flax` for `names` (every name of
    the layout by default): ``{name: float32 array in the port's layout}``."""
    out = {}
    for name in (layout if names is None else names):
        coll, path, kind = layout[name]
        node = tree[coll]
        for part in path:
            node = node[part]
        out[name] = _from_flax_array(node, kind)
    return out


def _chain_head(optimizer) -> list[dict]:
    """The optax chain's links before the core update: the masked decay and
    the clip, each present only when on (``ops/optim.py:115-123``)."""
    links = []
    if optimizer.decay > 0:
        links.append({"inner_state": {}})
    if optimizer.clip > 0:
        links.append({})
    return links


def train_state_to_flax(state, optimizer) -> dict:
    """The port's ``TrainState`` -> the JAX ``TrainState`` pytree (numpy
    leaves) that ``flax.serialization.to_bytes`` serializes."""
    model = state.model
    layout = flax_layout(model)
    sd = model.state_dict()
    variables = tensors_to_flax({k: sd[k] for k in layout}, layout)
    names = [n for n, _ in model.named_parameters()]

    def params_tree(bufs):
        return tensors_to_flax(dict(zip(names, bufs)), layout, ("params",))["params"]

    opt = state.opt_state
    links = _chain_head(optimizer)
    if optimizer.kind == "sgd":
        links += [{"trace": params_tree(opt.trace)}, {"count": np.asarray(opt.count, np.int32)}]
    else:
        links.append({"step": np.asarray(opt.count, np.int32), "ms": params_tree(opt.ms),
                      "mom": params_tree(opt.mom)})
    ema = None
    if state.ema is not None:
        ema = tensors_to_flax(state.ema, layout)
    return {"step": np.asarray(state.step, np.int32), "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": {str(i): link for i, link in enumerate(links)}, "ema": ema}


@torch.no_grad()
def load_flax_train_state(tree: Mapping, state, optimizer):
    """Copy a JAX ``TrainState`` pytree (a checkpoint of either package)
    into the port's `state` in place: the model's weights and BatchNorm
    statistics, the optimizer's buffers and count, the step and the EMA
    shadow.  The chain's links must be those of `optimizer`, and the EMA
    must be on in both or in neither.  Returns `state`."""
    model = state.model
    layout = flax_layout(model)
    live = model.state_dict()
    for name, arr in flax_to_tensors(tree, layout).items():
        live[name].copy_(torch.from_numpy(arr))
    names = [n for n, _ in model.named_parameters()]
    links = [tree["opt_state"][str(i)] for i in range(len(tree["opt_state"]))]
    head = len(_chain_head(optimizer))
    core = links[head:]
    want = ["trace", "count"] if optimizer.kind == "sgd" else ["step", "ms", "mom"]
    if [k for link in core for k in link] != want:
        raise ValueError(f"the checkpoint's optimizer chain {[list(x) for x in links]} is not "
                         f"the {optimizer.kind} chain this optimizer builds")

    def load_bufs(bufs, flax_params):
        arrs = flax_to_tensors({"params": flax_params}, layout, names)
        for b, n in zip(bufs, names):
            b.copy_(torch.from_numpy(arrs[n]))

    opt = state.opt_state
    if optimizer.kind == "sgd":
        load_bufs(opt.trace, core[0]["trace"])
        opt.count = int(core[1]["count"])
    else:
        load_bufs(opt.ms, core[0]["ms"])
        load_bufs(opt.mom, core[0]["mom"])
        opt.count = int(core[0]["step"])
    state.step = int(tree["step"])
    if (tree.get("ema") is None) != (state.ema is None):
        raise ValueError("the checkpoint and the state disagree on whether the EMA is on")
    if state.ema is not None:
        for name, arr in flax_to_tensors(tree["ema"], layout, list(state.ema)).items():
            state.ema[name].copy_(torch.from_numpy(arr))
    return state
