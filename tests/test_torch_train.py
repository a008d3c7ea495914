"""The port's training slice (``fast_autoaugment_tpu_torch.train``, the data
split and batching, the smoke script's ResNet-50 constants) against the JAX
package, on the CPU.

Oracles and bounds:

- ``make_train_step`` of the JAX package, compiled without fused
  multiply-add in one reference process (``test_torch_replay.
  jax_reference``), from the same initial weights (the JAX init through
  ``flax_to_state_dict``) and the same draws (``test_torch_replay.
  JaxDraws``; ``jax_threefry_partitionable`` pinned to True), over three
  steps on two stacks: the CIFAR stack with a WRN-10-1 (the
  ``fa_reduced_cifar10`` policy, cutout 16, SGD-nesterov with decay 5e-4,
  clip 5, EMA 0.999) and the ImageNet stack with a ResNet-18 with the
  ImageNet stem at 64x64 (no policy: ``test_torch_imagenet.py`` holds the
  stack with the ImageNet archive; the ``resnet50.yaml`` optimizer: decay
  1e-4, clip 0).  The same steps also run in float64 (the port's model and
  optimizer in float64, the exact oracle).  After step 1 and step 3: the
  augmented batch bitwise against JAX (an image with a gated-on Rotate slot
  excepted, ``test_torch_augment.py``); the loss sum within ``LOSS_RTOL``
  of JAX's; the top-1 and top-5 counts equal to JAX's or to the float64
  run's; every parameter, BatchNorm statistic and EMA tensor, and the
  loss, at most twice as far from the float64 run as the JAX package's
  (plus 0.1% of what the steps changed the tensor by), and the JAX
  package's within ``JAX_DRIFT`` of that change (5% on CIFAR; 1% after
  step 1 and 25% after step 3 on ImageNet), so that a fault shared by the
  port's float32 and float64 runs fails.  Neither float32 program is exact:
  the gradient jumps where a ReLU's pre-activation lies within float32
  rounding of 0, and each program closes such a gate now and then where
  the other opens it; BatchNorm's backward spreads the one element over its
  channel and every earlier layer (up to 2.6% of a gradient here).
  ``test_step_gradient_against_float64`` holds each step's gradient of both
  programs at the same variables within 1e-4 of float64, or within 5% with
  the departure shown to start at one such gate;
- ``train_and_eval`` of the JAX package (one device, host-fed path) on
  ``synthetic`` with a WRN-10-1, one epoch, a 0.4 CV split, from the same
  initial weights and draws: the same result keys (the JAX compile-cache
  stamp aside), the same reporter call, counts exact, losses within 1e-4
  relative and accuracies within one sample; and both resumed from the same
  imported checkpoint (the reference importer's ``imported_from`` record,
  no optimizer state): the same step, the EMA seeded from the imported
  weights, the metrics within the same bounds;
- ``cv_split`` and ``_stratified_split`` against sklearn's
  ``StratifiedShuffleSplit``, and ``load_dataset`` of a CIFAR pickle
  directory against the JAX package's: equal arrays;
- ``train_index_matrix`` and ``train_batches`` against the JAX package's:
  equal arrays;
- ``chip_smoke.RESNET50`` against the JAX package's reading of
  ``confs/resnet50.yaml``;
- the new modules import without JAX, the JAX package, flax, sklearn,
  PyYAML, msgpack or PIL.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu_torch.data import datasets as D
from fast_autoaugment_tpu_torch.data import pipeline as PL
from fast_autoaugment_tpu_torch.models.resnet import ResNet
from fast_autoaugment_tpu_torch.models.wideresnet import WideResNet
from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.ops import optim as O
from fast_autoaugment_tpu_torch.ops import schedules as S
from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
from fast_autoaugment_tpu_torch.train import steps as ST
from fast_autoaugment_tpu_torch.train import trainer as TR
from fast_autoaugment_tpu_torch.utils.interop import flax_to_state_dict
from test_torch_replay import JaxDraws, jax_reference_groups

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTITIONABLE = True
LOSS_RTOL = 1e-3
# the JAX run's largest distance from the port's float64 run after step 1
# and step 3, over what the steps changed the tensor by (readings: 1.9% and
# 3.0% on CIFAR, 0.15% and 16.2% on ImageNet, where JAX's gradient at step
# 2 has a ReLU gate flip, test_step_gradient_against_float64)
JAX_DRIFT = {"cifar_wrn10_1": {0: 0.05, 2: 0.05}, "imagenet_resnet18": {0: 0.01, 2: 0.25}}
STEPS = 3
FA_CIFAR = policy_to_tensor(load_policy("fa_reduced_cifar10"))
FA_IMAGENET = policy_to_tensor(load_policy("fa_resnet50_rimagenet"))


def _lr_conf(lr):
    return {"lr": lr, "epoch": 10, "lr_schedule": {"type": "cosine", "warmup": {
        "multiplier": 1, "epoch": 1}}}


# (name, family, model args, batch, image, policy, cutout, optimizer conf, ema, lr)
STACKS = [
    ("cifar_wrn10_1", "cifar", (10, 1, 10), 8, 32, FA_CIFAR, 16,
     {"type": "sgd", "nesterov": True, "decay": 5e-4, "ema": 0.999}, 0.999, 0.02),
    ("imagenet_resnet18", "imagenet", (18, 10), 8, 64, None, 0,
     {"type": "sgd", "nesterov": True, "decay": 1e-4, "clip": 0, "ema": 0}, 0.0, 0.001),
]
TRAIN_CONF = {"model": {"type": "wresnet10_1"}, "dataset": "synthetic",
              "aug": "fa_reduced_cifar10", "cutout": 16, "batch": 128, "epoch": 1,
              "lr": 0.1, "lr_schedule": {"type": "cosine", "warmup": {"multiplier": 1,
                                                                       "epoch": 5}},
              "optimizer": {"type": "sgd", "nesterov": True, "decay": 0.0002, "ema": 0}}


def _batches(seed, n, b, image, classes):
    g = np.random.default_rng(seed)
    return [(g.integers(0, 256, (b, image, image, 3), dtype=np.uint8),
             g.integers(0, classes, (b,), dtype=np.int32)) for _ in range(n)]


def _jax_model(family, args):
    from fast_autoaugment_tpu.models.resnet import ResNet as JaxResNet
    from fast_autoaugment_tpu.models.wideresnet import WideResNet as JaxWideResNet

    if family == "cifar":
        depth, widen, classes = args
        return JaxWideResNet(depth=depth, widen_factor=widen, num_classes=classes,
                             dropout_rate=0.0)
    depth, classes = args
    return JaxResNet(dataset="imagenet", depth=depth, num_classes=classes)


def _numpy(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def jax_train_steps(job):
    """Reference runner: the JAX train step over the job's batches from the
    JAX init, recording after each step the metric sums, the variables, the
    EMA, the augmented batch and (ImageNet) the stack's draws by key."""
    from fast_autoaugment_tpu.core.metrics import smooth_cross_entropy
    from fast_autoaugment_tpu.ops import optim as JO
    from fast_autoaugment_tpu.ops import schedules as JS
    from fast_autoaugment_tpu.ops.preprocess import cifar_train_batch
    from fast_autoaugment_tpu.ops.preprocess_imagenet import imagenet_train_batch
    from fast_autoaugment_tpu.train.steps import create_train_state, make_train_step
    from test_torch_replay import jax_imagenet_draws

    family, image, cutout = job["family"], job["image"], job["cutout"]
    model = _jax_model(family, job["model"])
    rng = jax.random.PRNGKey(job["seed"])
    lr = JS.build_schedule(_lr_conf(job["lr"]), 4)
    optimizer = JO.build_optimizer(job["optimizer"], lr)
    state = create_train_state(model, optimizer, rng, jnp.zeros((2, image, image, 3)),
                               use_ema=job["ema"] > 0)
    init = _numpy({"params": state.params, "batch_stats": state.batch_stats})
    use_policy = job["policy"] is not None
    policy = jnp.asarray(job["policy"] if use_policy else np.zeros((1, 1, 3), np.float32))
    if family == "imagenet":
        augment_fn = lambda images, pol, key: imagenet_train_batch(  # noqa: E731
            images, key, pol if use_policy else None, cutout_length=cutout,
            aug_dispatch="exact", aug_groups=8)
    else:
        augment_fn = lambda images, pol, key: cifar_train_batch(  # noqa: E731
            images, key, policy=pol, cutout_length=cutout)
    step = make_train_step(model, optimizer, num_classes=job["model"][-1], ema_mu=job["ema"],
                           cutout_length=cutout, use_policy=use_policy, augment_fn=augment_fn)
    aug = jax.jit(augment_fn)
    key = jnp.asarray(job["key"])
    out = {"init": init, "steps": [], "table": {}}

    def loss_fn(params, batch_stats, x, y):
        logits, _ = model.apply({"params": params, "batch_stats": batch_stats}, x,
                                train=True, mutable=["batch_stats"])
        return smooth_cross_entropy(logits, y)

    grad_fn = jax.jit(jax.grad(loss_fn))
    for s, (x, y) in enumerate(job["batches"]):
        key_aug = jax.random.split(jax.random.fold_in(key, s))[0]
        if family == "imagenet":
            k = tuple(int(v) for v in np.asarray(key_aug, np.uint32))
            out["table"][k] = jax_imagenet_draws(
                np.asarray(key_aug), len(y), tuple(policy.shape[:2]) if use_policy else None,
                image, image)
        augmented = np.asarray(aug(jnp.asarray(x, jnp.float32), policy, key_aug))
        grads = _numpy(grad_fn(state.params, state.batch_stats, jnp.asarray(augmented),
                               jnp.asarray(y)))
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y), policy, key)
        out["steps"].append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "variables": _numpy({"params": state.params, "batch_stats": state.batch_stats}),
            "ema": None if state.ema is None else _numpy(state.ema),
            "augmented": augmented, "grads": grads})
    variables = [out["init"]] + [st["variables"] for st in out["steps"][:-1]]
    out["bn_grads"] = _bn_output_grads(
        family, job["model"], variables, [st["augmented"] for st in out["steps"]],
        [y for _, y in job["batches"]])
    return out


def _bn_output_grads(family, args, variables, xs, ys):
    """JAX's gradient of the loss with respect to every BatchNorm's output,
    for each (variables, batch) in turn, by the port's module name: from a
    copy of the model whose BatchNorms pass their output through flax's
    ``perturb``.  The names come through ``flax_to_state_dict``: each
    BatchNorm's scale is replaced by its index before the conversion."""
    from flax import linen as nn

    from fast_autoaugment_tpu.core.metrics import smooth_cross_entropy
    from fast_autoaugment_tpu.models import layers as JL
    from fast_autoaugment_tpu.models import resnet as JR
    from fast_autoaugment_tpu.models import wideresnet as JW

    class Perturbed(JL.BatchNorm):
        @nn.compact
        def __call__(self, x, train):
            return self.perturb("out", super().__call__(x, train))

    saved = JR.BatchNorm, JW.BatchNorm
    JR.BatchNorm = JW.BatchNorm = Perturbed
    try:
        model = _jax_model(family, args)
        zeros = model.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), train=True)["perturbations"]

        def loss_fn(v, pert, x, y):
            logits, _ = model.apply({**v, "perturbations": pert}, x, train=True,
                                    mutable=["batch_stats"])
            return smooth_cross_entropy(logits, y)

        grad_fn = jax.jit(jax.grad(loss_fn, argnums=1))
        grads = [grad_fn(v, zeros, jnp.asarray(x), jnp.asarray(y))
                 for v, x, y in zip(variables, xs, ys)]
    finally:
        JR.BatchNorm, JW.BatchNorm = saved
    paths = [p[:-1] for p, _ in jax.tree_util.tree_leaves_with_path(zeros)]
    index = {p: i for i, p in enumerate(paths)}

    def mark(path, leaf):
        keys = tuple(getattr(k, "key", k) for k in path)
        if keys[-2:] == ("BatchNorm_0", "scale"):
            for p, i in index.items():
                if keys[1:-2] == tuple(getattr(k, "key", k) for k in p):
                    return np.full(leaf.shape, i, np.float32)
        return np.asarray(leaf)

    from fast_autoaugment_tpu_torch.utils.interop import flax_to_state_dict

    marked = jax.tree_util.tree_map_with_path(mark, {"params": variables[0]["params"],
                                                     "batch_stats": variables[0]["batch_stats"]})
    fam = "wideresnet" if family == "cifar" else "resnet"
    names = {int(v[0]): k[:-len(".weight")] for k, v in flax_to_state_dict(marked, fam).items()
             if k.endswith(".weight") and v.dim() == 1 and float(v[0]).is_integer()
             and int(v[0]) < len(paths) and bool((v == v[0]).all())}
    assert len(names) == len(paths), (names, paths)
    leaves = [jax.tree_util.tree_leaves(g) for g in grads]
    return [{names[i]: np.asarray(lv[i]) for i in range(len(paths))} for lv in leaves]


def jax_train_and_eval(job):
    """Reference runner: JAX ``train_and_eval`` on one device, host-fed,
    with a recording reporter; and the initial variables it drew."""
    from fast_autoaugment_tpu.models import get_model
    from fast_autoaugment_tpu.parallel.mesh import make_mesh
    from fast_autoaugment_tpu.train.trainer import train_and_eval

    conf, seed = job["conf"], job["seed"]
    model = get_model(dict(conf["model"], dataset=conf["dataset"]), 10)
    rng = jax.random.PRNGKey(seed)
    init = model.init({"params": rng, "shake": jax.random.fold_in(rng, 1)},
                      jnp.zeros((2, 32, 32, 3)), train=False)
    calls = []
    result = train_and_eval(conf, "", test_ratio=job["test_ratio"], cv_fold=job["cv_fold"],
                            reporter=lambda **kw: calls.append(kw), evaluation_interval=1,
                            mesh=make_mesh(jax.devices()[:1]), seed=seed, device_cache="off")
    return {"init": _numpy(init), "result": {k: v for k, v in result.items()
                                             if k != "compile_cache"},
            "reporter": [{k: float(v) for k, v in c.items()} for c in calls]}


#: the imported-checkpoint resume: the train conf with an EMA, 2 epochs;
#: the file, written by the JAX package's checkpoint writer, holds the JAX
#: init's weights and BatchNorm statistics at epoch 1 and no optimizer state
IMPORTED_CONF = dict(TRAIN_CONF, epoch=2,
                     optimizer=dict(TRAIN_CONF["optimizer"], ema=0.999))
IMPORTED_META = {"epoch": 1, "imported_from": "x.pth", "has_ema": False}


def _copy_checkpoint(src, dst):
    import shutil

    for suffix in ("", ".meta.json"):
        shutil.copyfile(src + suffix, dst + suffix)
    return dst


def jax_imported_resume(job):
    """Reference runner: JAX ``train_and_eval`` resumed from an imported
    checkpoint (the shape of JAX ``tests/test_train.py
    test_lenient_import_seeds_ema_and_schedule_position``), once to train
    its last epoch and once with the file at the run's last epoch (an
    evaluation); each run's result and sidecar."""
    from fast_autoaugment_tpu.core.checkpoint import read_metadata, save_checkpoint
    from fast_autoaugment_tpu.models import get_model
    from fast_autoaugment_tpu.parallel.mesh import make_mesh
    from fast_autoaugment_tpu.train.trainer import train_and_eval

    conf, seed, d = job["conf"], job["seed"], job["dir"]
    model = get_model(dict(conf["model"], dataset=conf["dataset"]), 10)
    init = model.init({"params": jax.random.PRNGKey(seed + 100)},
                      jnp.zeros((2, 32, 32, 3)), train=False)
    src = os.path.join(d, "imported.msgpack")
    save_checkpoint(src, {"step": 0, "params": init["params"],
                          "batch_stats": init["batch_stats"]}, IMPORTED_META)
    out = {"file": src}
    for name, epochs in (("train", conf["epoch"]), ("eval", 1)):
        path = _copy_checkpoint(src, os.path.join(d, f"jax_{name}.msgpack"))
        result = train_and_eval(dict(conf, epoch=epochs), "", test_ratio=0.4, cv_fold=1,
                                save_path=path, evaluation_interval=1,
                                mesh=make_mesh(jax.devices()[:1]), seed=seed,
                                device_cache="off")
        out[name] = {"result": {k: v for k, v in result.items() if k != "compile_cache"},
                     "meta": read_metadata(path)}
    return out


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    jobs = []
    for i, (_, family, args, b, image, policy, cutout, opt, ema, lr) in enumerate(STACKS):
        jobs.append({"runner": "test_torch_train:jax_train_steps", "family": family,
                     "model": args, "image": image, "cutout": cutout, "optimizer": opt,
                     "ema": ema, "lr": lr, "policy": policy, "seed": 3 + i,
                     "key": np.asarray(jax.random.PRNGKey(50 + i), np.uint32),
                     "batches": _batches(60 + i, STEPS, b, image, args[-1]),
                     "threefry_partitionable": PARTITIONABLE})
    groups = [[j] for j in jobs]
    # the train_and_eval references share one process
    groups.append([{"runner": "test_torch_train:jax_train_and_eval", "conf": TRAIN_CONF,
                    "seed": 0, "test_ratio": 0.4, "cv_fold": 1,
                    "threefry_partitionable": PARTITIONABLE},
                   {"runner": "test_torch_train:jax_imported_resume", "conf": IMPORTED_CONF,
                    "seed": 0, "dir": str(tmp_path_factory.mktemp("imported")),
                    "threefry_partitionable": PARTITIONABLE}])
    out = jax_reference_groups(groups, tmp_path_factory.mktemp("train"))
    return {"steps": [o[0] for o in out[:-1]], "train_and_eval": out[-1][0],
            "imported": out[-1][1]}


def _port_model(family, args, variables):
    if family == "cifar":
        depth, widen, classes = args
        model, fam = WideResNet(depth, widen, classes), "wideresnet"
    else:
        depth, classes = args
        model, fam = ResNet("imagenet", depth, classes), "resnet"
    model.load_state_dict(flax_to_state_dict(variables, fam))
    return model.to(memory_format=torch.channels_last), fam


def _has_gated_rotate(policy, sub, draws):
    from fast_autoaugment_tpu_torch.ops.augment import op_index

    rows = policy[sub]
    return bool(((rows[:, 0] == op_index("Rotate")) & (draws[:, 0] < rows[:, 1])).any())


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _close_to_jax_or_better(got, jax_value, exact, init, what, drift):
    """The port's float32 tensor is at most twice as far from the float64
    run as the JAX package's is, plus 0.1% of what the steps changed; and
    the JAX package's is within `drift` of that change, so that a fault the
    port's float32 and float64 runs share cannot pass."""
    e_port = float(np.abs(got - exact).max())
    e_jax = float(np.abs(jax_value - exact).max())
    change = float(np.abs(exact - init).max())
    floor = 1e-7 + 1e-3 * change
    assert e_port <= 2 * e_jax + floor, (what, e_port, e_jax, floor)
    assert e_jax <= drift * change + 1e-7, (what, e_jax, change)


def _run_port(idx, ref, dtype):
    """Three port steps of stack `idx` in `dtype` (float64: the exact oracle)
    from the JAX init, with the JAX draws: per step the metrics (floats),
    the state_dict, the EMA (numpy) and the augmented batch (NHWC)."""
    name, family, args, b, image, policy, cutout, opt, ema, lr = STACKS[idx]
    model, fam = _port_model(family, args, ref["init"])
    model = model.to(dtype)
    optimizer = O.build_optimizer(opt, S.build_schedule(_lr_conf(lr), 4))
    state = ST.create_train_state(model, optimizer, use_ema=ema > 0)
    make = ST.imagenet_augment_fn if family == "imagenet" else ST.cifar_augment_fn
    inner = make(cutout, use_policy=policy is not None)
    out = []

    def augment_fn(images, pol, key, src):
        x = inner(images, pol, key, src)
        out.append({"augmented": x.detach().permute(0, 2, 3, 1).numpy().copy()})
        return x.to(dtype)

    src = JaxDraws(ref["table"])
    step = ST.make_train_step(model, optimizer, num_classes=args[-1], ema_mu=ema,
                              cutout_length=cutout, augment_fn=augment_fn, draw_source=src)
    key = np.asarray(jax.random.PRNGKey(50 + idx), np.uint32)
    pol = torch.from_numpy(policy if policy is not None else np.zeros((1, 1, 3), np.float32))
    for s, (x, y) in enumerate(_batches(60 + idx, STEPS, b, image, args[-1])):
        state, metrics = step(state, torch.from_numpy(x), torch.from_numpy(y), pol, key)
        assert state.step == s + 1 and state.opt_state.count == s + 1
        out[s].update(metrics={k: float(v) for k, v in metrics.items()},
                      sd={k: v.detach().double().numpy().copy()
                          for k, v in model.state_dict().items()},
                      ema=None if state.ema is None else
                      {k: v.double().numpy().copy() for k, v in state.ema.items()})
    return out, fam


@pytest.mark.parametrize("idx", range(len(STACKS)), ids=[s[0] for s in STACKS])
def test_train_steps_match_jax(idx, refs):
    name, family, args, b, image, policy, cutout, opt, ema, lr = STACKS[idx]
    ref = refs["steps"][idx]
    port, fam = _run_port(idx, ref, torch.float32)
    exact, _ = _run_port(idx, ref, torch.float64)
    init = {k: v.double().numpy() for k, v in flax_to_state_dict(ref["init"], fam).items()}
    src = JaxDraws(ref["table"])
    key = np.asarray(jax.random.PRNGKey(50 + idx), np.uint32)
    for s in range(STEPS):
        want = ref["steps"][s]
        # the augmented batch, image by image
        rotated = []
        if policy is not None:
            k_aug = src.split(src.fold_in(key, s, "cpu"), 2, "cpu")[0]
            d = src.draws(k_aug, batch=b, num_sub=policy.shape[0], num_op=policy.shape[1],
                          height=image, width=image, dispatch="exact", groups=8, device="cpu")
            rotated = [i for i in range(b) if _has_gated_rotate(policy, d.sub_idx.numpy()[i],
                                                                d.policy.numpy()[i])]
        for i in range(b):
            if i not in rotated:
                assert np.array_equal(port[s]["augmented"][i], want["augmented"][i]), (s, i)
        if s not in (0, STEPS - 1):
            continue
        m, m64, mj = port[s]["metrics"], exact[s]["metrics"], want["metrics"]
        assert m["num"] == mj["num"] == b
        for k in ("top1", "top5"):
            assert m[k] in (mj[k], m64[k]), (k, m[k], mj[k], m64[k])
        _close(m["loss"], mj["loss"], LOSS_RTOL, "loss")
        assert abs(m["loss"] - m64["loss"]) <= 2 * abs(mj["loss"] - m64["loss"]) \
            + 1e-6 * abs(m64["loss"])
        tensors = [(k, port[s]["sd"][k], v.double().numpy(), exact[s]["sd"][k])
                   for k, v in flax_to_state_dict(want["variables"], fam).items()]
        if ema:
            jema = flax_to_state_dict(want["ema"], fam)
            tensors += [("ema " + k, v, jema[k].double().numpy(), exact[s]["ema"][k])
                        for k, v in port[s]["ema"].items()]
        for k, got, jax_value, exact_value in tensors:
            if k.endswith("num_batches_tracked"):
                assert int(got) == s + 1, k
                continue
            _close_to_jax_or_better(got, jax_value, exact_value, init[k.split(" ")[-1]],
                                    f"{name} step {s + 1} {k}", JAX_DRIFT[name][s])


def _port_grads(family, args, variables, x, y, dtype):
    """The port's gradient of the loss at `variables` on the augmented batch
    ``x`` (NHWC) in `dtype`: by parameter name, and by BatchNorm module
    name the gradient with respect to its output (NHWC)."""
    from fast_autoaugment_tpu_torch.core.metrics import smooth_cross_entropy
    from fast_autoaugment_tpu_torch.models.layers import BatchNorm

    model, _ = _port_model(family, args, variables)
    model = model.to(dtype).train()
    outs = {}

    def keep(name):
        def hook(module, inputs, out):
            out.retain_grad()
            outs[name] = out
        return hook

    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(keep(name))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
    smooth_cross_entropy(model(xt), torch.from_numpy(y).long()).backward()
    return ({n: p.grad.double() for n, p in model.named_parameters()},
            {n: o.grad.double().permute(0, 2, 3, 1).numpy() for n, o in outs.items()})


def _step_inputs(ref, idx, s):
    """(variables before step s, its augmented batch, its labels) of the JAX run."""
    _, family, args, b, image, *_ = STACKS[idx]
    variables = ref["init"] if s == 0 else ref["steps"][s - 1]["variables"]
    y = _batches(60 + idx, STEPS, b, image, args[-1])[s][1]
    return variables, ref["steps"][s]["augmented"], y


def _relative_gradient_errors(family, grads, exact):
    """Per parameter: the largest |grad - exact| over the largest |exact|.
    The conv biases that feed a BatchNorm have a true gradient of 0 and are
    checked apart: they must be noise below 1e-6."""
    errs = {}
    for n, t in exact.items():
        if family == "cifar" and n.endswith("bias") and "bn" not in n and n != "linear.bias":
            assert float(grads[n].abs().max()) < 1e-6, n
            continue
        errs[n] = float((grads[n] - t).abs().max()) / float(t.abs().max())
    return errs


def _gate_flip(bn_got, bn_exact):
    """Whether a gradient's departure from the exact one starts at one ReLU
    gate: at the last BatchNorm in forward order whose output gradient
    departs (an element more than 1e-3 of the largest entry off), at most 4
    elements depart, and each is zero on one side and not on the other (the
    ReLU after it is closed for one and open for the other).  Returns
    (verdict, where) for the message."""
    departing = [(m, np.abs(bn_got[m] - want) > 1e-3 * np.abs(want).max())
                 for m, want in bn_exact.items()]  # forward order
    departing = [(m, bad) for m, bad in departing if bad.any()]
    if not departing:
        return False, "no BatchNorm output departs"
    m, bad = departing[-1]
    flips = (bn_got[m][bad] == 0) != (bn_exact[m][bad] == 0)
    return bool(flips.all() and bad.sum() <= 4), (m, int(bad.sum()), bn_got[m][bad],
                                                  bn_exact[m][bad])


def test_step_gradient_against_float64(refs):
    """The gradient at every step of both stacks, at the JAX run's
    variables before the step and on that step's augmented batch, against
    the port's float64 gradient there; for the port's float32 gradient and
    for the JAX package's.  Each is within 1e-4 of float64 (relative to
    each tensor's largest entry) or, where it is not, within 5% and its
    departure starts at one ReLU gate (``_gate_flip``, from the gradients
    with respect to every BatchNorm output: flax's ``perturb`` on the JAX
    side, ``retain_grad`` on the port's).  A pre-activation within float32
    rounding of 0 closes the gate for one program and opens it for the
    other; BatchNorm's backward spreads that one element over its channel
    and every earlier layer.  These runs hold such steps for both programs
    (JAX at CIFAR steps 1 and 3 and ImageNet step 2, the port at ImageNet
    step 3), and the test requires one for each, so the check of the cause
    is not vacuous."""
    flipped = {"port": 0, "jax": 0}
    for idx, (name, family, args, *_) in enumerate(STACKS):
        ref = refs["steps"][idx]
        fam = "wideresnet" if family == "cifar" else "resnet"
        for s in range(STEPS):
            variables, x, y = _step_inputs(ref, idx, s)
            g64, bn64 = _port_grads(family, args, variables, x, y, torch.float64)
            g32, bn32 = _port_grads(family, args, variables, x, y, torch.float32)
            gj = {k: v.double() for k, v in flax_to_state_dict(
                {"params": ref["steps"][s]["grads"], "batch_stats": variables["batch_stats"]},
                fam).items() if k in g64}
            for who, grads, bn in (("port", g32, bn32), ("jax", gj, ref["bn_grads"][s])):
                assert set(bn) == set(bn64)
                err = max(_relative_gradient_errors(family, grads, g64).values())
                print(f"{name} step {s + 1} {who}: gradient {err:.3g} off float64")
                if err <= 1e-4:
                    continue
                flip, where = _gate_flip(bn, bn64)
                assert flip and err <= 0.05, (name, s + 1, who, err, where)
                flipped[who] += 1
    assert flipped["port"] >= 1 and flipped["jax"] >= 1, flipped


def test_train_and_eval_matches_jax(refs, monkeypatch):
    ref = refs["train_and_eval"]

    def get_model(conf, num_classes, *, device="cuda", seed=0):
        model = WideResNet(10, 1, num_classes)
        model.load_state_dict(flax_to_state_dict(ref["init"], "wideresnet"))
        return model.to(device=device, memory_format=torch.channels_last)

    monkeypatch.setattr(TR, "get_model", get_model)
    calls = []
    got = TR.train_and_eval(TRAIN_CONF, "", test_ratio=0.4, cv_fold=1,
                            reporter=lambda **kw: calls.append(kw), evaluation_interval=1,
                            seed=0, device="cpu", draw_source=JaxDraws())
    want = ref["result"]
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "elapsed_sec":
            continue
        if k.startswith("num_") or k == "epoch":
            assert got[k] == v, k
        elif "loss" in k:
            _close(got[k], v, 1e-4, k)
        else:  # accuracies: at most one sample apart
            n = want.get("num_" + k.split("_", 1)[1], 128 * 2)
            assert abs(got[k] - v) <= 1.0 / n + 1e-7, (k, got[k], v)
    assert len(calls) == len(ref["reporter"]) == 1
    for k, v in ref["reporter"][0].items():
        assert abs(float(calls[0][k]) - v) <= max(1e-4 * abs(v), 1.0 / 205 + 1e-7), k


def _held_to_jax(got, want, n_default):
    """A port result against the JAX one: the same keys, counts exact,
    losses within 1e-4 relative, accuracies at most one sample apart."""
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "elapsed_sec":
            continue
        if k.startswith("num_") or k == "epoch":
            assert got[k] == v, k
        elif "loss" in k:
            _close(got[k], v, 1e-4, k)
        else:
            n = want.get("num_" + k.split("_", 1)[1], n_default)
            assert abs(got[k] - v) <= 1.0 / n + 1e-7, (k, got[k], v)


def test_imported_checkpoint_resumes_like_jax(refs, tmp_path):
    """JAX oracle: ``train_and_eval`` resumed from the same imported file
    (``imported_from``, ``has_ema`` false, no optimizer state; JAX
    ``tests/test_train.py:180-218`` on a WRN-10-1, 2 epochs).  Only epoch 2
    trains in both, the step after it is equal (the schedule placed at the
    resume epoch); the EMA is seeded from the imported weights (with the file
    at the last epoch, a run is an evaluation, and its EMA metrics equal its
    raw ones in both); the metrics within ``test_train_and_eval_matches_jax``'s
    tolerance of JAX's."""
    from fast_autoaugment_tpu_torch.core.checkpoint import read_metadata

    ref = refs["imported"]
    got = {}
    for name, epochs in (("train", IMPORTED_CONF["epoch"]), ("eval", 1)):
        path = _copy_checkpoint(ref["file"], str(tmp_path / f"port_{name}.msgpack"))
        got[name] = {"result": TR.train_and_eval(
            dict(IMPORTED_CONF, epoch=epochs), "", test_ratio=0.4, cv_fold=1, save_path=path,
            evaluation_interval=1, seed=0, device="cpu", draw_source=JaxDraws()),
            "meta": read_metadata(path)}
    train, jtrain = got["train"], ref["train"]
    assert train["result"]["epoch"] == jtrain["result"]["epoch"] == 2
    # 2 steps an epoch here: epoch 1's placed by the resume, epoch 2's trained
    assert train["meta"]["step"] == jtrain["meta"]["step"] == 4
    assert train["meta"]["epoch"] == 2 and "imported_from" not in train["meta"]
    _held_to_jax(train["result"], jtrain["result"], 128 * 2)
    evals, jevals = got["eval"]["result"], ref["eval"]["result"]
    assert evals["epoch"] == jevals["epoch"] == 1 and "loss_train" not in evals
    for res in (evals, jevals):
        for split in ("valid", "test"):
            for metric in ("loss", "top1", "top5"):
                assert res[f"{metric}_{split}_ema"] == res[f"{metric}_{split}_raw"], \
                    (metric, split)
    _held_to_jax(evals, jevals, 128 * 2)


def test_host_step_is_picked_once_and_explicitly():
    """The host feed's step is picked by ``host_step`` (and the CLIs'
    ``--host-step``), not by the tensors a call gets: a model on the CPU
    gets ``make_train_step``'s eager step from ``make_graphed_train_step``,
    and an unknown choice is refused."""
    from fast_autoaugment_tpu_torch.launch import search_cli as SC
    from fast_autoaugment_tpu_torch.launch import train_cli as TC

    model = WideResNet(10, 1, 10)
    opt = O.build_optimizer({"type": "sgd", "decay": 1e-4, "clip": 0}, lambda c: 0.05)
    step = ST.make_graphed_train_step(model, opt, num_classes=10)
    assert step.__qualname__ == ST.make_train_step(model, opt, num_classes=10).__qualname__
    assert TR.HOST_STEPS == ("graph", "eager")
    with pytest.raises(ValueError, match="host_step must be one of"):
        TR.train_and_eval(TRAIN_CONF, "", device="cpu", host_step="fast")
    conf = os.path.join(REPO, "confs", "wresnet40x2_cifar.yaml")
    for cli in (SC, TC):
        assert cli.parse_args(cli.build_parser(), ["-c", conf]).host_step == "graph"
        assert cli.parse_args(cli.build_parser(), ["-c", conf, "--host-step", "eager"]
                              ).host_step == "eager"
        with pytest.raises(SystemExit):
            cli.parse_args(cli.build_parser(), ["-c", conf, "--host-step", "fast"])


def test_train_and_eval_refuses_what_is_not_ported(tmp_path):
    # the watchdog, the compile cache and divergence retries are ported
    # (tests/test_torch_resilience.py, tests/test_torch_runtime.py); multistep dispatch gathers from the device cache: the host feed refuses it
    with pytest.raises(ValueError, match="needs the device cache"):
        TR.train_and_eval(TRAIN_CONF, "", device="cpu", device_cache="off",
                          steps_per_dispatch=4)
    with pytest.raises(ValueError, match="unknown device-cache mode"):
        TR.train_and_eval(TRAIN_CONF, "", device="cpu", device_cache="maybe")
    # ImageNet is ported: a one-image listing loads (lazily, nothing decoded)
    # and the run stops at the batch check
    for split in ("train", "val"):
        (tmp_path / f"{split}_cls.txt").write_text("n00000001/a.JPEG 1 1\n")
    with pytest.raises(ValueError, match="1 examples < batch 128"):
        TR.train_and_eval(dict(TRAIN_CONF, dataset="imagenet"), str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TR.train_and_eval(TRAIN_CONF, "")  # CUDA is the default


def test_train_step_on_the_cpu_with_philox_draws():
    """The port's own draws: the step is a function of (state, batch,
    key); no kernel launches on the CPU; grouped dispatch runs; the eval
    step and ``swapped_weights`` leave the weights as they were."""
    torch.manual_seed(0)
    b, image = 6, 16
    x, y = (torch.from_numpy(a) for a in _batches(1, 1, b, image, 10)[0])
    runs = []
    _kernels.reset_launch_counts()
    for dispatch in ("exact", "exact", "grouped"):
        torch.manual_seed(1)
        model = ResNet("imagenet", 18, 10).to(memory_format=torch.channels_last)
        opt = O.build_optimizer({"type": "sgd", "decay": 1e-4, "clip": 0}, lambda c: 0.05)
        state = ST.create_train_state(model, opt, use_ema=True)
        step = ST.make_train_step(model, opt, num_classes=10, ema_mu=0.9,
                                  augment_fn=ST.imagenet_augment_fn(8, True, dispatch, 2))
        state, m = step(state, x, y, torch.from_numpy(FA_IMAGENET), torch.tensor([0, 9]))
        runs.append((m, {k: v.clone() for k, v in model.state_dict().items()}))
        ev = ST.make_eval_step(model, num_classes=10, preprocess_fn=lambda t: t.float()
                               .permute(0, 3, 1, 2))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        with ST.swapped_weights(model, state.ema):
            e = ev(x, y, torch.ones(b))
        assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
        assert float(e["num"]) == b and 0 <= float(e["top1"]) <= float(e["top5"]) <= b
    assert all(v == 0 for v in _kernels.launch_counts().values())
    (m0, s0), (m1, s1), (m2, _) = runs
    assert float(m0["num"]) == b and np.isfinite(float(m0["loss"]))
    assert float(m0["loss"]) == float(m1["loss"]) and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert float(m2["loss"]) != float(m0["loss"])  # grouped draws differ
    # mixup draws from the step's key_mix: a function of (state, batch, key)
    # too, and another loss than without it
    mixed = []
    for _ in range(2):
        torch.manual_seed(1)
        model = ResNet("imagenet", 18, 10).to(memory_format=torch.channels_last)
        opt = O.build_optimizer({"type": "sgd", "decay": 1e-4, "clip": 0}, lambda c: 0.05)
        state = ST.create_train_state(model, opt, use_ema=False)
        step = ST.make_train_step(model, opt, num_classes=10, mixup_alpha=0.2,
                                  augment_fn=ST.imagenet_augment_fn(8, True, "exact", 2))
        mixed.append(float(step(state, x, y, torch.from_numpy(FA_IMAGENET),
                                torch.tensor([0, 9]))[1]["loss"]))
    assert mixed[0] == mixed[1] != float(m0["loss"]) and np.isfinite(mixed[0])


# ------------------------------------------------------------- data


@pytest.mark.parametrize("n,classes,ratio", [(500, 10, 0.4), (777, 7, 0.2), (50_000, 10, 0.4),
                                             (1000, 100, 0.15)])
def test_cv_split_matches_sklearn(n, classes, ratio):
    from sklearn.model_selection import StratifiedShuffleSplit

    labels = np.random.default_rng(n).integers(0, classes, n).astype(np.int32)
    sss = StratifiedShuffleSplit(n_splits=5, test_size=ratio, random_state=0)
    for fold, (tr, va) in enumerate(sss.split(np.zeros(n), labels)):
        got_tr, got_va = D.cv_split(labels, ratio, fold)
        assert np.array_equal(got_tr, tr) and np.array_equal(got_va, va), fold


def test_stratified_split_and_cifar_reader_match_jax(tmp_path):
    from fast_autoaugment_tpu.data import datasets as JD

    labels = np.random.default_rng(4).integers(0, 10, 50_000).astype(np.int32)
    for a, b in zip(D._stratified_split(labels, 46_000), JD._stratified_split(labels, 46_000)):
        assert np.array_equal(a, b)
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    g = np.random.default_rng(5)
    for name, n in [(f"data_batch_{i}", 20) for i in range(1, 6)] + [("test_batch", 10)]:
        with open(base / name, "wb") as fh:
            pickle.dump({b"data": g.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": g.integers(0, 10, n).tolist()}, fh)
    got, want = D.load_dataset("cifar10", str(tmp_path)), JD.load_dataset("cifar10", str(tmp_path))
    for a, b in zip(got, want):
        assert np.array_equal(a.images, b.images) and np.array_equal(a.labels, b.labels)
        assert a.images.dtype == np.uint8 and a.images.shape[1:] == (32, 32, 3)
    for name in ("synthetic", "synthetic100", "synthetic_shapes_n50"):
        for a, b in zip(D.load_dataset(name, ""), JD.load_dataset(name, "")):
            assert np.array_equal(a.images, b.images) and np.array_equal(a.labels, b.labels)
    # ImageNet is ported (tests/test_torch_imagenet_data.py holds it against JAX)
    for split in ("train", "val"):
        (tmp_path / f"{split}_cls.txt").write_text("n00000001/a.JPEG 1 1\n")
    for ds in D.load_dataset("imagenet", str(tmp_path)):
        assert ds.lazy and list(ds.labels) == [1] and ds.num_classes == 1000


def test_train_batches_match_jax():
    from fast_autoaugment_tpu.data import pipeline as JPL
    from fast_autoaugment_tpu.data.datasets import _synthetic

    ds = _synthetic(10, 100, 8)[0]
    idx = np.random.default_rng(0).permutation(100)[:70]
    for epoch in (1, 2):
        assert np.array_equal(PL.train_index_matrix(idx, 16, epoch, seed=3),
                              JPL.train_index_matrix(idx, 16, epoch, seed=3))
        got = list(PL.BatchIterator(ds, idx).train_epoch(16, epoch, seed=3))
        want = list(JPL.BatchIterator(ds, idx).train_epoch(16, epoch, seed=3))
        assert len(got) == len(want) == 4  # drop-last
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    assert np.array_equal(PL.train_index_matrix(idx, 16, 1, process_index=1, process_count=2),
                          JPL.train_index_matrix(idx, 16, 1, process_index=1, process_count=2))


# ------------------------------------------------- constants, imports


def test_chip_smoke_resnet50_constants_match_the_config():
    from fast_autoaugment_tpu.core.config import load_config

    sys.path.insert(0, REPO)
    import chip_smoke

    conf = load_config(os.path.join(REPO, "confs", "resnet50.yaml"))
    c = chip_smoke.RESNET50
    assert c["model"] == {"type": conf["model"]["type"]} and c["dataset"] == conf["dataset"]
    assert c["aug"] == conf["aug"] and c["cutout"] == conf["cutout"]
    assert (c["batch"], c["epoch"], c["lr"]) == (conf["batch"], conf["epoch"], conf["lr"])
    assert c["lr_schedule"]["type"] == conf["lr_schedule"]["type"]
    assert c["lr_schedule"]["warmup"] == dict(conf["lr_schedule"]["warmup"])
    for k in ("type", "nesterov", "decay", "clip", "ema"):
        assert c["optimizer"][k] == conf["optimizer"][k], k
    assert chip_smoke.IMAGENET_TRAIN_IMAGES // c["batch"] == 1_281_167 // 128
    assert TR.AUG_ALIASES[c["aug"]] == "fa_resnet50_rimagenet"


def test_training_modules_import_nothing_the_card_lacks():
    """The training, search, model-zoo, runtime, serving, ImageNet data,
    fleet, control-loop and game-day slices' modules and ``chip_smoke.py`` import in
    a fresh interpreter without JAX, flax, the JAX package, sklearn,
    PyYAML, msgpack or PIL."""
    mods = ["fast_autoaugment_tpu_torch.train.trainer", "fast_autoaugment_tpu_torch.train.steps",
            "fast_autoaugment_tpu_torch.ops.optim", "fast_autoaugment_tpu_torch.ops.schedules",
            "fast_autoaugment_tpu_torch.ops.preprocess_imagenet",
            "fast_autoaugment_tpu_torch.models.resnet", "fast_autoaugment_tpu_torch.data.datasets",
            "fast_autoaugment_tpu_torch.data.pipeline"]
    # the ImageNet data path's modules
    mods += ["fast_autoaugment_tpu_torch.data." + m
             for m in ("native_loader", "imagenet_tools", "jpeg_golden")]
    # the search slice's modules
    mods += ["fast_autoaugment_tpu_torch." + m for m in (
        "core.resilience", "core.msgpack", "core.checkpoint", "core.config", "utils.interop",
        "utils.logging", "utils.stats", "policies.archive", "search.tpe", "search.driver",
        "launch.search_cli", "launch.train_cli")] + ["chip_smoke"]
    # the model zoo's modules
    mods += ["fast_autoaugment_tpu_torch." + m for m in (
        "ops.rng", "ops.shake", "core.metrics", "models", "models.shake_resnet",
        "models.pyramidnet", "models.efficientnet")]
    # the search runtime's modules
    mods += ["fast_autoaugment_tpu_torch." + m for m in (
        "core.telemetry", "core.watchdog", "core.compilecache", "utils.faultinject",
        "utils.profiling", "search.census", "search.pipeline", "search.tta")]
    # the serving plane's modules
    mods += ["fast_autoaugment_tpu_torch." + m for m in (
        "core.fsfault", "serve.wire", "serve.policy_server", "serve.serve_cli",
        "serve.router", "serve.router_cli", "serve.autoscaler")]
    # the fleet tier and the TensorBoard bridge
    mods += ["fast_autoaugment_tpu_torch." + m for m in (
        "launch.fleet", "launch.workqueue", "utils.tb_events")]
    # the closed control loop
    mods += ["fast_autoaugment_tpu_torch." + m for m in (
        "control", "control.drift", "control.research", "control.canary", "control.resume",
        "control.loop", "launch.control_cli")]
    # the game days
    mods += ["fast_autoaugment_tpu_torch." + m for m in (
        "gameday", "gameday.scenario", "gameday.workload", "gameday.verdict",
        "gameday.runner", "launch.gameday_cli")]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "roots = {'jax', 'jaxlib', 'flax', 'fast_autoaugment_tpu', 'sklearn', 'yaml',\n"
            "         'msgpack', 'PIL', 'optax'}\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in roots)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
