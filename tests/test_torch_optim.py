"""The port's LR schedules, optimizer chain and EMA
(``fast_autoaugment_tpu_torch.ops.schedules``, ``.ops.optim``) against the
JAX package, on the CPU.

Oracles and bounds:

- ``build_schedule`` of the JAX package, jitted, at every step of short runs
  (and a sweep of a long one): cosine with and without warmup, resnet over
  90 and 270 epochs, efficientnet.  Bitwise, except (a) cosine, whose
  float32 ``cos`` is XLA's own approximation: within ``base_lr * 2**-23``
  absolute (one ulp of ``1 + cos`` at the scale of the rate), and (b) the
  warmup ramp with a multiplier other than 1, where XLA folds the two
  constant factors ``1/steps_per_epoch`` and ``(multiplier-1)/warmup`` into
  one: 1 ulp.  The repo's configs use multiplier 1;
- five updates of the optax chain of ``ops/optim.py build_optimizer``
  (SGD-nesterov with weight decay masked off BatchNorm, clip 5 and clip 0;
  RMSprop-TF), jitted, from the same parameters and gradients:
  |diff| <= 1e-6 + 1e-6 * |value| (the global norm is summed in another
  order; every other operation is the same float32 operation in the same
  order);
- ``ema_update`` over five steps: the same bound;
- ``non_bn_mask`` against the JAX mask on the same model's parameter
  names: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu.models.resnet import ResNet as JaxResNet
from fast_autoaugment_tpu.ops import optim as JO
from fast_autoaugment_tpu.ops import schedules as JS
from fast_autoaugment_tpu.utils.interop import import_state_dict
from fast_autoaugment_tpu_torch.models.resnet import ResNet
from fast_autoaugment_tpu_torch.ops import optim as O
from fast_autoaugment_tpu_torch.ops import schedules as S
from fast_autoaugment_tpu_torch.utils.interop import flax_to_state_dict

RTOL = ATOL = 1e-6

# (name, conf, steps_per_epoch, steps to check: None = every step)
SCHEDULES = [
    ("cosine_warmup", {"lr": 0.1, "epoch": 6, "lr_schedule": {
        "type": "cosine", "warmup": {"multiplier": 1, "epoch": 2}}}, 7, None),
    ("cosine_flagship_sweep", {"lr": 0.1, "epoch": 200, "lr_schedule": {
        "type": "cosine", "warmup": {"multiplier": 1, "epoch": 5}}}, 391, 3000),
    ("cosine_plain", {"lr": 0.2, "epoch": 20, "lr_schedule": {"type": "cosine"}}, 5, None),
    ("cosine_warmup_x2", {"lr": 0.1, "epoch": 20, "lr_schedule": {
        "type": "cosine", "warmup": {"multiplier": 2, "epoch": 3}}}, 7, None),
    ("resnet90", {"lr": 0.05, "epoch": 90, "lr_schedule": {
        "type": "resnet", "warmup": {"multiplier": 1, "epoch": 5}}}, 3, None),
    ("resnet90_x2", {"lr": 0.05, "epoch": 90, "lr_schedule": {
        "type": "resnet", "warmup": {"multiplier": 2, "epoch": 5}}}, 3, None),
    ("resnet270_resnet50_yaml", {"lr": 0.05, "epoch": 270, "lr_schedule": {
        "type": "resnet", "warmup": {"multiplier": 1, "epoch": 5}}}, 2, None),
    ("efficientnet", {"lr": 0.016, "epoch": 350, "lr_schedule": {
        "type": "efficientnet", "warmup": {"multiplier": 1, "epoch": 5}}}, 3, None),
]


@pytest.mark.parametrize("idx", range(len(SCHEDULES)), ids=[s[0] for s in SCHEDULES])
def test_build_schedule_matches_jax(idx):
    name, conf, spe, sweep = SCHEDULES[idx]
    total = int(conf["epoch"] * spe)
    steps = np.arange(total + 1) if sweep is None else np.unique(
        np.linspace(0, total, sweep).astype(np.int64))
    want = np.asarray(jax.jit(jax.vmap(JS.build_schedule(conf, spe)))(
        jnp.asarray(steps, jnp.int32)), np.float32)
    port = S.build_schedule(conf, spe)
    got = np.array([port(int(s)) for s in steps], np.float32)
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    kind = conf["lr_schedule"]["type"]
    multiplier = conf["lr_schedule"].get("warmup", {}).get("multiplier", 1)
    if kind == "cosine":
        assert np.abs(want - got).max() <= conf["lr"] * multiplier * 2.0**-23, name
    elif multiplier != 1:
        assert ulps.max() <= 1, name
    else:
        assert ulps.max() == 0, (name, int((ulps > 0).sum()))
    if kind != "cosine" and multiplier == 1:
        assert np.array_equal(got, want)


def test_schedule_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError):
        S.build_schedule({"lr": 0.1, "epoch": 100, "lr_schedule": {"type": "resnet"}}, 10)
    with pytest.raises(ValueError):
        S.build_schedule({"lr": 0.1, "epoch": 100, "lr_schedule": {"type": "linear"}}, 10)


# ---------------------------------------------------------------- optimizer


def _model_and_params(seed=0):
    """A CIFAR ResNet-8 (BatchNorm and conv parameters, a dense head), its
    JAX twin's parameters, and the port's parameter list in the same
    values."""
    jmodel = JaxResNet(dataset="cifar", depth=8, num_classes=10)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                                              jnp.zeros((1, 8, 8, 3))))
    model = ResNet("cifar", 8, 10)
    model.load_state_dict(flax_to_state_dict(variables, "resnet"))
    return jmodel, variables["params"], model


def _grads_like(params_tree, seed, scale):
    g = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (g.normal(0, scale, p.shape)).astype(np.float32), params_tree)


def _port_tree(model):
    """The port's parameters as a flax params tree, through the converter's
    inverse."""
    return import_state_dict({k: v.detach().numpy() for k, v in model.state_dict().items()},
                             "resnet")["params"]


def _assert_close(got_tree, want_tree):
    flat_want = jax.tree_util.tree_leaves_with_path(want_tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert len(flat_got) == len(flat_want)
    for path, w in flat_want:
        np.testing.assert_allclose(np.asarray(flat_got[path]), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=jax.tree_util.keystr(path))


def _grads_in_port_order(model, grads_tree):
    """A flax gradient tree -> the list in ``model.parameters()`` order."""
    full = {"params": grads_tree, "batch_stats": jax.tree.map(
        np.zeros_like, _stats_like(grads_tree))}
    sd = flax_to_state_dict(full, "resnet")
    names = [n for n, _ in model.named_parameters()]
    return [sd[n].clone() for n in names]


def _stats_like(params_tree):
    """A batch_stats tree for every BatchNorm_0 of a params tree."""
    def walk(node):
        out = {}
        for k, v in node.items():
            if k == "BatchNorm_0":
                out[k] = {"mean": np.zeros_like(v["scale"]), "var": np.zeros_like(v["scale"])}
            elif isinstance(v, dict):
                sub = walk(v)
                if sub:
                    out[k] = sub
        return out
    return walk(params_tree)


OPTIMIZERS = [
    ("sgd_nesterov_decay_clip5", {"type": "sgd", "nesterov": True, "decay": 5e-4}, 3.0),
    ("sgd_nesterov_decay_clip0", {"type": "sgd", "nesterov": True, "decay": 1e-4, "clip": 0}, 3.0),
    ("sgd_momentum_clip_inactive", {"type": "sgd", "nesterov": False, "decay": 2e-4}, 1e-4),
    ("rmsprop_tf_decay_clip5", {"type": "rmsprop", "decay": 1e-5}, 3.0),
]


@pytest.mark.parametrize("idx", range(len(OPTIMIZERS)), ids=[o[0] for o in OPTIMIZERS])
def test_five_steps_match_optax(idx):
    name, opt_conf, gscale = OPTIMIZERS[idx]
    conf = {"lr": 0.1, "epoch": 10, "lr_schedule": {"type": "cosine", "warmup": {
        "multiplier": 1, "epoch": 1}}}
    jlr, plr = JS.build_schedule(conf, 2), S.build_schedule(conf, 2)
    jopt = JO.build_optimizer(opt_conf, jlr)
    popt = O.build_optimizer(opt_conf, plr)
    _, params, model = _model_and_params()
    pparams = list(model.parameters())
    jstate, pstate = jopt.init(params), popt.init(pparams)
    mask = O.non_bn_mask(model)
    update = jax.jit(jopt.update)
    for step in range(5):
        grads = _grads_like(params, 100 + step, gscale)
        updates, jstate = update(grads, jstate, params)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)
        popt.step(pparams, _grads_in_port_order(model, grads), pstate, mask)
    assert pstate.count == 5
    _assert_close(_port_tree(model), params)


def test_clip_engages_and_rmsprop_alone():
    """Gradients of global norm > 5 are scaled to norm 5; ``rmsprop_tf``
    alone (no decay, no clip) matches the JAX transform."""
    _, params, model = _model_and_params(1)
    grads = _grads_like(params, 7, 3.0)
    plist = _grads_in_port_order(model, grads)
    opt = O.Optimizer("sgd", 1.0, clip=5.0, momentum=0.0, nesterov=False)
    p0 = [p.detach().clone() for p in model.parameters()]
    opt.step(list(model.parameters()), plist, opt.init(list(model.parameters())),
             [True] * len(p0))
    moved = torch.sqrt(sum(((p.detach() - q) ** 2).sum() for p, q in zip(model.parameters(), p0)))
    assert abs(float(moved) - 5.0) < 1e-4
    jt = JO.rmsprop_tf(0.01)
    pt = O.rmsprop_tf(0.01)
    _, params, model = _model_and_params(2)
    pparams = list(model.parameters())
    js, ps = jt.init(params), pt.init(pparams)
    update = jax.jit(jt.update)
    for step in range(5):
        grads = _grads_like(params, 200 + step, 1.0)
        updates, js = update(grads, js, params)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)
        pt.step(pparams, _grads_in_port_order(model, grads), ps, [True] * len(pparams))
    _assert_close(_port_tree(model), params)


def test_ema_update_matches_jax():
    _, params, model = _model_and_params(3)
    shadow = O.init_ema(model)
    jshadow = jax.tree.map(np.asarray, params)
    tensors = O.ema_tensors(model)
    for step in range(1, 6):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01 * step)
        new = _port_tree(model)
        jshadow = jax.tree.map(np.asarray, JO.ema_update(jshadow, new, 0.999, step))
        O.ema_update(shadow, tensors, 0.999, step)
    got = {k: v for k, v in shadow.items()}
    model.load_state_dict({**model.state_dict(), **got})
    _assert_close(_port_tree(model), jshadow)
    assert set(shadow) == {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}


def test_non_bn_mask_matches_jax():
    _, params, model = _model_and_params()
    jmask = JO.non_bn_mask(params)
    names = [n for n, _ in model.named_parameters()]
    got = dict(zip(names, O.non_bn_mask(model)))
    # the JAX mask through the converter's names: a leaf is decayed iff its
    # path has no "bn"
    flat = {jax.tree_util.keystr(p): bool(m) for p, m in jax.tree_util.tree_leaves_with_path(jmask)}
    assert sum(flat.values()) == sum(got.values())
    assert len(flat) == len(got)
    for n, decayed in got.items():
        assert decayed == (".bn" not in n and not n.startswith("bn")
                           and "downsample.1" not in n), n
