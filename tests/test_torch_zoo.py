"""The port's model zoo (``models/shake_resnet.py``, ``models/pyramidnet.py``,
``models/efficientnet.py``, ``get_model``, the ``utils/interop.py``
families) against the JAX package, on the CPU.

Oracles and bounds:

- parameter counts: ``get_model`` on the meta device for the model of each
  of the 18 presets in ``confs/`` against the JAX package's model of that
  preset (``jax.eval_shape`` of its ``init``), and against the reference
  counts the JAX tests hold (``tests/test_models.py:19-28``, ``:70``,
  ``tests/test_efficientnet.py:28-36``); ``bf16`` raises naming item 9b;
- each family at a small size (ShakeResNet 26 2x32d, ShakeResNeXt 11 2x64d,
  PyramidNet 11 bottleneck and 20 basic, EfficientNet-b0 with 4 CondConv
  experts at 32x32) with the JAX init carried over by ``flax_to_state_dict``:
  the eval forward within ``FWD_RTOL`` of the JAX logits (relative to their
  largest entry); the train-mode forward with the JAX package's noise
  **recorded** (``sample_shake_shake_noise``, ``sample_shake_drop_noise``,
  ``drop_connect`` and flax dropout's Bernoulli are wrapped in the JAX
  modules' namespaces inside the test) and replayed into the port through
  ``ModelNoise``: the new BatchNorm statistics within ``FWD_RTOL`` of
  JAX's; the logits and the parameter gradients of a fixed linear loss
  (per tensor, relative to its largest entry) held against the port's
  float64 run: the port's float32 run at most ``FACTOR`` (4) times as far
  from it as the JAX package's, plus ``*_FLOOR``, and the JAX package's
  within ``*_RTOL``
  (so that a fault shared by the port's two runs fails); a gradient that is
  0 in float64 (a BatchNorm bias feeding another BatchNorm) is noise below
  1e-5 of the largest gradient in both programs;
- the way back: ``tensors_to_flax`` of the port's ``state_dict`` is the JAX
  tree, leaf for leaf, for each family;
- TensorFlow ``SAME`` padding (``Conv2dSame``) against XLA's ``SAME``
  convolution at odd and even sizes, strides 1 and 2, kernels 1, 3 and 5,
  within 1e-5 relative; PyramidNet's shortcut (2x2 average pool with
  ``ceil_mode`` over the valid pixels, zero channels) against the JAX
  ``_shortcut_add`` at 7x9, bitwise, and a PyramidNet's eval forward at
  15x13 within ``FWD_RTOL``;
- JAX-written train states (small Shake-Shake; small EfficientNet with
  CondConv, RMSprop and the EMA) load into the port, and the port saves them
  back with a byte-equal payload and an equal sidecar.
"""

import contextlib
import dataclasses
import os
import types

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu.core import checkpoint as JC
from fast_autoaugment_tpu.models import efficientnet as JE
from fast_autoaugment_tpu.models import get_model as jax_get_model
from fast_autoaugment_tpu.models import input_image_size as jax_input_image_size
from fast_autoaugment_tpu.models import num_class as jax_num_class
from fast_autoaugment_tpu.models import pyramidnet as JP
from fast_autoaugment_tpu.models import shake_resnet as JSR
from fast_autoaugment_tpu.ops.optim import build_optimizer as jax_build_optimizer
from fast_autoaugment_tpu.train.steps import create_train_state as jax_create_train_state
from fast_autoaugment_tpu_torch.core import checkpoint as C
from fast_autoaugment_tpu_torch.core.config import load_config
from fast_autoaugment_tpu_torch.models import efficientnet as E
from fast_autoaugment_tpu_torch.models import get_model
from fast_autoaugment_tpu_torch.models import pyramidnet as P
from fast_autoaugment_tpu_torch.models import shake_resnet as SR
from fast_autoaugment_tpu_torch.models.layers import Conv2dSame, same_padding
from fast_autoaugment_tpu_torch.ops.optim import build_optimizer
from fast_autoaugment_tpu_torch.ops.shake import ModelNoise
from fast_autoaugment_tpu_torch.train.steps import create_train_state
from fast_autoaugment_tpu_torch.utils import interop as I

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the largest departure of a float32 program from the port's float64 run,
# relative to the largest entry: the JAX package's is held under *_RTOL and
# the port's under FACTOR times the JAX package's plus *_FLOOR, on 2 torch
# threads (``two_threads`` below).  Readings: logits 2e-6
# (JAX) and 1.4e-6 (port) on ShakeResNet, 4e-5 and 2.1e-5 on EfficientNet,
# where the last BatchNorms see 4 values per channel; gradients below 1e-5
# on the CIFAR families; on EfficientNet 1.1e-3 (JAX), and the port's up to
# 2.05 times JAX's on a tensor (1.4 on 8 threads, 2.4 on one)
FWD_RTOL, FWD_FLOOR = 1e-4, 1e-6
GRAD_RTOL, GRAD_FLOOR = 5e-3, 1e-5
FACTOR = 4
# reference parameter counts the JAX tests hold (torch-cpu reference modules)
REF_COUNTS = {("shakeshake26_2x32d", 0): 2923146, ("shakeshake26_2x96d", 0): 26192906,
              ("shakeshake26_2x112d", 0): 35640426, ("wresnet40_2", 0): 2246474,
              ("wresnet28_10", 0): 36489290, ("resnet50", 0): 25557032,
              ("pyramid", 0): 26210842, ("efficientnet-b0", 0): 5288548,
              ("efficientnet-b1", 0): 7794184}
PRESETS = sorted(f for f in os.listdir(os.path.join(REPO, "confs")) if f.endswith(".yaml"))


def _count(tree) -> int:
    return sum(int(np.prod(p.shape)) for p in jax.tree.leaves(tree))



@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Run the port's models on 2 CPU threads, whatever the host has: the
    float32 bounds here depend on the count (torch's CPU reductions split by
    thread), and CondConv's grouped convolution has thousands of tiny groups,
    each paying the pool's fork and join (an EfficientNet-b0 step at batch 4
    and 32x32 took 5.7 s on 8 threads and 0.16 s on one; under 6 test
    workers it took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("preset", PRESETS)
def test_get_model_builds_every_preset_with_the_jax_parameter_count(preset):
    conf = load_config(os.path.join(REPO, "confs", preset))
    model_conf = dict(conf["model"], dataset=conf["dataset"])
    classes = jax_num_class(conf["dataset"])
    port = get_model(model_conf, classes, device="meta")
    n = sum(p.numel() for p in port.parameters())
    size = jax_input_image_size(conf["dataset"], model_conf["type"])
    jmodel = jax_get_model(model_conf, classes)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "shake": jax.random.PRNGKey(1)},
        jnp.zeros((1, size, size, 3)), train=False))
    assert n == _count(shapes["params"])
    ref = REF_COUNTS.get((model_conf["type"], 0))
    if ref is not None and classes in (10, 1000):
        assert n == ref


def test_condconv_counts_and_precision():
    m = get_model({"type": "efficientnet-b0-condconv", "condconv_num_expert": 4}, 1000,
                  device="meta")
    assert sum(p.numel() for p in m.parameters()) == 13314116
    assert sum(p.numel() for p in get_model(
        {"type": "shakeshake26_2x96d_next"}, 10, device="meta").parameters()) == 22717706
    with pytest.raises(NotImplementedError, match="item 9b"):
        get_model({"type": "shakeshake26_2x96d", "precision": "bf16"}, 10, device="cpu")


# ------------------------------------------------------------- families


# (name, interop family, jax model, port model, image, batch)
FAMILIES = [
    ("shake_resnet_26_2x32d", "shakeshake", lambda: JSR.ShakeResNet(26, 32, 10),
     lambda: SR.ShakeResNet(26, 32, 10), 16, 4),
    ("shake_resnext_11_2x64d", "shakeshake_next", lambda: JSR.ShakeResNeXt(11, 64, 4, 10),
     lambda: SR.ShakeResNeXt(11, 64, 4, 10), 8, 3),
    ("pyramid_11_bottleneck", "pyramid", lambda: JP.PyramidNet("cifar10", 11, 48, 10, True),
     lambda: P.PyramidNet(11, 48, 10, True), 16, 4),
    ("pyramid_20_basic", "pyramid", lambda: JP.PyramidNet("cifar10", 20, 24, 10, False),
     lambda: P.PyramidNet(20, 24, 10, False), 16, 4),
    ("efficientnet_b0_condconv4", "efficientnet",
     lambda: JE.EfficientNet.from_name("efficientnet-b0", 10, condconv_num_expert=4),
     lambda: E.EfficientNet.from_name("efficientnet-b0", 10, condconv_num_expert=4), 32, 4),
]


@contextlib.contextmanager
def recorded_jax_noise():
    """Wrap the JAX models' noise draws so each call's tensors are kept, in
    call order, as ``(kind, tensors)`` (numpy): ShakeShake's (alpha, beta),
    ShakeDrop's (gate, alpha, beta), drop-connect's keep mask (float), and
    dropout's keep mask (flax ``Dropout`` draws it with
    ``jax.random.bernoulli`` from ``flax.linen.stochastic``).  The values leave
    a compiled program through ordered ``jax.debug.callback``s, so the JAX
    side runs jitted and its draws are the jitted program's."""
    calls = []
    saved = (JSR.sample_shake_shake_noise, JP.sample_shake_drop_noise, JE.drop_connect,
             flax_stochastic.random)

    def record(kind, values):
        jax.debug.callback(lambda *v: calls.append((kind, tuple(np.array(a) for a in v))),
                           *values, ordered=True)

    def shake_shake(*a, **kw):
        out = saved[0](*a, **kw)
        record("shake_shake", out)
        return out

    def shake_drop(*a, **kw):
        out = saved[1](*a, **kw)
        record("shake_drop", out)
        return out

    def drop_connect(x, key, drop_p, train):
        if not train:
            return saved[2](x, key, drop_p, train)
        keep = jax.random.bernoulli(key, 1.0 - drop_p, (x.shape[0], 1, 1, 1))
        record("drop_connect", (keep.astype(jnp.float32),))
        return x * keep.astype(x.dtype)

    def bernoulli(*a, **kw):
        out = jax.random.bernoulli(*a, **kw)
        record("dropout", (out,))
        return out

    JSR.sample_shake_shake_noise, JP.sample_shake_drop_noise, JE.drop_connect = \
        shake_shake, shake_drop, drop_connect
    flax_stochastic.random = types.SimpleNamespace(bernoulli=bernoulli)
    try:
        yield calls
    finally:
        (JSR.sample_shake_shake_noise, JP.sample_shake_drop_noise, JE.drop_connect,
         flax_stochastic.random) = saved


def noise_from_calls(calls, dtype=torch.float32) -> ModelNoise:
    """The recorded JAX draws as the port's ``ModelNoise`` (one site per
    call, in order; the per-sample ``[B, 1, 1, 1]`` shapes carry over)."""
    tensors = []
    for kind, arrs in calls:
        ts = tuple(torch.from_numpy(np.array(a)) for a in arrs)
        if kind != "dropout":
            ts = tuple(t.to(dtype) for t in ts)
        tensors.append(ts)
    return ModelNoise(tensors, [k for k, _ in calls])


def _numpy(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _port(i, variables, dtype=torch.float32):
    name, fam, _, make, *_ = FAMILIES[i]
    model = make()
    model.load_state_dict(I.flax_to_state_dict(variables, fam, model=model))
    return model.to(dtype=dtype, memory_format=torch.channels_last)


def _input(i, seed=0):
    *_, image, batch = FAMILIES[i]
    g = np.random.default_rng(seed)
    return g.standard_normal((batch, image, image, 3)).astype(np.float32)


def _to_port(x, dtype=torch.float32):
    return torch.from_numpy(np.transpose(x, (0, 3, 1, 2))).to(dtype).contiguous(
        memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def jax_runs():
    """Per family, compiled: the JAX init, the eval logits, and one train-mode
    forward and backward of ``sum(logits * w)`` with its recorded noise, its
    gradients and its new BatchNorm statistics."""
    out = []
    for i, (name, fam, make_jax, *_) in enumerate(FAMILIES):
        model = make_jax()
        x = jnp.asarray(_input(i))
        variables = _numpy(jax.jit(lambda x: model.init(  # noqa: B023
            {"params": jax.random.PRNGKey(i), "shake": jax.random.PRNGKey(100 + i)}, x,
            train=False))(x))
        logits_eval = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(  # noqa
            variables, x))
        w = np.random.default_rng(50 + i).standard_normal(logits_eval.shape).astype(np.float32)

        def loss(params):
            logits, mutated = model.apply(  # noqa: B023
                {"params": params, "batch_stats": variables["batch_stats"]}, x,  # noqa: B023
                train=True, mutable=["batch_stats"],
                rngs={"shake": jax.random.PRNGKey(200 + i), "dropout": jax.random.PRNGKey(300 + i)})
            return (logits * w).sum(), (logits, mutated["batch_stats"])  # noqa: B023

        with recorded_jax_noise() as calls:
            (_, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                variables["params"])
            jax.effects_barrier()
        out.append({"variables": variables, "eval": logits_eval, "w": w, "calls": list(calls),
                    "logits": np.asarray(logits), "stats": _numpy(stats),
                    "grads": _numpy(grads)})
    return out


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(),
                                                                         1e-30))


@pytest.mark.parametrize("i", range(len(FAMILIES)), ids=[f[0] for f in FAMILIES])
def test_eval_forward_matches_jax(i, jax_runs):
    ref = jax_runs[i]
    model = _port(i, ref["variables"]).eval()
    with torch.no_grad():
        got = model(_to_port(_input(i))).numpy()
    assert got.shape == ref["eval"].shape
    assert _rel(got, ref["eval"]) <= FWD_RTOL, _rel(got, ref["eval"])


def _port_train(i, ref, dtype):
    model = _port(i, ref["variables"], dtype).train()
    logits = model(_to_port(_input(i), dtype), noise=noise_from_calls(ref["calls"], dtype))
    (logits * torch.from_numpy(ref["w"]).to(dtype)).sum().backward()
    grads = {n: p.grad.detach().double().numpy() for n, p in model.named_parameters()}
    return model, logits.detach().double().numpy(), grads


@pytest.mark.parametrize("i", range(len(FAMILIES)), ids=[f[0] for f in FAMILIES])
def test_train_forward_and_gradients_with_replayed_jax_noise(i, jax_runs):
    ref = jax_runs[i]
    name, fam, *_ = FAMILIES[i]
    kinds = [k for k, _ in ref["calls"]]
    model, logits, grads = _port_train(i, ref, torch.float32)
    assert kinds == [s.kind for s in model.modules() if hasattr(s, "kind")]
    assert len(kinds) > 0 and (name.startswith("efficientnet") == ("dropout" in kinds))
    _, logits64, grads64 = _port_train(i, ref, torch.float64)
    layout = I.flax_layout(model)
    stats = I.flax_to_tensors({"params": ref["variables"]["params"],
                               "batch_stats": ref["stats"]}, layout)
    sd = model.state_dict()
    for k, want in stats.items():
        if k.endswith("running_var"):
            assert _rel(sd[k].numpy(), want) <= FWD_RTOL, k
        elif k.endswith("running_mean"):
            # 0.1 x the batch mean, near 0 after a BatchNorm: held against
            # 0.1 x the batch's standard deviation, read from running_var
            # (0.9 + 0.1 x the batch variance)
            std = np.sqrt(np.maximum(stats[k[:-4] + "var"] - 0.9, 0) * 10).max()
            err = np.abs(sd[k].numpy() - want).max()
            assert err <= FWD_RTOL * max(np.abs(want).max(), 0.1 * std), k
    names = [n for n, _ in model.named_parameters()]
    jgrads = I.flax_to_tensors({"params": ref["grads"]}, layout, names)
    top = max(np.abs(g).max() for g in grads64.values())
    worst = {}
    for n in names:
        scale = np.abs(grads64[n]).max()
        if scale <= 1e-6 * top:
            # a true gradient of 0 (the bias of a BatchNorm whose output
            # feeds another BatchNorm): both programs give rounding noise
            assert max(np.abs(grads[n]).max(), np.abs(jgrads[n]).max()) <= 1e-5 * top, n
            continue
        e_port = float(np.abs(grads[n] - grads64[n]).max() / scale)
        e_jax = float(np.abs(jgrads[n] - grads64[n]).max() / scale)
        if e_port > FACTOR * e_jax + GRAD_FLOOR or e_jax > GRAD_RTOL:
            worst[n] = (e_port, e_jax)
    assert not worst, (name, worst)
    e_port, e_jax = _rel(logits, logits64), _rel(ref["logits"], logits64)
    assert e_port <= FACTOR * e_jax + FWD_FLOOR and e_jax <= FWD_RTOL, (e_port, e_jax)


@pytest.mark.parametrize("i", range(len(FAMILIES)), ids=[f[0] for f in FAMILIES])
def test_flax_layout_is_the_way_back(i, jax_runs):
    ref = jax_runs[i]
    model = _port(i, ref["variables"])
    layout = I.flax_layout(model)
    sd = model.state_dict()
    tree = I.tensors_to_flax({k: sd[k] for k in layout}, layout)
    want = {"params": ref["variables"]["params"], "batch_stats": ref["variables"]["batch_stats"]}
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert np.array_equal(a, b)


def test_interop_refuses_a_tree_without_its_model():
    with pytest.raises(ValueError, match="model="):
        I.flax_to_state_dict({"params": {}, "batch_stats": {}}, "pyramid")
    with pytest.raises(ValueError, match="family"):
        I.flax_to_state_dict({"params": {}, "batch_stats": {}}, "densenet")


# --------------------------------------------------- padding and pooling


@pytest.mark.parametrize("size", [7, 8, 9, 13, 224])
def test_tf_same_padding_matches_xla(size):
    g = np.random.default_rng(size)
    if size == 224:
        assert same_padding(224, 3, 2) == (0, 1) and same_padding(224, 5, 2) == (1, 2)
        size = 16
    for k in (1, 3, 5):
        for s in (1, 2):
            x = g.standard_normal((2, size, size + 1, 4)).astype(np.float32)
            w = g.standard_normal((k, k, 4, 6)).astype(np.float32)
            want = np.asarray(jax.lax.conv_general_dilated(
                jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC")))
            conv = Conv2dSame(4, 6, k, s)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(np.transpose(w, (3, 2, 0, 1))))
                got = conv(_to_port(x)).permute(0, 2, 3, 1).numpy()
            assert got.shape == want.shape, (k, s)
            assert _rel(got, want) <= 1e-5, (k, s)


def test_pyramid_shortcut_at_odd_size_matches_jax():
    g = np.random.default_rng(7)
    x = g.standard_normal((2, 7, 9, 5)).astype(np.float32)
    out = g.standard_normal((2, 4, 5, 8)).astype(np.float32)
    want = np.asarray(JP._shortcut_add(jnp.asarray(x), jnp.asarray(out), 2))
    got = P._shortcut_add(_to_port(x), _to_port(out), 2).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got, want)
    jmodel = JP.PyramidNet("cifar10", 11, 48, 10, True)
    xs = g.standard_normal((2, 15, 13, 3)).astype(np.float32)
    variables = _numpy(jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.asarray(xs)))
    port = P.PyramidNet(11, 48, 10, True)
    port.load_state_dict(I.flax_to_state_dict(variables, "pyramid", model=port))
    with torch.no_grad():
        got = port.eval()(_to_port(xs)).numpy()
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(xs))
    assert _rel(got, np.asarray(want)) <= FWD_RTOL


# ---------------------------------------------------------- checkpoints



def _small_efficientnet(mod, experts=4):
    """Two block groups of EfficientNet-b0, the second with CondConv."""
    first = mod.decode_block_string("r1_k3_s11_e1_i32_o16_se0.25")
    second = mod.decode_block_string("r2_k3_s22_e6_i16_o24_se0.25")
    return mod.EfficientNet((first, dataclasses.replace(second, condconv_num_expert=experts)),
                            1.0, 1.0, 0.2, 10)


# (name, jax model, port model, interop family, optimizer, ema)
CHECKPOINTS = [
    ("shakeshake26_2x32d_sgd", lambda: JSR.ShakeResNet(26, 32, 10),
     lambda: SR.ShakeResNet(26, 32, 10), "shakeshake",
     {"type": "sgd", "nesterov": True, "decay": 0.001}, 0.0),
    ("efficientnet_condconv4_rmsprop_ema", lambda: _small_efficientnet(JE),
     lambda: _small_efficientnet(E), "efficientnet",
     {"type": "rmsprop", "decay": 1e-5, "clip": 0}, 0.9999),
]


@pytest.mark.parametrize("case", CHECKPOINTS, ids=[c[0] for c in CHECKPOINTS])
def test_jax_checkpoint_loads_and_saves_back_byte_equal(tmp_path, case):
    name, make_jax, make_port, fam, opt_conf, ema = case
    jmodel = make_jax()
    jopt = jax_build_optimizer(opt_conf, lambda s: 0.05)
    state = jax.jit(lambda: jax_create_train_state(jmodel, jopt, jax.random.PRNGKey(3),
                                                   jnp.zeros((2, 32, 32, 3)),
                                                   use_ema=ema > 0))()
    # a state with every buffer nonzero and distinct: random leaves
    g = np.random.default_rng(4)
    rand = lambda a: jnp.asarray(g.standard_normal(np.shape(a)).astype(np.float32))  # noqa
    state = state.replace(step=jnp.asarray(7, jnp.int32), params=jax.tree.map(rand, state.params),
                          batch_stats=jax.tree.map(lambda a: jnp.abs(rand(a)), state.batch_stats),
                          opt_state=jax.tree.map(lambda a: rand(a) if a.dtype == jnp.float32
                                                 else jnp.asarray(7, a.dtype), state.opt_state),
                          ema=None if state.ema is None else jax.tree.map(rand, state.ema))
    meta = {"epoch": 2, "step": 7, "metrics": {"loss_train": 1.5}}
    jpath, ppath = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    JC.save_checkpoint(jpath, state, dict(meta))
    model = make_port()
    opt = build_optimizer(opt_conf, lambda c: 0.05)
    port = create_train_state(model, opt, use_ema=ema > 0)
    I.load_flax_train_state(C.load_checkpoint(jpath), port, opt)
    assert port.step == 7 and port.opt_state.count == 7
    sd = model.state_dict()
    want = I.flax_to_tensors(jax.tree.map(np.asarray, {"params": state.params,
                                                       "batch_stats": state.batch_stats}),
                             I.flax_layout(model))
    assert all(torch.equal(sd[k], torch.from_numpy(v)) for k, v in want.items())
    C.save_checkpoint(ppath, I.train_state_to_flax(port, opt), dict(meta))
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    for key in ("digest", "nbytes", "epoch", "step", "metrics"):
        assert C.read_metadata(ppath)[key] == JC.read_metadata(jpath)[key]
