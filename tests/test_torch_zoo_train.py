"""One train step of each new family (``train/steps.py make_train_step`` with
the model's noise, and mixup) against the JAX package's step, on the CPU.

Oracle: ``make_train_step`` of the JAX package, compiled without fused
multiply-add in one reference process per family (``test_torch_replay.
jax_reference_groups``), from the same initial weights (the JAX init through
``flax_to_state_dict``), over three steps (one for EfficientNet):

- ShakeResNet 26 2x32d on the CIFAR stack (the ``fa_reduced_cifar10``
  policy, cutout 16, SGD-nesterov with decay 1e-3, ``shake26_2x96d_cifar``'s
  optimizer);
- PyramidNet 11 (bottleneck, alpha 48) with ShakeDrop on the CIFAR stack
  (``pyramid272_cifar``'s optimizer);
- EfficientNet-b0 with 4 CondConv experts at 32x32 on the ImageNet stack
  with mixup 0.2, label smoothing 0.1, RMSprop with decay 1e-5 and the EMA
  at 0.9999 (``efficientnet_b0_condconv``'s settings).

The same draws on both sides: the augmentation's through
``test_torch_replay.JaxDraws`` (``jax_threefry_partitionable`` pinned to
True), the model's noise and mixup's ``lam`` and permutation **recorded** in
the JAX step (``test_torch_zoo.recorded_jax_noise``, and ``mixup_batch``
wrapped in the JAX step module's namespace) and replayed into the port's step
through its draw source.  The same steps also run in float64 (the port's
model and optimizer), the exact oracle.  After step 1 and step 3 (step 1
alone for EfficientNet: at 32x32 its last BatchNorms see 8 values per
channel, and after three steps the two float32 programs and the float64 run
are far apart: loss sums 57.6 (port), 37.4 (JAX) and 46.2 (float64)): the
top-1 and top-5 counts equal to JAX's or to the float64 run's and the loss
sum within ``LOSS_RTOL`` of JAX's, as ``tests/test_torch_train.py`` holds
WRN-10-1; then each float32 program, the port's and the JAX package's
alike, within ``BOUNDS`` of the float64 run: the loss sum's relative
distance, and for the tensors the steps changed (parameters, BatchNorm
statistics, the EMA) their distance over that change, its largest, median
and 90th percentile, and the largest distance of a tensor the steps left
(near) unchanged.

Why bounds and not a ratio to the JAX package's distance (WRN's rule): a
ShakeDrop gate, a drop-connect mask or a ReLU turns one rounding
difference into a different step, in either program and at any seed, so
the two float32 programs' distances are alike in spread but not seed by
seed.  Over seeds 0-5 (the batches' and keys' seeds shifted by 0-5) the
port's median distance read up to 750 times the JAX package's (PyramidNet,
seed 2, step 3: 4.7e-3 against 6.3e-6) and the JAX package's up to 300
times the port's (PyramidNet, seed 5, step 1: 2.75e-3 against 9.3e-6), and
JAX's own largest distance reached 0.27 at EfficientNet seed 2.  Each
bound is twice the largest reading of either program over those seeds,
rounded up (:func:`readings` prints them); a control, the port's float32
step with the model's input rounded to bfloat16, reads above it at every
seed except where ``BOUNDS`` says otherwise.  The port runs on 2 torch threads:
its float32 CPU reductions change with the thread count (Shake-Shake's
median distance at step 1 reads 3.7e-3 on one thread, 1.9e-4 on two,
1.25e-4 on eight), so the bounds are held at one count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu_torch.models import efficientnet as E
from fast_autoaugment_tpu_torch.models import pyramidnet as P
from fast_autoaugment_tpu_torch.models import shake_resnet as SR
from fast_autoaugment_tpu_torch.ops import optim as O
from fast_autoaugment_tpu_torch.ops import schedules as S
from fast_autoaugment_tpu_torch.ops.shake import noise_sites
from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
from fast_autoaugment_tpu_torch.train import steps as ST
from fast_autoaugment_tpu_torch.utils.interop import flax_to_state_dict
from test_torch_replay import JaxDraws, jax_reference_groups
from test_torch_train import LOSS_RTOL, _batches, _close, _lr_conf
from test_torch_zoo import noise_from_calls, recorded_jax_noise

PARTITIONABLE = True
STEPS = {"shake": 3, "pyramid": 3, "efficientnet": 1}
# per family and held step (index): the bounds on each float32 program's
# distance from the float64 run (see the module's docstring), and beside each
# the largest readings over seeds 0-5 of the port, the JAX package and the
# bfloat16-input control (the control's least reading), from :func:`readings`;
# the unchanged tensors' distance never separates the control, the other
# exceptions are named
BOUNDS = {
    "shake": {
        # loss 2.43e-7, 1.94e-7, 3.20e-5; max 0.172, 0.092, 0.316; p50 8.9e-3,
        # 1.5e-3, 0.085; p90 0.028, 0.011, 0.193 (the largest distance does not
        # separate the control at seeds 1 and 3)
        0: {"loss": 4.9e-7, "max": 0.35, "p50": 0.018, "p90": 0.057, "still": 0.0},
        # loss 1.87e-4, 2.34e-4, 6.6e-5; max 0.172, 0.146, 0.409; p50 0.056, 0.047,
        # 0.127; p90 0.120, 0.098, 0.296 (the loss does not separate the control
        # at seed 1)
        2: {"loss": 4.7e-4, "max": 0.35, "p50": 0.12, "p90": 0.24, "still": 0.0}},
    "pyramid": {
        # loss 2.50e-7, 1.03e-7, 2.20e-5; max 0.020, 0.029, 0.100; p50 4.5e-4,
        # 2.75e-3, 0.020; p90 6.1e-3, 9.4e-3, 0.075; unchanged 1.79e-6, 6.4e-7
        0: {"loss": 5.0e-7, "max": 0.059, "p50": 5.6e-3, "p90": 0.019, "still": 3.6e-6},
        # loss 1.12e-4, 2.48e-4, 7.6e-5; max 0.114, 0.082, 0.250; p50 0.0146,
        # 0.0185, 0.0348; p90 0.050, 0.053, 0.143; unchanged 2.44e-6, 9.4e-7 (the
        # loss does not separate the control at 4 seeds, the median at seed 4)
        2: {"loss": 5.0e-4, "max": 0.23, "p50": 0.037, "p90": 0.11, "still": 4.9e-6}},
    "efficientnet": {
        # loss 5.34e-5, 2.22e-5, 2.51e-2; max 0.200, 0.270, 2.00; p50 8.6e-4,
        # 1.01e-3, 0.425; p90 0.016, 0.017, 1.62; unchanged 1.54e-6, 1.28e-6
        0: {"loss": 1.1e-4, "max": 0.55, "p50": 2.1e-3, "p90": 0.035, "still": 3.1e-6}},
}
FA_CIFAR = policy_to_tensor(load_policy("fa_reduced_cifar10"))
SGD_SHAKE = {"type": "sgd", "nesterov": True, "decay": 0.001, "ema": 0}
SGD_PYRAMID = {"type": "sgd", "nesterov": True, "decay": 0.00005, "ema": 0}
RMSPROP = {"type": "rmsprop", "decay": 0.00001, "clip": 0, "ema": 0.9999}


def _jax_model(name):
    from fast_autoaugment_tpu.models import efficientnet as JE
    from fast_autoaugment_tpu.models import pyramidnet as JP
    from fast_autoaugment_tpu.models import shake_resnet as JSR

    return {"shake": lambda: JSR.ShakeResNet(26, 32, 10),
            "pyramid": lambda: JP.PyramidNet("cifar10", 11, 48, 10, True),
            "efficientnet": lambda: JE.EfficientNet.from_name(
                "efficientnet-b0", 10, condconv_num_expert=4)}[name]()


def _port_model(name):
    return {"shake": lambda: SR.ShakeResNet(26, 32, 10),
            "pyramid": lambda: P.PyramidNet(11, 48, 10, True),
            "efficientnet": lambda: E.EfficientNet.from_name(
                "efficientnet-b0", 10, condconv_num_expert=4)}[name]()


# (name, interop family, stack, batch, image, policy, cutout, optimizer, ema, lr, mixup,
#  label smoothing)
CASES = [
    ("shake", "shakeshake", "cifar", 8, 32, FA_CIFAR, 16, SGD_SHAKE, 0.0, 0.01, 0.0, 0.0),
    ("pyramid", "pyramid", "cifar", 8, 32, FA_CIFAR, 16, SGD_PYRAMID, 0.0, 0.05, 0.0, 0.0),
    ("efficientnet", "efficientnet", "imagenet", 8, 32, None, 0, RMSPROP, 0.9999, 0.008, 0.2,
     0.1),
]



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

def _numpy(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def jax_zoo_steps(job):
    """Reference runner: the JAX train step of case ``job["idx"]`` over the
    job's batches from the JAX init, recording per step the metric sums, the
    variables, the EMA, the model's noise and mixup's draws, and (ImageNet)
    the stack's draws by key."""
    from fast_autoaugment_tpu.ops import optim as JO
    from fast_autoaugment_tpu.ops import schedules as JS
    from fast_autoaugment_tpu.ops.preprocess import cifar_train_batch
    from fast_autoaugment_tpu.ops.preprocess_imagenet import imagenet_train_batch
    from fast_autoaugment_tpu.train import steps as JST
    from test_torch_replay import jax_imagenet_draws

    name, _, stack, b, image, policy, cutout, opt, ema, lr, mixup, lb = CASES[job["idx"]]
    model = _jax_model(name)
    optimizer = JO.build_optimizer(opt, JS.build_schedule(_lr_conf(lr), 4))
    state = JST.create_train_state(model, optimizer, jax.random.PRNGKey(job["seed"]),
                                   jnp.zeros((2, image, image, 3)), use_ema=ema > 0)
    out = {"init": _numpy({"params": state.params, "batch_stats": state.batch_stats}),
           "steps": [], "table": {}}
    use_policy = policy is not None
    pol = jnp.asarray(policy if use_policy else np.zeros((1, 1, 3), np.float32))
    if stack == "imagenet":
        augment_fn = lambda images, p, key: imagenet_train_batch(  # noqa: E731
            images, key, p if use_policy else None, cutout_length=cutout)
    else:
        augment_fn = lambda images, p, key: cifar_train_batch(  # noqa: E731
            images, key, policy=p, cutout_length=cutout)
    mixes = []
    saved = JST.mixup_batch

    def mixup_batch(key, images, labels, alpha):
        key_lam, key_perm = jax.random.split(key)
        lam = jax.random.beta(key_lam, alpha, alpha)
        perm = jax.random.permutation(key_perm, images.shape[0])
        jax.debug.callback(lambda lv, pv: mixes.append((np.array(lv), np.array(pv))), lam, perm,
                           ordered=True)
        return saved(key, images, labels, alpha)

    JST.mixup_batch = mixup_batch
    key = jnp.asarray(job["key"])
    try:
        with recorded_jax_noise() as calls:
            step = JST.make_train_step(model, optimizer, num_classes=10, mixup_alpha=mixup,
                                       lb_smooth=lb, ema_mu=ema, cutout_length=cutout,
                                       use_policy=use_policy, augment_fn=augment_fn)
            for s, (x, y) in enumerate(job["batches"]):
                if stack == "imagenet":
                    key_aug = jax.random.split(jax.random.fold_in(key, s))[0]
                    k = tuple(int(v) for v in np.asarray(key_aug, np.uint32))
                    out["table"][k] = jax_imagenet_draws(np.asarray(key_aug), len(y), None,
                                                         image, image)
                n_calls, n_mixes = len(calls), len(mixes)
                state, metrics = step(state, jnp.asarray(x), jnp.asarray(y), pol, key)
                jax.effects_barrier()
                out["steps"].append({
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "variables": _numpy({"params": state.params,
                                         "batch_stats": state.batch_stats}),
                    "ema": None if state.ema is None else _numpy(state.ema),
                    "noise": calls[n_calls:], "mixup": mixes[n_mixes:]})
    finally:
        JST.mixup_batch = saved
    return out


def _jobs(shift: int = 0) -> list:
    """The reference job of each case, its seeds shifted by `shift`."""
    return [[{"runner": "test_torch_zoo_train:jax_zoo_steps", "idx": i, "seed": 7 + i + shift,
              "key": np.asarray(jax.random.PRNGKey(70 + i + shift), np.uint32),
              "batches": _batches(80 + i + shift, STEPS[c[0]], c[3], c[4], 10),
              "threefry_partitionable": PARTITIONABLE}] for i, c in enumerate(CASES)]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return [o[0] for o in jax_reference_groups(_jobs(), tmp_path_factory.mktemp("zoo"))]


class ReplayDraws(JaxDraws):
    """:class:`JaxDraws` with the JAX step's recorded model noise and mixup
    draws, handed out step by step in order."""

    def __init__(self, ref, dtype):
        super().__init__(ref["table"])
        self.ref, self.dtype = ref, dtype
        self.noise_calls = self.mix_calls = 0

    def model_noise(self, sites, batch, key_shake, key_drop, device):
        rec = self.ref["steps"][self.noise_calls]["noise"]
        self.noise_calls += 1
        assert [k for k, _ in rec] == [s.kind for s in sites]
        return noise_from_calls(rec, self.dtype)

    def mixup_draws(self, key, batch, alpha, device):
        (lam, perm), = self.ref["steps"][self.mix_calls]["mixup"]
        self.mix_calls += 1
        return torch.tensor(float(lam)), torch.from_numpy(np.array(perm)).long()


def _run_port(idx, ref, dtype, shift=0, input_dtype=None):
    """The port's steps of case `idx` in `dtype` from the JAX init with the
    JAX draws of the seeds shifted by `shift`, the model's input rounded
    through `input_dtype` if given: per step the metrics, the state_dict and
    the EMA."""
    name, fam, stack, b, image, policy, cutout, opt, ema, lr, mixup, lb = CASES[idx]
    model = _port_model(name)
    model.load_state_dict(flax_to_state_dict(ref["init"], fam, model=model))
    model = model.to(dtype=dtype, memory_format=torch.channels_last)
    optimizer = O.build_optimizer(opt, S.build_schedule(_lr_conf(lr), 4))
    state = ST.create_train_state(model, optimizer, use_ema=ema > 0)
    make = ST.imagenet_augment_fn if stack == "imagenet" else ST.cifar_augment_fn
    inner = make(cutout, use_policy=policy is not None)
    src = ReplayDraws(ref, dtype)
    step = ST.make_train_step(model, optimizer, num_classes=10, mixup_alpha=mixup,
                              lb_smooth=lb, ema_mu=ema, cutout_length=cutout,
                              augment_fn=lambda *a: inner(*a).to(input_dtype or dtype).to(dtype),
                              draw_source=src)
    key = np.asarray(jax.random.PRNGKey(70 + idx + shift), np.uint32)
    pol = torch.from_numpy(policy if policy is not None else np.zeros((1, 1, 3), np.float32))
    out = []
    for s, (x, y) in enumerate(_batches(80 + idx + shift, STEPS[name], b, image, 10)):
        state, metrics = step(state, torch.from_numpy(x), torch.from_numpy(y), pol, key)
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "sd": {k: v.detach().double().numpy().copy()
                           for k, v in model.state_dict().items()},
                    "ema": None if state.ema is None else
                    {k: v.double().numpy().copy() for k, v in state.ema.items()}})
    assert src.noise_calls == STEPS[name] and src.mix_calls == (STEPS[name] if mixup else 0)
    assert len(noise_sites(model)) == len(ref["steps"][0]["noise"]) > 0
    return out


def _departures(tensors, init):
    """Per tensor that the steps changed (by more than 1e-5 of its size):
    the port's and the JAX package's largest distance from the float64 run
    over that change; and the tensors the steps left (near) unchanged."""
    port, jax_, still = [], [], []
    for k, got, jax_value, exact in tensors:
        change = float(np.abs(exact - init[k.split(" ")[-1]]).max())
        e_port, e_jax = float(np.abs(got - exact).max()), float(np.abs(jax_value - exact).max())
        if change > 1e-5 * max(float(np.abs(exact).max()), 1e-3):
            port.append(e_port / change)
            jax_.append(e_jax / change)
        else:
            still.append((k, e_port, e_jax))
    return np.asarray(port), np.asarray(jax_), still


def _distances(idx, s, run, exact, want, model, init) -> dict:
    """At held step `s` of case `idx`, the distances from the float64 run
    `exact` of the port's float32 `run` and of the JAX step `want`: the loss
    sum's relative distance; the largest, median and 90th percentile of the
    changed tensors' distances over their change; the largest distance of a
    tensor the steps left (near) unchanged."""
    fam, ema = CASES[idx][1], CASES[idx][8]
    tensors = [(k, run[s]["sd"][k], v.double().numpy(), exact[s]["sd"][k])
               for k, v in flax_to_state_dict(want["variables"], fam, model=model).items()]
    if ema:
        jema = flax_to_state_dict(want["ema"], fam, model=model)
        tensors += [("ema " + k, v, jema[k].double().numpy(), exact[s]["ema"][k])
                    for k, v in run[s]["ema"].items()]
    d_port, d_jax, still = _departures(
        [t for t in tensors if not t[0].endswith("num_batches_tracked")], init)
    loss64 = exact[s]["metrics"]["loss"]
    out = {}
    for who, loss, d, d_still in (
            ("port", run[s]["metrics"]["loss"], d_port, [e for _, e, _ in still]),
            ("jax", want["metrics"]["loss"], d_jax, [e for _, _, e in still])):
        out[who] = {"loss": abs(loss - loss64) / abs(loss64), "max": float(d.max()),
                    "p50": float(np.percentile(d, 50)), "p90": float(np.percentile(d, 90)),
                    "still": max(d_still, default=0.0)}
    return out


def _init(idx, ref, model) -> dict:
    return {k: v.double().numpy()
            for k, v in flax_to_state_dict(ref["init"], CASES[idx][1], model=model).items()}


@pytest.mark.parametrize("idx", range(len(CASES)), ids=[c[0] for c in CASES])
def test_zoo_train_steps_match_jax(idx, refs):
    name, *_, mixup, lb = CASES[idx]
    ref = refs[idx]
    assert all(len(st["mixup"]) == (1 if mixup else 0) for st in ref["steps"])
    port = _run_port(idx, ref, torch.float32)
    exact = _run_port(idx, ref, torch.float64)
    model = _port_model(name)
    init = _init(idx, ref, model)
    for s, bound in BOUNDS[name].items():
        want = ref["steps"][s]
        m, m64, mj = port[s]["metrics"], exact[s]["metrics"], want["metrics"]
        assert m["num"] == mj["num"] == 8
        for k in ("top1", "top5"):
            assert m[k] in (mj[k], m64[k]), (k, m[k], mj[k], m64[k])
        _close(m["loss"], mj["loss"], LOSS_RTOL, "loss")
        for k, got in port[s]["sd"].items():
            if k.endswith("num_batches_tracked"):
                assert int(got) == s + 1, k
        for who, got in _distances(idx, s, port, exact, want, model, init).items():
            for k, v in got.items():
                assert v <= bound[k], (f"{name} step {s + 1}", who, k, v, bound[k])


def readings(shifts=range(6)) -> None:
    """Print the readings that ``BOUNDS`` is set from: for each seed shift,
    case and held step, the distances (:func:`_distances`) of the port, the
    JAX package and the control (the port's float32 steps with the model's
    input rounded to bfloat16), one JSON line each.  Run as
    ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_zoo_train.py`` (about 20
    minutes on 8 cores)."""
    import json
    import tempfile

    torch.set_num_threads(2)
    for shift in shifts:
        with tempfile.TemporaryDirectory() as tmp:
            refs = [o[0] for o in jax_reference_groups(_jobs(shift), tmp)]
        for idx, ref in enumerate(refs):
            name = CASES[idx][0]
            model = _port_model(name)
            init = _init(idx, ref, model)
            exact = _run_port(idx, ref, torch.float64, shift)
            runs = {"port": _run_port(idx, ref, torch.float32, shift),
                    "control": _run_port(idx, ref, torch.float32, shift, torch.bfloat16)}
            for s in BOUNDS[name]:
                row = {"case": name, "shift": shift, "step": s + 1}
                for who, run in runs.items():
                    d = _distances(idx, s, run, exact, ref["steps"][s], model, init)
                    row[who], row["jax"] = d["port"], d["jax"]
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    readings()
