"""The port's TTA policy-scoring step (``fast_autoaugment_tpu_torch.search.
tta``), its data, metrics and the smoke script's config constants, against
the JAX package, on the CPU.

Oracles and bounds:

- ``make_tta_step``, ``make_audit_step``, ``eval_tta`` and
  ``eval_tta_batched`` of the JAX package on a WRN-10-1 with random weights
  (the same weights through the converter), over a 10-image fold in
  batches of 6 (the last padded with 2 masked repeats), run in one JAX
  process without fused multiply-add; the port is given the JAX key tree's
  draws (``test_torch_replay.JaxDraws``), so its augmented lanes are the
  JAX ones bit for bit (``test_torch_preprocess.py``); the same fold in
  ragged batches (6, then 4: ``pad_multiple=1``) through ``eval_tta``, a
  fold the port captures two graphs for on the card (one per batch shape).
  Rule:
  ``minus_loss`` within ``2 * LOGIT_TOL`` (an NLL moves by at most twice
  the logits' largest change; ``LOGIT_TOL`` is ``test_torch_models.py``'s
  1e-5); ``cnt`` exactly; ``top1_valid`` and ``top1_mean`` exactly wherever
  the JAX logits' top-2 margin of every lane exceeds ``LOGIT_TOL`` (else
  within the count of samples with a lane below it);
- the candidate-axis identity (``tests/test_batched_search.py:132``,
  ported): K candidates through the K-step equal the same (policy, key)
  pairs through the single step, exactly;
- ``eval_batches``, ``_synthetic``, the metrics and ``Accumulator`` against
  the JAX package's: exact;
- ``chip_smoke.py``'s flagship constants against the JAX package's reading
  of ``confs/wresnet40x2_cifar.yaml`` and the ``search_cli`` defaults.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu.core import metrics as JM
from fast_autoaugment_tpu.data.datasets import _synthetic as jax_synthetic
from fast_autoaugment_tpu.data.pipeline import eval_batches as jax_eval_batches
from fast_autoaugment_tpu.models.wideresnet import WideResNet as JaxWideResNet
from fast_autoaugment_tpu_torch.core import metrics as M
from fast_autoaugment_tpu_torch.data.datasets import ArrayDataset, _synthetic
from fast_autoaugment_tpu_torch.data.pipeline import device_batches, eval_batches
from fast_autoaugment_tpu_torch.models.wideresnet import WideResNet
from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
from fast_autoaugment_tpu_torch.search import tta
from fast_autoaugment_tpu_torch.utils.interop import flax_to_state_dict
from test_torch_models import ATOL as LOGIT_TOL
from test_torch_models import _random_variables
from test_torch_replay import JaxDraws, jax_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH, WIDEN, CLASSES = 10, 1, 10
P, BATCH, FOLD = 3, 6, 10
FA_CIFAR = policy_to_tensor(load_policy("fa_reduced_cifar10"))
IDENTITY = np.zeros((1, 2, 3), np.float32)  # search/driver.py:491 baseline
SUBS = FA_CIFAR[[0, 7, 42]]  # three sub-policies for the audit
KEYS = np.stack([np.asarray(jax.random.PRNGKey(s), np.uint32) for s in (11, 12)])

# (name, JAX function, dispatch, policy, key); a [K] policy stack for batched
RUNS = [
    ("eval_tta_exact", "eval_tta", "exact", FA_CIFAR, KEYS[0]),
    ("eval_tta_identity", "eval_tta", "exact", IDENTITY, KEYS[1]),
    ("eval_tta_grouped", "eval_tta", "grouped", FA_CIFAR, KEYS[1]),
    ("eval_tta_batched_exact", "eval_tta_batched", "exact",
     np.stack([FA_CIFAR, FA_CIFAR[::-1].copy()]), KEYS),
    ("audit_exact", "audit", "exact", SUBS, KEYS[0]),
]
#: the runs over the ragged fold (the same policies and keys)
RAGGED = [("ragged_" + RUNS[0][0],) + RUNS[0][1:]]
#: (run, fold, index of the run's reference in that fold's job)
CASES = [(r, "batches", i) for i, r in enumerate(RUNS)] + \
    [(r, "ragged", i) for i, r in enumerate(RAGGED)]


def _fold():
    g = np.random.default_rng(21)
    return ArrayDataset(g.integers(0, 256, (FOLD, 32, 32, 3), dtype=np.uint8),
                        g.integers(0, CLASSES, (FOLD,), dtype=np.int32), CLASSES)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jmodel = JaxWideResNet(depth=DEPTH, widen_factor=WIDEN, num_classes=CLASSES)
    variables = _random_variables(jmodel, 7)
    batches = list(eval_batches(_fold(), None, BATCH, pad_multiple=BATCH))
    ragged = list(eval_batches(_fold(), None, BATCH, pad_multiple=1))
    assert [len(y) for _, y, _ in ragged] == [6, 4]

    def job(batches, runs):
        return {"kind": "tta", "model": (DEPTH, WIDEN, CLASSES), "variables": variables,
                "batches": batches, "runs": [
                    {"fn": fn, "dispatch": d, "groups": 3, "num_policy": P, "cutout_length": 16,
                     "policy": pol, "key": key, "batch": 1} for _, fn, d, pol, key in runs]}

    refs, ragged_refs = jax_reference([job(batches, RUNS), job(ragged, RAGGED)],
                                      tmp_path_factory.mktemp("tta"))
    return {"jmodel": jmodel, "variables": variables, "batches": batches, "refs": refs,
            "ragged": ragged, "ragged_refs": ragged_refs,
            "sizes": {"batches": (BATCH, BATCH), "ragged": (6, 4)}}


class Recorder(torch.nn.Module):
    """The model, keeping every input it was given (the augmented lanes)."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.inputs = []

    def forward(self, x):
        self.inputs.append(x.clone())
        return self.model(x)


def _port_model(variables):
    model = WideResNet(DEPTH, WIDEN, CLASSES)
    model.load_state_dict(flax_to_state_dict(variables))
    return Recorder(model.to(memory_format=torch.channels_last))


def _small_margin_samples(setup, inputs, lanes_per_sample, batch_sizes=None) -> int:
    """Samples with a lane whose JAX top-2 logit margin is <= LOGIT_TOL
    (batches of `batch_sizes`, by default all of ``BATCH``)."""
    batch_sizes = batch_sizes or (BATCH,) * len(inputs)
    small = 0
    for x, b in zip(inputs, batch_sizes):
        nhwc = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
        logits = np.asarray(setup["jmodel"].apply(setup["variables"], nhwc, train=False))
        top2 = np.sort(logits, axis=-1)[:, -2:]
        tight = (top2[:, 1] - top2[:, 0] <= LOGIT_TOL).reshape(lanes_per_sample, -1, b)
        small += int(tight.any(axis=(0, 1)).sum())
    return small


def _check_fields(got, want, small):
    assert got["cnt"] == want["cnt"] == FOLD
    assert abs(got["minus_loss"] - want["minus_loss"]) <= 2 * LOGIT_TOL, (got, want)
    for f in ("top1_valid", "top1_mean"):
        if small == 0:
            assert got[f] == want[f], (f, got, want)
        else:
            assert abs(got[f] - want[f]) * FOLD <= small, (f, got, want, small)


def _port_run(setup, name, fn, dispatch, policy, key, fold="batches"):
    model = _port_model(setup["variables"])
    dev_batches = device_batches(setup[fold], device="cpu")
    opts = dict(num_policy=P, cutout_length=16, aug_dispatch=dispatch, aug_groups=3,
                draw_source=JaxDraws())
    if fn == "eval_tta":
        out = tta.eval_tta(tta.make_tta_step(model, **opts), dev_batches, policy, key)
        return model, [out]
    if fn == "eval_tta_batched":
        step = tta.make_tta_step(model, num_candidates=len(policy), **opts)
        return model, tta.eval_tta_batched(step, dev_batches, policy, key)
    step = tta.make_audit_step(model, **opts)
    b = dev_batches[1]
    return model, step(b["x"], b["y"], b["m"], policy, key)


@pytest.mark.parametrize("idx", range(len(CASES)), ids=[c[0][0] for c in CASES])
def test_port_matches_jax(idx, setup):
    (name, fn, dispatch, policy, key), fold, i = CASES[idx]
    model, got = _port_run(setup, name, fn, dispatch, policy, key, fold)
    want = setup["refs" if fold == "batches" else "ragged_refs"][i]
    if fn == "audit":
        lanes = len(policy) * P
        small = _small_margin_samples(setup, model.inputs, lanes)
        assert float(got["cnt"]) == float(want["cnt"]) == 4  # batch 1: 4 real of 6
        diff = np.abs(got["correct_mean_sum"].numpy() - want["correct_mean_sum"])
        assert got["correct_mean_sum"].shape == (len(policy),)
        assert (diff == 0).all() if small == 0 else (diff <= small).all(), (got, want)
        return
    k = len(policy) if fn == "eval_tta_batched" else 1
    sizes = setup["sizes"][fold]
    small = _small_margin_samples(setup, model.inputs, k * P, sizes)
    assert [tuple(x.shape) for x in model.inputs] == [(k * P * b, 3, 32, 32) for b in sizes]
    for g, w in zip(got, want if fn == "eval_tta_batched" else [want]):
        _check_fields(g, w, small)


def test_batched_candidates_equal_single_step(setup):
    """``eval_tta_batched`` with the JAX package's default dispatch: candidate
    k equals ``eval_tta`` of candidate k alone (the real CIFAR stack)."""
    policies = np.stack([FA_CIFAR, FA_CIFAR[::-1].copy()])
    model = _port_model(setup["variables"])
    batches = device_batches(setup["batches"], device="cpu")
    opts = dict(num_policy=P, cutout_length=16, draw_source=JaxDraws())
    got = tta.eval_tta_batched(tta.make_tta_step(model, num_candidates=2, **opts), batches,
                               policies, KEYS)
    for k in range(2):
        want = tta.eval_tta(tta.make_tta_step(model, **opts), batches, policies[k], KEYS[k])
        for f in ("minus_loss", "top1_valid", "top1_mean", "cnt"):
            assert got[k][f] == want[f], (k, f)


# ------------------------------- the candidate-axis identity, ported


class _Probe(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.dense = torch.nn.Linear(4, 10)

    def forward(self, x):
        return self.dense(torch.relu(self.conv(x)).mean(dim=(2, 3)))


def _policy_scaled_augment(images, policy, draws):
    # policy- and draw-dependent, cheap: a brightness scale from the lane's
    # sub-policy's first (prob, level) and per-lane noise from its draws
    rows = policy[draws.sub_idx.to(torch.int64)]
    scale = (0.5 + rows[:, 0, 1] * rows[:, 0, 2]).reshape(-1, 1, 1, 1)
    noise = (draws.policy[:, :1, :1, None] - 0.5) * 0.1  # [L, 1, 1, 1]
    return (images / 255.0 * scale + noise).permute(0, 3, 1, 2)


def test_tta_batched_matches_single_exact():
    """K candidates through the ``num_candidates=K`` step equal the same K
    (policy, key) pairs through the single-candidate step exactly."""
    torch.manual_seed(1)
    model = _Probe()
    g = np.random.default_rng(0)
    batches = device_batches([
        (g.integers(0, 256, (6, 8, 8, 3), dtype=np.uint8), g.integers(0, 10, 6),
         np.float32([1, 1, 1, 1, 1, 0])),
        (g.integers(0, 256, (6, 8, 8, 3), dtype=np.uint8), g.integers(0, 10, 6),
         np.ones(6, np.float32))], device="cpu")
    k = 3
    policies = torch.from_numpy(g.uniform(0, 1, (k, 2, 2, 3)).astype(np.float32))
    keys = torch.tensor([[0, 50 + i] for i in range(k)])
    opts = dict(num_policy=3, cutout_length=0, augment_fn=_policy_scaled_augment)
    single = tta.make_tta_step(model, **opts)
    batched = tta.make_tta_step(model, num_candidates=k, **opts)
    got = tta.eval_tta_batched(batched, batches, policies, keys)
    for i in range(k):
        want = tta.eval_tta(single, batches, policies[i], keys[i])
        for field in ("minus_loss", "top1_valid", "top1_mean", "cnt"):
            assert got[i][field] == want[field], (i, field, got[i], want)


def test_step_fields_and_trace_on_the_cpu():
    """The step's output contract, the trace callback, the identity draws of
    the port's own sampler, and no kernel launch on the CPU."""
    torch.manual_seed(2)
    model = _Probe()
    batches = device_batches(eval_batches(_fold(), None, 4, pad_multiple=4), device="cpu")
    assert [int(b["m"].sum()) for b in batches] == [4, 4, 2]
    _kernels.reset_launch_counts()
    windows = []
    step = tta.make_tta_step(model, num_policy=2)
    out = tta.eval_tta(step, batches, FA_CIFAR, torch.tensor([0, 3]),
                       trace=lambda t0, t1: windows.append(t1 - t0))
    assert set(out) == {"minus_loss", "top1_valid", "top1_mean", "cnt"} and out["cnt"] == FOLD
    assert len(windows) == 3 and min(windows) >= 0
    assert 0 <= out["top1_mean"] <= out["top1_valid"] <= 1 and out["minus_loss"] <= 0
    again = tta.eval_tta(step, batches, FA_CIFAR, torch.tensor([0, 3]))
    assert again == out  # the Philox draws are a function of the key
    assert _kernels.launch_counts() == {"augment": 0, "cifar_stack": 0, "imagenet_stack": 0}
    with pytest.raises(ValueError):
        tta.make_tta_step(model, aug_dispatch="fast")
    with pytest.raises(ValueError):  # candidate axis != num_candidates
        tta.make_tta_step(model, num_candidates=2)(
            batches[0]["x"], batches[0]["y"], batches[0]["m"], FA_CIFAR[None], torch.zeros(1, 2))


def test_philox_draws_follow_the_key_tree():
    src = tta.PhiloxDraws()
    key = torch.tensor([1, 2])
    keys = src.split(key, 3, "cpu")
    assert keys.shape == (3, 2) and len({tuple(k.tolist()) for k in keys}) == 3
    assert torch.equal(src.fold_in(torch.stack([key, key]), 4, "cpu")[1], src.fold_in(key, 4, "cpu"))
    d = src.draws(keys, batch=5, num_sub=493, num_op=2, height=32, width=32,
                  dispatch="exact", groups=8, device="cpu")
    assert d.sub_idx.shape == (15,) and d.policy.shape == (15, 2, 4) and d.crop.shape == (15, 5)
    one = src.draws(keys[1:2], batch=5, num_sub=493, num_op=2, height=32, width=32,
                    dispatch="exact", groups=8, device="cpu")
    assert torch.equal(one.crop, d.crop[5:10]) and torch.equal(one.sub_idx, d.sub_idx[5:10])
    g = src.draws(keys, batch=5, num_sub=493, num_op=2, height=32, width=32,
                  dispatch="grouped", groups=2, device="cpu")
    assert all(len(set(g.sub_idx[i * 5:(i + 1) * 5].tolist())) <= 2 for i in range(3))
    assert torch.equal(g.crop, d.crop)  # the stack's draws do not depend on the dispatch


# --------------------------------------------- data, metrics, constants


def test_eval_batches_and_synthetic_match_jax():
    ds = _fold()
    idx = np.array([9, 2, 4, 7, 0, 1, 3])
    for pad_multiple in (1, 4):
        got = list(eval_batches(ds, idx, 4, pad_multiple=pad_multiple))
        want = list(jax_eval_batches(ds, idx, 4, pad_multiple=pad_multiple))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert np.array_equal(a, b) and a.dtype == b.dtype
    for a, b in zip(_synthetic(10, 8, 4), jax_synthetic(10, 8, 4)):
        assert np.array_equal(a.images, b.images) and np.array_equal(a.labels, b.labels)
        assert a.num_classes == b.num_classes


def test_metrics_match_jax():
    g = np.random.default_rng(5)
    logits = g.normal(0, 1, (16, 10)).astype(np.float32)
    labels = g.integers(0, 10, 16).astype(np.int32)
    got = M.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), False).numpy()
    want = np.asarray(JM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), False))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for k in (1, 3):
        assert int(M.top_k_correct(torch.from_numpy(logits), torch.from_numpy(labels), k)) == \
            int(JM.top_k_correct(jnp.asarray(logits), jnp.asarray(labels), k))
    assert [float(a) for a in M.accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                                         (1, 5))] == \
        [float(a) for a in JM.accuracy(jnp.asarray(logits), jnp.asarray(labels), (1, 5))]
    acc, jacc = M.Accumulator(), JM.Accumulator()
    for d in ({"loss": 2.0, "num": 4}, {"loss": torch.tensor(1.0), "num": 2}):
        acc.add_dict(d)
        jacc.add_dict({k: float(v) for k, v in d.items()})
    assert acc.normalize() == jacc.normalize() and "loss" in acc and acc["num"] == 6.0


def test_chip_smoke_constants_match_the_flagship_config():
    from fast_autoaugment_tpu.core.config import load_config
    from fast_autoaugment_tpu.launch.search_cli import build_parser

    sys.path.insert(0, REPO)
    import chip_smoke

    conf = load_config(os.path.join(REPO, "confs", "wresnet40x2_cifar.yaml"))
    args = build_parser().parse_args(["-c", "confs/wresnet40x2_cifar.yaml"])
    c = chip_smoke.FLAGSHIP
    assert c["model"] == conf["model"]["type"] and c["dataset"] == conf["dataset"]
    assert c["batch"] == conf["batch"] and c["cutout"] == conf["cutout"]
    assert c["precision"] == (conf.get("precision") or "f32")
    assert (c["num_policy"], c["num_op"], c["cv_ratio"], c["aug_groups"]) == \
        (args.num_policy, args.num_op, args.cv_ratio, args.aug_groups)
    assert c["fold_images"] == int(50_000 * args.cv_ratio)  # CIFAR-10's train split


def test_port_imports_nothing_the_card_lacks():
    """Every module of the port imports in a fresh interpreter without JAX,
    flax, the JAX package, sklearn, PyYAML or msgpack (the card's machine
    has none of the last three)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import fast_autoaugment_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "roots = {'jax', 'jaxlib', 'flax', 'fast_autoaugment_tpu', 'sklearn', 'yaml', 'msgpack'}\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in roots)\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 25  # every module of the port was imported
