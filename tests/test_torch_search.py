"""The port's three-phase search (``fast_autoaugment_tpu_torch/search/driver.py``,
``launch/search_cli.py``, ``launch/train_cli.py``) against the JAX
package's, on the CPU.

Whole-search parity: ``confs/wresnet10x1_shapes.yaml`` with ``epoch`` 1 on
the offline ``synthetic_shapes`` data, 2 folds, 4 trials per fold (all in
the TPE's random start-up, so the proposals do not depend on the rewards),
``num_policy`` 2, ``num_top`` 1, ``--fold-quality-floor off``, the default
audit (floor 0.95) and phase 3 with 1 run of 1 epoch per arm, through both
packages' ``search_cli``:

- the JAX package's in the FMA-free reference process
  (``tests/test_torch_replay.py``), on one device, on its host-fed path
  (``--device-cache off``, the path the port has), with
  ``jax_threefry_partitionable`` pinned to True (the jax 0.9 default);
- the port's on the CPU with the JAX init (``flax_to_state_dict`` of the
  reference process's ``model.init``, the trainer's ``get_model``
  patched as ``tests/test_torch_train.py`` does) and ``JaxDraws``
  replaying the JAX key tree.

A third run is the port's search resumed from the JAX run's fold
checkpoints and trial log: its phase 1 trains nothing, its phase 2
dispatches no trial, and its phase 3 trains both arms on the JAX run's
final set, so each arm is compared on equal inputs.

Where the two packages compute the same function of the same inputs, the
bounds are tight: the trial proposals equal; the JAX fold models scored by
the port's TTA with the JAX trial keys give the JAX rewards within one
sample of the held-out fold (240 images); the JAX fold and phase-3 models
through the port's eval step give the JAX metrics (losses within 1e-4,
accuracies within one sample); each package's final policy set is the JAX
ranking of its own trial log.  Training does not give the same function:
two float32 programs drift apart (a ReLU gate closed in one and open in the
other, ROADMAP "Reference caveats"), and these one-epoch models are near
chance, with many near-tied logits (on equal inputs the two packages'
default arms lie 4 test samples apart here).  So each
model the port trains is held to the JAX one trained on the same inputs
(``_trained_model_matches_jax``): by its weights (median <= 5%, max <= 50%
of the weights' change; a wrong policy in the augmented arm reads 54-62%),
its train metrics (loss within 1e-4, accuracies within one sample), its
record against its own checkpoint, and paired tests of its held-out
metrics against the JAX model's over the split's samples.  The final
policy sets of the two whole runs are equal unless a fold's two best JAX
rewards lie within one sample of each other.  The port runs on two
threads: the reference process runs beside it.

Also: ``search_policies`` and both CLIs refuse every unported option by its ROADMAP
item; the quality gate's retrain, promotion and exclusion; resume (a rerun
trains and dispatches nothing); quarantine; ``trial_batch`` > 1 against the
sequential loop; ``train_cli`` on the CPU.
"""

import contextlib
import json
import os
import pickle
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu.policies import archive as JA
from fast_autoaugment_tpu_torch.core.checkpoint import load_checkpoint, read_metadata
from fast_autoaugment_tpu_torch.core.metrics import Accumulator
from fast_autoaugment_tpu_torch.data.datasets import cv_split, load_dataset
from fast_autoaugment_tpu_torch.data.pipeline import eval_batches
from fast_autoaugment_tpu_torch.launch import search_cli as SC
from fast_autoaugment_tpu_torch.launch import train_cli as TC
from fast_autoaugment_tpu_torch.models.wideresnet import WideResNet
from fast_autoaugment_tpu_torch.ops.preprocess import cifar_eval_batch
from fast_autoaugment_tpu_torch.policies.archive import policy_decoder
from fast_autoaugment_tpu_torch.search import driver as D
from fast_autoaugment_tpu_torch.search.tta import prng_key
from fast_autoaugment_tpu_torch.train import trainer as TR
from fast_autoaugment_tpu_torch.train.steps import make_eval_step
from fast_autoaugment_tpu_torch.utils.interop import (
    flax_layout,
    flax_to_state_dict,
    flax_to_tensors,
)
from test_torch_replay import NO_FMA_XLA_FLAGS, JaxDraws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "confs", "wresnet10x1_shapes.yaml")
PARTITIONABLE = True
SEARCH_ARGS = ["-c", CONF, "--num-fold", "2", "--num-search", "4", "--num-policy", "2",
               "--num-top", "1", "--num-result-per-cv", "1", "--fold-quality-floor", "off"]
OVERRIDES = ["epoch=1"]
FOLD_IMAGES, TEST_IMAGES = 240, 2000  # synthetic_shapes: 600 train x 0.4, 2000 test


# ----------------------------------------------- the JAX reference runs


def jax_init(job):
    """Reference runner: the trainer's ``model.init`` for the config at a seed."""
    from fast_autoaugment_tpu.models import get_model

    model = get_model({"type": "wresnet10_1", "dataset": "synthetic_shapes"}, 10)
    rng = jax.random.PRNGKey(job["seed"])
    init = model.init({"params": rng, "shake": jax.random.fold_in(rng, 1)},
                      jnp.zeros((2, 32, 32, 3)), train=False)
    return jax.tree.map(lambda a: np.array(a, np.float32), init)


def jax_search(job):
    """Reference runner: the JAX ``search_cli`` on one device."""
    from fast_autoaugment_tpu.launch import search_cli
    from fast_autoaugment_tpu.parallel import mesh as JM
    from fast_autoaugment_tpu.search import driver as JD
    from fast_autoaugment_tpu.train import trainer as JTR

    def one_device(*_a, **_k):
        return JM.make_mesh(jax.devices()[:1])

    JD.make_mesh = JTR.make_mesh = one_device
    result = search_cli.main(job["argv"])
    return {k: v for k, v in result.items() if k not in ("compile_cache",)}


def _start(jobs, tmp, name):
    """Start the FMA-free reference process on `jobs` (the runner protocol of
    ``test_torch_replay.jax_reference``) without waiting for it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + NO_FMA_XLA_FLAGS).strip(),
               PYTHONPATH=os.path.join(REPO, "tests") + os.pathsep + REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    src, dst = os.path.join(tmp, f"{name}.jobs.pkl"), os.path.join(tmp, f"{name}.out.pkl")
    with open(src, "wb") as fh:
        pickle.dump(jobs, fh)
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "test_torch_replay.py"),
                             src, dst], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, dst


def _finish(started, timeout=600):
    proc, dst = started
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    with open(dst, "rb") as fh:
        return pickle.load(fh)


@contextlib.contextmanager
def _port_cpu(init):
    """The port's ``search_cli`` on the JAX init (the trainer's ``get_model``
    patched as ``tests/test_torch_train.py`` does), on two threads: the
    reference process runs beside this one, and the tier-1 run beside other
    test workers."""
    real_get_model = TR.get_model

    def get_model(conf, num_classes, *, device="cuda", seed=0):
        assert seed == 0 and conf["type"] == "wresnet10_1"
        model = WideResNet(10, 1, num_classes)
        model.load_state_dict(flax_to_state_dict(init, "wideresnet"))
        return model.to(device=device, memory_format=torch.channels_last)

    TR.get_model = get_model
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with jax.threefry_partitionable(PARTITIONABLE):
            yield
    finally:
        TR.get_model = real_get_model
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three runs: the JAX package's search, the port's whole search, and
    the port's search resumed from the JAX run's fold checkpoints and trial
    log (``on_jax``), so that its phase 3 trains both arms on the JAX run's
    inputs; the resumed run's phase 1 trains nothing."""
    tmp = str(tmp_path_factory.mktemp("search"))
    jdir, pdir, rdir = (os.path.join(tmp, d) for d in ("jax", "port", "on_jax"))
    search = _start([{"runner": "test_torch_search:jax_search",
                      "argv": SEARCH_ARGS + ["--save-dir", jdir, "--device-cache", "off"]
                      + OVERRIDES, "threefry_partitionable": PARTITIONABLE}], tmp, "search")
    init = _finish(_start([{"runner": "test_torch_search:jax_init", "seed": 0,
                            "threefry_partitionable": PARTITIONABLE}], tmp, "init"))[0]
    with _port_cpu(init):
        port = SC.main(SEARCH_ARGS + ["--save-dir", pdir, "--device", "cpu"] + OVERRIDES,
                       draw_source=JaxDraws())
    want = _finish(search)[0]
    os.makedirs(rdir)
    for name in os.listdir(jdir):
        if "_fold" in name or name == "search_trials.json":
            shutil.copy(os.path.join(jdir, name), os.path.join(rdir, name))
    trained = []
    real_train = D.train_and_eval
    D.train_and_eval = lambda *a, **k: trained.append(a) or real_train(*a, **k)
    try:
        with _port_cpu(init):
            on_jax = SC.main(SEARCH_ARGS + ["--save-dir", rdir, "--device", "cpu"] + OVERRIDES,
                             draw_source=JaxDraws())
    finally:
        D.train_and_eval = real_train
    assert trained == []  # phase 1 resumed from the JAX fold checkpoints
    return {"port": port, "jax": want, "on_jax": on_jax, "pdir": pdir, "jdir": jdir,
            "rdir": rdir, "init": init}


def _trials(d):
    with open(os.path.join(d, "search_trials.json")) as fh:
        return json.load(fh)


def _one_sample(got, want, n, what, slack=0):
    assert abs(got - want) <= (1 + slack) / n + 1e-7, (what, got, want, slack)


FOLD_CKPT = "wresnet10_1_synthetic_shapes_fold{}_ratio0.40.msgpack"


def _port_model(path):
    """A port WRN-10-1 holding the weights of the checkpoint at `path`
    (either package's)."""
    model = WideResNet(10, 1, 10).to(memory_format=torch.channels_last)
    live = model.state_dict()
    for name, arr in flax_to_tensors(load_checkpoint(path), flax_layout(model)).items():
        live[name].copy_(torch.from_numpy(arr))
    return model.eval()


def _per_sample(path, images, labels) -> dict:
    """Per sample, through the port's forward of the model at `path`: its
    cross-entropy and whether its top-1 and top-5 hit the label."""
    with torch.no_grad():
        logits = _port_model(path)(cifar_eval_batch(torch.from_numpy(images))).double()
    y = torch.from_numpy(labels.astype(np.int64))
    top5 = torch.topk(logits, 5, dim=-1).indices
    return {"loss": torch.nn.functional.cross_entropy(logits, y, reduction="none").numpy(),
            "top1": (torch.argmax(logits, dim=-1) == y).numpy(),
            "top5": (top5 == y[:, None]).any(dim=-1).numpy()}


def _held_out(fold: int | None) -> dict:
    """The held-out splits a run evaluates: the fold's valid split (phase 1)
    and the test split, as (images, labels)."""
    train, test = load_dataset("synthetic_shapes", "")
    out = {"test": (test.images, test.labels)}
    if fold is not None:
        _, valid_idx = cv_split(train.labels, 0.4, fold)
        out["valid"] = (train.images[valid_idx], train.labels[valid_idx])
    return out


def _eval_metrics(path, fold):
    """The port's eval step on the checkpoint at `path`: the fold's valid
    split and the test split, as train_and_eval evaluates them."""
    train, test = load_dataset("synthetic_shapes", "")
    _, valid_idx = cv_split(train.labels, 0.4, fold)
    step = make_eval_step(_port_model(path), num_classes=10)
    out = {}
    for split, batches in (("valid", eval_batches(train, valid_idx, 64)),
                           ("test", eval_batches(test, None, 64))):
        acc = Accumulator()
        for x, y, m in batches:
            acc.add_dict(step(torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
                              torch.from_numpy(m)))
        out.update({f"{k}_{split}": v for k, v in acc.normalize().items()})
    return out


def test_port_evaluates_jax_fold_models_like_jax(runs):
    """The evaluation path alone: the JAX fold models through the port's eval
    step give the JAX run's metrics (losses within 1e-4, accuracies within
    one sample)."""
    for fold in range(2):
        path = os.path.join(runs["jdir"], FOLD_CKPT.format(fold))
        want = read_metadata(path)["metrics"]
        got = _eval_metrics(path, fold)
        for k, v in got.items():
            if k.startswith("num_"):
                assert v == want[k], k
            elif "loss" in k:
                np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-4, err_msg=k)
            else:
                _one_sample(v, want[k], want["num_" + k.split("_")[1]], (fold, k))


def _weight_drift(path_a, path_b, init) -> tuple[float, float]:
    """Per tensor, max |a - b| over max |b - init|: the (median, max) over the
    model's tensors of how far two trained models lie apart, relative to how
    far training moved them."""
    def leaves(tree, pre=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{pre}/{k}")
        else:
            yield pre, tree

    def flat(tree):
        return dict(leaves({"params": tree["params"], "batch_stats": tree["batch_stats"]}))

    a, b, i = flat(load_checkpoint(path_a)), flat(load_checkpoint(path_b)), flat(init)
    r = [float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k] - i[k]).max(), 1e-12)) for k in b]
    return float(np.median(r)), max(r)


def _trained_model_matches_jax(ppath, jpath, init, fold: int | None):
    """A model the port trained against the one the JAX package trained on
    the same inputs.  The same sidecar keys, counts, epochs and steps; the
    weights within the float32 drift (per tensor, the distance between the
    two over the distance training moved the JAX one: median <= 5%, max <=
    50%; 0.6-2.7% and 10-27% here, the two packages' models of two
    different folds 49% and 275%); the train metrics, which the input
    stream fixes, tight: loss within 1e-4, accuracies within one sample.

    Held-out metrics of two float32 trainings do not agree to one sample:
    these models are near chance, with near-tied logits, and the port's own
    trajectory moves with its thread count.  So each is held to its own
    model (the port's record equals its checkpoint through the port's
    forward: loss within 1e-4, accuracy within one sample) and the two
    models are held to each other by
    paired tests over the split's samples, which a systematic difference
    fails: the mean per-sample loss difference within 1e-4 + 4 standard
    errors, and the accuracy difference within 1 + 4 sqrt(d) samples, d the
    samples that exactly one of the two models gets right (a sign test)."""
    got, want = read_metadata(ppath), read_metadata(jpath)
    assert got["epoch"] == want["epoch"] and got["step"] == want["step"]
    assert set(got["metrics"]) == set(want["metrics"])
    median, worst = _weight_drift(ppath, jpath, init)
    assert median <= 0.05 and worst <= 0.5, (ppath, median, worst)
    g, w = got["metrics"], want["metrics"]
    for k in ("epoch", *(k for k in w if k.startswith("num_"))):
        assert g[k] == w[k], k
    np.testing.assert_allclose(g["loss_train"], w["loss_train"], rtol=1e-4, atol=1e-4)
    for k in ("top1_train", "top5_train"):
        _one_sample(g[k], w[k], want["step"] * 64, (ppath, k))
    splits = _held_out(fold)
    for split, (images, labels) in splits.items():
        n = len(labels)
        a, b = _per_sample(ppath, images, labels), _per_sample(jpath, images, labels)
        k = f"loss_{split}"
        np.testing.assert_allclose(g[k], a["loss"].mean(), rtol=1e-4, atol=1e-4, err_msg=k)
        d = a["loss"] - b["loss"]
        assert abs(g[k] - w[k]) <= 1e-4 * (1 + abs(w[k])) + 4 * d.std() / np.sqrt(n), (
            ppath, k, g[k], w[k], d.std())
        for top in ("top1", "top5"):
            k = f"{top}_{split}"
            _one_sample(g[k], a[top].mean(), n, (ppath, k, "own model"))
            discordant = int((a[top] != b[top]).sum())
            assert abs(g[k] - w[k]) * n <= 1 + 4 * np.sqrt(discordant) + 1e-6, (
                ppath, k, g[k], w[k], "discordant", discordant)
        k = f"best_{split}_top1"
        assert g[k] == g[f"top1_{split}"] and w[k] == w[f"top1_{split}"], k  # one epoch
    for k in ("best_valid_top1", "best_test_top1"):
        if k.split("_")[1] not in splits:
            assert g.get(k) == w.get(k), k


def test_phase1_fold_models_match_jax(runs):
    """Each fold model the port trained against the JAX package's
    (``_trained_model_matches_jax``)."""
    for fold in range(2):
        _trained_model_matches_jax(os.path.join(runs["pdir"], FOLD_CKPT.format(fold)),
                                   os.path.join(runs["jdir"], FOLD_CKPT.format(fold)),
                                   runs["init"], fold)


def test_trial_log_matches_jax(runs):
    """The proposals are equal; the port's TTA on the JAX fold models with
    the JAX trial keys gives the JAX rewards within one sample (the rewards
    of the port's own run differ further by the fold models' drift)."""
    got, want = _trials(runs["pdir"]), _trials(runs["jdir"])
    assert sorted(got) == sorted(want) == ["0", "1"]
    conf = SC.load_config(CONF, overrides=OVERRIDES)
    with jax.threefry_partitionable(PARTITIONABLE):
        ev = D._FoldEval(conf, "", num_policy=2, num_op=2, cv_ratio=0.4, device="cpu",
                         draw_source=JaxDraws())
        for fold in want:
            assert len(got[fold]) == len(want[fold]) == 4
            path = os.path.join(runs["jdir"], FOLD_CKPT.format(fold))
            for t, ((gp, _), (wp, wr)) in enumerate(zip(got[fold], want[fold])):
                assert json.dumps(gp) == json.dumps(wp)
                policy = ev.policy_tensor(policy_decoder(wp, 2, 2))
                key = ev.draw_source.fold_in(prng_key(77 * 0 + int(fold)), t, "cpu")
                r = ev.evaluate(int(fold), path, policy, key)["top1_valid"]
                _one_sample(r, wr, FOLD_IMAGES, ("same-weights reward", fold, t))


def _jax_ranked_set(trials):
    """The JAX package's ranking (top ``num_top`` = 1 per fold, decode,
    de-duplicate) of a trial log."""
    out = []
    for fold in sorted(trials, key=int):
        for entry in sorted(trials[fold], key=lambda o: -o[1])[:1]:
            out.extend(JA.policy_decoder(entry[0], 2, 2))
    return JA.remove_duplicates(out)


def _phase3_arm_matches_jax(got_dir, got, arm, runs):
    """One phase-3 arm: the JAX model through the port's eval gives the JAX
    ``top1_test`` within one sample; the port's model against the JAX one
    (``_trained_model_matches_jax``, test split); the result's
    ``top1_test`` is its checkpoint's."""
    ppath = os.path.join(got_dir, f"final_{arm}_0.msgpack")
    jpath = os.path.join(runs["jdir"], f"final_{arm}_0.msgpack")
    jtop1 = runs["jax"]["phase3"][arm]["per_seed"][0]
    _one_sample(_eval_metrics(jpath, 0)["top1_test"], jtop1, TEST_IMAGES, (arm, "eval"))
    assert got["phase3"][arm]["per_seed"][0] == read_metadata(ppath)["metrics"]["top1_test"]
    _trained_model_matches_jax(ppath, jpath, runs["init"], None)


def test_final_policy_and_phase3_match_jax(runs):
    """Each package's final set is the JAX ranking of its own trial log; the
    port's whole run has the JAX set unless a fold's two best JAX rewards lie
    within one sample of each other.  Both arms ran in every run.  Phase 3
    on equal inputs: the port resumed from the JAX run's fold checkpoints
    and trial log dispatches no trial, selects the JAX final set, and each
    of its arms matches the JAX arm (``_phase3_arm_matches_jax``); so does
    the default arm of the port's whole run, whose inputs do not depend on
    the search."""
    got, want, on_jax = runs["port"], runs["jax"], runs["on_jax"]
    pt, jt = _trials(runs["pdir"]), _trials(runs["jdir"])
    assert _trials(runs["rdir"]) == jt  # no trial dispatched on resume
    for r, t in ((got, pt), (want, jt), (on_jax, jt)):
        assert json.dumps(r["final_policy_set"]) == json.dumps(_jax_ranked_set(t))
        assert r["phase3"]["num_runs"] == 1 and {"default", "augment"} <= set(r["phase3"])
    near_tie = any(sorted((r for _, r in jt[f]), reverse=True)[0]
                   - sorted((r for _, r in jt[f]), reverse=True)[1] <= 1.0 / FOLD_IMAGES + 1e-7
                   for f in jt)
    same = json.dumps(got["final_policy_set"]) == json.dumps(want["final_policy_set"])
    assert same or near_tie
    assert json.dumps(on_jax["final_policy_set"]) == json.dumps(want["final_policy_set"])
    for arm in ("default", "augment"):
        _phase3_arm_matches_jax(runs["rdir"], on_jax, arm, runs)
    _phase3_arm_matches_jax(runs["pdir"], got, "default", runs)
    for r in (got, on_jax):
        assert r["num_sub_policies_selected"] == want["num_sub_policies_selected"]
        shared = {"trial_batch", "aug_dispatch", "aug_groups", "fold_stack", "excluded_folds",
                  "num_quarantined_trials", "num_sub_policies"}
        assert {k: r[k] for k in shared} == {k: want[k] for k in shared}
        assert r["backend"] == "cpu" and r["device_hours_total"] == r["tpu_hours_total"]
        assert set(r) - set(want) == set()  # no key the JAX artifact lacks
    for d in (runs["pdir"], runs["rdir"]):
        assert sorted(os.listdir(d)) == sorted(os.listdir(runs["jdir"]))
    with open(os.path.join(runs["pdir"], "final_policy.json")) as fh:
        assert json.load(fh) == json.loads(json.dumps(got["final_policy_set"]))


# -------------------------------------------------------- refusals


@pytest.mark.parametrize("kw,item", [
    ({"fold_stack": 2}, "item 10"), ({"fold_stack": "auto"}, "item 10"),
    ({"device_cache": "on"}, "item 10"), ({"steps_per_dispatch": 4}, "item 10"),
    ({"async_pipeline": "on"}, "item 12"), ({"watchdog": "auto"}, "item 12"),
    ({"compile_cache": "/tmp/cc"}, "item 12"), ({"telemetry_spec": "/tmp/t"}, "item 12"),
    ({"divergence_retries": 1}, "item 12"), ({"work_queue": object()}, "item 13"),
    ({"fleet_transport": object()}, "item 13")],
    ids=["fold_stack_2", "fold_stack_auto", "device_cache", "steps_per_dispatch",
         "async_pipeline", "watchdog", "compile_cache", "telemetry", "divergence_retries",
         "work_queue", "fleet_transport"])
def test_search_policies_refuses_what_is_not_ported(tmp_path, kw, item):
    conf = SC.load_config(CONF)
    with pytest.raises(NotImplementedError, match=item):
        D.search_policies(conf, "", str(tmp_path), device="cpu", **kw)


@pytest.mark.parametrize("flag", sorted(SC.UNPORTED_FLAGS))
def test_clis_refuse_unported_flags_by_item(flag, capsys):
    for cli in (SC, TC):
        with pytest.raises(SystemExit) as e:
            cli.main(["-c", CONF, flag, "1", "--device", "cpu"])
        assert e.value.code == 2
        assert f"item {SC.UNPORTED_FLAGS[flag]}" in capsys.readouterr().err


def test_clis_refuse_unknown_flags_and_a_missing_card(capsys):
    for cli in (SC, TC):
        with pytest.raises(SystemExit) as e:
            cli.main(["-c", CONF, "--no-such-flag"])
        assert e.value.code == 2 and "unrecognized" in capsys.readouterr().err
        if not torch.cuda.is_available():
            with pytest.raises(SystemExit) as e:
                cli.main(["-c", CONF])  # cuda is the default
            assert e.value.code not in (0, None) and "device='cpu'" in str(e.value.code)


# ----------------------------------------- the driver's own behaviour

TINY = SEARCH_ARGS[2:]


def _search(tmp, *extra, conf_over=("epoch=1",)):
    return SC.main(["-c", CONF, "--save-dir", str(tmp), "--device", "cpu"] + TINY
                   + list(extra) + list(conf_over))


def test_resume_trains_and_dispatches_nothing(tmp_path, monkeypatch):
    first = _search(tmp_path, "--until", "2")
    calls = {"train": 0, "tta": 0}
    real_train, real_eval = D.train_and_eval, D._FoldEval.evaluate

    def train(*a, **k):
        calls["train"] += 1
        return real_train(*a, **k)

    def evaluate(self, fold, path, policy_t, key):
        # trials score num_policy sub-policies; the audit's baselines score one
        calls["tta"] += int(policy_t.shape[0]) == 2
        return real_eval(self, fold, path, policy_t, key)

    monkeypatch.setattr(D, "train_and_eval", train)
    monkeypatch.setattr(D._FoldEval, "evaluate", evaluate)
    with open(tmp_path / "search_trials.json") as fh:
        trials = fh.read()
    again = _search(tmp_path, "--until", "2")
    assert calls == {"train": 0, "tta": 0}
    assert again["final_policy_set"] == first["final_policy_set"]
    with open(tmp_path / "search_trials.json") as fh:
        assert fh.read() == trials
    # --topup-trials extends the budget: only the new trials dispatch
    more = _search(tmp_path, "--until", "2", "--topup-trials", "1")
    assert calls == {"train": 0, "tta": 2} and more["warm_start"]["topup_trials"] == 1
    assert all(len(t) == 5 for t in _trials(str(tmp_path)).values())


def test_quality_gate_retrains_promotes_and_excludes(tmp_path):
    res = _search(tmp_path, "--until", "2", "--fold-quality-floor", "0.99",
                  "--fold-retrain-tries", "1", "--folds", "0")
    assert res["excluded_folds"] == [0] and res["final_policy_set"] == []
    assert res["guards"]["fold_quality_floor"] == 0.99
    assert 0.0 <= res["fold_baselines"]["0"] < 0.99
    assert not [f for f in os.listdir(tmp_path) if ".retry" in f]  # promoted or removed
    assert float(res["device_secs_phase1_per_fold"]["0"]) > 0


def test_quarantine_and_trial_batch(tmp_path, monkeypatch):
    seq = _search(tmp_path / "seq", "--until", "2", "--folds", "0")
    batched = _search(tmp_path / "bat", "--until", "2", "--folds", "0", "--trial-batch", "3")
    st, bt = _trials(str(tmp_path / "seq")), _trials(str(tmp_path / "bat"))
    assert [json.dumps(p) for p, _ in st["0"]] == [json.dumps(p) for p, _ in bt["0"]]
    for (_, a), (_, b) in zip(st["0"], bt["0"]):
        _one_sample(a, b, FOLD_IMAGES, "batched reward")
    assert batched["trial_batch"] == 3 and seq["trial_batch"] == 1
    real = D._FoldEval.evaluate

    def flaky(self, fold, path, policy_t, key):
        if flaky.calls == 1:
            flaky.calls += 1
            raise RuntimeError("injected")
        flaky.calls += 1
        return real(self, fold, path, policy_t, key)

    flaky.calls = 0
    monkeypatch.setattr(D._FoldEval, "evaluate", flaky)
    res = _search(tmp_path / "q", "--until", "2", "--folds", "0")
    assert res["num_quarantined_trials"] == 1
    assert res["quarantined_trials"][0]["trial"] == 1
    entry = _trials(str(tmp_path / "q"))["0"][1]
    assert entry[2]["quarantined"] and entry[1] == min(r for _, r, *x in
                                                       _trials(str(tmp_path / "q"))["0"][:1])


def test_train_cli_on_the_cpu(tmp_path):
    path = str(tmp_path / "m.msgpack")
    res = TC.main(["-c", CONF, "--save", path, "--cv-ratio", "0.4", "--device", "cpu",
                   "--evaluation-interval", "1", "epoch=1"])
    assert res["epoch"] == 1 and read_metadata(path)["epoch"] == 1
    again = TC.main(["-c", CONF, "--save", path, "--cv-ratio", "0.4", "--device", "cpu",
                     "--only-eval", "epoch=1"])
    assert again["top1_valid"] == res["top1_valid"] and "loss_train" not in again
    with pytest.raises(SystemExit):
        TC.main(["-c", CONF, "--only-eval", "--device", "cpu"])
