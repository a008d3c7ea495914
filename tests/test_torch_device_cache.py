"""The port's device-resident data path (``data/pipeline.py DeviceCache``,
``train/steps.py make_multistep_train_step``, the cache branch of
``train/trainer.py train_and_eval``, the driver's and the CLIs' flags)
against the JAX package and against the port's own host feed, on the CPU,
where a dispatch of N steps runs as a loop (the card replays a CUDA graph
of the same body; ``chip_smoke.py`` holds the two together there).

Oracles and bounds:

- ``train_index_matrix``, ``split_dispatch_chunks`` and
  ``resolve_device_cache`` against the JAX package's: equal values, and
  the same refusals;
- ``DeviceCache``: its tensors equal to the dataset's arrays, its byte
  count the JAX formula's;
- one dispatch of N = 1 and N = 3 steps (WRN-10-1 with the
  ``fa_reduced_cifar10`` policy and EMA; a PyramidNet with ShakeDrop and
  mixup) against N host-fed steps of the port from the same state:
  every state tensor and the metric sums bitwise;
- the port's N = 1 dispatch against the JAX package's
  ``make_multistep_train_step`` at N = 1, both inside ``train_and_eval``
  from one state (the port's mid-epoch link after step 2) with the JAX
  draws (``test_torch_replay.JaxDraws``, ``jax_threefry_partitionable``
  pinned), the JAX run compiled without FMA
  (``test_torch_replay.jax_reference``): step 3's loss sum within
  ``LOSS_RTOL`` relative, its top-1 and top-5 counts within one sample,
  every weight, BatchNorm statistic and EMA tensor within ``2 * JAX_DRIFT``
  of what the step changed it by (the bounds of
  ``tests/test_torch_train.py``);
- ``train_and_eval`` with ``device_cache`` ``"auto"`` (N = 1, a mid-epoch
  checkpoint every dispatch) and ``"on"`` (N = 3 over two epochs:
  dispatches of 3 and 1) against ``"off"``, and each resumed from a
  mid-epoch link (N = 1 inside the epoch; N = 3 after epoch 1's first
  dispatch, so the resumed run does the remainder and epoch 2) against
  its uninterrupted run: the final checkpoint bytes and the result dicts
  equal; the host feed walks back past a mid-epoch link;
- the JAX ``train_and_eval`` under ``"auto"`` resumed from a port-written
  mid-epoch link, against the port's run, and the port resumed from the
  JAX run's own mid-epoch link, against the JAX run: counts exact, losses
  within 1e-4 relative, accuracies within one sample (the bounds of
  ``tests/test_torch_train.py test_train_and_eval_matches_jax``, which
  holds the port's default path, this one, against JAX from the same
  init);
- the driver's stamps and the ``train_and_eval`` arguments of phase 1 and
  phase 3; the CLI flags; ``--fold-stack`` refused naming item 10b and the
  multi-host flags naming 10c.
"""

import os

import jax
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu_torch.data import pipeline as PL
from fast_autoaugment_tpu_torch.data.datasets import ArrayDataset, cv_split, load_dataset
from fast_autoaugment_tpu_torch.launch import search_cli as SC
from fast_autoaugment_tpu_torch.launch import train_cli as TC
from fast_autoaugment_tpu_torch.models import get_model
from fast_autoaugment_tpu_torch.ops import optim as O
from fast_autoaugment_tpu_torch.ops import schedules as S
from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
from fast_autoaugment_tpu_torch.search import driver as D
from fast_autoaugment_tpu_torch.train import steps as ST
from fast_autoaugment_tpu_torch.train import trainer as TR
from test_torch_replay import JaxDraws, jax_reference_groups

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "confs", "wresnet10x1_shapes.yaml")
LOSS_RTOL = 1e-3  # tests/test_torch_train.py
JAX_DRIFT = 0.05  # tests/test_torch_train.py JAX_DRIFT["cifar_wrn10_1"]
FA_CIFAR = policy_to_tensor(load_policy("fa_reduced_cifar10"))
# synthetic at test_ratio 0.4: 307 train images, 4 steps an epoch at batch 64
TRAIN_CONF = {"model": {"type": "wresnet10_1"}, "dataset": "synthetic",
              "aug": "fa_reduced_cifar10", "cutout": 16, "batch": 64, "epoch": 1,
              "lr": 0.1, "lr_schedule": {"type": "cosine", "warmup": {"multiplier": 2,
                                                                       "epoch": 1}},
              "optimizer": {"type": "sgd", "nesterov": True, "decay": 0.0002, "ema": 0.9}}
RUN_KW = dict(test_ratio=0.4, cv_fold=0, metric="last", evaluation_interval=1, seed=0,
              device_cache="auto", steps_per_dispatch=1, checkpoint_every_dispatch=1,
              ckpt_keep=3)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch on 2 threads in this file, as the zoo files pin it: the tier-1
    run's workers share the machine (and float32 results move with the
    count, so it is put back for the next file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dataset(n=64, img=8, seed=0, lazy=False):
    g = np.random.default_rng(seed)
    if lazy:
        return ArrayDataset(np.asarray(["a.jpg"] * n, object), np.zeros(n, np.int32), 10,
                            lazy=True)
    return ArrayDataset(g.integers(0, 256, (n, img, img, 3), dtype=np.uint8),
                        g.integers(0, 10, (n,), np.int32), 10)


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))
            if ".msgpack" in n and not n.endswith(".jsonl")}


def _write_link(files: dict, link: str, dst: str) -> None:
    """Chain link `link` (e.g. ``b.msgpack.prev``) of `files` as the head `dst`."""
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "wb") as fh:
        fh.write(files[link])
    with open(dst + ".meta.json", "wb") as fh:
        fh.write(files[link + ".meta.json"])


# -------------------------------------------------- the JAX references


def jax_device_cache_refs(job):
    """Reference runner (FMA-free process): JAX ``train_and_eval`` under
    ``auto``, a mid-epoch link every dispatch, resumed from the chain link
    ``job["link"]`` of ``job["files"]``: its result and its chain's files."""
    from fast_autoaugment_tpu.core.config import Config
    from fast_autoaugment_tpu.parallel.mesh import make_mesh
    from fast_autoaugment_tpu.train import trainer as JT

    # the resumed link overwrites the initial state: make it as zeros of its
    # shapes, not drawn op by op (13 s; this process only)
    eager_init = JT.create_train_state
    JT.create_train_state = lambda model, opt, rng, sample, use_ema=False: jax.tree.map(
        lambda a: jax.numpy.zeros(a.shape, a.dtype), jax.eval_shape(
            lambda r: eager_init(model, opt, r, sample, use_ema=use_ema), rng))
    # the split as the port's cv_split draws it (tests/test_torch_train.py
    # holds it equal to the JAX package's sklearn one, whose import costs
    # this process 6 s)
    JT.cv_split = lambda labels, ratio, fold: job["split"]
    save = os.path.join(job["dir"], "r.msgpack")
    _write_link(job["files"], job["link"], save)
    result = JT.train_and_eval(Config(TRAIN_CONF), "", save_path=save,
                               mesh=make_mesh(jax.devices()[:1]), **RUN_KW)
    return {"result": {k: v for k, v in result.items() if k != "compile_cache"},
            "files": _files(job["dir"])}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The port's run P (its own init, the JAX draws, a mid-epoch link every
    dispatch) first, then the JAX reference: JAX ``train_and_eval`` resumed
    from P's link after step 2 of 4, which writes its own mid-epoch link
    after step 3 (so steps 3 of P and of the JAX run are one N = 1 dispatch
    each from one state)."""
    base = tmp_path_factory.mktemp("cache")
    pdir = str(base / "p")
    p_result = TR.train_and_eval(TRAIN_CONF, "", save_path=os.path.join(pdir, "p.msgpack"),
                                 device="cpu", draw_source=JaxDraws(), **RUN_KW)
    p_files = _files(pdir)
    split = cv_split(load_dataset("synthetic", "")[0].labels, RUN_KW["test_ratio"],
                     RUN_KW["cv_fold"])
    jobs = [{"runner": "test_torch_device_cache:jax_device_cache_refs",
             "dir": str(base / "jr"), "files": p_files, "link": "p.msgpack.prev2",
             "split": split, "threefry_partitionable": True}]
    [a_resume] = jax_reference_groups([jobs], str(base))[0]
    return {"base": base, "p": {"result": p_result, "files": p_files}, "jax_resume": a_resume}


def _results_close(got: dict, want: dict, what: str) -> None:
    """The bounds of tests/test_torch_train.py test_train_and_eval_matches_jax."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, v in want.items():
        if k == "elapsed_sec":
            continue
        if k.startswith("num_") or k == "epoch":
            assert got[k] == v, (what, k)
        elif "loss" in k:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4, err_msg=f"{what} {k}")
        else:  # accuracies: at most one sample apart
            n = want.get("num_" + k.split("_", 1)[1], 64 * 4)
            assert abs(got[k] - v) <= 1.0 / n + 1e-7, (what, k, got[k], v)


# ------------------------------------- index matrix, chunks, the gates


def test_train_index_matrix_matches_jax():
    from fast_autoaugment_tpu.data.pipeline import train_index_matrix as jax_matrix

    idx = np.arange(13, 61)
    for epoch, seed in ((1, 0), (5, 3), (2, 77)):
        np.testing.assert_array_equal(PL.train_index_matrix(idx, 8, epoch, seed=seed),
                                      jax_matrix(idx, 8, epoch, seed=seed))


@pytest.mark.parametrize("total,n", [(10, 1), (10, 4), (4, 4), (3, 8), (0, 4), (390, 8),
                                     (390, 1), (7, 3)])
def test_split_dispatch_chunks_matches_jax(total, n):
    from fast_autoaugment_tpu.data.pipeline import split_dispatch_chunks as jax_chunks

    got = PL.split_dispatch_chunks(total, n)
    assert got == jax_chunks(total, n) and sum(got) == total and len(set(got)) <= 2


def test_split_dispatch_chunks_refuses_zero():
    from fast_autoaugment_tpu.data.pipeline import split_dispatch_chunks as jax_chunks

    for fn in (PL.split_dispatch_chunks, jax_chunks):
        with pytest.raises(ValueError, match="steps_per_dispatch"):
            fn(10, 0)


@pytest.mark.parametrize("mode", ["auto", "on", "off", True, False, None, "0", "maybe"])
@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("procs", [1, 2])
def test_resolve_device_cache_matches_jax(mode, lazy, procs):
    from fast_autoaugment_tpu.data.datasets import ArrayDataset as JaxArrayDataset
    from fast_autoaugment_tpu.data.pipeline import resolve_device_cache as jax_resolve

    ds = _dataset(4, lazy=lazy)
    jds = JaxArrayDataset(ds.images, ds.labels, 10, lazy=lazy)
    try:
        want = jax_resolve(mode, jds, process_count=procs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            PL.resolve_device_cache(mode, ds, process_count=procs)
        assert str(got.value).split(":")[0] == str(e).split(":")[0]
        return
    assert PL.resolve_device_cache(mode, ds, process_count=procs) is want


def test_device_cache_contents():
    ds = _dataset(13)
    cache = PL.DeviceCache(ds, "cpu")
    assert cache.num_examples == 13
    assert cache.images.dtype == torch.uint8 and cache.labels.dtype == torch.int64
    np.testing.assert_array_equal(cache.images.numpy(), ds.images)
    np.testing.assert_array_equal(cache.labels.numpy(), ds.labels)
    assert cache.nbytes == ds.images.nbytes + ds.labels.nbytes
    with pytest.raises(ValueError, match="in-memory"):
        PL.DeviceCache(_dataset(4, lazy=True), "cpu")


@pytest.mark.parametrize("step", [0, 1, 389, 2**31 + 5, 2**32 + 7])
def test_fold_in_takes_a_tensor_counter(step):
    """A graph reads the step counter from a device tensor: the same key as
    the Python integer's, for counters past 32 bits too (taken mod 2^32)."""
    from fast_autoaugment_tpu_torch.ops import rng

    key = torch.tensor([[0, 7], [3, 2**32 - 1]])
    assert torch.equal(rng.fold_in(key, torch.tensor(step)), rng.fold_in(key, step))


def test_launch_counters_count_graph_replays(monkeypatch):
    """A launch recorded under capture counts nothing until the graph is
    replayed; then once per replay."""
    from fast_autoaugment_tpu_torch.ops import _kernels

    _kernels.reset_launch_counts()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with _kernels.counting_capture() as tally:
        _kernels._count("augment")
        _kernels._count("cifar_stack", 2)
    assert _kernels.launch_counts() == {"augment": 0, "cifar_stack": 0, "imagenet_stack": 0}
    _kernels._count("augment")  # captured outside counting_capture: counted nowhere
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    _kernels._count("imagenet_stack")
    _kernels.count_replays(tally, 3)
    assert _kernels.launch_counts() == {"augment": 3, "cifar_stack": 6, "imagenet_stack": 1}
    _kernels.reset_launch_counts()


# ------------------------------------- a dispatch against host-fed steps


def _state_arrays(state):
    out = {f"m.{k}": v.detach().numpy().copy() for k, v in state.model.state_dict().items()}
    opt = state.opt_state
    for name, ts in (("trace", opt.trace), ("ms", opt.ms), ("mom", opt.mom)):
        out.update({f"{name}.{i}": t.numpy().copy() for i, t in enumerate(ts)})
    if state.ema is not None:
        out.update({f"ema.{k}": v.numpy().copy() for k, v in state.ema.items()})
    return out


CASES = {"wrn_n1": ({"type": "wresnet10_1"}, 0.0, 0.9, "sgd", 1),
         "wrn_n3": ({"type": "wresnet10_1"}, 0.0, 0.9, "sgd", 3),
         "pyramid_mixup_n3": ({"type": "pyramid", "depth": 11, "alpha": 12,
                               "bottleneck": True}, 0.2, 0.0, "rmsprop", 3)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_multistep_dispatch_equals_host_steps_bitwise(case):
    mconf, mixup, ema, opt, n = CASES[case]
    ds = _dataset(24, img=16, seed=4)
    idx = np.random.default_rng(9).permutation(24)[:n * 6].reshape(n, 6)
    pol = torch.from_numpy(FA_CIFAR)
    key = torch.tensor([0, 21])

    def build():
        model = get_model(dict(mconf, dataset="cifar10"), 10, device="cpu", seed=2)
        optimizer = O.build_optimizer({"type": opt, "decay": 5e-4}, S.build_schedule(
            {"lr": 0.1, "epoch": 3, "lr_schedule": {"type": "cosine", "warmup": {
                "multiplier": 2, "epoch": 1}}}, 2))
        kw = dict(num_classes=10, mixup_alpha=mixup, ema_mu=ema, cutout_length=8)
        return (ST.create_train_state(model, optimizer, use_ema=ema > 0),
                ST.make_train_step(model, optimizer, **kw),
                ST.make_train_step_body(model, optimizer, **kw))

    state, step, _ = build()
    host = None
    for row in idx:
        state, m = step(state, torch.from_numpy(ds.images[row]),
                        torch.from_numpy(ds.labels[row].astype(np.int64)), pol, key)
        host = m if host is None else {k: host[k] + m[k] for k in m}
    want = _state_arrays(state)
    state2, _, body = build()
    fn = ST.make_multistep_train_step(body, steps_per_dispatch=n)
    cache = PL.DeviceCache(ds, "cpu")
    state2, got = fn(state2, cache.images, cache.labels, idx, pol, key)
    assert state2.step == state2.opt_state.count == n
    for k in ST.METRIC_KEYS:
        assert got[k].item() == host[k].item(), k
    have = _state_arrays(state2)
    assert set(have) == set(want)
    bad = [k for k in want if not np.array_equal(want[k], have[k])]
    assert not bad, bad[:5]


def _float_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_float_leaves(v, f"{prefix}/{k}"))
        return out
    a = np.asarray(tree)
    return {prefix: a} if a.dtype.kind == "f" else {}


def test_multistep_n1_dispatch_matches_jax(refs):
    """Step 3 of P and of the JAX run: one N = 1 dispatch each, from P's
    link after step 2, with the JAX draws."""
    import json

    from fast_autoaugment_tpu_torch.core.msgpack import unpackb

    port_files, jax_files = refs["p"]["files"], refs["jax_resume"]["files"]

    def link(files, name):
        tree = unpackb(files[name])
        leaves = {k: v for part in ("params", "batch_stats", "ema")
                  for k, v in _float_leaves(tree[part], part).items()}
        return leaves, json.loads(files[name + ".meta.json"])["in_epoch"]

    base, before = link(port_files, "p.msgpack.prev2")
    port, port_rec = link(port_files, "p.msgpack.prev")
    want, jax_rec = link(jax_files, "r.msgpack.prev")
    assert before["pos"] == 2 and port_rec["pos"] == jax_rec["pos"] == 3
    step3 = {k: (port_rec["sums"][k] - before["sums"][k], jax_rec["sums"][k] - before["sums"][k])
             for k in ST.METRIC_KEYS}
    np.testing.assert_allclose(*step3["loss"], rtol=LOSS_RTOL)
    for k in ("top1", "top5"):
        assert abs(step3[k][0] - step3[k][1]) <= 1.0, (k, step3[k])
    assert step3["num"][0] == step3["num"][1] == TRAIN_CONF["batch"]
    assert set(port) == set(want) == set(base) and len(want) > 40
    for k, v in want.items():
        change = float(np.abs(v - base[k]).max())
        err = float(np.abs(port[k] - v).max())
        assert err <= 2 * JAX_DRIFT * change + 1e-7, (k, err, change)


# ----------------------------------------------------- train_and_eval


#: (steps_per_dispatch, epochs, the mid-epoch link to resume from)
RESUME_CASES = {1: (1, "prev"), 3: (2, "prev3")}


@pytest.fixture(scope="module")
def cache_runs(tmp_path_factory):
    """Per N of :data:`RESUME_CASES`, made once and shared by the tests
    below: the cache run (a mid-epoch link every dispatch), the host feed's
    run, and the cache run resumed from its mid-epoch link; for N = 1 also
    the host feed given only that link (it walks back past it).  N = 1: the
    link after step 3 of 4; N = 3 over two epochs (dispatches of 3 and 1):
    the link after epoch 1's first dispatch, so the resumed run does the
    remainder, evaluates and trains epoch 2."""
    made = {}

    def get(n):
        if n in made:
            return made[n]
        epochs, link = RESUME_CASES[n]
        base = tmp_path_factory.mktemp(f"n{n}")
        conf = dict(TRAIN_CONF, epoch=epochs)
        kw = dict(RUN_KW, steps_per_dispatch=n, ckpt_keep=4,
                  device_cache="auto" if n == 1 else "on")
        off_kw = dict(kw, device_cache="off", steps_per_dispatch=1, checkpoint_every_dispatch=0)

        def run(name, files=None, **over):
            path = str(base / name / "m.msgpack")
            if files is not None:
                _write_link(files, f"m.msgpack.{link}", path)
            result = TR.train_and_eval(conf, "", save_path=path, device="cpu",
                                       **dict(kw, **over))
            return {k: v for k, v in result.items() if k != "elapsed_sec"}, \
                _files(str(base / name))

        out = {"link": link}
        out["cache"], files = run("cache")
        out["off"] = run("off", **off_kw)
        out["resumed"] = run("resumed", files=files)
        if n == 1:
            out["off_from_link"] = run("off_from_link", files=files, **off_kw)
        out["link_meta"] = __import__("json").loads(files[f"m.msgpack.{link}.meta.json"])
        out["cache"] = (out["cache"], files)
        made[n] = out
        return out

    return get


@pytest.mark.parametrize("n", [1, 3], ids=["auto_n1", "on_n3"])
def test_train_and_eval_cache_equals_host_feed_bitwise(cache_runs, n):
    runs = cache_runs(n)
    (cache, files), (off, off_files) = runs["cache"], runs["off"]
    assert cache == off
    assert files["m.msgpack"] == off_files["m.msgpack"]


@pytest.mark.parametrize("n", [1, 3], ids=["n1_in_epoch", "n3_remainder_across_epochs"])
def test_mid_epoch_resume_equals_uninterrupted(cache_runs, n):
    runs = cache_runs(n)
    (whole, files), (got, got_files) = runs["cache"], runs["resumed"]
    meta = runs["link_meta"]
    assert meta["in_epoch"]["pos"] == 3 and meta["in_epoch"]["epoch"] == meta["epoch"] + 1
    assert got == whole
    assert got_files["m.msgpack"] == files["m.msgpack"]
    if n == 1:  # the host feed does not resume a mid-epoch link: it starts afresh
        (again, again_files), (off, off_files) = runs["off_from_link"], runs["off"]
        assert again == off and again_files["m.msgpack"] == off_files["m.msgpack"]


def test_port_mid_epoch_link_resumes_in_jax(refs):
    """JAX ``train_and_eval`` under ``auto``, resumed from the port's link
    after step 2, ends within the bounds of the port's run: the port's
    cache path against the JAX package's, from the same state and draws."""
    got = refs["jax_resume"]["result"]
    _results_close(got, refs["p"]["result"], "JAX resumed from a port link vs the port")
    meta = __import__("json").loads(refs["p"]["files"]["p.msgpack.prev2.meta.json"])
    assert meta["in_epoch"] == {"epoch": 1, "pos": 2, "sums": meta["in_epoch"]["sums"],
                                "retries": 0} and meta["epoch"] == 0 and meta["step"] == 2


def test_jax_mid_epoch_link_resumes_in_the_port(refs, tmp_path):
    """The JAX run's own link after step 3, resumed by the port, ends within
    the bounds of that JAX run."""
    ref = refs["jax_resume"]
    cut = str(tmp_path / "m.msgpack")
    _write_link(ref["files"], "r.msgpack.prev", cut)
    meta = __import__("json").loads(ref["files"]["r.msgpack.prev.meta.json"])
    assert meta["in_epoch"]["pos"] == 3 and set(meta["in_epoch"]["sums"]) == set(ST.METRIC_KEYS)
    got = TR.train_and_eval(TRAIN_CONF, "", save_path=cut, device="cpu", draw_source=JaxDraws(),
                            **RUN_KW)
    _results_close(got, ref["result"], "port resumed from a JAX link vs the JAX run")
    assert __import__("json").loads(open(cut + ".meta.json").read())["step"] == 4


# ------------------------------------------------- the driver and the CLIs


class _Stop(Exception):
    pass


def test_driver_threads_and_stamps_the_cache(tmp_path, monkeypatch):
    calls = []

    def record(conf, dataroot, **kw):
        calls.append(kw)
        raise _Stop

    monkeypatch.setattr(D, "train_and_eval", record)
    conf = SC.load_config(CONF)
    with pytest.raises(_Stop):
        D.search_policies(conf, "", str(tmp_path), cv_num=2, num_search=1, device="cpu",
                          device_cache="on", steps_per_dispatch=4)
    assert calls[0]["device_cache"] == "on" and calls[0]["steps_per_dispatch"] == 4
    got = D.search_policies(conf, "", str(tmp_path), cv_num=2, num_search=1, device="cpu",
                            folds=[], device_cache="off", steps_per_dispatch=0)
    assert got["device_cache"] == "off" and got["steps_per_dispatch"] == 1
    assert got["fold_stack"] == 0


def test_clis_take_the_cache_flags(tmp_path, monkeypatch):
    calls = []

    def record(conf, dataroot, **kw):
        calls.append(kw)
        return {"top1_test": 0.5, "epoch": 1}

    def search(conf, **kw):
        calls.append(kw)
        return D.SearchResult(final_policy_set=[[("Invert", 0.5, 0.5)]], backend="cpu",
                              device_kind="cpu")

    monkeypatch.setattr(SC, "train_and_eval", record)
    monkeypatch.setattr(SC, "search_policies", search)
    monkeypatch.setattr(TC, "train_and_eval", record)
    flags = ["--device-cache", "on", "--steps-per-dispatch", "4", "--ckpt-every-dispatch", "2",
             "--device", "cpu"]
    SC.main(["-c", CONF, "--save-dir", str(tmp_path), "--num-result-per-cv", "1"] + flags)
    assert calls[0]["device_cache"] == "on" and calls[0]["steps_per_dispatch"] == 4
    assert "checkpoint_every_dispatch" not in calls[0]  # the JAX driver takes no such knob
    assert {k: calls[1][k] for k in ("device_cache", "steps_per_dispatch",
                                     "checkpoint_every_dispatch")} == \
        {"device_cache": "on", "steps_per_dispatch": 4, "checkpoint_every_dispatch": 2}
    TC.main(["-c", CONF] + flags)
    assert {k: calls[-1][k] for k in ("device_cache", "steps_per_dispatch",
                                      "checkpoint_every_dispatch")} == \
        {"device_cache": "on", "steps_per_dispatch": 4, "checkpoint_every_dispatch": 2}
    for cli in (SC, TC):
        args = cli.build_parser().parse_args(["-c", CONF])
        assert (args.device_cache, args.steps_per_dispatch, args.ckpt_every_dispatch) == \
            ("auto", 1, 0)


@pytest.mark.parametrize("flag,item", [("--fold-stack", "10b"), ("--coordinator", "10c"),
                                       ("--num-hosts", "10c"), ("--host-id", "10c")])
def test_clis_refuse_the_rest_of_item_10(flag, item, capsys):
    for cli in (SC, TC):
        with pytest.raises(SystemExit) as e:
            cli.main(["-c", CONF, flag, "1", "--device", "cpu"])
        assert e.value.code == 2
        assert f"item {item})" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        SC.main(["-c", CONF, "--device-cache", "maybe", "--device", "cpu"])
