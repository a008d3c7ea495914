"""The trainer's resilience against the JAX package's, on the CPU:
preemption (``FAA_FAULT=sigterm@step=K``), divergence retries
(``nan_loss@step=K`` with ``divergence_retries=1``), torn checkpoint writes
(``torn_ckpt@save=N``), the hang watchdog, and the CLIs' exit-77 contract.

Bounds: a preempted run resumed is bitwise the uninterrupted run (the
checkpoint's bytes and the result), on the device cache's dispatch
boundaries and on the host feed's epoch boundary.  The divergence retry
replays with the retry-folded key ``fold_in(PRNGKey(seed), 1_000_003)``, the
JAX key tree's (checked through the JAX draw source, ``JaxDraws``, that
replays it), and the run's result is held to the JAX run's (the same init,
the same fault, in the FMA-free reference process) within
``tests/test_torch_train.py``'s bounds for ``train_and_eval``: losses within
1e-4, accuracies within one sample.
"""

import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu.core import resilience as JR
from fast_autoaugment_tpu_torch.core import checkpoint as C
from fast_autoaugment_tpu_torch.core import resilience as R
from fast_autoaugment_tpu_torch.core import telemetry as T
from fast_autoaugment_tpu_torch.launch import train_cli as TC
from fast_autoaugment_tpu_torch.models.wideresnet import WideResNet
from fast_autoaugment_tpu_torch.train import trainer as TR
from fast_autoaugment_tpu_torch.utils import faultinject as F
from fast_autoaugment_tpu_torch.utils.interop import flax_to_state_dict
from test_torch_replay import JaxDraws, jax_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTITIONABLE = True
#: wresnet10_1 on `synthetic` (512 train images, 256 test): 2 steps an
#: epoch, so that the final state is 4 steps from the init, as in
#: tests/test_torch_train.py's train_and_eval parity
NAN_CONF = {"model": {"type": "wresnet10_1"}, "dataset": "synthetic",
            "aug": "fa_reduced_cifar10", "cutout": 16, "batch": 256, "epoch": 2,
            "lr": 0.1, "lr_schedule": {"type": "cosine", "warmup": {"multiplier": 1, "epoch": 5}},
            "optimizer": {"type": "sgd", "nesterov": True, "decay": 0.0002, "ema": 0}}
NAN_STEP = 3  # in epoch 2: the epoch-1 link is the rollback point
#: the preemption runs: 6 steps an epoch on 384 train images, EMA on
PRE_CONF = {"model": {"type": "wresnet10_1"}, "dataset": "synthetic",
            "aug": "fa_reduced_cifar10", "cutout": 16, "batch": 64, "epoch": 2,
            "lr": 0.1, "lr_schedule": {"type": "cosine", "warmup": {"multiplier": 1, "epoch": 1}},
            "optimizer": {"type": "sgd", "nesterov": True, "decay": 0.0002, "ema": 0.9}}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.delenv("FAA_FAULT", raising=False)
    F.reset()
    R.clear_preemption()
    yield
    F.reset()
    R.clear_preemption()
    torch.set_num_threads(threads)  # float32 results move with the count


def _fault(monkeypatch, spec):
    monkeypatch.setenv("FAA_FAULT", spec)
    F.reset()


def _unfault(monkeypatch):
    monkeypatch.delenv("FAA_FAULT")
    F.reset()
    R.clear_preemption()


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _pre_run(path, **kw):
    return TR.train_and_eval(PRE_CONF, "", test_ratio=0.25, cv_fold=0, save_path=path,
                             evaluation_interval=1, seed=3, device="cpu", **kw)


@pytest.mark.parametrize("feed,spec,link", [
    ({"steps_per_dispatch": 2}, "sigterm@step=3", "in_epoch"),
    ({"device_cache": "off"}, "sigusr1@step=2", "epoch")],
    ids=["cache_dispatch_boundary", "host_feed_epoch_boundary"])
def test_preempted_run_resumes_bitwise(tmp_path, monkeypatch, feed, spec, link):
    whole = _pre_run(str(tmp_path / "w.msgpack"), **feed)
    cut = str(tmp_path / "c.msgpack")
    _fault(monkeypatch, spec)
    with pytest.raises(R.PreemptedError):
        _pre_run(cut, **feed)
    meta = C.read_metadata(cut)
    assert meta["preempted"] is True
    if link == "in_epoch":  # the dispatch boundary after step 3 (dispatches of 2)
        assert meta["in_epoch"] == {"epoch": 1, "pos": 4, "retries": 0,
                                    "sums": meta["in_epoch"]["sums"]} and meta["step"] == 4
    else:  # the host feed stops at the end of epoch 1
        assert meta["epoch"] == 1 and "in_epoch" not in meta
    _unfault(monkeypatch)
    got = _pre_run(cut, **feed)
    assert _bytes(cut) == _bytes(str(tmp_path / "w.msgpack"))
    assert {k: v for k, v in got.items() if k != "elapsed_sec"} == \
        {k: v for k, v in whole.items() if k != "elapsed_sec"}


def test_signal_handlers_are_put_back_after_another_library_replaced_them():
    """Another library in the process (here the JAX package) installs its
    own SIGTERM/SIGUSR1 handlers after the port's: the port's next install
    puts its own back, so a signal still sets the port's flag."""
    sigs = (signal.SIGTERM, signal.SIGUSR1)
    prev = {s: signal.getsignal(s) for s in sigs}
    try:
        assert R.install_signal_handlers()
        JR.install_signal_handlers()
        assert R.install_signal_handlers()
        for s in sigs:
            R.clear_preemption()
            os.kill(os.getpid(), s)
            deadline = time.monotonic() + 5
            while not R.preemption_requested() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert R.preemption_requested(), s
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        JR.clear_preemption()


def test_torn_checkpoint_walks_back(tmp_path, monkeypatch):
    path = str(tmp_path / "m.msgpack")
    saved0 = T.registry().counter("faa_checkpoints_saved_total").value
    corrupt0 = T.registry().counter("faa_checkpoints_corrupt_total").value
    C.save_checkpoint(path, {"step": np.asarray(1, np.int32)}, {"epoch": 1})
    _fault(monkeypatch, "torn_ckpt@save=1")
    C.save_checkpoint(path, {"step": np.asarray(2, np.int32)}, {"epoch": 2})
    _unfault(monkeypatch)
    with pytest.raises(C.CheckpointCorruptError):
        C.load_checkpoint(path)
    tree, meta, used = C.load_checkpoint_chain(path)
    assert used == path + ".prev" and meta["epoch"] == 1 and int(tree["step"]) == 1
    assert T.registry().counter("faa_checkpoints_saved_total").value == saved0 + 1
    # the direct load and the chain walk each found the torn link
    assert T.registry().counter("faa_checkpoints_corrupt_total").value == corrupt0 + 2


def jax_divergence(job):
    """Reference runner: the JAX ``train_and_eval`` on one device, host-fed,
    with ``FAA_FAULT`` nan_loss and one divergence retry; its initial
    variables and the saved checkpoint's sidecar."""
    import tempfile

    from fast_autoaugment_tpu.core.checkpoint import read_metadata
    from fast_autoaugment_tpu.models import get_model
    from fast_autoaugment_tpu.parallel.mesh import make_mesh
    from fast_autoaugment_tpu.train.trainer import train_and_eval
    from fast_autoaugment_tpu.utils import faultinject

    conf, seed = job["conf"], job["seed"]
    model = get_model(dict(conf["model"], dataset=conf["dataset"]), 10)
    rng = jax.random.PRNGKey(seed)
    init = model.init({"params": rng, "shake": jax.random.fold_in(rng, 1)},
                      jnp.zeros((2, 32, 32, 3)), train=False)
    os.environ["FAA_FAULT"] = job["fault"]
    faultinject.reset()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.msgpack")
        result = train_and_eval(conf, "", save_path=path, evaluation_interval=1,
                                mesh=make_mesh(jax.devices()[:1]), seed=seed,
                                device_cache="off", divergence_retries=1)
        meta = read_metadata(path)
    return {"init": jax.tree.map(lambda a: np.array(a, np.float32), init),
            "result": {k: v for k, v in result.items() if k != "compile_cache"},
            "meta": {k: meta[k] for k in ("epoch", "step")}}


class _RecordingDraws(JaxDraws):
    def __init__(self):
        super().__init__()
        self.folds = []

    def fold_in(self, key, i, device):
        out = super().fold_in(key, i, device)
        self.folds.append((np.asarray(key, np.uint32).tolist(), int(i), out.tolist()))
        return out


def test_divergence_retry_matches_jax(tmp_path, monkeypatch):
    spec = f"nan_loss@step={NAN_STEP}"
    ref = jax_reference([{"runner": "test_torch_resilience:jax_divergence", "conf": NAN_CONF,
                          "seed": 0, "fault": spec, "threefry_partitionable": PARTITIONABLE}],
                        tmp_path)[0]

    def get_model(conf, num_classes, *, device="cuda", seed=0):
        model = WideResNet(10, 1, num_classes)
        model.load_state_dict(flax_to_state_dict(ref["init"], "wideresnet"))
        return model.to(device=device, memory_format=torch.channels_last)

    monkeypatch.setattr(TR, "get_model", get_model)
    draws = _RecordingDraws()
    path = str(tmp_path / "m.msgpack")
    _fault(monkeypatch, spec)
    got = TR.train_and_eval(NAN_CONF, "", save_path=path, evaluation_interval=1, seed=0,
                            device="cpu", device_cache="off", divergence_retries=1,
                            draw_source=draws)
    _unfault(monkeypatch)
    assert got.pop("divergence_retries_used") == 1
    # the retry's key is the JAX key tree's fold_in(PRNGKey(0), 1_000_003)
    want_key = np.asarray(jax.random.fold_in(jax.random.PRNGKey(0), 1_000_003), np.uint32)
    retry = [f for f in draws.folds if f[1] == 1_000_003]
    assert retry and retry[0][0] == [0, 0] and retry[0][2] == want_key.tolist()
    meta = C.read_metadata(path)
    assert {k: meta[k] for k in ("epoch", "step")} == ref["meta"] == {"epoch": 2, "step": 4}
    want = ref["result"]
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "elapsed_sec":
            continue
        if k.startswith("num_") or k == "epoch":
            assert got[k] == v, k
        elif "loss" in k:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4, err_msg=k)
        else:  # accuracies: at most one sample apart
            n = want.get("num_" + k.split("_", 1)[1], 256 * 2)
            assert abs(got[k] - v) <= 1.0 / n + 1e-7, (k, got[k], v)


def test_divergence_without_retries_or_links_raises(tmp_path, monkeypatch):
    _fault(monkeypatch, f"nan_loss@step={NAN_STEP}")
    with pytest.raises(RuntimeError, match="diverged"):
        TR.train_and_eval(NAN_CONF, "", save_path=str(tmp_path / "a.msgpack"),
                          evaluation_interval=1, seed=0, device="cpu")
    _fault(monkeypatch, "nan_loss@step=1")  # epoch 1: no link to roll back to
    with pytest.raises(RuntimeError, match="diverged"):
        TR.train_and_eval(NAN_CONF, "", save_path=str(tmp_path / "b.msgpack"),
                          evaluation_interval=1, seed=0, device="cpu", divergence_retries=1)


def _cli(tmp_path, extra):
    conf = os.path.join(REPO, "confs", "wresnet10x1_shapes.yaml")
    return ["-c", conf, "--save", str(tmp_path / "m.msgpack"), "--device", "cpu",
            "--telemetry", str(tmp_path / "tel")] + extra + ["dataset=synthetic", "epoch=1"]


def test_train_cli_exit_77_on_preemption_and_a_hung_dispatch(tmp_path, monkeypatch):
    _fault(monkeypatch, "sigterm@step=2")
    with pytest.raises(SystemExit) as e:
        TC.main(_cli(tmp_path / "a", []))
    assert e.value.code == R.PREEMPTED_EXIT_CODE
    assert C.read_metadata(str(tmp_path / "a" / "m.msgpack"))["preempted"] is True
    _unfault(monkeypatch)
    _fault(monkeypatch, "hang@step=2")
    with pytest.raises(SystemExit) as e:
        TC.main(_cli(tmp_path / "b", ["--watchdog", "0.5"]))
    assert e.value.code == R.PREEMPTED_EXIT_CODE
    _unfault(monkeypatch)
    T.journal_flush()
    events = [json.loads(ln) for d in ("a", "b") for n in sorted(os.listdir(tmp_path / d / "tel"))
              if n.endswith(".jsonl") for ln in open(tmp_path / d / "tel" / n)]
    T._disable_for_tests()
    fires = [e for e in events if e["type"] == "watchdog_fire"]
    assert len(fires) == 1 and fires[0]["label"] == "train_dispatch"
    assert fires[0]["deadline_sec"] == 0.5
    kinds = sorted(e["kind"] for e in events if e["type"] == "preempt")
    assert kinds == ["dispatch_hung", "preempted"]
