"""The port's checkpoints (``fast_autoaugment_tpu_torch.core.checkpoint``,
``core/msgpack.py``, ``utils/interop.py`` train-state mapping) and the
trainer's save/resume path, against the JAX package, on the CPU.

Oracles and bounds:

- the msgpack codec against the ``msgpack`` package (the one flax uses):
  byte-equal encodings of every admitted type, and the same objects back;
  other types raise;
- a WRN-10-1 train state after two JAX train steps (SGD-nesterov with
  decay and clip; EMA on and off; also RMSprop), saved by
  ``fast_autoaugment_tpu.core.checkpoint.save_checkpoint``: it loads into
  the port's ``TrainState`` with equal tensors (weights, BatchNorm
  statistics, optimizer trace or RMSprop buffers, count, step, EMA
  shadow), and the port saves it back with a byte-equal payload and an
  equal sidecar (``digest``, ``nbytes``, ``epoch``, ``step``, ``metrics``),
  which the JAX ``load_checkpoint`` reads into its template with equal
  arrays;
- the restore chain against the JAX one for the same saves: the same
  files, a corrupt newest link raising ``CheckpointCorruptError`` from
  ``load_checkpoint`` and walked back to ``.prev`` by
  ``load_checkpoint_chain``;
- ``train_and_eval`` with ``save_path``: a run stopped after epoch 1 and
  rerun ends bitwise equal to one uninterrupted run (the port against
  itself on the CPU); a complete checkpoint turns the rerun into an
  evaluation; the scalar logs; the refused records.
"""

import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from fast_autoaugment_tpu.core import checkpoint as JC
from fast_autoaugment_tpu.models import get_model as jax_get_model
from fast_autoaugment_tpu.ops.optim import build_optimizer as jax_build_optimizer
from fast_autoaugment_tpu.train.steps import create_train_state as jax_create_train_state
from fast_autoaugment_tpu.train.steps import make_train_step as jax_make_train_step
from fast_autoaugment_tpu_torch.core import checkpoint as C
from fast_autoaugment_tpu_torch.core import msgpack as M
from fast_autoaugment_tpu_torch.core.resilience import CheckpointCorruptError
from fast_autoaugment_tpu_torch.models import get_model
from fast_autoaugment_tpu_torch.models.resnet import ResNet
from fast_autoaugment_tpu_torch.ops.optim import build_optimizer
from fast_autoaugment_tpu_torch.train import trainer as TR
from fast_autoaugment_tpu_torch.train.steps import create_train_state
from fast_autoaugment_tpu_torch.utils import interop as I

MODEL = {"type": "wresnet10_1", "dataset": "synthetic"}
SGD = {"type": "sgd", "nesterov": True, "decay": 0.0002}
RMSPROP = {"type": "rmsprop", "decay": 1e-5, "clip": 0}
# (name, optimizer conf, ema)
STATES = [("sgd_ema_off", SGD, 0.0), ("sgd_ema_on", SGD, 0.9), ("rmsprop_ema_on", RMSPROP, 0.9)]
META = {"epoch": 3, "step": 2, "metrics": {"epoch": 3.0, "loss_train": 2.25, "top1_valid": 0.125}}


# ------------------------------------------------------------ the codec

ADMITTED = {
    "nil": None, "true": True, "false": False, "fixint": 7, "negfixint": -5,
    "uint8": 200, "uint16": 60_000, "uint32": 4_000_000_000, "uint64": 2**63 + 5,
    "int8": -100, "int16": -30_000, "int32": -2_000_000_000, "int64": -2**40,
    "float": 0.1, "fixstr": "abc", "str8": "x" * 40, "str16": "y" * 300, "bin8": b"\x00\x01",
    "bin16": bytes(range(256)) * 2, "fixarray": [1, "a", None], "array16": list(range(20)),
    "fixmap": {"a": 1, "b": {"c": []}}, "map16": {f"k{i}": i for i in range(20)},
}


def _flax_pack(obj) -> bytes:
    """flax's packer: ``msgpack.packb`` with flax's array extension hook."""
    return msgpack.packb(obj, default=serialization._msgpack_ext_pack, strict_types=True)


@pytest.mark.parametrize("name", sorted(ADMITTED))
def test_msgpack_scalars_and_containers_match_the_msgpack_package(name):
    obj = ADMITTED[name]
    want = msgpack.packb(obj, use_bin_type=True)
    assert M.packb(obj) == want
    back = M.unpackb(want)
    assert back == msgpack.unpackb(want, raw=False) or back == obj


ARRAYS = {
    "f32_0d": np.asarray(3.5, np.float32), "i32_0d": np.asarray(7, np.int32),
    "f32_4d": np.arange(2 * 3 * 3 * 4, dtype=np.float32).reshape(3, 3, 2, 4),
    "u8_2": np.asarray([1, 2], np.uint8),
    "i64_vec": np.arange(5, dtype=np.int64), "f64_empty": np.zeros((0, 3), np.float64),
    "bool": np.asarray([True, False]), "np_scalar_f32": np.float32(1.25),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_msgpack_arrays_match_flax(name):
    """Arrays are extension type 1 with flax's inner encoding, whatever the
    extension's length form (fixext or ext8/16/32); they decode to equal
    arrays of the same dtype and shape."""
    arr = ARRAYS[name]
    tree = {"a": arr, "n": None}
    if isinstance(arr, np.generic):  # flax packs numpy scalars as type 3: the port as 0-d
        got = M.unpackb(M.packb(tree))["a"]
        assert got.shape == () and got.dtype == arr.dtype and got == arr
        return
    want = _flax_pack(tree)
    assert M.packb(tree) == want
    got = M.unpackb(want)["a"]
    flax_back = serialization.msgpack_restore(want)["a"]
    assert got.dtype == flax_back.dtype and got.shape == flax_back.shape
    assert np.array_equal(got, flax_back)


def test_msgpack_every_ext_length_form():
    """Arrays whose inner payload is 1..40 bytes long cover fixext 1/2/4/8/16
    and ext8; a large array covers ext32."""
    for n in range(0, 12):
        arr = np.arange(n, dtype=np.uint8)
        assert M.packb(arr) == _flax_pack(arr), n
        assert np.array_equal(M.unpackb(M.packb(arr)), arr)
    big = np.zeros(70_000, np.float32)
    assert M.packb(big) == _flax_pack(big)


@pytest.mark.parametrize("bad", [{1, 2}, 1 + 2j, object(), {1: "non-str key"}, 2**64, 1.5j,
                                 bytearray(b"x")], ids=lambda v: type(v).__name__)
def test_msgpack_refuses_types_outside_the_subset(bad):
    with pytest.raises(ValueError):
        M.packb({"x": bad})


@pytest.mark.parametrize("raw", [
    msgpack.packb(msgpack.ExtType(2, b"\x00\x01")),  # flax's complex type
    b"\xc1",  # never used
    msgpack.packb(1.5, use_single_float=True) + b"\x00",  # trailing bytes
    b"\x92\x01",  # truncated
], ids=["ext2", "c1", "trailing", "truncated"])
def test_msgpack_refuses_payloads_outside_the_subset(raw):
    with pytest.raises(ValueError):
        M.unpackb(raw)


# ----------------------------------------------------- states, both ways


def _jax_state(opt_conf, ema):
    """A JAX WRN-10-1 train state after two steps, with its template."""
    model = jax_get_model(MODEL, 10)
    opt = jax_build_optimizer(opt_conf, lambda s: 0.05)
    init = jax_create_train_state(model, opt, jax.random.PRNGKey(1), jnp.zeros((2, 32, 32, 3)),
                                  use_ema=ema > 0)
    step = jax_make_train_step(model, opt, num_classes=10, ema_mu=ema, use_policy=False,
                               cutout_length=0)
    g = np.random.default_rng(0)
    state = init
    for i in range(2):
        x = jnp.asarray(g.integers(0, 256, (8, 32, 32, 3)), jnp.uint8)
        y = jnp.asarray(g.integers(0, 10, (8,)), jnp.int32)
        state, _ = step(state, x, y, jnp.zeros((1, 1, 3)), jax.random.PRNGKey(i))
    return state, init


def _port_state(opt_conf, ema):
    model = get_model(MODEL, 10, device="cpu")
    opt = build_optimizer(opt_conf, lambda c: 0.05)
    return create_train_state(model, opt, use_ema=ema > 0), opt


@pytest.fixture(scope="module")
def jax_states():
    return {name: _jax_state(opt, ema) for name, opt, ema in STATES}


@pytest.mark.parametrize("name,opt_conf,ema", STATES, ids=[s[0] for s in STATES])
def test_jax_checkpoint_loads_into_the_port(tmp_path, jax_states, name, opt_conf, ema):
    state, _ = jax_states[name]
    path = str(tmp_path / "jax.msgpack")
    JC.save_checkpoint(path, state, dict(META))
    tree, meta, used = C.load_checkpoint_chain(path)
    assert used == path and meta == JC.read_metadata(path)
    port, opt = _port_state(opt_conf, ema)
    I.load_flax_train_state(tree, port, opt)
    assert port.step == int(state.step) == 2
    layout = I.flax_layout(port.model)
    sd = port.model.state_dict()
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    for k, arr in I.flax_to_tensors(jax.tree.map(np.asarray, variables), layout).items():
        assert torch.equal(sd[k], torch.from_numpy(arr)), k
    names = [n for n, _ in port.model.named_parameters()]
    jopt = state.opt_state
    if opt_conf["type"] == "sgd":
        bufs = {"trace": (port.opt_state.trace, jopt[2].trace)}
        assert port.opt_state.count == int(jopt[3].count) == 2
    else:
        bufs = {"ms": (port.opt_state.ms, jopt[1].ms), "mom": (port.opt_state.mom, jopt[1].mom)}
        assert port.opt_state.count == int(jopt[1].step) == 2
    for what, (got, want) in bufs.items():
        arrs = I.flax_to_tensors({"params": jax.tree.map(np.asarray, want)}, layout, names)
        for n, t in zip(names, got):
            assert torch.equal(t, torch.from_numpy(arrs[n])), (what, n)
    if ema:
        want = I.flax_to_tensors(jax.tree.map(np.asarray, state.ema), layout, list(port.ema))
        assert all(torch.equal(port.ema[k], torch.from_numpy(v)) for k, v in want.items())
    else:
        assert port.ema is None and state.ema is None


@pytest.mark.parametrize("name,opt_conf,ema", STATES, ids=[s[0] for s in STATES])
def test_port_checkpoint_is_the_jax_bytes_and_loads_in_jax(tmp_path, jax_states, name,
                                                           opt_conf, ema):
    state, template = jax_states[name]
    jpath, ppath = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    JC.save_checkpoint(jpath, state, dict(META))
    port, opt = _port_state(opt_conf, ema)
    I.load_flax_train_state(C.load_checkpoint(jpath), port, opt)
    C.save_checkpoint(ppath, I.train_state_to_flax(port, opt), dict(META))
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    assert C.read_metadata(ppath) == JC.read_metadata(jpath)
    for key in ("digest", "nbytes", "epoch", "step", "metrics"):
        assert C.read_metadata(ppath)[key] == JC.read_metadata(jpath)[key]
    back = JC.load_checkpoint(ppath, template)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree.structure(back) == jax.tree.structure(state)


@pytest.mark.parametrize("family", ["wideresnet", "resnet"])
def test_flax_layout_inverts_flax_to_state_dict(family):
    """The way back lands every tensor where the importer found it."""
    if family == "wideresnet":
        jmodel, model = jax_get_model(MODEL, 10), get_model(MODEL, 10, device="cpu")
        size = 32
    else:
        from fast_autoaugment_tpu.models.resnet import ResNet as JaxResNet

        jmodel, model, size = JaxResNet(dataset="imagenet", depth=18, num_classes=10), \
            ResNet("imagenet", 18, 10), 64
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, size, size, 3)), train=False))
    sd = I.flax_to_state_dict(variables, family)
    model.load_state_dict(sd)
    layout = I.flax_layout(model)
    assert set(layout) == {k for k in sd if not k.endswith("num_batches_tracked")}
    tree = I.tensors_to_flax({k: sd[k] for k in layout}, layout)
    assert jax.tree.structure(tree) == jax.tree.structure(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(
            {"params": variables["params"], "batch_stats": variables["batch_stats"]})):
        assert np.array_equal(a, b)


# ------------------------------------------------------------ the chain


def _files(d):
    return sorted(os.listdir(d))


def test_chain_matches_jax_and_walks_back_past_a_corrupt_link(tmp_path):
    """Three saves with keep 3 in both packages give the same files and
    sidecars; a flipped byte in the newest payload raises from
    ``load_checkpoint`` in both and sends both chains to ``.prev``."""
    trees = [{"step": np.asarray(i, np.int32), "w": np.full((3,), i, np.float32)}
             for i in range(3)]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, pdir):
        d.mkdir()
    for i, tree in enumerate(trees):
        JC.save_checkpoint(str(jdir / "c"), tree, {"epoch": i}, keep=3)
        C.save_checkpoint(str(pdir / "c"), tree, {"epoch": i}, keep=3)
    assert _files(jdir) == _files(pdir) == ["c", "c.meta.json", "c.prev", "c.prev.meta.json",
                                            "c.prev2", "c.prev2.meta.json"]
    for name in _files(jdir):
        with open(jdir / name, "rb") as a, open(pdir / name, "rb") as b:
            assert a.read() == b.read(), name
    assert C.chain_paths(str(pdir / "c"), 3) == [str(pdir / n) for n in ("c", "c.prev",
                                                                           "c.prev2")]
    for d in (jdir, pdir):
        raw = bytearray((d / "c").read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        (d / "c").write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptError):
        C.load_checkpoint(str(pdir / "c"))
    with pytest.raises(JC.CheckpointCorruptError):
        JC.load_checkpoint(str(jdir / "c"), trees[0])
    tree, meta, used = C.load_checkpoint_chain(str(pdir / "c"), keep=3)
    jtree, jmeta, jused = JC.load_checkpoint_chain(str(jdir / "c"), trees[0], keep=3)
    assert os.path.basename(used) == os.path.basename(jused) == "c.prev"
    assert meta["epoch"] == jmeta["epoch"] == 1
    assert np.array_equal(tree["w"], jtree["w"])
    # rejected by metadata, torn sidecar, zero-byte payload: skipped alike
    assert C.load_checkpoint_chain(str(pdir / "c"), keep=3,
                                   accept=lambda m: m["epoch"] == 0)[2].endswith("c.prev2")
    (pdir / "c.prev.meta.json").write_text("{torn")
    (jdir / "c.prev.meta.json").write_text("{torn")
    assert C.checkpoint_exists(str(pdir / "c.prev")) == JC.checkpoint_exists(
        str(jdir / "c.prev")) is False
    (pdir / "c.prev2").write_bytes(b"")
    assert not C.checkpoint_exists(str(pdir / "c.prev2"))
    assert C.load_checkpoint_chain(str(pdir / "c"), keep=3) is None
    assert C.read_metadata(str(pdir / "missing")) is None


# ----------------------------------------------------- the trainer path

TRAIN_CONF = {"model": {"type": "wresnet10_1"}, "dataset": "synthetic",
              "aug": "fa_reduced_cifar10", "cutout": 16, "batch": 64, "epoch": 2,
              "lr": 0.1, "lr_schedule": {"type": "cosine", "warmup": {"multiplier": 1,
                                                                       "epoch": 1}},
              "optimizer": {"type": "sgd", "nesterov": True, "decay": 0.0002, "ema": 0.9}}


class _Stop(Exception):
    pass


def _stop_after(epoch):
    def reporter(**kw):
        if kw["epoch"] == epoch:
            raise _Stop
    return reporter


def _run(path, **kw):
    return TR.train_and_eval(TRAIN_CONF, "", test_ratio=0.25, cv_fold=0, save_path=path,
                             evaluation_interval=1, seed=3, device="cpu", **kw)


def _payload(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_train_and_eval_resumes_bitwise_and_flips_to_only_eval(tmp_path):
    """Stopped after epoch 1 and rerun, the run ends bitwise equal to an
    uninterrupted one (the checkpoint's bytes, the result); a rerun of the
    complete run only evaluates; the scalar logs sit beside the checkpoint."""
    whole = str(tmp_path / "whole" / "m.msgpack")
    cut = str(tmp_path / "cut" / "m.msgpack")
    want = _run(whole)
    with pytest.raises(_Stop):
        _run(cut, reporter=_stop_after(1))
    assert C.read_metadata(cut)["epoch"] == 1
    got = _run(cut)
    assert _payload(cut) == _payload(whole)
    meta_w, meta_c = C.read_metadata(whole), C.read_metadata(cut)
    assert meta_c["epoch"] == meta_w["epoch"] == 2 and meta_c["step"] == meta_w["step"] == 12
    assert meta_c["digest"] == meta_w["digest"]
    assert meta_c["metrics"] == meta_w["metrics"]
    for k, v in want.items():
        if k != "elapsed_sec":
            assert got[k] == v, k
    # the chain: the epoch-1 link rotated to .prev
    assert C.read_metadata(cut + ".prev")["epoch"] == 1
    again = _run(cut)  # complete: evaluation only, nothing saved
    assert again["epoch"] == 2 and "loss_train" not in again
    for k in ("top1_valid", "loss_valid", "top1_test", "loss_test", "top1_valid_raw"):
        assert again[k] == want[k], k
    assert _payload(cut) == _payload(whole)
    only = TR.train_and_eval(TRAIN_CONF, "", test_ratio=0.25, save_path=cut, only_eval=True,
                             seed=3, device="cpu")
    assert only["top1_test"] == want["top1_test"]
    for split in ("train", "valid", "test"):
        rows = [json.loads(line) for line in open(f"{whole}_{split}.jsonl")]
        assert {r["step"] for r in rows} == {1, 2}
    rows = [json.loads(line) for line in open(f"{whole}_valid.jsonl")]
    assert {r["tag"] for r in rows} == {"loss", "top1", "top5", "loss_ema", "top1_ema",
                                       "top5_ema", "loss_raw", "top1_raw", "top5_raw"}


def test_train_and_eval_checkpoint_loads_in_jax(tmp_path):
    """The trainer's checkpoint is a JAX train state: the JAX package reads
    it into its own template for the same config."""
    from fast_autoaugment_tpu.ops.schedules import build_schedule

    path = str(tmp_path / "m.msgpack")
    conf = dict(TRAIN_CONF, epoch=1, aug="default")
    TR.train_and_eval(conf, "", test_ratio=0.25, save_path=path, seed=3, device="cpu")
    model = jax_get_model(MODEL, 10)
    opt = jax_build_optimizer(conf["optimizer"], build_schedule(conf, 6))
    template = jax_create_train_state(model, opt, jax.random.PRNGKey(0),
                                      jnp.zeros((2, 32, 32, 3)), use_ema=True)
    state = JC.load_checkpoint(path, template)
    assert int(state.step) == 6 and int(state.opt_state[3].count) == 6
    assert JC.read_metadata(path)["epoch"] == 1


def test_train_and_eval_refuses_records_it_cannot_resume(tmp_path):
    path = str(tmp_path / "m.msgpack")
    with pytest.raises(FileNotFoundError):
        TR.train_and_eval(TRAIN_CONF, "", save_path=path, only_eval=True, device="cpu")
    C.save_checkpoint(path, {"step": np.asarray(0, np.int32)}, {"epoch": 0, "imported_from": 1})
    with pytest.raises(NotImplementedError, match="item 12"):
        TR.train_and_eval(TRAIN_CONF, "", save_path=path, device="cpu")
    # an inconsistent mid-epoch record is not resumed: the chain walks back to
    # an epoch-boundary link (none here), and the run trains from the start
    for mode in ("auto", "off"):
        C.save_checkpoint(path, {"step": np.asarray(0, np.int32)},
                          {"epoch": 0, "in_epoch": {"epoch": 5, "pos": 1}}, keep=1)
        got = TR.train_and_eval(dict(TRAIN_CONF, epoch=1), "", save_path=path, seed=3,
                                device="cpu", device_cache=mode, ckpt_keep=1)
        assert got["epoch"] == 1 and C.read_metadata(path)["step"] == 512 // 64
