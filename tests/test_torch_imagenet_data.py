"""The port's ImageNet data path and the SVHN and CIFAR-10.1 readers against
the JAX package, on the CPU.

Oracles and bounds:

- ``load_dataset`` of the JAX package (``data/datasets.py``): for
  ``imagenet`` in both listfile forms (three-token and Kaggle
  ``<wnid>/<stem>``), the ``os.walk`` fallback and the flat-listing
  refusal; ``reduced_imagenet`` on a 50,120-line listfile whose files never
  exist (a lazy listing is never decoded); ``svhn``, ``reduced_svhn`` and
  ``cifar10.1`` on small ``.mat``, pickle and ``.npy`` files: paths, labels,
  ``num_classes`` and ``lazy`` equal, images byte-equal;
- ``random_crop_box`` and ``center_crop_box`` of the JAX package for the same
  ``np.random.Generator`` state: equal boxes and equal generator states after;
- the JAX ``train_batches`` and ``eval_batches`` of a lazy dataset (the
  ``BatchIterator`` box functions of the JAX trainer): byte-equal batches,
  once with the native decoder (the port's libjpeg build against the JAX
  wrapper over the Makefile's build) and once with PIL;
- the JAX search driver's lazy fold stream (``search/driver.py
  _batches_locked``): byte-equal batches;
- JAX ``train_and_eval`` on a tiny JPEG listing (``tests/
  test_imagenet_pipeline.py:75``: WRN-10-1, batch 1, the ImageNet stack with
  ``fa_reduced_imagenet``, here at ``imgsize`` 32; PIL decodes on both sides), from the JAX run's
  initial weights (``utils/interop.py flax_to_state_dict``) and its draws
  (``test_torch_replay.JaxDraws``), in the FMA-free reference process: the
  bounds of ``tests/test_torch_train.py test_train_and_eval_matches_jax``
  (counts exact, losses within 1e-4 relative, accuracies within one
  sample).
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

from fast_autoaugment_tpu.data import datasets as JD
from fast_autoaugment_tpu.data import native_loader as JNL
from fast_autoaugment_tpu.data import pipeline as JP
from fast_autoaugment_tpu.ops import preprocess_imagenet as JPI
from fast_autoaugment_tpu_torch.data import datasets as D
from fast_autoaugment_tpu_torch.data import imagenet_tools as IT
from fast_autoaugment_tpu_torch.data import pipeline as PL
from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as PI
from test_torch_native_loader import jax_native_library
from test_torch_replay import NO_FMA_XLA_FLAGS, JaxDraws

PARTITIONABLE = True
TINY_CONF = {"model": {"type": "wresnet10_1"}, "dataset": "imagenet", "imgsize": 32,
             "aug": "fa_reduced_imagenet", "cutout": 0, "batch": 1, "epoch": 1, "lr": 0.01,
             "lr_schedule": {"type": "cosine"},
             "optimizer": {"type": "sgd", "decay": 1e-4, "clip": 5.0, "momentum": 0.9,
                           "nesterov": True}}


def write_imagenet(root, classes=3, per_class=8, val=4, sizes=((80, 60), (64, 100)),
                   seed=0) -> None:
    """``train/`` and ``val/`` of random-noise JPEGs, one ``n0000000c``
    folder a class (PIL, in the tests only; ``tests/test_imagenet_pipeline.py
    _write_fake_imagenet``)."""
    import PIL.Image

    rng = np.random.default_rng(seed)
    for split, count in (("train", per_class), ("val", val)):
        for c in range(classes):
            cdir = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(cdir, exist_ok=True)
            for i in range(count):
                w, h = sizes[i % len(sizes)]
                arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                PIL.Image.fromarray(arr).save(os.path.join(cdir, f"img{i}.jpg"))


class _Reference:
    """The FMA-free JAX reference process of
    :func:`test_train_and_eval_on_a_jpeg_listing_matches_jax` (as
    ``test_torch_replay.jax_reference`` runs one), started when the module's
    first test starts, so that its compiles run beside the other tests."""

    def __init__(self, tmp):
        import test_torch_replay

        from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor

        self.root = os.path.join(tmp, "data")
        write_imagenet(self.root, classes=2, per_class=4, val=3)
        job = {"runner": "test_torch_imagenet_data:jax_imagenet_train_and_eval",
               "conf": TINY_CONF, "seed": 0, "image": 32, "steps": 8, "dataroot": self.root,
               "policy_shape": policy_to_tensor(load_policy("fa_resnet50_rimagenet")).shape[:2],
               "threefry_partitionable": PARTITIONABLE}
        src, self.dst = os.path.join(tmp, "jobs.pkl"), os.path.join(tmp, "refs.pkl")
        with open(src, "wb") as fh:
            pickle.dump([job], fh)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + NO_FMA_XLA_FLAGS).strip(),
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.proc = subprocess.Popen([sys.executable, test_torch_replay.__file__, src, self.dst],
                                     cwd=repo, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)

    def result(self) -> dict:
        _, err = self.proc.communicate(timeout=300)
        assert self.proc.returncode == 0, err[-4000:]
        with open(self.dst, "rb") as fh:
            return pickle.load(fh)[0]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    ref = _Reference(str(tmp_path_factory.mktemp("reference")))
    try:
        yield ref
    finally:
        ref.close()


def _same(got, want) -> None:
    assert got.lazy == want.lazy and got.num_classes == want.num_classes
    assert got.images.dtype == want.images.dtype and got.labels.dtype == want.labels.dtype
    if got.lazy:
        assert list(got.images) == list(want.images)
    else:
        assert got.images.tobytes() == want.images.tobytes()
    assert got.labels.tobytes() == want.labels.tobytes()


def _both(name, root):
    return D.load_dataset(name, str(root)), JD.load_dataset(name, str(root))


@pytest.mark.parametrize("form", ["walk", "kaggle", "three_token"])
def test_imagenet_listings_match_jax(tmp_path, form):
    write_imagenet(tmp_path, classes=3, per_class=3, val=2)
    if form == "kaggle":  # the port's write_listfile writes what both read
        for split in ("train", "val"):
            IT.write_listfile(str(tmp_path / split), str(tmp_path / f"{split}_cls.txt"))
            # an extensionless stem gets .JPEG: rename the files to match
            for wnid in os.listdir(tmp_path / split):
                for f in os.listdir(tmp_path / split / wnid):
                    os.rename(tmp_path / split / wnid / f,
                              tmp_path / split / wnid / (os.path.splitext(f)[0] + ".JPEG"))
    elif form == "three_token":
        for split in ("train", "val"):
            with open(tmp_path / f"{split}_cls.txt", "w") as fh:
                for i, wnid in enumerate(sorted(os.listdir(tmp_path / split))):
                    for f in sorted(os.listdir(tmp_path / split / wnid)):
                        fh.write(f"{wnid}/{f} {i} {7 * i + 3}\n")
    (got_train, got_val), (want_train, want_val) = _both("imagenet", tmp_path)
    _same(got_train, want_train)
    _same(got_val, want_val)
    assert got_train.lazy and len(got_train) == 9 and got_train.num_classes == 1000
    assert all(os.path.exists(p) for p in got_train.images)


def test_flat_listing_is_refused_as_in_jax(tmp_path):
    (tmp_path / "train").mkdir()
    with open(tmp_path / "train_cls.txt", "w") as fh:
        fh.write("ILSVRC2012_val_00000001 1\nILSVRC2012_val_00000002 2\n")
    with pytest.raises(ValueError, match="lack a '<wnid>/' directory prefix"):
        D.load_dataset("imagenet", str(tmp_path))
    with pytest.raises(ValueError, match="lack a '<wnid>/' directory prefix"):
        JD.load_dataset("imagenet", str(tmp_path))


def test_reduced_imagenet_on_a_listing_that_is_never_decoded(tmp_path):
    g = np.random.default_rng(4)
    # 100 classes: 60 of IDX120 and 40 outside it; the files never exist
    classes = np.array(D.IDX120[:60] + [c for c in range(1000) if c not in D.IDX120][:40])
    train_labels = classes[g.integers(0, len(classes), 50_120)]
    with open(tmp_path / "train_cls.txt", "w") as fh:
        fh.writelines(f"n{lb:08d}/img{i}.JPEG {i + 1} {lb}\n"
                      for i, lb in enumerate(train_labels))
    with open(tmp_path / "val_cls.txt", "w") as fh:
        fh.writelines(f"n{lb:08d}/val{i}.JPEG {i + 1} {lb}\n"
                      for i, lb in enumerate(classes[g.integers(0, len(classes), 500)]))
    (got_train, got_val), (want_train, want_val) = _both("reduced_imagenet", tmp_path)
    _same(got_train, want_train)
    _same(got_val, want_val)
    assert got_train.num_classes == 120 and got_train.labels.max() < 60
    assert not any(os.path.exists(p) for p in got_train.images[:100])


def _write_svhn(root, n_train=73_257, n_extra=50, n_test=30):
    import scipy.io

    g = np.random.default_rng(5)
    for split, n in (("train", n_train), ("extra", n_extra), ("test", n_test)):
        # 2x2 images keep the files small; the readers take any image size
        scipy.io.savemat(os.path.join(root, f"{split}_32x32.mat"), {
            "X": g.integers(0, 256, (2, 2, 3, n), dtype=np.uint8),
            "y": g.integers(1, 11, (n, 1)).astype(np.uint8)})


@pytest.mark.parametrize("name", ["svhn", "reduced_svhn"])
def test_svhn_readers_match_jax(tmp_path, name):
    _write_svhn(tmp_path)
    (got_train, got_test), (want_train, want_test) = _both(name, tmp_path)
    _same(got_train, want_train)
    _same(got_test, want_test)
    assert got_train.labels.min() == 0 and got_train.labels.max() == 9  # 10 -> 0
    assert len(got_train) == (1000 if name == "reduced_svhn" else 73_307)


def test_cifar10_1_matches_jax(tmp_path):
    g = np.random.default_rng(6)
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as fh:
            pickle.dump({b"data": g.integers(0, 256, (20, 3072), dtype=np.uint8),
                         b"labels": g.integers(0, 10, 20).tolist()}, fh)
    np.save(tmp_path / "cifar10.1_v6_data.npy", g.integers(0, 256, (40, 32, 32, 3),
                                                           dtype=np.uint8))
    np.save(tmp_path / "cifar10.1_v6_labels.npy", g.integers(0, 10, 40).astype(np.int64))
    (got_train, got_test), (want_train, want_test) = _both("cifar10.1", tmp_path)
    _same(got_train, want_train)
    _same(got_test, want_test)
    assert len(got_train) == 100 and len(got_test) == 40


def test_crop_boxes_match_jax_bitwise():
    sizes = np.random.default_rng(7)
    for seed in range(400):
        w, h = int(sizes.integers(8, 1400)), int(sizes.integers(8, 1400))
        imgsize = int(sizes.choice([32, 224, 240, 320, 600]))
        rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            got = PI.random_crop_box(rp, w, h, imgsize)
            want = JPI.random_crop_box(rj, w, h, imgsize)
            assert got == want and [type(v) for v in got] == [type(v) for v in want]
        assert rp.bit_generator.state == rj.bit_generator.state
        assert PI.center_crop_box(w, h, imgsize) == JPI.center_crop_box(w, h, imgsize)


@pytest.fixture(scope="module")
def jax_native_so(tmp_path_factory):
    return jax_native_library(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture()
def jax_native(jax_native_so):
    """The JAX wrapper over the Makefile's build of ``native/faa_loader.cpp``
    in a temporary directory."""
    saved = JNL._SO_PATH, JNL._lib
    JNL._SO_PATH, JNL._lib = jax_native_so, None
    try:
        yield
    finally:
        JNL._SO_PATH, JNL._lib = saved


def _iterators(train, image):
    """The trainer's lazy iterators in both packages: ``random_crop_box``
    for training, ``center_crop_box`` for evaluation."""
    kw = dict(train_box_fn=lambda rng, w, h: PI.random_crop_box(rng, w, h, image),
              eval_box_fn=lambda rng, w, h: PI.center_crop_box(w, h, image), imgsize=image)
    jkw = dict(train_box_fn=lambda rng, w, h: JPI.random_crop_box(rng, w, h, image),
               eval_box_fn=lambda rng, w, h: JPI.center_crop_box(w, h, image), imgsize=image)
    idx = np.arange(len(train))[::-1][:10]
    return kw, JP.BatchIterator(train, idx, **jkw), idx


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_lazy_batches_match_jax(tmp_path, jax_native, monkeypatch, decoder):
    write_imagenet(tmp_path / "data", classes=3, per_class=4, val=1,
                   sizes=((80, 60), (64, 100), (300, 200)))
    train, _ = D.load_dataset("imagenet", str(tmp_path / "data"))
    kw, jit, idx = _iterators(train, 32)
    if decoder == "pil":
        monkeypatch.setattr(JNL, "available", lambda: False)
    stats = PL.DecodeStats()
    it = PL.BatchIterator(train, idx, decoder=decoder, stats=stats, **kw)
    for epoch in (1, 2):
        got = list(it.train_epoch(4, epoch, seed=3))
        want = list(jit.train_epoch(4, epoch, seed=3))
        assert len(got) == len(want) == 2
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == np.uint8 and gx.shape == (4, 32, 32, 3)
            assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()
    got = list(it.eval_epoch(4, pad_multiple=4))
    want = list(jit.eval_epoch(4, pad_multiple=4))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.tobytes() == b.tobytes()
    snap = stats.snapshot()
    assert snap["decoder"] == ("libjpeg" if decoder == "native" else "pil")
    assert snap["images"] == 2 * 8 + 12 and snap["failures"] == 0


def test_lazy_decode_failures_are_zero_filled_and_counted(tmp_path):
    write_imagenet(tmp_path / "data", classes=2, per_class=2, val=1)
    train, _ = D.load_dataset("imagenet", str(tmp_path / "data"))
    stats = PL.DecodeStats()
    it = PL.BatchIterator(train, None, eval_box_fn=lambda rng, w, h: (0, 0, w, h),
                          imgsize=16, decoder="native", stats=stats)
    for p in train.images:
        it.size_cache.get(p)
    with open(train.images[1], "wb") as fh:  # replaced after it was listed and sized
        fh.write(b"not a jpeg any more")
    (x, _, _), = list(it.eval_epoch(4))
    assert stats.snapshot()["failures"] == 1 and x[1].max() == 0 and x[0].max() > 0


def test_search_fold_stream_matches_jax(tmp_path, jax_native):
    from fast_autoaugment_tpu.parallel.mesh import make_mesh
    from fast_autoaugment_tpu.search.driver import _FoldEval as JaxFoldEval
    from fast_autoaugment_tpu_torch.search.driver import _FoldStream

    write_imagenet(tmp_path / "data", classes=3, per_class=5, val=1)
    train, _ = D.load_dataset("imagenet", str(tmp_path / "data"))
    batch, image, ratio = 4, 24, 0.4
    jfe = JaxFoldEval.__new__(JaxFoldEval)  # the stream alone: no model is built
    jfe.total_train, _ = JD.load_dataset("imagenet", str(tmp_path / "data"))
    jfe.conf, jfe.cv_ratio, jfe.image, jfe.mesh = {"batch": batch}, ratio, image, \
        make_mesh(jax.devices()[:1])
    jfe._box_fn = lambda rng, w, h: JPI.random_crop_box(rng, w, h, image)
    jfe._batches = {}
    _, valid_idx = D.cv_split(train.labels, ratio, 1)
    stream = _FoldStream(train, valid_idx, batch, image, torch.device("cpu"))
    want = [{k: np.asarray(v) for k, v in b.items()} for b in jfe._batches_locked(1)()]
    for _ in range(2):  # every pass decodes the same crops
        got = [{k: v.numpy() for k, v in b.items()} for b in stream]
        assert len(got) == len(want) == len(stream) == 2
        for g, w in zip(got, want):
            assert g["x"].tobytes() == w["x"].tobytes()
            np.testing.assert_array_equal(g["y"], w["y"])
            np.testing.assert_array_equal(g["m"], w["m"])
            assert g["x"].shape == (batch, image, image, 3)


# ----------------------------------------------------- train_and_eval vs JAX


def jax_imagenet_train_and_eval(job):
    """Reference runner: JAX ``train_and_eval`` of :data:`TINY_CONF` on the
    job's listing, one device, host-fed, PIL decoding; its initial
    variables; and the ImageNet stack's draws of every step by key."""
    from fast_autoaugment_tpu.data import native_loader
    from fast_autoaugment_tpu.models import get_model
    from fast_autoaugment_tpu.parallel.mesh import make_mesh
    from fast_autoaugment_tpu.train.trainer import train_and_eval
    from test_torch_replay import jax_imagenet_draws
    from test_torch_train import _numpy

    native_loader._SO_PATH, native_loader._lib = "/nonexistent/libfaa_loader.so", None
    conf, seed, image = job["conf"], job["seed"], job["image"]
    model = get_model(dict(conf["model"], dataset=conf["dataset"]), 1000)
    rng = jax.random.PRNGKey(seed)
    init = model.init({"params": rng, "shake": jax.random.fold_in(rng, 1)},
                      jnp.zeros((2, image, image, 3)), train=False)
    policy = np.asarray(job["policy_shape"])
    key = jax.random.PRNGKey(seed)
    table = {}
    for s in range(job["steps"]):
        key_aug = jax.random.split(jax.random.fold_in(key, s))[0]
        k = tuple(int(v) for v in np.asarray(key_aug, np.uint32))
        table[k] = jax_imagenet_draws(np.asarray(key_aug), conf["batch"], tuple(policy),
                                      image, image)
    result = train_and_eval(conf, job["dataroot"], evaluation_interval=1,
                            mesh=make_mesh(jax.devices()[:1]), seed=seed, device_cache="off")
    return {"init": _numpy(init), "table": table,
            "result": {k: v for k, v in result.items() if k != "compile_cache"}}


def test_train_and_eval_on_a_jpeg_listing_matches_jax(reference, monkeypatch):
    from fast_autoaugment_tpu_torch.models.wideresnet import WideResNet
    from fast_autoaugment_tpu_torch.train import trainer as TR
    from fast_autoaugment_tpu_torch.utils.interop import flax_to_state_dict

    root = reference.root
    ref = reference.result()

    def get_model(conf, num_classes, *, device="cuda", seed=0):
        model = WideResNet(10, 1, num_classes)
        model.load_state_dict(flax_to_state_dict(ref["init"], "wideresnet"))
        return model.to(device=device, memory_format=torch.channels_last)

    monkeypatch.setattr(TR, "get_model", get_model)
    monkeypatch.setenv("FAA_NATIVE_LOADER", "0")  # PIL, as in the reference
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = TR.train_and_eval(TINY_CONF, str(root), evaluation_interval=1, seed=0,
                                device="cpu", draw_source=JaxDraws(ref["table"]))
    finally:
        torch.set_num_threads(threads)
    want = ref["result"]
    loader = got.pop("loader")
    assert (loader["decoder"], loader["images"], loader["failures"]) == ("pil", 8 + 6, 0)
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "elapsed_sec":
            continue
        if k.startswith("num_") or k == "epoch":
            assert got[k] == v, k
        elif "loss" in k:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4, err_msg=k)
        else:  # accuracies: at most one sample apart
            n = want.get("num_" + k.split("_", 1)[1], 8)
            assert abs(got[k] - v) <= 1.0 / n + 1e-7, (k, got[k], v)
