"""The ImageNet data path on the card: the native loader's decode against a
libjpeg golden, and the host-fed train step replayed as a CUDA graph against
the same step run eagerly.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no JAX, so it runs on a GPU machine that has only the port's
dependencies:

    python -m pytest tests/test_torch_imagenet_card.py -m cuda --noconftest -q

The golden (``tests/data/jpeg_golden/``, read through
``data/jpeg_golden.py``): five small JPEGs and what the libjpeg build of the
native loader makes of them, which ``tests/test_torch_native_loader.py``
holds bitwise against that build on the CPU.  On a machine without libjpeg
the loader decodes with nvJPEG (``csrc/nvjpeg_loader.cpp``); its departure
from libjpeg's decode, nvJPEG's inverse DCT, is the tolerance
``NVJPEG_TOLERANCE``.

The graphed step (``train/steps.py make_graphed_train_step``) is held
bitwise against ``make_train_step`` through ``train_and_eval`` on a JPEG
listing: the same result and the same checkpoint bytes, both under
deterministic cuDNN.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from fast_autoaugment_tpu_torch.data import native_loader
from fast_autoaugment_tpu_torch.data.jpeg_golden import (
    GOLDEN_DIR,
    NVJPEG_TOLERANCE,
    departure,
    golden_arrays,
    golden_paths,
)

pytestmark = pytest.mark.cuda

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphed step and the nvJPEG decode have no CPU "
                    "mode")
    return torch.device("cuda")


def test_native_loader_against_libjpeg_golden(card, tmp_path):
    name = native_loader.backend()
    assert name is not None, "no native loader can be built on this GPU machine"
    lib = native_loader.load(native_loader.build(name, tmp_path))
    got = golden_arrays(lib)
    want = dict(np.load(GOLDEN_DIR / "libjpeg.npz"))
    d = departure(got, want)
    assert d["sizes_equal"] and d["failures"] == 0, d
    for kind, bound in NVJPEG_TOLERANCE.items():
        if name == "libjpeg":
            assert d[kind]["max_abs"] == 0, d
        else:
            assert d[kind]["max_abs"] <= bound["max_abs"], d
            assert d[kind]["mean_abs"] <= bound["mean_abs"], d


def test_native_loader_counts_failures(card, tmp_path):
    lib = native_loader.load(native_loader.build(None, tmp_path))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    paths = [golden_paths()[0], str(bad), str(tmp_path / "missing.jpg")]
    batch, failures = native_loader.decode_resize_batch(paths, 16, lib=lib)
    assert failures == 2
    assert batch[1:].max() == 0 and batch[0].max() > 0


def test_native_loader_raises_when_the_card_fails(card, tmp_path):
    """A failure of the card is no bad file: with the card's memory full,
    the decode of a JPEG that needs more device memory than is left (a
    fresh copy of the library, so no pooled buffer is big enough) raises;
    once the memory is back, the same call decodes."""
    import PIL.Image

    name = native_loader.backend()
    if name != "nvjpeg":
        pytest.skip(f"the {name} build decodes on the host: no device failure to force")
    g = np.random.default_rng(5)
    small = g.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    big = tmp_path / "big.jpg"
    PIL.Image.fromarray(small).resize((4096, 4096), PIL.Image.BICUBIC).save(big, quality=90)
    lib = native_loader.load(native_loader.build(name, tmp_path / "fresh"))
    hold = []
    try:
        for chunk in (2**30, 2**26, 2**22):
            while True:
                try:
                    hold.append(torch.empty(chunk, dtype=torch.uint8, device=card))
                except torch.cuda.OutOfMemoryError:
                    break
        with pytest.raises(RuntimeError, match="failed on the card"):
            native_loader.decode_resize_batch([str(big)], 32, lib=lib, threads=1)
    finally:
        hold.clear()
        torch.cuda.empty_cache()
    batch, failures = native_loader.decode_resize_batch([str(big)], 32, lib=lib, threads=1)
    assert failures == 0 and batch.max() > 0


def write_listing(root: Path, classes: int, per_class: int, val_per_class: int) -> None:
    """A JPEG listing of copies of the golden JPEGs under `root`: ``train/``
    and ``val/`` with one ``n0000000c`` folder a class."""
    src = golden_paths()
    k = 0
    for split, count in (("train", per_class), ("val", val_per_class)):
        for c in range(classes):
            d = root / split / f"n{c:08d}"
            d.mkdir(parents=True)
            for i in range(count):
                shutil.copy(src[k % len(src)], d / f"img{i}.jpg")
                k += 1


def test_graphed_host_fed_train_equals_eager(card, tmp_path):
    from fast_autoaugment_tpu_torch.train import trainer

    write_listing(tmp_path / "data", classes=4, per_class=6, val_per_class=2)
    conf = {"model": {"type": "wresnet10_1"}, "dataset": "imagenet", "imgsize": 32,
            "aug": "fa_reduced_imagenet", "cutout": 0, "batch": 8, "epoch": 2, "lr": 0.01,
            "lr_schedule": {"type": "cosine"},
            "optimizer": {"type": "sgd", "decay": 1e-4, "clip": 5.0, "momentum": 0.9,
                          "nesterov": True}}
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {}
    try:
        for arm, host_step in (("graphed", "graph"), ("eager", "eager")):
            path = tmp_path / arm / "m.msgpack"
            path.parent.mkdir()
            result = trainer.train_and_eval(conf, str(tmp_path / "data"), save_path=str(path),
                                            evaluation_interval=1, device=card,
                                            host_step=host_step)
            out[arm] = (result, path.read_bytes())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    (graphed, g_bytes), (eager, e_bytes) = out["graphed"], out["eager"]
    for r in (graphed, eager):
        assert r["loader"]["failures"] == 0 and r["loader"]["decoder"] in ("libjpeg", "nvjpeg")
        assert r["loader"]["images"] == 2 * (24 + 8)
    drop = ("elapsed_sec", "loader")
    assert {k: v for k, v in graphed.items() if k not in drop} == \
        {k: v for k, v in eager.items() if k not in drop}
    assert g_bytes == e_bytes
