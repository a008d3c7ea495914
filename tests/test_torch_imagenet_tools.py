"""The port's copy of the ImageNet preparation tools
(``data/imagenet_tools.py``) against the JAX package's, on the CPU, on a
fabricated mini ILSVRC2012 tree (``tests/test_imagenet_tools.py``'s
fixtures): the devkit parsers on a ``scipy.io.savemat`` ``meta.mat``, the val
reorganisation, ``write_listfile``, ``extract_tar``'s refusals, ``fetch``
and ``download_and_extract`` over ``file://`` (no network).  Oracle: the
JAX functions on a copy of the same tree; bound: equal results and
byte-equal trees and files.
"""

import hashlib
import io
import os
import shutil
import tarfile

import pytest

from fast_autoaugment_tpu.data import imagenet_tools as JT
from fast_autoaugment_tpu_torch.data import imagenet_tools as IT
from test_imagenet_tools import WNIDS, _write_devkit, _write_flat_val


def _tree(root) -> dict:
    """Every file under `root` by relative path, with its bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _both(tmp_path, make):
    """`make(root)` in two copies of a tree: the port's and the JAX one's."""
    roots = {name: tmp_path / name for name in ("port", "jax")}
    for r in roots.values():
        r.mkdir()
        make(str(r))
    return roots


def test_devkit_parsers_match_jax(tmp_path):
    _write_devkit(str(tmp_path), n_val=9)
    assert IT.parse_meta_mat(str(tmp_path)) == JT.parse_meta_mat(str(tmp_path))
    assert IT.parse_val_groundtruth(str(tmp_path)) == JT.parse_val_groundtruth(str(tmp_path))
    assert IT.parse_devkit(str(tmp_path)) == JT.parse_devkit(str(tmp_path))
    idx_to_wnid, wnid_to_classes = IT.parse_meta_mat(str(tmp_path))
    assert idx_to_wnid == {1: WNIDS[0], 2: WNIDS[1], 3: WNIDS[2]}
    assert wnid_to_classes[WNIDS[0]] == ("tench", "Tinca tinca")


def test_val_reorganisation_and_listfile_match_jax(tmp_path):
    devkit = tmp_path / "devkit"
    gt = _write_devkit(str(devkit), n_val=7)
    roots = _both(tmp_path, lambda r: _write_flat_val(os.path.join(r, "val"), n_val=7))
    moved = {name: (IT if name == "port" else JT).prepare_val_folder(
        str(r / "val"), str(devkit)) for name, r in roots.items()}
    assert moved == {"port": 7, "jax": 7}
    assert _tree(roots["port"]) == _tree(roots["jax"])
    assert sorted(os.listdir(roots["port"] / "val")) == sorted({WNIDS[g - 1] for g in gt})
    assert IT.prepare_val_folder(str(roots["port"] / "val"), str(devkit)) == 0  # idempotent
    # a stray file that is no image is skipped by both listfile writers
    for r in roots.values():
        (r / "val" / WNIDS[0] / "notes.txt").write_text("x")
    n = {name: (IT if name == "port" else JT).write_listfile(str(r / "val"),
                                                              str(r / "val_cls.txt"))
         for name, r in roots.items()}
    assert n == {"port": 7, "jax": 7}
    assert (roots["port"] / "val_cls.txt").read_bytes() == \
        (roots["jax"] / "val_cls.txt").read_bytes()
    first = (roots["port"] / "val_cls.txt").read_text().splitlines()[0]
    assert first.startswith(WNIDS[0] + "/ILSVRC2012_val_") and first.endswith(" 1")
    # a mispaired val folder is refused by both
    for r, mod in ((roots["port"], IT), (roots["jax"], JT)):
        (r / "val" / "ILSVRC2012_val_99999999.JPEG").write_text("stray")
        with pytest.raises(ValueError, match="refusing to mispair"):
            mod.prepare_val_folder(str(r / "val"), str(devkit))


def _tar_with(path, members: dict, links=()):
    with tarfile.open(path, "w") as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        for name, target in links:
            info = tarfile.TarInfo(name)
            info.type = tarfile.SYMTYPE
            info.linkname = target
            tar.addfile(info)


@pytest.mark.parametrize("bad", [{"../escape.txt": b"x"}, {"/abs/escape.txt": b"x"},
                                 "link"])
def test_extract_tar_refuses_what_jax_refuses(tmp_path, bad):
    src = tmp_path / "bad.tar"
    if bad == "link":
        _tar_with(src, {"ok.txt": b"fine"}, links=[("evil", "../../etc/passwd")])
    else:
        _tar_with(src, dict({"ok.txt": b"fine"}, **bad))
    for mod in (IT, JT):
        with pytest.raises(ValueError, match="unsafe"):
            mod.extract_tar(str(src), str(tmp_path / mod.__name__.split(".")[0]))


def test_extract_and_train_folder_match_jax(tmp_path):
    inner = tmp_path / "inner"
    inner.mkdir()
    for wnid in WNIDS[:2]:
        _tar_with(inner / f"{wnid}.tar", {f"{wnid}_{i}.JPEG": bytes([i]) * 9 for i in range(3)})
    outer = tmp_path / "train.tar"
    with tarfile.open(outer, "w") as tar:
        for f in sorted(os.listdir(inner)):
            tar.add(inner / f, arcname=f)
    for mod, name in ((IT, "port"), (JT, "jax")):
        dest = tmp_path / name
        mod.extract_tar(str(outer), str(dest))
        assert mod.prepare_train_folder(str(dest)) == 2
        assert mod.prepare_train_folder(str(dest)) == 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert sorted(_tree(tmp_path / "port")) == sorted(
        os.path.join(w, f"{w}_{i}.JPEG") for w in WNIDS[:2] for i in range(3))


def test_fetch_and_download_over_file_urls_match_jax(tmp_path):
    payload = tmp_path / "src" / "ILSVRC2012_devkit_t12.tar.gz"
    payload.parent.mkdir()
    staging = tmp_path / "staging" / "ILSVRC2012_devkit_t12"
    _write_devkit(str(staging), n_val=3)
    with tarfile.open(payload, "w:gz") as tar:
        tar.add(staging, arcname="ILSVRC2012_devkit_t12")
    md5 = hashlib.md5(payload.read_bytes()).hexdigest()
    url = payload.as_uri()
    assert IT.md5sum(str(payload)) == JT.md5sum(str(payload)) == md5
    assert IT.ARCHIVES == JT.ARCHIVES
    for mod, name in ((IT, "port"), (JT, "jax")):
        root = tmp_path / name
        got = mod.fetch(url, str(root), md5=md5)
        assert got == str(root / payload.name)
        # present with the right checksum: not fetched again
        mtime = os.stat(got).st_mtime_ns
        assert mod.fetch(url, str(root), md5=md5) == got and os.stat(got).st_mtime_ns == mtime
        with pytest.raises(IOError, match="corrupt download"):
            mod.fetch(url, str(root / "again"), md5="0" * 32)
        assert not os.path.exists(root / "again" / (payload.name + ".part"))
        dest = mod.download_and_extract("devkit", str(root / "dl"), url=url, md5=md5)
        assert dest == str(root / "dl" / "ILSVRC2012_devkit_t12")
        assert mod.parse_devkit(dest) == JT.parse_devkit(str(staging))
        with pytest.raises(KeyError, match="unknown split"):
            mod.download_and_extract("test", str(root), url=url)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    shutil.rmtree(tmp_path / "staging")
