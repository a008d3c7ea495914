"""ImageNet preparation (``fast_autoaugment_tpu/data/imagenet_tools.py``,
copied: the port imports nothing of the JAX package): devkit parsing, val
reorganization, listfile generation, and the tar fetch/verify/extract
pipeline.

As the reference prepares ImageNet (``imagenet.py:164-245``): parse the
ILSVRC2012 devkit's ``meta.mat`` for the synset table, read the val
ground-truth index list, move the flat ``val/`` download into per-wnid class
folders, fetch an archive with its md5 checked (plain ``urllib``, so
``file://`` URLs work), extract tars safely (absolute paths, parent
traversal, unsafe links and special members are refused) and expand the
train split's per-class inner tars.  :func:`write_listfile` writes the
Kaggle CLS-LOC listing that ``data/datasets.py`` reads
(``<wnid>/<stem> <1-based index>``, extension stripped), so that loading a
split skips the ``os.walk``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tarfile

__all__ = [
    "ARCHIVES",
    "parse_meta_mat",
    "parse_val_groundtruth",
    "parse_devkit",
    "prepare_val_folder",
    "write_listfile",
    "md5sum",
    "fetch",
    "extract_tar",
    "prepare_train_folder",
    "download_and_extract",
]

IMG_EXTENSIONS = (".jpeg", ".jpg", ".png", ".bmp", ".webp")

# The ILSVRC2012 release artifacts: public URLs + published md5s
# (the reference's ARCHIVE_DICT, ``imagenet.py:6-19`` — a fixed data
# table, reproduced as data).
ARCHIVES: dict[str, dict[str, str]] = {
    "train": {
        "url": "http://www.image-net.org/challenges/LSVRC/2012/nnoupb/ILSVRC2012_img_train.tar",
        "md5": "1d675b47d978889d74fa0da5fadfb00e",
    },
    "val": {
        "url": "http://www.image-net.org/challenges/LSVRC/2012/nnoupb/ILSVRC2012_img_val.tar",
        "md5": "29b22e2961454d5413ddabcf34fc5622",
    },
    "devkit": {
        "url": "http://www.image-net.org/challenges/LSVRC/2012/nnoupb/ILSVRC2012_devkit_t12.tar.gz",
        "md5": "fa75699e90414af021442c21a62c3abf",
    },
}


def md5sum(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as fh:
        while block := fh.read(chunk):
            h.update(block)
    return h.hexdigest()


def fetch(url: str, dest_dir: str, *, filename: str | None = None,
          md5: str | None = None) -> str:
    """Integrity-gated fetch: skip the transfer when the target file
    already exists with the right checksum, verify after download, fail
    loudly on mismatch (reference ``imagenet.py:186-190`` via
    torchvision's ``download_url``/``check_integrity``).  Plain urllib —
    ``file://`` URLs work, which is how the zero-egress tests drive it.
    """
    import urllib.request

    os.makedirs(dest_dir, exist_ok=True)
    filename = filename or os.path.basename(url)
    target = os.path.join(dest_dir, filename)
    if os.path.exists(target) and (md5 is None or md5sum(target) == md5):
        return target
    # download to a .part temp and rename only after the checksum
    # passes: a download interrupted mid-transfer can never leave a
    # truncated file at `target` that a later md5=None call silently
    # accepts (ADVICE r3)
    part = target + ".part"
    urllib.request.urlretrieve(url, part)
    if md5 is not None and (got := md5sum(part)) != md5:
        os.remove(part)
        raise IOError(f"{target}: md5 {got} != expected {md5} — corrupt download")
    os.replace(part, target)
    return target


def extract_tar(src: str, dest: str | None = None, *, gzip: bool | None = None,
                delete: bool = False) -> str:
    """Safe tar extraction (reference ``imagenet.py:164-177``): refuses
    absolute paths / parent traversal in member names (the reference's
    bare ``extractall`` trusts the archive)."""
    dest = dest or os.path.dirname(src)
    if gzip is None:
        gzip = src.lower().endswith(".gz")
    os.makedirs(dest, exist_ok=True)
    with tarfile.open(src, "r:gz" if gzip else "r") as tar:
        members = tar.getmembers()
        for member in members:
            name = member.name
            if os.path.isabs(name) or ".." in name.split("/"):
                raise ValueError(f"{src}: unsafe member path {name!r}")
            if member.issym() or member.islnk():
                link = member.linkname
                if os.path.isabs(link) or ".." in link.split("/"):
                    raise ValueError(
                        f"{src}: unsafe link member {name!r} -> {link!r}"
                    )
            # filter='data' also rejects special members (FIFOs, device
            # nodes) and strips setuid/setgid bits; mirror both on the
            # pre-3.12 fallback path (ADVICE r3)
            if not (member.isfile() or member.isdir()
                    or member.issym() or member.islnk()):
                raise ValueError(f"{src}: special member {name!r} refused")
            member.mode &= 0o777  # drop setuid/setgid/sticky
        try:
            tar.extractall(dest, filter="data")  # py>=3.12 semantics
        except TypeError:  # older tarfile without the filter kwarg;
            tar.extractall(dest, members=members)  # checks above apply
    if delete:
        os.remove(src)
    return dest


def prepare_train_folder(folder: str) -> int:
    """Expand the train split's per-class inner tars
    (``n01440764.tar`` -> ``n01440764/``; reference
    ``imagenet.py:224-226``); returns #archives expanded.  Idempotent:
    already-expanded trees have no loose .tar files left."""
    n = 0
    for name in sorted(os.listdir(folder)):
        if not name.endswith(".tar"):
            continue
        src = os.path.join(folder, name)
        extract_tar(src, os.path.join(folder, os.path.splitext(name)[0]),
                    gzip=False, delete=True)
        n += 1
    return n


def download_and_extract(split: str, root: str, *,
                         url: str | None = None, md5: str | None = None) -> str:
    """Fetch + verify + extract one ILSVRC2012 archive into
    ``<root>/<split>`` and post-process it (train: inner per-class tars;
    val: left flat for :func:`prepare_val_folder`; devkit: extracted
    in-place).  `url`/`md5` override the table for mirrors and tests.
    Returns the extraction directory (reference ``imagenet.py:101-131``).
    """
    if split not in ARCHIVES:
        raise KeyError(f"unknown split {split!r}: {sorted(ARCHIVES)}")
    spec = ARCHIVES[split]
    url = url or spec["url"]
    md5 = spec["md5"] if md5 is None else (md5 or None)
    archive = fetch(url, root, md5=md5)
    if split == "devkit":
        extract_tar(archive, root)
        return os.path.join(root, "ILSVRC2012_devkit_t12")
    dest = os.path.join(root, split)
    extract_tar(archive, dest)
    if split == "train":
        prepare_train_folder(dest)
    return dest


def parse_meta_mat(devkit_root: str):
    """Parse ``<devkit>/data/meta.mat`` -> (idx_to_wnid, wnid_to_classes).

    Keeps only LEAF synsets (``num_children == 0``) — the 1000
    classification classes; internal WordNet nodes are dropped
    (reference ``imagenet.py:201-214``).  Class names are tuples of the
    comma-separated "words" field.
    """
    import scipy.io as sio

    meta = sio.loadmat(
        os.path.join(devkit_root, "data", "meta.mat"), squeeze_me=True
    )["synsets"]
    leaves = meta[meta["num_children"] == 0]
    idx_to_wnid = {}
    wnid_to_classes = {}
    for rec in leaves:
        idx = int(rec["ILSVRC2012_ID"])
        wnid = str(rec["WNID"])
        classes = tuple(str(rec["words"]).split(", "))
        idx_to_wnid[idx] = wnid
        wnid_to_classes[wnid] = classes
    return idx_to_wnid, wnid_to_classes


def parse_val_groundtruth(devkit_root: str) -> list[int]:
    """``ILSVRC2012_validation_ground_truth.txt`` -> 1-based synset ids,
    one per val image in sorted-filename order (reference
    ``imagenet.py:217-221``)."""
    path = os.path.join(
        devkit_root, "data", "ILSVRC2012_validation_ground_truth.txt"
    )
    with open(path) as fh:
        return [int(line) for line in fh if line.strip()]


def parse_devkit(devkit_root: str):
    """-> (wnid_to_classes, val_wnids): per-val-image wnid labels in
    sorted-filename order (reference ``imagenet.py:194-198``)."""
    idx_to_wnid, wnid_to_classes = parse_meta_mat(devkit_root)
    val_wnids = [idx_to_wnid[idx] for idx in parse_val_groundtruth(devkit_root)]
    return wnid_to_classes, val_wnids


def prepare_val_folder(val_dir: str, devkit_root: str) -> int:
    """Move the flat ``val/`` images into per-wnid class folders
    (reference ``imagenet.py:233-240``); returns #images moved.

    Sorted filename order pairs image i with ground-truth line i.
    Idempotent: already-organized trees (no loose files) are a no-op.
    """
    _, val_wnids = parse_devkit(devkit_root)
    img_files = sorted(
        f for f in os.listdir(val_dir)
        if os.path.isfile(os.path.join(val_dir, f))
    )
    if not img_files:
        return 0
    if len(img_files) != len(val_wnids):
        raise ValueError(
            f"{len(img_files)} loose val images but {len(val_wnids)} "
            "ground-truth labels — refusing to mispair"
        )
    for wnid in set(val_wnids):
        os.makedirs(os.path.join(val_dir, wnid), exist_ok=True)
    for wnid, name in zip(val_wnids, img_files):
        shutil.move(os.path.join(val_dir, name), os.path.join(val_dir, wnid, name))
    return len(img_files)


def write_listfile(split_dir: str, out_path: str) -> int:
    """Generate a CLS-LOC-format listfile for an ImageFolder tree:
    ``<wnid>/<stem> <1-based index>`` per image, classes and files in
    sorted order (the format reference ``imagenet.py:60-88`` consumes to
    skip its os.walk).  Returns #lines written."""
    wnids = sorted(
        d for d in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, d))
    )
    n = 0
    with open(out_path, "w") as fh:
        for wnid in wnids:
            for name in sorted(os.listdir(os.path.join(split_dir, wnid))):
                stem, ext = os.path.splitext(name)
                if ext.lower() not in IMG_EXTENSIONS:
                    continue
                n += 1
                fh.write(f"{wnid}/{stem} {n}\n")
    return n
