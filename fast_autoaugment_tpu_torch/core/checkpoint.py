"""Checkpoints in the JAX package's format, with their metadata sidecar
(``fast_autoaugment_tpu/core/checkpoint.py``).

The payload is the msgpack that flax ``serialization.to_bytes`` writes for
the JAX train-state pytree (:mod:`fast_autoaugment_tpu_torch.core.msgpack`;
the port's state maps onto that pytree through
:func:`fast_autoaugment_tpu_torch.utils.interop.train_state_to_flax`), and
the metadata is a small JSON sidecar ``path.meta.json``, so progress
polling never reads tensor bytes.  Either package reads the other's files.

Writes are atomic (tmp + rename).  Every save stamps the payload's sha256
``digest`` and its size ``nbytes`` into the sidecar and rotates a bounded
restore chain (``path``, ``path.prev``, ``path.prev2``, ..., depth
``keep``); :func:`load_checkpoint` verifies the digest and raises
:class:`~fast_autoaugment_tpu_torch.core.resilience.CheckpointCorruptError`
on a mismatch, and :func:`load_checkpoint_chain` walks back to the newest
intact link.  As in the JAX module, ``save_checkpoint`` consults the
``FAA_FAULT`` verbs ``torn_ckpt@save=N`` (the N-th save writes half its
payload under the full payload's digest, after rotating the chain: the torn
write of a crash mid-save) and ``corrupt_ckpt@save=N`` (a byte flipped
after the digest), and the saves and the corrupt loads are counted in the
telemetry registry (``faa_checkpoints_saved_total``,
``faa_checkpoints_loaded_total``, ``faa_checkpoints_corrupt_total``) and
journaled.

Here a state is the plain pytree: nested ``dict``s with numpy array
leaves (and ``None``).  :func:`load_checkpoint` returns that tree; the
caller maps it onto its model.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable

from fast_autoaugment_tpu_torch.core import msgpack, telemetry
from fast_autoaugment_tpu_torch.core.resilience import CheckpointCorruptError
from fast_autoaugment_tpu_torch.utils import faultinject
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["save_checkpoint", "load_checkpoint", "load_checkpoint_chain", "read_metadata",
           "checkpoint_exists", "chain_paths", "CheckpointCorruptError", "DEFAULT_KEEP"]

logger = get_logger("faa_torch.checkpoint")

#: default rollback-chain depth (the live file plus one predecessor)
DEFAULT_KEEP = 2


def _meta_path(path: str) -> str:
    return path + ".meta.json"


def chain_paths(path: str, keep: int = DEFAULT_KEEP) -> list[str]:
    """The restore-chain filenames, newest first: ``path``, ``path.prev``,
    ``path.prev2``, ... (``keep`` links in all)."""
    out = [path]
    for i in range(1, max(1, keep)):
        out.append(path + (".prev" if i == 1 else f".prev{i}"))
    return out


def _digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def _rotate_chain(path: str, keep: int) -> None:
    """Shift ``path`` -> ``path.prev`` -> ... before a new save lands; the
    oldest link falls off the end.  A crash between a payload's move and its
    sidecar's leaves a digest mismatch that the chain walk skips."""
    links = chain_paths(path, keep)
    for newer, older in zip(reversed(links[:-1]), reversed(links[1:])):
        for suffix in ("", ".meta.json"):
            src, dst = newer + suffix, older + suffix
            if os.path.exists(src):
                os.replace(src, dst)
            elif os.path.exists(dst):
                os.remove(dst)  # a fresh pair must never sit next to a stale leftover


def save_checkpoint(path: str, state: Any, metadata: dict | None = None,
                    keep: int = DEFAULT_KEEP) -> None:
    """Write `state` (the pytree) to `path` atomically, then the JSON
    `metadata` sidecar stamped with the payload's sha256 ``digest`` and
    ``nbytes``.  ``keep >= 2`` first rotates the existing checkpoint into
    the restore chain; ``keep=1`` overwrites in place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = msgpack.packb(state)
    meta = dict(metadata or {})
    meta["digest"] = _digest(payload)
    meta["nbytes"] = len(payload)
    fi = faultinject.active_plan()
    if fi is not None:
        save_n = fi.next_save()
        if fi.torn_at(save_n):
            # a torn non-atomic write: half the payload under the FULL
            # payload's digest, after the rotation, then the "crash"
            _rotate_chain(path, keep)
            with open(path, "wb") as fh:
                fh.write(payload[: max(1, len(payload) // 2)])
            with open(_meta_path(path), "w") as fh:
                json.dump(meta, fh)
            return
        if fi.corrupt_at(save_n):  # silent bit-rot after the digest
            corrupted = bytearray(payload)
            corrupted[len(corrupted) // 2] ^= 0xFF
            payload = bytes(corrupted)
    if keep >= 2:
        _rotate_chain(path, keep)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(payload)
    os.replace(tmp, path)
    tmp_meta = _meta_path(path) + ".tmp"
    with open(tmp_meta, "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp_meta, _meta_path(path))
    telemetry.registry().counter("faa_checkpoints_saved_total", "checkpoint chain saves").inc()
    telemetry.emit("checkpoint", os.path.basename(path), action="save", nbytes=len(payload),
                   epoch=meta.get("epoch"))


def _verify_payload(path: str, payload: bytes) -> None:
    """Check the payload against its sidecar's ``nbytes`` and ``digest``;
    a sidecar without them (or no sidecar) passes unchecked."""
    meta = read_metadata(path)
    if meta is None:
        return
    nbytes = meta.get("nbytes")
    if nbytes is not None and int(nbytes) != len(payload):
        raise CheckpointCorruptError(
            f"{path}: payload is {len(payload)} bytes, sidecar says {nbytes} (torn write?)")
    digest = meta.get("digest")
    if digest is not None and _digest(payload) != digest:
        raise CheckpointCorruptError(
            f"{path}: payload sha256 {_digest(payload)[:12]}... does not match sidecar "
            f"digest {str(digest)[:12]}...")


def load_checkpoint(path: str, verify: bool = True) -> Any:
    """The pytree stored at `path` (nested dicts with numpy leaves).
    `verify` (default) checks the payload against the sidecar's digest and
    size and raises :class:`CheckpointCorruptError` on a mismatch, as does
    a payload that does not decode."""
    with open(path, "rb") as fh:
        payload = fh.read()
    if verify:
        try:
            _verify_payload(path, payload)
        except CheckpointCorruptError:
            telemetry.registry().counter("faa_checkpoints_corrupt_total",
                                         "checkpoint loads failing digest/size verification").inc()
            telemetry.emit("checkpoint", os.path.basename(path), action="corrupt")
            raise
    telemetry.registry().counter("faa_checkpoints_loaded_total", "checkpoint restores").inc()
    telemetry.emit("checkpoint", os.path.basename(path), action="load", nbytes=len(payload))
    try:
        return msgpack.unpackb(payload)
    except ValueError as e:
        raise CheckpointCorruptError(f"{path}: payload does not decode ({e})") from e


def load_checkpoint_chain(path: str, *, keep: int = DEFAULT_KEEP,
                          accept: Callable[[dict], bool] | None = None
                          ) -> tuple[Any, dict, str] | None:
    """Restore from the newest intact link of `path`'s chain: links that are
    missing, corrupt, unreadable or rejected by `accept` (a predicate on
    their metadata) are skipped with a warning.  Returns ``(state,
    metadata, used_path)``, or None when no link survives."""
    for link in chain_paths(path, keep):
        if not checkpoint_exists(link):
            continue
        meta = read_metadata(link) or {}
        if accept is not None and not accept(meta):
            logger.warning("restore chain: skipping %s (metadata rejected: epoch=%s%s)", link,
                           meta.get("epoch"), ", mid-epoch snapshot" if "in_epoch" in meta else "")
            continue
        try:
            state = load_checkpoint(link)
        except CheckpointCorruptError as e:
            logger.warning("restore chain: skipping CORRUPT link %s (%s)", link, e)
            continue
        except OSError as e:
            logger.warning("restore chain: skipping unreadable link %s (%s)", link, e)
            continue
        if link != path:
            logger.warning("restore chain: recovered from OLDER link %s (epoch %s) - newer "
                           "link(s) were corrupt or rejected", link, meta.get("epoch"))
        return state, meta, link
    return None


def read_metadata(path: str) -> dict | None:
    """The sidecar of `path` without touching tensor bytes, or None when it
    is missing, unreadable or torn."""
    try:
        with open(_meta_path(path)) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def checkpoint_exists(path: str) -> bool:
    """True when `path` holds a non-empty payload with a readable sidecar."""
    try:
        if os.path.getsize(path) == 0:
            return False
    except OSError:
        return False
    return read_metadata(path) is not None
