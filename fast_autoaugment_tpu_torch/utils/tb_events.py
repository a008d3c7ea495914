"""Dependency-free TensorBoard event-file writer (and reader): the port's
copy of ``fast_autoaugment_tpu/utils/tb_events.py``, byte for byte the
same files.

A ``tfevents`` file is a TFRecord stream of serialized ``Event`` protos,
and the two pieces the scalar use-case needs (varint/fixed-width proto
fields, masked crc32c record framing) are small and stable, so the
format is written directly, without the ``tensorboard`` package:

- record framing: ``uint64 len | uint32 masked_crc(len) | payload |
  uint32 masked_crc(payload)`` with crc32c (Castagnoli) and TF's mask
  ``((c >> 15 | c << 17) + 0xa282ead8)``;
- ``Event`` proto: ``wall_time`` (field 1, double), ``step`` (field 2,
  varint), ``file_version`` (field 3, string, first record only),
  ``summary`` (field 5) holding ``Summary.Value{tag, simple_value}``.

Any TensorBoard >= 1.x loads the output directly (scalars dashboard).
:func:`read_events` parses files back (CRC-verified) for tests and
tooling.  The writers are ``utils/logging.py make_writers(..., tb=True)``
(or ``FAA_TB_EVENTS=1``) and the journal's bridge (``core/telemetry.py``).
"""

from __future__ import annotations

import os
import socket
import struct
import time

__all__ = ["TBEventWriter", "read_events", "crc32c"]

# ---------------------------------------------------------------------------
# crc32c (Castagnoli, reflected 0x82F63B78) — table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ _CRC_TABLE[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal proto encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    # negative ints would need 10-byte two's-complement encoding AND
    # would spin this loop forever (-1 >> 7 == -1); every value we
    # encode (steps, lengths, field keys) is non-negative by contract
    if n < 0:
        raise ValueError(f"varint requires a non-negative int, got {n}")
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _event_bytes(wall_time: float, step: int | None = None,
                 file_version: str | None = None,
                 scalar: tuple[str, float] | None = None) -> bytes:
    ev = bytearray()
    ev += _field(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        ev += _field(2, 0) + _varint(step)
    if file_version is not None:
        raw = file_version.encode()
        ev += _field(3, 2) + _varint(len(raw)) + raw
    if scalar is not None:
        tag, value = scalar
        tag_raw = tag.encode()
        val = (_field(1, 2) + _varint(len(tag_raw)) + tag_raw
               + _field(2, 5) + struct.pack("<f", value))
        summ = _field(1, 2) + _varint(len(val)) + val
        ev += _field(5, 2) + _varint(len(summ)) + summ
    return bytes(ev)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TBEventWriter:
    """Scalar-only TensorBoard event writer.

    Drop-in for :class:`utils.logging.ScalarWriter`'s ``add_scalar``
    interface; one ``events.out.tfevents.<ts>.<host>.<name>`` file per
    writer under ``logdir``."""

    def __init__(self, logdir: str, name: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "host"
        # exclusive create + numbered retry: two writers born in the
        # same second must not append to one file (a second mid-stream
        # file_version record corrupts the stream for TensorBoard)
        base = os.path.join(
            logdir,
            f"events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}"
            f".{name}")
        for attempt in range(1000):
            path = base if attempt == 0 else f"{base}.{attempt}"
            try:
                self._fh = open(path, "xb")
                self._path = path
                break
            except FileExistsError:
                continue
        else:
            raise OSError(f"could not create a unique event file at {base}")
        self._fh.write(_record(_event_bytes(time.time(),
                                            file_version="brain.Event:2")))
        self._fh.flush()

    @property
    def path(self) -> str:
        return self._path

    def add_scalar(self, tag: str, value, step: int):
        # negative steps raise (via _varint): silently clamping would
        # pile mis-stepped scalars onto step 0 and hide the caller bug
        self._fh.write(_record(_event_bytes(
            time.time(), step=int(step), scalar=(tag, float(value)))))
        # records are ~60 bytes against an ~8 KB buffer: without a per-
        # record flush a live TensorBoard sees only the file header
        # until close, and a killed run loses every buffered scalar
        self._fh.flush()

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.close()


# ---------------------------------------------------------------------------
# reader (tests / tooling)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _skip_field(buf: bytes, i: int, wire: int) -> int:
    """Advance past one unknown field of the given wire type."""
    if wire == 0:
        _, i = _read_varint(buf, i)
    elif wire == 1:
        i += 8
    elif wire == 5:
        i += 4
    else:
        ln, i = _read_varint(buf, i)
        i += ln
    return i


def _parse_value(buf: bytes) -> dict:
    out: dict = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if num == 1 and wire == 2:
            ln, i = _read_varint(buf, i)
            out["tag"] = buf[i:i + ln].decode()
            i += ln
        elif num == 2 and wire == 5:
            out["simple_value"] = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        else:
            i = _skip_field(buf, i, wire)
    return out


def read_events(path: str, verify_crc: bool = True) -> list[dict]:
    """Parse a tfevents file back into dicts
    ``{"wall_time", "step"?, "file_version"?, "tag"?, "value"?}``.

    A truncated trailing record (killed writer mid-flush) ends the
    parse gracefully: the complete prefix is returned."""
    events = []
    with open(path, "rb") as fh:
        data = fh.read()
    i = 0
    while i < len(data):
        if i + 12 > len(data):
            break  # truncated header
        header = data[i:i + 8]
        (ln,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
        if i + 16 + ln > len(data):
            break  # truncated payload/footer
        payload = data[i + 12:i + 12 + ln]
        (pcrc,) = struct.unpack("<I", data[i + 12 + ln:i + 16 + ln])
        if verify_crc:
            # explicit raises, not asserts: `python -O` strips asserts,
            # which would silently void the verify_crc=True contract
            if _masked_crc(header) != hcrc:
                raise ValueError(f"header crc mismatch @ {i} in {path}")
            if _masked_crc(payload) != pcrc:
                raise ValueError(f"payload crc mismatch @ {i} in {path}")
        i += 16 + ln

        ev: dict = {}
        j = 0
        while j < len(payload):
            key, j = _read_varint(payload, j)
            num, wire = key >> 3, key & 7
            if num == 1 and wire == 1:
                ev["wall_time"] = struct.unpack("<d", payload[j:j + 8])[0]
                j += 8
            elif num == 2 and wire == 0:
                ev["step"], j = _read_varint(payload, j)
            elif num == 3 and wire == 2:
                ln2, j = _read_varint(payload, j)
                ev["file_version"] = payload[j:j + ln2].decode()
                j += ln2
            elif num == 5 and wire == 2:
                ln2, j = _read_varint(payload, j)
                summ = payload[j:j + ln2]
                j += ln2
                k = 0
                while k < len(summ):
                    skey, k = _read_varint(summ, k)
                    if skey >> 3 == 1 and skey & 7 == 2:
                        vlen, k = _read_varint(summ, k)
                        v = _parse_value(summ[k:k + vlen])
                        k += vlen
                        ev["tag"] = v.get("tag")
                        ev["value"] = v.get("simple_value")
                    else:
                        k = _skip_field(summ, k, skey & 7)
            else:
                j = _skip_field(payload, j, wire)
        events.append(ev)
    return events
