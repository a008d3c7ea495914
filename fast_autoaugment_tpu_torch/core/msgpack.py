"""The msgpack subset that flax ``serialization.to_bytes`` writes.

The JAX package's checkpoints are ``flax.serialization.to_bytes`` of the
train-state pytree (``fast_autoaugment_tpu/core/checkpoint.py:90-146``): one
msgpack map whose array leaves are msgpack extension type 1, the extension
data being itself the msgpack array ``(shape, dtype name, C-order bytes)``
packed with ``use_bin_type=True`` (flax ``_ndarray_to_bytes``).  This module
writes and reads exactly that, without the ``msgpack`` or ``flax``
packages, so that the port's checkpoints are byte-equal to the JAX
package's and each package reads the other's files.

:func:`packb` admits the types flax emits: ``dict`` (str keys, in
insertion order), ``str``, ``bytes``, ``int``, ``float`` (float64),
``None``, ``bool``, ``list``/``tuple`` and numpy arrays (extension type 1;
a numpy scalar is a 0-d array).  Each value takes the smallest msgpack
encoding that holds it, as the reference packer does.  :func:`unpackb`
reads those types back (arrays as read-only numpy views of the payload);
any other msgpack type, or any other extension type, raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

__all__ = ["packb", "unpackb", "NDARRAY_EXT"]

#: flax ``_MsgpackExtType.ndarray``
NDARRAY_EXT = 1


def _len_header(n: int, fix: int | None, fix_max: int, codes: tuple[int, int, int]) -> bytes:
    """The header of a str/bin/array/map of length `n`: the fix form when it
    fits, else the 8-, 16- or 32-bit length forms (``codes``; 0 = absent)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    c8, c16, c32 = codes
    if c8 and n <= 0xFF:
        return struct.pack(">BB", c8, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", c16, n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"msgpack object of length {n} is too large")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                               (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return struct.pack(fmt, code, v)
    else:
        for code, fmt, bottom in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                                  (0xD2, ">Bi", -0x80000000), (0xD3, ">Bq", -0x8000000000000000)):
            if v >= bottom:
                return struct.pack(fmt, code, v)
    raise ValueError(f"integer {v} does not fit in 64 bits")


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack(">Bb", fixed[n], code)
    elif n <= 0xFF:
        head = struct.pack(">BBb", 0xC7, n, code)
    elif n <= 0xFFFF:
        head = struct.pack(">BHb", 0xC8, n, code)
    else:
        head = struct.pack(">BIb", 0xC9, n, code)
    return head + data


def _ndarray(arr: np.ndarray) -> bytes:
    """flax ``_ndarray_to_bytes``: ``packb((shape, dtype name, bytes))``."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"unsupported array dtype {arr.dtype}")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj: Any, out: list[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (np.ndarray, np.generic)):
        out.append(_ext(NDARRAY_EXT, _ndarray(np.asarray(obj))))
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        out.append(_len_header(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw)
    elif type(obj) is bytes:
        out.append(_len_header(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + obj)
    elif type(obj) in (list, tuple):
        out.append(_len_header(len(obj), 0x90, 15, (0, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        out.append(_len_header(len(obj), 0x80, 15, (0, 0xDE, 0xDF)))
        for k, v in obj.items():
            if type(k) is not str:
                raise ValueError(f"map key {k!r} is not a str")
            _pack(k, out)
            _pack(v, out)
    else:
        raise ValueError(f"type {type(obj).__name__} is outside the msgpack subset")


def packb(obj: Any) -> bytes:
    """Encode `obj` (see the module docstring for the admitted types)."""
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack payload")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I"}
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(1 << (b - 0xD4))
        if b not in lengths:
            raise ValueError(f"msgpack type byte 0x{b:02x} is outside the subset")
        n = self.unpack(lengths[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return self.str(n)
        return self.array(n) if b <= 0xDD else self.map(n)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        data = self.take(n)
        if code != NDARRAY_EXT:
            raise ValueError(f"msgpack extension type {code} is outside the subset")
        shape, dtype, raw = unpackb(bytes(data))
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object of the subset; trailing bytes raise."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack object")
    return out
