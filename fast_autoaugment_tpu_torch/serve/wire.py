"""The raw tensor wire format of the serving path (the port's copy of the
FAAR1 lane of ``fast_autoaugment_tpu/serve/wire.py``).

``FAAR1\\n{"dtype":"float32","shape":[n,H,W,C],"seeds":k}\\n`` then
``n*H*W*C`` elements of ``dtype`` in C order, then (if ``k > 0``) ``k*2``
uint32 key words.  ``k`` is either 0 (the server derives keys) or ``n``
(one ``[2]`` uint32 key per image, the reproducible-serving contract).
Decoding is ``np.frombuffer`` over the request body, a view and not a
copy; the response is assembled into a pooled :class:`BufferArena`
buffer.  The npz lane is handled in ``serve_cli``.
"""

from __future__ import annotations

import json
import threading

import numpy as np

__all__ = ["RAW_MAGIC", "RAW_CONTENT_TYPE", "BufferArena", "encode_raw",
           "encode_raw_into", "decode_raw"]

RAW_MAGIC = b"FAAR1\n"
RAW_CONTENT_TYPE = "application/x-faa-raw"

#: dtypes a peer may name on the wire: a closed set, so a hostile header
#: cannot instantiate arbitrary dtype constructors
_WIRE_DTYPES = {"uint8", "float32", "float64", "uint32", "int32"}


def _check_dtype(name: str) -> np.dtype:
    if name not in _WIRE_DTYPES:
        raise ValueError(f"unsupported wire dtype {name!r} "
                         f"(allowed: {sorted(_WIRE_DTYPES)})")
    return np.dtype(name)


class BufferArena:
    """A pool of reusable ``bytearray`` buffers in power-of-two size
    classes.  ``checkout(n)`` returns a writable buffer of at least ``n``
    bytes (recycled when one is free); ``checkin`` returns it.  A buffer
    must not be used after ``checkin``.  The pool is bounded
    (``max_per_class``) so a burst cannot pin unbounded host memory."""

    def __init__(self, max_per_class: int = 4):
        self._pools: dict[int, list[bytearray]] = {}
        self._lock = threading.Lock()
        self.max_per_class = int(max_per_class)

    @staticmethod
    def _size_class(nbytes: int) -> int:
        return 1 << max(6, int(nbytes - 1).bit_length())

    def checkout(self, nbytes: int) -> bytearray:
        cls = self._size_class(nbytes)
        with self._lock:
            pool = self._pools.get(cls)
            if pool:
                return pool.pop()
        return bytearray(cls)

    def checkin(self, buf: bytearray) -> None:
        with self._lock:
            pool = self._pools.setdefault(len(buf), [])
            if len(pool) < self.max_per_class:
                pool.append(buf)


def _header(dtype: np.dtype, shape, n_seeds: int) -> bytes:
    hdr = {"dtype": dtype.name, "shape": list(shape), "seeds": n_seeds}
    return RAW_MAGIC + json.dumps(hdr, separators=(",", ":")).encode() + b"\n"


def encode_raw(images: np.ndarray, seeds: np.ndarray | None = None) -> bytes:
    """Client-side encode: header + contiguous tensor bytes (+ keys).
    ``seeds`` is ``[n, 2]`` uint32 or None (the server derives keys)."""
    images = np.ascontiguousarray(images)
    if seeds is not None:
        seeds = np.ascontiguousarray(seeds, np.uint32).reshape(-1, 2)
    parts = [_header(images.dtype, images.shape,
                     0 if seeds is None else int(seeds.shape[0])),
             images.tobytes()]
    if seeds is not None:
        parts.append(seeds.tobytes())
    return b"".join(parts)


def encode_raw_into(arena: BufferArena, images: np.ndarray,
                    as_dtype=None) -> tuple[memoryview, bytearray]:
    """Serve-side encode into a pooled arena buffer: returns
    ``(payload_view, lease)``; the caller writes the view to the socket,
    then ``arena.checkin(lease)``.  `as_dtype` fuses a cast into the one
    copy (``np.copyto(..., casting="unsafe")``)."""
    images = np.ascontiguousarray(images)
    dtype = images.dtype if as_dtype is None else np.dtype(as_dtype)
    head = _header(dtype, images.shape, 0)
    total = len(head) + images.size * dtype.itemsize
    lease = arena.checkout(total)
    lease[:len(head)] = head
    dst = np.frombuffer(lease, dtype=dtype, count=images.size,
                        offset=len(head)).reshape(images.shape)
    np.copyto(dst, images, casting="unsafe")
    return memoryview(lease)[:total], lease


def decode_raw(body) -> tuple[np.ndarray, np.ndarray | None]:
    """Decode a raw-format body into ``(images, seeds)``: read-only views
    over ``body``, which the caller keeps alive while they are used."""
    if not bytes(body[:len(RAW_MAGIC)]) == RAW_MAGIC:
        raise ValueError("not a raw tensor payload (bad magic)")
    view = memoryview(body)
    nl = bytes(view[len(RAW_MAGIC):len(RAW_MAGIC) + 256]).find(b"\n")
    if nl < 0:
        raise ValueError("raw header line missing/oversized")
    hdr_end = len(RAW_MAGIC) + nl
    hdr = json.loads(bytes(view[len(RAW_MAGIC):hdr_end]))
    dtype = _check_dtype(hdr["dtype"])
    shape = tuple(int(d) for d in hdr["shape"])
    if len(shape) not in (3, 4) or any(d < 0 for d in shape):
        raise ValueError(f"bad image shape on the wire: {shape}")
    count = int(np.prod(shape, dtype=np.int64))
    off = hdr_end + 1
    need = off + count * dtype.itemsize
    n_seeds = int(hdr.get("seeds", 0))
    if len(view) < need + n_seeds * 2 * 4:
        raise ValueError(f"raw payload truncated: need "
                         f"{need + n_seeds * 8} bytes, got {len(view)}")
    images = np.frombuffer(body, dtype=dtype, count=count,
                           offset=off).reshape(shape)
    seeds = None
    if n_seeds:
        seeds = np.frombuffer(body, dtype=np.uint32, count=n_seeds * 2,
                              offset=need).reshape(n_seeds, 2)
    return images, seeds
