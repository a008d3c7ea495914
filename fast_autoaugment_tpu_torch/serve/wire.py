"""The serving path's wire formats and connection plumbing: the port's
copy of ``fast_autoaugment_tpu/serve/wire.py``, byte for byte the same
formats.

- **raw tensor format** (``FAAR1``): a one-line JSON header
  (dtype/shape, optional per-image keys) followed by the contiguous
  tensor bytes.  Decoding is ``np.frombuffer`` over the request body, a
  *view*, not a copy; encoding assembles header + payload into a pooled
  :class:`BufferArena` buffer.  npz stays the fallback format
  (``serve_cli``).
- **frame format** (``FAAB1``): N (meta, body) parts in one payload, the
  router's batched forwarding unit (one ``/augment_batch`` POST per
  replica flush instead of N singleton POSTs).
- **shared-memory lane**: a same-host client puts the tensor in a
  ``multiprocessing.shared_memory`` segment and POSTs a tiny JSON
  descriptor (``application/x-faa-shm``); the replica maps the segment
  (zero bytes of image data on the socket) and writes the uint8 result
  back in place.  :class:`ShmRegion` is the client's half.
- :class:`ConnectionPool`: keep-alive ``http.client`` connections, one
  pool per (host, port), with a retry-once-on-stale-socket rule that
  never replays a request once a byte of it reached the wire.

Raw format: ``FAAR1\\n{"dtype":"float32","shape":[n,H,W,C],"seeds":k}\\n``
then ``n*H*W*C`` elements of ``dtype`` in C order, then (if ``k > 0``)
``k*2`` uint32 key words.  ``k`` is either 0 (the server derives keys) or
``n`` (one ``[2]`` uint32 key per image, the reproducible-serving
contract).
"""

from __future__ import annotations

import http.client
import json
import socket
import threading

import numpy as np

__all__ = [
    "RAW_MAGIC", "FRAME_MAGIC", "RAW_CONTENT_TYPE", "FRAME_CONTENT_TYPE", "SHM_CONTENT_TYPE",
    "BufferArena", "encode_raw", "encode_raw_into", "decode_raw",
    "encode_frames", "decode_frames", "encode_shm_request",
    "decode_shm_request", "ShmRegion", "ConnectionPool",
]

RAW_MAGIC = b"FAAR1\n"
FRAME_MAGIC = b"FAAB1\n"
RAW_CONTENT_TYPE = "application/x-faa-raw"
FRAME_CONTENT_TYPE = "application/x-faa-frames"
SHM_CONTENT_TYPE = "application/x-faa-shm"

#: dtypes a peer may name on the wire — a closed set, so a hostile
#: header can't instantiate arbitrary dtype constructors
_WIRE_DTYPES = {"uint8", "float32", "float64", "uint32", "int32"}


def _check_dtype(name: str) -> np.dtype:
    if name not in _WIRE_DTYPES:
        raise ValueError(f"unsupported wire dtype {name!r} "
                         f"(allowed: {sorted(_WIRE_DTYPES)})")
    return np.dtype(name)


# --------------------------------------------------------------- arena


class BufferArena:
    """A pool of reusable ``bytearray`` buffers in power-of-two size
    classes.  ``checkout(n)`` returns a writable buffer of at least
    ``n`` bytes (recycled when one is free, fresh otherwise);
    ``checkin`` returns it to the pool.  The serving hot path checks a
    response buffer out, fills it in place (``np.copyto`` into a
    ``np.frombuffer`` view — no intermediate bytes object), writes it
    to the socket and checks it back in: steady-state serialization
    allocates nothing.

    A buffer must not be used after ``checkin`` — views over it alias
    the next checkout.  The pool is bounded (``max_per_class``) so a
    burst can't pin unbounded host memory.
    """

    def __init__(self, max_per_class: int = 4):
        self._pools: dict[int, list[bytearray]] = {}
        self._lock = threading.Lock()
        self.max_per_class = int(max_per_class)
        self._hits = 0
        self._misses = 0

    @staticmethod
    def _size_class(nbytes: int) -> int:
        return 1 << max(6, int(nbytes - 1).bit_length())

    def checkout(self, nbytes: int) -> bytearray:
        cls = self._size_class(nbytes)
        with self._lock:
            pool = self._pools.get(cls)
            if pool:
                self._hits += 1
                return pool.pop()
            self._misses += 1
        return bytearray(cls)

    def checkin(self, buf: bytearray) -> None:
        cls = len(buf)
        with self._lock:
            pool = self._pools.setdefault(cls, [])
            if len(pool) < self.max_per_class:
                pool.append(buf)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "pooled": sum(len(p) for p in self._pools.values())}


# ----------------------------------------------------- raw tensor wire


def _raw_header(images: np.ndarray, seeds: np.ndarray | None) -> bytes:
    hdr = {"dtype": images.dtype.name, "shape": list(images.shape),
           "seeds": 0 if seeds is None else int(seeds.shape[0])}
    return RAW_MAGIC + json.dumps(hdr, separators=(",", ":")).encode() \
        + b"\n"


def encode_raw(images: np.ndarray,
               seeds: np.ndarray | None = None) -> bytes:
    """Client-side encode: header + contiguous tensor bytes (+ seeds).
    ``seeds`` is ``[n, 2]`` uint32 or None (server derives keys)."""
    images = np.ascontiguousarray(images)
    if seeds is not None:
        seeds = np.ascontiguousarray(seeds, np.uint32).reshape(-1, 2)
    parts = [_raw_header(images, seeds), images.tobytes()]
    if seeds is not None:
        parts.append(seeds.tobytes())
    return b"".join(parts)


def encode_raw_into(arena: BufferArena, images: np.ndarray,
                    as_dtype=None) -> tuple[memoryview, bytearray]:
    """Serve-side encode into a pooled arena buffer: returns
    ``(payload_view, lease)``.  The caller writes ``payload_view`` to
    the socket then ``arena.checkin(lease)``.  No intermediate bytes
    object is built — the tensor is copied exactly once, into the
    reusable buffer.  `as_dtype` fuses a cast into that one copy
    (``np.copyto(..., casting="unsafe")``): the serving response path
    emits uint8 straight from the float32 result, no intermediate
    ``astype`` allocation."""
    images = np.ascontiguousarray(images)
    dtype = images.dtype if as_dtype is None else np.dtype(as_dtype)
    hdr = {"dtype": dtype.name, "shape": list(images.shape), "seeds": 0}
    head = RAW_MAGIC + json.dumps(hdr, separators=(",", ":")).encode() \
        + b"\n"
    total = len(head) + images.size * dtype.itemsize
    lease = arena.checkout(total)
    lease[:len(head)] = head
    dst = np.frombuffer(lease, dtype=dtype, count=images.size,
                        offset=len(head)).reshape(images.shape)
    np.copyto(dst, images, casting="unsafe")
    return memoryview(lease)[:total], lease


def decode_raw(body) -> tuple[np.ndarray, np.ndarray | None]:
    """Decode a raw-format request body into ``(images, seeds)``.

    Both arrays are **zero-copy read-only views** over ``body``
    (``np.frombuffer``) — no decode allocation at all.  The caller
    must keep ``body`` alive while the views are in use (the HTTP
    handler holds it for the request's lifetime)."""
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
    seed_bytes = n_seeds * 2 * 4
    if len(view) < need + seed_bytes:
        raise ValueError(
            f"raw payload truncated: need {need + seed_bytes} bytes, "
            f"got {len(view)}")
    images = np.frombuffer(body, dtype=dtype, count=count,
                           offset=off).reshape(shape)
    seeds = None
    if n_seeds:
        seeds = np.frombuffer(body, dtype=np.uint32, count=n_seeds * 2,
                              offset=need).reshape(n_seeds, 2)
    return images, seeds


# ------------------------------------------------------------- frames


def encode_frames(parts: list[tuple[dict, bytes]]) -> bytes:
    """Pack N ``(meta, body)`` parts into one payload — the router's
    batched-forwarding unit.  ``meta`` is a small JSON-safe dict
    (forwarded headers on the request leg; status/content-type on the
    response leg)."""
    metas = [m for m, _ in parts]
    lengths = [len(b) for _, b in parts]
    hdr = {"count": len(parts), "lengths": lengths, "meta": metas}
    out = [FRAME_MAGIC,
           json.dumps(hdr, separators=(",", ":")).encode(), b"\n"]
    out.extend(b for _, b in parts)
    return b"".join(out)


def decode_frames(body) -> list[tuple[dict, memoryview]]:
    """Unpack :func:`encode_frames` — bodies come back as zero-copy
    memoryviews over ``body``."""
    view = memoryview(body)
    if bytes(view[:len(FRAME_MAGIC)]) != FRAME_MAGIC:
        raise ValueError("not a frame payload (bad magic)")
    rest = bytes(view[len(FRAME_MAGIC):])
    nl = rest.find(b"\n")
    if nl < 0:
        raise ValueError("frame header line missing")
    hdr = json.loads(rest[:nl])
    off = len(FRAME_MAGIC) + nl + 1
    out: list[tuple[dict, memoryview]] = []
    lengths = [int(x) for x in hdr["lengths"]]
    metas = hdr["meta"]
    if len(lengths) != int(hdr["count"]) or len(metas) != len(lengths):
        raise ValueError("frame header count/lengths/meta mismatch")
    if off + sum(lengths) > len(view):
        raise ValueError("frame payload truncated")
    for meta, ln in zip(metas, lengths):
        out.append((meta, view[off:off + ln]))
        off += ln
    return out


# -------------------------------------------------- shared-memory lane


def encode_shm_request(name: str, dtype: str, shape,
                       seeds=None) -> bytes:
    """The tiny descriptor body a same-host client POSTs instead of
    the tensor itself: the segment name plus dtype/shape (and optional
    inline seeds — they are small)."""
    req = {"shm": str(name), "dtype": str(dtype),
           "shape": [int(d) for d in shape]}
    if seeds is not None:
        req["seeds"] = np.asarray(seeds, np.uint32).reshape(-1, 2) \
            .tolist()
    return json.dumps(req, separators=(",", ":")).encode()


def decode_shm_request(body) -> tuple[str, np.dtype, tuple,
                                      np.ndarray | None]:
    req = json.loads(bytes(body))
    dtype = _check_dtype(req["dtype"])
    shape = tuple(int(d) for d in req["shape"])
    if len(shape) not in (3, 4) or any(d < 1 for d in shape):
        raise ValueError(f"bad shm image shape: {shape}")
    seeds = req.get("seeds")
    if seeds is not None:
        seeds = np.asarray(seeds, np.uint32).reshape(-1, 2)
    return str(req["shm"]), dtype, shape, seeds


class ShmRegion:
    """Client-side helper for the shared-memory lane: owns one
    ``multiprocessing.shared_memory`` segment sized for the request
    tensor, writes the input in, and reads the uint8 result back out
    of the same region after the replica overwrites it in place.

    The segment is reused across requests (same shape) — a same-host
    client's steady state moves zero image bytes over the socket.
    """

    def __init__(self, shape, dtype=np.float32):
        from multiprocessing import shared_memory

        self.shape = tuple(int(d) for d in shape)
        self.dtype = np.dtype(dtype)
        nbytes = int(np.prod(self.shape, dtype=np.int64)
                     ) * self.dtype.itemsize
        self._seg = shared_memory.SharedMemory(create=True, size=nbytes)
        self.name = self._seg.name

    def write(self, images: np.ndarray) -> None:
        dst = np.ndarray(self.shape, self.dtype, buffer=self._seg.buf)
        np.copyto(dst, images)
        del dst

    def read_result(self) -> np.ndarray:
        """The replica wrote uint8 results over the input region; copy
        them out (the copy detaches the result from the segment so the
        region can be reused/closed)."""
        src = np.ndarray(self.shape, np.uint8, buffer=self._seg.buf)
        out = np.array(src)
        del src
        return out

    def request_body(self, seeds=None) -> bytes:
        return encode_shm_request(self.name, self.dtype.name, self.shape,
                                  seeds=seeds)

    def close(self) -> None:
        try:
            self._seg.close()
            self._seg.unlink()
        except (FileNotFoundError, BufferError):
            pass  # already unlinked / view still live


# --------------------------------------------------- keep-alive pool


class _TrackedConnection(http.client.HTTPConnection):
    """``HTTPConnection`` that counts the bytes actually written to the
    socket during the current request attempt (``bytes_sent``).

    The count is byte-exact even through a mid-write failure: sends go
    through a ``socket.send`` loop (whose partial-write count survives
    the raise) instead of ``sendall`` (which loses it).  The pool's
    stale-keep-alive retry consults the counter — replaying a request
    is safe ONLY while zero bytes of it reached the wire, because the
    server cannot have seen any of it; after the first byte a replay
    risks a double-send of a request the server may already be
    processing.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.bytes_sent = 0

    def send(self, data):
        if self.sock is None:
            if self.auto_open:
                self.connect()
            else:
                raise http.client.NotConnected()
        try:
            view = memoryview(data)
        except TypeError:
            # file-like / str bodies are not byte-exact trackable:
            # mark the attempt dirty up front (a retry after this
            # could double-send), then delegate.  The pool itself
            # only ever passes bytes.
            self.bytes_sent += 1
            return super().send(data)
        with view.cast("B") as flat:
            off, total = 0, len(flat)
            while off < total:
                n = self.sock.send(flat[off:])
                off += n
                self.bytes_sent += n


class ConnectionPool:
    """Keep-alive ``http.client`` connections, pooled per
    ``(host, port)``.

    ``request()`` borrows a pooled connection (opening one only when
    the pool is dry), issues the request, reads the response fully and
    returns the connection for reuse.  A **reused** connection that
    fails BEFORE ANY BYTE of the request reached the wire is retried
    exactly once on a fresh socket — the stale-keep-alive rule (the
    server may have closed an idle connection between our requests),
    narrowed so the retry can never double-send: once even one byte
    was written the server may already be processing the request, so
    the failure propagates instead (partially-written bodies and
    response-stage failures are the caller's to judge).  A fresh
    connection's failure always propagates (a real upstream error).
    Bounded idle connections per key; thread-safe.
    """

    def __init__(self, timeout_s: float = 5.0, max_idle_per_key: int = 4):
        self.timeout_s = float(timeout_s)
        self.max_idle_per_key = int(max_idle_per_key)
        self._idle: dict[tuple[str, int], list] = {}
        self._lock = threading.Lock()
        self._reuses = 0
        self._opens = 0

    def _acquire(self, host: str, port: int):
        key = (host, int(port))
        with self._lock:
            pool = self._idle.get(key)
            if pool:
                self._reuses += 1
                return pool.pop(), True
            self._opens += 1
        conn = _TrackedConnection(host, int(port),
                                  timeout=self.timeout_s)
        conn.connect()
        # persistent connections leave Linux's initial TCP quickack
        # mode, so Nagle + delayed-ACK then stalls every small
        # request/response exchange ~40ms; disable Nagle like every
        # production HTTP client (a fresh one-shot connection never
        # lives long enough to hit this)
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn, False

    def _release(self, host: str, port: int, conn) -> None:
        key = (host, int(port))
        with self._lock:
            pool = self._idle.setdefault(key, [])
            if len(pool) < self.max_idle_per_key:
                pool.append(conn)
                return
        conn.close()

    def request(self, host: str, port: int, method: str, path: str,
                body: bytes = b"", headers: dict | None = None
                ) -> tuple[int, dict, bytes]:
        """One HTTP exchange over a pooled connection: returns
        ``(status, response_headers, payload)``."""
        last_exc: Exception | None = None
        for attempt in (0, 1):
            conn, reused = self._acquire(host, port)
            conn.bytes_sent = 0
            try:
                conn.request(method, path, body=body,
                             headers=dict(headers or {}))
                resp = conn.getresponse()
                payload = resp.read()
                rheaders = dict(resp.getheaders())
                if resp.will_close:
                    conn.close()
                else:
                    self._release(host, port, conn)
                return resp.status, rheaders, payload
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                last_exc = e
                if not reused:
                    raise  # fresh socket: a real upstream failure
                if conn.bytes_sent > 0:
                    # part (or all) of the request reached the wire:
                    # the server may be processing it, so a replay
                    # could double-send — surface the failure instead
                    raise
                # stale keep-alive detected before any byte left the
                # host: safe to replay once on a fresh connection
        raise last_exc  # pragma: no cover — loop always returns/raises

    def stats(self) -> dict:
        with self._lock:
            idle = sum(len(p) for p in self._idle.values())
            return {"reuses": self._reuses, "opens": self._opens,
                    "idle": idle}

    def close_all(self) -> None:
        with self._lock:
            conns = [c for pool in self._idle.values() for c in pool]
            self._idle.clear()
        for c in conns:
            c.close()
