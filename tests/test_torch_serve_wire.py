"""The port's serving wire formats (``fast_autoaugment_tpu_torch/serve/
wire.py``) against the JAX package's (``fast_autoaugment_tpu/serve/
wire.py``): the raw tensor lane, the FAAB1 frames and the shared-memory
request descriptors encode to the same bytes, and each package's decoder
reads the other's output; ``ShmRegion`` round-trips a tensor through a
segment; ``ConnectionPool`` reuses keep-alive connections to a local
server and replays a request on a stale one exactly as the JAX pool does.

Host code only (neither wire module imports JAX): bound is byte equality.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from fast_autoaugment_tpu.serve import wire as jax_wire
from fast_autoaugment_tpu_torch.serve import wire


def _images(shape, dtype, seed=0):
    g = np.random.default_rng(seed)
    return g.integers(0, 256, shape).astype(dtype)


def _keys(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("with_keys", [False, True])
@pytest.mark.parametrize("shape", [(3, 8, 8, 3), (8, 8, 3)])
def test_raw_bytes_equal_and_cross_decode(dtype, with_keys, shape):
    imgs = _images(shape, dtype, seed=len(shape))
    n = shape[0] if len(shape) == 4 else 1
    keys = _keys(n, seed=3) if with_keys else None
    got = wire.encode_raw(imgs, seeds=keys)
    assert got == jax_wire.encode_raw(imgs, seeds=keys)
    for dec in (wire.decode_raw, jax_wire.decode_raw):
        back, k = dec(got)
        assert back.dtype == imgs.dtype and np.array_equal(back, imgs)
        assert (k is None) if keys is None else np.array_equal(k, keys)
    view, lease = wire.encode_raw_into(wire.BufferArena(), imgs.astype(np.float32),
                                       as_dtype=np.uint8)
    jview, _ = jax_wire.encode_raw_into(jax_wire.BufferArena(), imgs.astype(np.float32),
                                        as_dtype=np.uint8)
    assert bytes(view) == bytes(jview)


FRAME_SETS = [
    [],
    [({}, b"")],
    [({"ctype": wire.RAW_CONTENT_TYPE}, wire.encode_raw(_images((2, 4, 4, 3), np.uint8))),
     ({"ctype": "application/octet-stream", "deadline_ms": 50.0, "digest": "abc123abc123"},
      b"npz-bytes"),
     ({"status": 429, "ctype": "application/json", "headers": {"Retry-After": "1"}},
      json.dumps({"error": "full", "type": "overloaded"}).encode())],
    [({"i": i}, bytes(range(i))) for i in range(9)],
]


@pytest.mark.parametrize("parts", FRAME_SETS, ids=lambda p: f"{len(p)}parts")
def test_frames_bytes_equal_and_cross_decode(parts):
    got = wire.encode_frames(parts)
    assert got == jax_wire.encode_frames(parts)
    for enc, dec in ((wire.encode_frames, jax_wire.decode_frames),
                     (jax_wire.encode_frames, wire.decode_frames)):
        back = dec(enc(parts))
        assert [(m, bytes(b)) for m, b in back] == [(m, b) for m, b in parts]


@pytest.mark.parametrize("bad", [b"", b"nope", wire.FRAME_MAGIC + b"{}",
                                 wire.FRAME_MAGIC + b'{"count":2,"lengths":[1],"meta":[{}]}\nx',
                                 wire.FRAME_MAGIC + b'{"count":1,"lengths":[9],"meta":[{}]}\nx'])
def test_frames_refuse_what_the_jax_decoder_refuses(bad):
    errors = []
    for dec in (wire.decode_frames, jax_wire.decode_frames):
        try:
            dec(bad)
            errors.append(None)
        except (ValueError, KeyError) as e:
            errors.append(type(e))
    assert errors[0] is not None and errors[0] == errors[1]


@pytest.mark.parametrize("seeds", [None, np.uint32([[0, 5], [7, 2**31]])])
@pytest.mark.parametrize("dtype,shape", [("float32", (2, 8, 8, 3)), ("uint8", (8, 8, 3))])
def test_shm_request_bytes_equal_and_cross_decode(seeds, dtype, shape):
    got = wire.encode_shm_request("psm_abc", dtype, shape, seeds=seeds)
    assert got == jax_wire.encode_shm_request("psm_abc", dtype, shape, seeds=seeds)
    for dec in (wire.decode_shm_request, jax_wire.decode_shm_request):
        name, dt, sh, k = dec(got)
        assert (name, dt, sh) == ("psm_abc", np.dtype(dtype), shape)
        assert (k is None) if seeds is None else np.array_equal(k, seeds)
    with pytest.raises(ValueError):
        wire.decode_shm_request(wire.encode_shm_request("x", "complex64", shape))


def test_shm_region_round_trip():
    """The client's region: a tensor written in, a request body the JAX
    decoder reads, the replica's in-place uint8 answer read back."""
    imgs = _images((2, 4, 4, 3), np.float32, seed=9)
    region = wire.ShmRegion(imgs.shape, np.float32)
    try:
        region.write(imgs)
        name, dt, shape, keys = jax_wire.decode_shm_request(
            region.request_body(seeds=np.uint32([[0, 1], [0, 2]])))
        assert (name, dt, shape) == (region.name, np.dtype(np.float32), imgs.shape)
        assert keys.tolist() == [[0, 1], [0, 2]]
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(name=name)
        try:
            seen = np.ndarray(shape, dt, buffer=seg.buf)
            assert np.array_equal(seen, imgs)
            answer = (255 - imgs).astype(np.uint8)
            np.copyto(np.ndarray(shape, np.uint8, buffer=seg.buf), answer)
            del seen
        finally:
            seg.close()
        assert np.array_equal(region.read_result(), answer)
    finally:
        region.close()
    region.close()  # idempotent


class _Server:
    """A local keep-alive HTTP/1.1 server that echoes the body and counts
    the connections it accepted."""

    def __init__(self):
        self.connections = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self):
                outer.connections += 1
                super().setup()

            def log_message(self, *a):
                pass

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.port = self.httpd.server_address[1]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


@pytest.mark.parametrize("mod", [wire, jax_wire], ids=["port", "jax"])
def test_connection_pool_reuses_and_replays_a_stale_socket(mod):
    srv = _Server()
    pool = mod.ConnectionPool(timeout_s=10.0)
    try:
        answers = [pool.request("127.0.0.1", srv.port, "POST", "/x", body=b"%d" % i)
                   for i in range(5)]
        assert [(s, b) for s, _, b in answers] == [(200, b"%d" % i) for i in range(5)]
        assert pool.stats() == {"reuses": 4, "opens": 1, "idle": 1}
        assert srv.connections == 1
        # the idle connection goes stale: the pool replays once on a fresh one
        for conn in pool._idle[("127.0.0.1", srv.port)]:
            conn.sock.close()
        status, _, body = pool.request("127.0.0.1", srv.port, "POST", "/x", body=b"again")
        assert (status, body) == (200, b"again")
        assert pool.stats() == {"reuses": 5, "opens": 2, "idle": 1}
    finally:
        pool.close_all()
        srv.close()
    assert pool.stats()["idle"] == 0
