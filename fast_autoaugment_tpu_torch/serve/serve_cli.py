"""Policy-serving CLI: turn a found policy into an HTTP augmentation
endpoint on the GPU.

    python -m fast_autoaugment_tpu_torch.serve.serve_cli \\
        --policy fa_reduced_cifar10 --image 32 --port 8765

The counterpart of ``fast_autoaugment_tpu/serve/serve_cli.py``.  Loads the
policy (a ``final_policy.json`` path or a shipped archive name), builds the
CUDA augmentation kernel, and serves:

- ``POST /augment``: the body is an ``.npz`` with ``images`` (``[n, H, W,
  C]`` uint8 or float32) and optionally ``seeds`` (``[n]`` int, pinning
  each image's draws), or the raw tensor format (``application/x-faa-raw``,
  ``serve/wire.py``) with optional ``[n, 2]`` uint32 keys.  An
  ``X-FAA-Deadline-Ms`` header stamps the request's deadline.  The
  response mirrors the request format (npz in -> npz out; raw in -> raw
  uint8 out).  Requests from concurrent clients coalesce into shared
  dispatches (:class:`~fast_autoaugment_tpu_torch.serve.policy_server.
  PolicyServer`).  Errors are structured JSON: 400 (malformed), 413 (body
  too large, refused on Content-Length: the body is never decoded, only
  read and discarded), 429 with
  ``Retry-After`` (queue full), 503 (draining, deadline missed).
- ``GET /stats``: serving accounting plus the kernel's launch count.
- ``GET /healthz``: liveness.  ``GET /readyz``: 200 only while admitting.

SIGTERM (or SIGINT) drains gracefully -- stop admitting, finish queued
requests -- and exits 0.  The server runs on the CUDA device; without a GPU
it exits non-zero unless ``--device cpu`` is given, a path that exists for
tests.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from fast_autoaugment_tpu_torch.core.telemetry import wall
from fast_autoaugment_tpu_torch.utils.logging import get_logger

logger = get_logger("faa_torch.serve_cli")

#: default POST body bound: 64 MiB holds a 128-image float32 batch at
#: 224px with generous npz overhead; bigger bodies answer 413
DEFAULT_MAX_BODY_MB = 64

DEADLINE_HEADER = "X-FAA-Deadline-Ms"

#: a refused body up to this many bytes is read and discarded before the
#: connection closes: closing a socket with unread bytes resets the
#: connection, and a client still sending its body then sees the reset
#: instead of the answer
DRAIN_LIMIT_BYTES = 256 * 1024 * 1024


def build_policy_tensor(spec: str) -> np.ndarray:
    """``--policy`` -> [num_sub, num_op, 3] tensor: a path to a
    ``final_policy.json`` (a list of sub-policies) or an archive name."""
    from fast_autoaugment_tpu_torch.policies.archive import (
        load_policy,
        policy_to_tensor,
    )

    if os.path.exists(spec):
        with open(spec) as fh:
            raw = json.load(fh)
        if not raw:
            raise ValueError(f"{spec} holds an empty policy set")
        subs = [[(str(op), float(p), float(lv)) for op, p, lv in sub] for sub in raw]
        return np.asarray(policy_to_tensor(subs), np.float32)
    return np.asarray(policy_to_tensor(load_policy(spec)), np.float32)


def seed_keys(seeds) -> np.ndarray:
    """Per-image npz seeds -> [n, 2] uint32 keys ``(0, seed & 0x7FFFFFFF)``,
    the words of the JAX package's ``PRNGKey(seed)``."""
    s = np.asarray(seeds, np.int64).reshape(-1) & 0x7FFFFFFF
    return np.stack([np.zeros_like(s), s], axis=1).astype(np.uint32)


def _retry_after(sec: float) -> str:
    return str(max(1, int(sec + 0.999)))  # Retry-After is whole seconds


def make_handler(server, max_body_bytes: int = DEFAULT_MAX_BODY_MB * 1024 * 1024):
    """The request handler bound to one PolicyServer instance."""
    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.serve import wire
    from fast_autoaugment_tpu_torch.serve.policy_server import (
        DeadlineExpiredError,
        ServeError,
        ServerOverloadedError,
        ServerStoppedError,
    )

    arena = wire.BufferArena()
    started_at = wall()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive; every response has a length
        timeout = 60  # reap idle keep-alive connections
        disable_nagle_algorithm = True  # no Nagle + delayed-ACK stall per response

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

        def _send(self, code: int, body, ctype: str, headers: dict | None = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj, headers: dict | None = None) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json", headers)

        def _refuse(self, code: int, err_type: str, msg: str, unread: int = 0) -> None:
            """Refuse and close the connection, since unread bytes would
            poison the next request on it.  The `unread` bytes of the body
            are read and discarded first (up to ``DRAIN_LIMIT_BYTES``), so
            that the client reads the answer rather than a reset."""
            self.close_connection = True
            self._send_json(code, {"error": msg, "type": err_type},
                            {"Connection": "close"})
            remaining = unread if unread <= DRAIN_LIMIT_BYTES else 0
            try:
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 16))
                    if not chunk:
                        break
                    remaining -= len(chunk)
            except OSError:  # the client went away or stalled past the timeout
                pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"ok": True})
            elif self.path == "/readyz":
                ok = server.running and not server.draining
                self._send_json(200 if ok else 503, {
                    "ready": ok, "reason": "ok" if ok else
                    ("draining" if server.draining else "worker not running")})
            elif self.path == "/stats":
                stats = server.stats()
                stats["kernel_launches"] = _kernels.launch_counts()
                stats["started_at"] = started_at
                self._send_json(200, stats)
            else:
                self._send_json(404, {"error": f"unknown path {self.path}",
                                      "type": "unknown_path"})

        def _read_body(self) -> bytes | None:
            """Bounded body read; answers 400/413 itself on refusal."""
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._refuse(400, "bad_request", "malformed Content-Length")
                return None
            if length <= 0:
                self._refuse(400, "bad_request", "empty or missing body")
                return None
            if length > max_body_bytes:
                self._refuse(413, "body_too_large", f"body of {length} bytes "
                             f"exceeds the {max_body_bytes}-byte bound", unread=length)
                return None
            return self.rfile.read(length)

        def _deadline_ms(self) -> float | None:
            raw = self.headers.get(DEADLINE_HEADER)
            if raw is None:
                return None
            try:
                ms = float(raw)
            except ValueError:
                raise ValueError(f"malformed {DEADLINE_HEADER} header {raw!r}")
            if ms <= 0:
                raise ValueError(f"{DEADLINE_HEADER} must be > 0, got {ms}")
            return ms

        def _error_response(self, e: BaseException) -> tuple[int, dict, dict] | None:
            """The typed serving errors as ``(status, body, headers)``;
            None for an exception that is not a serving error."""
            if isinstance(e, TimeoutError):  # before OSError: a subclass
                return 503, {"error": str(e), "type": "timeout"}, {}
            if isinstance(e, ServerOverloadedError):
                return 429, {"error": str(e), "type": "overloaded"}, \
                    {"Retry-After": _retry_after(e.retry_after_s)}
            if isinstance(e, ServerStoppedError):
                return 503, {"error": str(e), "type": "draining"}, {}
            if isinstance(e, DeadlineExpiredError):
                return 503, {"error": str(e), "type": "deadline_expired"}, {}
            if isinstance(e, ServeError):
                return 500, {"error": str(e), "type": "dispatch_error"}, {}
            if isinstance(e, (KeyError, ValueError, OSError)):
                return 400, {"error": f"{type(e).__name__}: {e}", "type": "bad_request"}, {}
            return None

        def _parse_images(self, body, ctype: str):
            """One body -> ``(images, keys, was_raw)``."""
            if ctype == wire.RAW_CONTENT_TYPE or bytes(body[:len(wire.RAW_MAGIC)]) == wire.RAW_MAGIC:
                images, keys = wire.decode_raw(body)
                return (images[None] if images.ndim == 3 else images), keys, True
            payload = np.load(io.BytesIO(body), allow_pickle=False)
            images = np.asarray(payload["images"])
            keys = seed_keys(payload["seeds"]) if "seeds" in payload.files else None
            return (images[None] if images.ndim == 3 else images), keys, False

        def _send_result(self, out: np.ndarray, was_raw: bool) -> None:
            np.clip(out, 0, 255, out=out)
            if was_raw:
                view, lease = wire.encode_raw_into(arena, out, as_dtype=np.uint8)
                try:
                    self._send(200, view, wire.RAW_CONTENT_TYPE)
                finally:
                    arena.checkin(lease)
            else:
                buf = io.BytesIO()
                np.savez(buf, images=out.astype(np.uint8))
                self._send(200, buf.getvalue(), "application/octet-stream")

        def _do_augment(self) -> None:
            body = self._read_body()
            if body is None:
                return
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip().lower()
            try:
                deadline_ms = self._deadline_ms()
                images, keys, was_raw = self._parse_images(body, ctype)
                out = server.result(server.submit(images, keys, deadline_ms=deadline_ms))
            except Exception as e:  # noqa: BLE001 -- mapped to the typed answers
                resp = self._error_response(e)
                if resp is None:
                    raise
                self._send_json(*resp)
                return
            self._send_result(out, was_raw)

        def do_POST(self):
            try:
                if self.path == "/augment":
                    self._do_augment()
                else:
                    self._send_json(404, {"error": f"unknown path {self.path}",
                                          "type": "unknown_path"})
            except Exception as e:  # noqa: BLE001 -- never a bare traceback
                logger.exception("http handler failed on %s", self.path)
                try:
                    self._send_json(500, {"error": f"{type(e).__name__}: {e}",
                                          "type": "internal"})
                except OSError:
                    pass  # the client is gone

    return Handler


class _ServeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True  # handler threads never block exit after shutdown()
    # listen backlog: the default of 5 drops the SYNs of a burst of
    # concurrent connects, and each dropped client waits out the 1 s
    # TCP retransmit (measured: a 1 s p99 with 16 clients)
    request_queue_size = 1024


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="fast-autoaugment policy-serving endpoint (PyTorch/CUDA)")
    p.add_argument("--policy", required=True,
                   help="final_policy.json path or a shipped archive name")
    p.add_argument("--image", type=int, default=32,
                   help="served image resolution (the client resizes)")
    p.add_argument("--shapes", default="1,8,32,128",
                   help="comma-separated padded batch shapes")
    p.add_argument("--dispatch", default="auto", choices=("auto", "exact", "grouped"),
                   help="'exact' = per-image keys; 'grouped' = one key per "
                        "dispatch, one sub-policy per chunk; 'auto' (default) "
                        "= exact for a single-sub policy, grouped otherwise")
    p.add_argument("--groups", type=int, default=8,
                   help="chunk count for grouped dispatch")
    p.add_argument("--max-batch", type=int, default=None,
                   help="coalescer cap (default: the largest shape)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="coalescing window after the first queued request")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the policy runs (default cuda; cpu exists for tests)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="write the bound port (supports --port 0) to PATH")
    p.add_argument("--queue-depth", type=int, default=4096,
                   help="bounded request queue; a full queue answers 429 at once")
    p.add_argument("--default-deadline-ms", type=float, default=None,
                   help=f"deadline for requests without an {DEADLINE_HEADER} "
                        "header; expired requests are shed before dispatch")
    p.add_argument("--max-body-mb", type=int, default=DEFAULT_MAX_BODY_MB,
                   help="POST body bound; larger bodies answer 413")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="seconds the graceful drain waits for queued requests")
    p.add_argument("--serve-seconds", type=float, default=0.0,
                   help="drain and exit 0 after this many seconds (0 = forever)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from fast_autoaugment_tpu_torch.serve.policy_server import (
        PolicyApplier,
        PolicyServer,
    )

    shapes = tuple(int(s) for s in str(args.shapes).split(",") if s)
    try:
        applier = PolicyApplier(
            build_policy_tensor(args.policy), image=args.image, shapes=shapes,
            dispatch=args.dispatch, groups=args.groups, device=args.device)
    except RuntimeError as e:
        print(f"serve_cli: {e}", file=sys.stderr)
        return 2
    server = PolicyServer(
        applier, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth,
        default_deadline_ms=args.default_deadline_ms).start()
    httpd = _ServeHTTPServer(
        (args.host, args.port),
        make_handler(server, max_body_bytes=args.max_body_mb * 1024 * 1024))
    bound_port = httpd.server_address[1]
    if args.port_file:
        tmp = f"{args.port_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(str(bound_port))
        os.replace(tmp, args.port_file)  # a poller never reads a partial port
    logger.info("serving %d sub-policies (dispatch=%s, device=%s) at http://%s:%d",
                applier.num_sub, applier.dispatch, applier.device, args.host, bound_port)

    def drain_and_stop():
        drained = server.drain(timeout=args.drain_timeout)
        logger.info("graceful drain %s", "complete" if drained else "TIMED OUT")
        httpd.shutdown()

    def on_signal(signum, frame):
        logger.info("signal %d: draining and shutting down", signum)
        threading.Thread(target=drain_and_stop, daemon=True, name="serve-drain").start()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    if args.serve_seconds > 0:
        timer = threading.Timer(args.serve_seconds, drain_and_stop)
        timer.daemon = True
        timer.start()
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
