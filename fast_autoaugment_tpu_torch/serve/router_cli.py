"""Serving-plane front door CLI — one address over N policy replicas
(the port's copy of ``fast_autoaugment_tpu/serve/router_cli.py``).

    python -m fast_autoaugment_tpu_torch.serve.router_cli \
        --port-dir /shared/replicas --port 8780

Clients speak the exact ``serve_cli`` protocol to the router; the
router forwards each request to the replica its policy digest
rendezvous-hashes to (``serve/router.py``):

- ``POST /augment`` — proxied to the digest's rendezvous-primary
  in-rotation replica; ``X-FAA-Policy-Digest`` and
  ``X-FAA-Deadline-Ms`` pass through; upstream 429/503 answers mark
  the replica backing off per its ``Retry-After`` and fail over
  (bounded by ``--failover-attempts``); with no replica in rotation
  the router itself answers a structured 503.  ``--batch-window-ms``
  arms pipelined forwarding: concurrent requests for the same replica
  coalesce into one framed ``/augment_batch`` POST per flush
  (serve/wire.py).  Both hops are keep-alive — persistent client
  connections in, a pooled upstream connection per replica out.
- ``POST /augment_batch`` — client-assembled frame payloads pass
  through to the routed replica unchanged.
- ``POST /canary`` — the control plane's canary-split admin
  (``{"digest": D, "replicas": [tags], "every": N}`` arms it,
  ``{"clear": true}`` clears it): canary-digest traffic steers to the
  subset, other-digest traffic away from it, digest-less traffic
  splits 1/N deterministically.
- ``GET /stats`` — router topology: replica census with in/out-of-
  rotation verdicts, affinity hit rate, failover/outcome counters,
  the armed canary split (arm landing counts included).
- ``GET /healthz`` — router liveness (200 while the process runs).
- ``GET /readyz`` — 200 only while >= 1 replica is in rotation.
- ``GET /metrics`` — Prometheus exposition of the process registry
  (``faa_router_*`` families).

SIGTERM exits 0 after stopping the listener (the router holds no
in-flight device work of its own — replicas drain independently).
Replica discovery is continuous: replicas joining the ``--port-dir``
enter rotation after proving ``/readyz``, leaving ones are dropped.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from fast_autoaugment_tpu_torch.serve.router import (
    Router,
    parse_static_replicas,
)
from fast_autoaugment_tpu_torch.serve.serve_cli import (
    DEADLINE_HEADER,
    DEFAULT_MAX_BODY_MB,
    DIGEST_HEADER,
)
from fast_autoaugment_tpu_torch.utils.logging import get_logger

logger = get_logger("faa_torch.router_cli")


def make_router_handler(router: Router,
                        max_body_bytes: int =
                        DEFAULT_MAX_BODY_MB * 1024 * 1024):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive on the client leg too: the router's
        # upstream leg already pools connections (serve/wire.py), so a
        # persistent client sees zero TCP setup on either hop
        protocol_version = "HTTP/1.1"
        timeout = 60  # reap idle keep-alive connections
        # persistent connections leave Linux's initial TCP quickack
        # mode; without TCP_NODELAY the headers/body write pair then
        # hits Nagle + delayed-ACK (~40ms per response)
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            logger.info("http: " + fmt, *args)

        def _send(self, code: int, body: bytes, ctype: str,
                  headers: dict | None = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj,
                       headers: dict | None = None) -> None:
            self._send(code, json.dumps(obj).encode(),
                       "application/json", headers)

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"ok": True})
                return
            if self.path == "/readyz":
                n = len(router.stats()["in_rotation"])
                self._send_json(200 if n else 503,
                                {"ready": n > 0, "in_rotation": n})
                return
            if self.path == "/stats":
                self._send_json(200, router.stats())
                return
            if self.path == "/metrics":
                from fast_autoaugment_tpu_torch.core import telemetry

                self._send(200,
                           telemetry.registry().prometheus_text().encode(),
                           telemetry.PROMETHEUS_CONTENT_TYPE)
                return
            self._send_json(404, {"error": f"unknown path {self.path}",
                                  "type": "unknown_path"})

        def _refuse(self, code: int, obj: dict) -> None:
            """Refuse a request whose body was never read: under
            HTTP/1.1 keep-alive the unread bytes would poison the next
            request on this connection, so the refusal closes it."""
            self.close_connection = True
            self._send_json(code, obj, {"Connection": "close"})

        def _do_canary(self):
            """``POST /canary`` — the control plane's split admin:
            body ``{"digest": D, "replicas": [tags],
            "every": N}`` arms the split, ``{"clear": true}`` clears
            it.  Answers the router's canary stats block."""
            try:
                length = int(self.headers.get("Content-Length", "0") or 0)
            except ValueError:
                self._refuse(400, {"error": "malformed Content-Length",
                                   "type": "bad_request"})
                return
            if length > max_body_bytes:
                # bound admin bodies like data-plane ones: refuse on
                # Content-Length BEFORE buffering anything
                self._refuse(413, {"error": f"canary body of {length} "
                                            "bytes refused",
                                   "type": "body_too_large"})
                return
            try:
                req = json.loads(self.rfile.read(length) or b"{}") \
                    if length > 0 else {}
                if not isinstance(req, dict):
                    raise ValueError("canary body must be a JSON object")
                if req.get("clear"):
                    router.clear_canary()
                else:
                    router.set_canary(str(req["digest"]),
                                      list(req["replicas"]),
                                      every=int(req.get("every", 2)))
            except (KeyError, TypeError, ValueError) as e:
                self._send_json(400, {"error": f"{type(e).__name__}: {e}",
                                      "type": "bad_request"})
                return
            self._send_json(200, {"canary": router.stats()["canary"]})

        def do_POST(self):
            try:
                if self.path == "/canary":
                    self._do_canary()
                    return
                if self.path not in ("/augment", "/augment_batch"):
                    self._send_json(404,
                                    {"error": f"unknown path {self.path}",
                                     "type": "unknown_path"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    self._refuse(400, {"error": "malformed "
                                       "Content-Length",
                                       "type": "bad_request"})
                    return
                if length <= 0 or length > max_body_bytes:
                    self._refuse(
                        413 if length > max_body_bytes else 400,
                        {"error": f"body of {length} bytes refused",
                         "type": ("body_too_large"
                                  if length > max_body_bytes
                                  else "bad_request")})
                    return
                body = self.rfile.read(length)
                fwd_headers = {"Content-Length": str(length)}
                for name in (DEADLINE_HEADER, DIGEST_HEADER,
                             "Content-Type"):
                    val = self.headers.get(name)
                    if val is not None:
                        fwd_headers[name] = val
                digest = self.headers.get(DIGEST_HEADER)
                if self.path == "/augment":
                    # the batched lane when --batch-window-ms armed it,
                    # the direct failover path otherwise
                    status, rheaders, data, routed = \
                        router.forward_augment(body, fwd_headers, digest)
                else:
                    # a client-assembled frame payload passes through
                    status, rheaders, data, routed = router.forward(
                        "POST", self.path, body, fwd_headers, digest)
                out_headers = {}
                for k, v in rheaders.items():
                    if k.lower() in ("retry-after",):
                        out_headers[k] = v
                if routed is not None:
                    out_headers["X-FAA-Routed-To"] = routed
                self._send(status, data,
                           rheaders.get("Content-Type",
                                        "application/octet-stream"),
                           out_headers)
            except Exception as e:  # noqa: BLE001 — never a bare traceback
                logger.error("router handler failed on %s: %s",
                             self.path, e)
                try:
                    self._send_json(500, {"error": f"{type(e).__name__}: "
                                          f"{e}", "type": "internal"})
                except OSError:
                    pass  # client already gone

    return Handler


class _RouterHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # listen backlog: the default of 5 drops the SYNs of a burst of
    # concurrent connects, and each dropped client waits out the 1 s TCP
    # retransmit (measured on the card: a 1.04 s p99 with 16 clients)
    request_queue_size = 1024


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="fast-autoaugment serving-plane router (PyTorch/CUDA replicas)")
    p.add_argument("--port-dir", default=None, metavar="DIR",
                   help="shared replica-discovery dir: serve_cli "
                        "--port-dir records join/leave the rotation "
                        "continuously")
    p.add_argument("--replicas", default=None,
                   help="static host:port,host:port replica list "
                        "(fixed topologies; combines with --port-dir)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8780)
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="write the BOUND port (supports --port 0) to "
                        "PATH — how supervised tests find the router")
    p.add_argument("--poll-interval", type=float, default=0.5,
                   help="seconds between /readyz health-poll rounds")
    p.add_argument("--eject-after", type=int, default=2,
                   help="consecutive failed polls that eject a replica "
                        "from rotation (hysteresis against flapping)")
    p.add_argument("--readmit-after", type=int, default=1,
                   help="consecutive successful polls that re-admit an "
                        "ejected replica")
    p.add_argument("--readyz-timeout", type=float, default=2.0,
                   help="per-probe /readyz timeout in seconds")
    p.add_argument("--upstream-timeout", type=float, default=60.0,
                   help="per-attempt upstream request timeout")
    p.add_argument("--failover-attempts", type=int, default=2,
                   help="extra candidates tried after the rendezvous "
                        "primary on 429/503/transport failure (bounded "
                        "failover); Retry-After answers also put the "
                        "rejecting replica in a routing backoff window")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="pipelined forwarding: concurrent /augment "
                        "requests headed for the same replica coalesce "
                        "for this window into ONE framed /augment_batch "
                        "POST per flush (0 = off, singleton forwarding)")
    p.add_argument("--batch-max", type=int, default=8,
                   help="max sub-requests per batched flush")
    p.add_argument("--max-body-mb", type=int, default=DEFAULT_MAX_BODY_MB)
    p.add_argument("--telemetry", default="off", metavar="{off,DIR}",
                   help="flight-recorder journal dir: rotation events "
                        "(eject/readmit) land here (core/telemetry.py)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from fast_autoaugment_tpu_torch.core.telemetry import configure_telemetry

    configure_telemetry(args.telemetry)
    static = parse_static_replicas(args.replicas) if args.replicas else None
    router = Router(
        port_dir=args.port_dir, static_replicas=static,
        poll_interval_s=args.poll_interval,
        eject_after=args.eject_after,
        readmit_after=args.readmit_after,
        readyz_timeout_s=args.readyz_timeout,
        upstream_timeout_s=args.upstream_timeout,
        failover_attempts=args.failover_attempts,
        batch_window_ms=args.batch_window_ms,
        batch_max=args.batch_max).start()
    httpd = _RouterHTTPServer(
        (args.host, args.port),
        make_router_handler(router,
                            max_body_bytes=args.max_body_mb * 1024 * 1024))
    bound_port = httpd.server_address[1]
    if args.port_file:
        with open(args.port_file, "w") as fh:
            fh.write(str(bound_port))
    logger.info("router listening on http://%s:%d (%d replica(s) known)",
                args.host, bound_port, len(router.stats()["replicas"]))

    def shutdown(signum, frame):
        logger.info("signal %d: stopping router", signum)
        threading.Thread(target=httpd.shutdown, daemon=True,
                         name="router-shutdown").start()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
