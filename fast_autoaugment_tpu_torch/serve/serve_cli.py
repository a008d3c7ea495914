"""Policy-serving CLI: turn a found policy into an HTTP augmentation
endpoint on the GPU.

    python -m fast_autoaugment_tpu_torch.serve.serve_cli \\
        --policy fa_reduced_cifar10 --image 32 --port 8765

The counterpart of ``fast_autoaugment_tpu/serve/serve_cli.py``, with the
same flags and defaults, plus ``--device``.  Loads the policy (a
``final_policy.json`` path or a shipped archive name), builds the CUDA
augmentation kernel, captures one CUDA graph per padded shape
(``serve/policy_server.py``; with ``--compile-cache`` a restarted server
loads the kernel library from the cache instead of running ``nvcc``),
and serves:

- ``POST /augment``: the body is an ``.npz`` with ``images`` (``[n, H, W,
  C]`` uint8 or float32) and optionally ``seeds`` (``[n]`` int, pinning
  each image's draws), or the raw tensor format (``application/x-faa-raw``,
  ``serve/wire.py``) with optional ``[n, 2]`` uint32 keys, or (with
  ``--shm-ingest``) a same-host shared-memory descriptor
  (``application/x-faa-shm``: the replica maps the client's segment and
  writes the uint8 result back over it).  An ``X-FAA-Deadline-Ms`` header
  stamps the request's deadline; ``X-FAA-Policy-Digest`` selects a
  resident tenant policy.  The response mirrors the request format (npz
  in -> npz out; raw in -> raw uint8 out) and names the policy that
  served it in its own ``X-FAA-Policy-Digest`` header.  Requests from concurrent
  clients coalesce into shared dispatches.  Errors are structured JSON:
  400 (malformed), 413 (body too large, refused on Content-Length: the
  body is never decoded, only read and discarded), 429 with
  ``Retry-After`` (queue full), 503 (breaker open, draining, deadline
  missed, cold tenant, all handler slots busy).
- ``POST /augment_batch``: N framed sub-requests in one body
  (``application/x-faa-frames``), the router's batched forwarding unit.
  All sub-requests are submitted before any result is awaited, so they
  coalesce; per-part status and body come back in response frames.
- ``POST /reload``: hot policy reload; the body is optional JSON
  ``{"policy": PATH}`` (default: the ``--policy`` the server started
  with, re-read).  The new policy's graphs are captured off to the side
  and the applier swaps in between dispatches: no dropped request, no
  half-policy batch.  SIGHUP triggers the same reload.
- ``POST /tenants/warm``: multi-policy tenancy (``--tenant-capacity``):
  body ``{"policy": PATH}`` builds the policy's applier off to the side
  and admits it as a resident tenant.  A request for a cold digest
  answers 503 ``tenant_cold`` and, when ``--policy-dir`` holds its
  recipe, starts a background warm.
- ``GET /stats``: serving accounting plus the kernel's launch count, the
  graph captures and the compile-cache stamp.
- ``GET /metrics``: Prometheus text of the process's telemetry registry
  (the ``faa_serve_*`` families the autoscaler scrapes).
- ``GET /healthz``: liveness.  ``GET /readyz``: 200 only while admitting
  with the breaker closed.

SIGTERM (or SIGINT) drains gracefully -- stop admitting, finish queued
requests -- and exits 0.  With ``--telemetry`` the replica journals its
last word as it exits: a ``mark`` with ``event="serve_exit"``, its device
and its kernel launch counters.  ``--breaker-exit`` turns an open breaker into
exit 77 ("restart me", ``core/resilience.py``).  ``--port-dir`` writes the
replica's discovery record for the router (``serve/router.py``) and
removes it on exit; ``--heartbeat-dir`` writes host beats.  The server
runs on the CUDA device; without a GPU it exits non-zero unless
``--device cpu`` is given, a path that exists for tests.
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

from fast_autoaugment_tpu_torch.core import fsfault
from fast_autoaugment_tpu_torch.core.resilience import PREEMPTED_EXIT_CODE, CircuitOpenError
from fast_autoaugment_tpu_torch.core.telemetry import mono, wall
from fast_autoaugment_tpu_torch.utils.logging import get_logger

logger = get_logger("faa_torch.serve_cli")

#: default POST body bound: 64 MiB holds a 128-image float32 batch at
#: 224px with generous npz overhead; bigger bodies answer 413
DEFAULT_MAX_BODY_MB = 64

DEADLINE_HEADER = "X-FAA-Deadline-Ms"

#: selects the TENANT policy a request is served by; absent = the
#: replica's default policy
DIGEST_HEADER = "X-FAA-Policy-Digest"

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


def load_policy_provenance(spec: str) -> dict | None:
    """The provenance sidecar for a policy file, or None.

    ``<stem>.provenance.json`` next to ``<stem>.json`` (the control
    plane's re-search writes it; ``control/research.py`` owns the schema
    and the path rule); archive names and policies without a sidecar
    have none, and an unreadable sidecar reads as None (serving never
    fails on provenance bookkeeping)."""
    if not spec or not str(spec).endswith(".json") or not os.path.exists(spec):
        return None
    from fast_autoaugment_tpu_torch.control.research import load_provenance

    return load_provenance(spec)


def seed_keys(seeds) -> np.ndarray:
    """Per-image npz seeds -> [n, 2] uint32 keys ``(0, seed & 0x7FFFFFFF)``,
    the words of the JAX package's ``PRNGKey(seed)``."""
    s = np.asarray(seeds, np.int64).reshape(-1) & 0x7FFFFFFF
    return np.stack([np.zeros_like(s), s], axis=1).astype(np.uint32)


def _retry_after(sec: float) -> str:
    return str(max(1, int(sec + 0.999)))  # Retry-After is whole seconds


class ServeState:
    """The mutable serving-process state the handler, the signal handlers
    and the supervision threads share: the live server, the reload
    recipe, the tenancy recipes, the shutdown path and the exit code."""

    def __init__(self, server, policy_spec: str, build_applier=None,
                 policy_dir: str | None = None):
        self.server = server
        self.policy_spec = policy_spec
        self.build_applier = build_applier  # policy tensor -> applier
        self.provenance = load_policy_provenance(policy_spec)
        self.httpd = None
        self.exit_code = 0
        self.stop_event = threading.Event()
        self.reload_lock = threading.Lock()
        self.started_at = wall()
        self.policy_dir = policy_dir
        self.tenant_warm_lock = threading.Lock()
        self.warming: set[str] = set()
        self._digest_cache: dict[str, tuple[float, str]] = {}

    def ready(self) -> tuple[bool, str]:
        srv = self.server
        if not srv.running:
            return False, "worker not running"
        if srv.draining:
            return False, "draining"
        if srv.breaker.is_open():
            return False, "circuit breaker open"
        return True, "ok"

    def reload_policy(self, spec: str | None = None) -> dict:
        """Build a fresh applier (capturing every shape's graph OFF TO THE
        SIDE while live traffic keeps dispatching on the old one) and swap
        it in.  Serialized: a concurrent reload gets a loud error."""
        if self.build_applier is None:
            raise RuntimeError("reload not configured on this server")
        if not self.reload_lock.acquire(blocking=False):
            raise BlockingIOError("a reload is already in progress")
        try:
            spec = spec or self.policy_spec
            t0 = mono()
            applier = self.build_applier(build_policy_tensor(spec))
            info = self.server.swap_applier(applier)
            self.provenance = load_policy_provenance(spec)
            info.update(policy=spec, provenance=self.provenance,
                        warm_sec=round(mono() - t0, 3))
            logger.info("reload complete: %s", info)
            return info
        finally:
            self.reload_lock.release()

    def tenant_recipe(self, digest: str) -> str | None:
        """Resolve a cold digest to a policy file under ``--policy-dir``:
        ``<digest>.json`` directly, else any ``*.json`` whose tensor digest
        matches (an mtime-cached scan)."""
        if not self.policy_dir:
            return None
        direct = os.path.join(self.policy_dir, f"{digest}.json")
        if os.path.exists(direct):
            return direct
        from fast_autoaugment_tpu_torch.serve.policy_server import policy_digest

        try:
            names = sorted(fsfault.listdir(self.policy_dir))
        except OSError:
            return None
        for name in names:
            if not name.endswith(".json") or name.endswith(".provenance.json"):
                continue
            path = os.path.join(self.policy_dir, name)
            try:
                mtime = os.path.getmtime(path)
                cached = self._digest_cache.get(path)
                if cached is None or cached[0] != mtime:
                    cached = (mtime, policy_digest(build_policy_tensor(path)))
                    self._digest_cache[path] = cached
                if cached[1] == digest:
                    return path
            except (OSError, ValueError, KeyError) as e:
                logger.warning("policy-dir scan skipped %s: %s", path, e)
        return None

    def warm_tenant(self, spec: str) -> dict:
        """Build an applier for `spec` OFF TO THE SIDE (its graphs captured
        while warm tenants keep dispatching) and admit it into the LRU."""
        if self.build_applier is None:
            raise RuntimeError("tenancy warm not configured")
        t0 = mono()
        applier = self.build_applier(build_policy_tensor(spec))
        info = self.server.warm_tenant(applier)
        info.update(policy=spec, warm_sec=round(mono() - t0, 3))
        logger.info("tenant warm complete: %s", info)
        return info

    def kick_background_warm(self, digest: str) -> bool:
        """Single-flight background warm for a cold digest with a known
        recipe.  True when a warm is running or was just started."""
        if not getattr(self.server, "tenancy_enabled", False):
            return False
        with self.tenant_warm_lock:
            if digest in self.warming:
                return True
            spec = self.tenant_recipe(digest)
            if spec is None:
                return False
            self.warming.add(digest)

        def _go():
            try:
                self.warm_tenant(spec)
            except (ValueError, OSError, RuntimeError, KeyError) as e:
                logger.error("background tenant warm %s failed: %s", digest, e)
            finally:
                with self.tenant_warm_lock:
                    self.warming.discard(digest)

        threading.Thread(target=_go, daemon=True, name=f"tenant-warm-{digest}").start()
        return True

    def initiate_shutdown(self, *, drain: bool, exit_code: int = 0,
                          drain_timeout: float = 30.0) -> None:
        """Run the shutdown sequence in a daemon thread: optionally drain,
        then stop the HTTP loop."""
        self.exit_code = exit_code
        self.stop_event.set()

        def _go():
            if drain:
                drained = self.server.drain(timeout=drain_timeout)
                logger.info("graceful drain %s", "complete" if drained else "TIMED OUT")
            else:
                self.server.stop(timeout=5.0)
            if self.httpd is not None:
                self.httpd.shutdown()

        threading.Thread(target=_go, daemon=True, name="serve-shutdown").start()


def make_handler(server, max_body_bytes: int = DEFAULT_MAX_BODY_MB * 1024 * 1024,
                 state: ServeState | None = None, max_inflight: int = 0,
                 shm_ingest: bool = False):
    """The request handler bound to one PolicyServer instance.

    `state` arms ``/readyz``'s breaker view, ``/reload`` and
    ``/tenants/warm``; without it those two answer a structured 503.
    `max_inflight` > 0 bounds concurrent ``/augment`` handler threads (a
    burst beyond it answers 503 at once).  `shm_ingest` turns on the
    same-host shared-memory lane."""
    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.serve import wire
    from fast_autoaugment_tpu_torch.serve.policy_server import (
        DeadlineExpiredError,
        ServeError,
        ServerOverloadedError,
        ServerStoppedError,
        TenantNotResidentError,
        warmup_launches,
    )

    arena = wire.BufferArena()
    started_at = wall()
    inflight = threading.BoundedSemaphore(max_inflight) if max_inflight > 0 else None

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

        def _send_error_json(self, code: int, err_type: str, msg: str) -> None:
            self._send_json(code, {"error": msg, "type": err_type})

        def _refuse(self, code: int, err_type: str, msg: str, unread: int = 0,
                    retry_after_s: float | None = None) -> None:
            """Refuse and close the connection, since unread bytes would
            poison the next request on it.  The `unread` bytes of the body
            are read and discarded first (up to ``DRAIN_LIMIT_BYTES``), so
            that the client reads the answer rather than a reset."""
            self.close_connection = True
            headers = {"Connection": "close"}
            if retry_after_s is not None:
                headers["Retry-After"] = _retry_after(retry_after_s)
            self._send_json(code, {"error": msg, "type": err_type}, headers)
            remaining = unread if unread <= DRAIN_LIMIT_BYTES else 0
            try:
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 16))
                    if not chunk:
                        break
                    remaining -= len(chunk)
            except OSError:  # the client went away or stalled past the timeout
                pass

        # ------------------------------------------------------- GETs

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"ok": True})
            elif self.path == "/readyz":
                if state is not None:
                    ok, reason = state.ready()
                else:
                    ok = server.running and not server.draining
                    reason = "ok" if ok else ("draining" if server.draining
                                              else "worker not running")
                self._send_json(200 if ok else 503, {"ready": ok, "reason": reason})
            elif self.path == "/stats":
                from fast_autoaugment_tpu_torch.core.compilecache import compile_cache_stats

                stats = server.stats()
                stats["kernel_launches"] = _kernels.launch_counts()
                stats["kernel_launches_warmup"] = warmup_launches()
                stats["graph_capture"] = {str(s): r for s, r in getattr(
                    server.applier, "compile_log", {}).items()}
                stats["compile_cache"] = compile_cache_stats()
                stats["policy_provenance"] = state.provenance if state is not None else None
                stats["started_at"] = started_at
                self._send_json(200, stats)
            elif self.path == "/metrics":
                from fast_autoaugment_tpu_torch.core import telemetry

                self._send(200, telemetry.registry().prometheus_text().encode(),
                           telemetry.PROMETHEUS_CONTENT_TYPE)
            else:
                self._send_error_json(404, "unknown_path", f"unknown path {self.path}")

        # ------------------------------------------------------ POSTs

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

        def _read_json_body(self) -> tuple[bool, dict]:
            """An optional small JSON body (``/reload``, ``/tenants/warm``):
            ``(ok, obj)``; answers itself when not ok."""
            try:
                length = int(self.headers.get("Content-Length", "0") or 0)
            except ValueError:
                self._refuse(400, "bad_request", "malformed Content-Length")
                return False, {}
            if length <= 0:
                return True, {}
            if length > max_body_bytes:
                self._refuse(413, "body_too_large", "body too large", unread=length)
                return False, {}
            try:
                obj = json.loads(self.rfile.read(length) or b"{}")
            except ValueError:
                obj = None
            if not isinstance(obj, dict):
                self._send_error_json(400, "bad_request",
                                      'body must be JSON {"policy": PATH}')
                return False, {}
            return True, obj

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
            if isinstance(e, TenantNotResidentError):
                warming = (state.kick_background_warm(e.digest)
                           if state is not None and e.digest else False)
                return 503, {"error": str(e), "type": "tenant_cold", "digest": e.digest,
                             "resident": list(e.resident), "warming": warming}, \
                    ({"Retry-After": "1"} if warming else {})
            if isinstance(e, ServerOverloadedError):
                return 429, {"error": str(e), "type": "overloaded"}, \
                    {"Retry-After": _retry_after(e.retry_after_s)}
            if isinstance(e, CircuitOpenError):
                return 503, {"error": str(e), "type": "breaker_open"}, \
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

        def _encode_result(self, out: np.ndarray, was_raw: bool) -> tuple[bytes, str]:
            np.clip(out, 0, 255, out=out)
            if was_raw:
                return wire.encode_raw(out.astype(np.uint8)), wire.RAW_CONTENT_TYPE
            buf = io.BytesIO()
            np.savez(buf, images=out.astype(np.uint8))
            return buf.getvalue(), "application/octet-stream"

        def _send_result(self, out: np.ndarray, was_raw: bool, served: str | None) -> None:
            t0 = mono()
            headers = {DIGEST_HEADER: served} if served else None
            if was_raw:
                np.clip(out, 0, 255, out=out)
                view, lease = wire.encode_raw_into(arena, out, as_dtype=np.uint8)
                try:
                    self._send(200, view, wire.RAW_CONTENT_TYPE, headers)
                finally:
                    arena.checkin(lease)
            else:
                body, ctype = self._encode_result(out, False)
                self._send(200, body, ctype, headers)
            server.observe_stage("serialize", mono() - t0)

        def _send_mapped(self, e: BaseException) -> None:
            resp = self._error_response(e)
            if resp is None:
                raise e
            self._send_json(*resp)

        def _do_augment(self) -> None:
            if inflight is not None and not inflight.acquire(blocking=False):
                self._refuse(503, "handler_overloaded", "all handler slots busy: retry",
                             unread=int(self.headers.get("Content-Length", "0") or 0),
                             retry_after_s=0.1)
                return
            try:
                body = self._read_body()
                if body is None:
                    return
                ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip().lower()
                if ctype == wire.SHM_CONTENT_TYPE:
                    self._do_augment_shm(body)
                    return
                try:
                    deadline_ms = self._deadline_ms()
                    t0 = mono()
                    images, keys, was_raw = self._parse_images(body, ctype)
                    server.observe_stage("decode", mono() - t0)
                    pending = server.submit(images, keys, deadline_ms=deadline_ms,
                                            digest=self.headers.get(DIGEST_HEADER))
                    out = server.result(pending)
                except Exception as e:  # noqa: BLE001 -- mapped to the typed answers
                    self._send_mapped(e)
                    return
                self._send_result(out, was_raw, pending.served)
            finally:
                if inflight is not None:
                    inflight.release()

        def _do_augment_shm(self, body: bytes) -> None:
            """The same-host shared-memory lane: the body is a JSON
            descriptor naming a client-created segment; the uint8 result is
            written back over the segment and the answer echoes the
            descriptor."""
            from multiprocessing import shared_memory

            if not shm_ingest:
                self._send_error_json(403, "shm_disabled",
                                      "shared-memory ingestion requires --shm-ingest")
                return
            seg = None
            pending = None
            images = None
            try:
                try:
                    name, dtype, shape, keys = wire.decode_shm_request(body)
                    t0 = mono()
                    seg = shared_memory.SharedMemory(name=name)
                    # attaching registers the segment with this process's
                    # resource tracker, which would unlink the CLIENT's
                    # segment at exit: the client owns it, so unregister
                    try:
                        from multiprocessing import resource_tracker
                        resource_tracker.unregister(seg._name, "shared_memory")
                    except (ImportError, AttributeError, KeyError):
                        pass
                    images = np.ndarray(shape, dtype, buffer=seg.buf)
                    server.observe_stage("decode", mono() - t0)
                    pending = server.submit(images, keys, deadline_ms=self._deadline_ms(),
                                            digest=self.headers.get(DIGEST_HEADER))
                    images = None  # the pending holds the view now
                    out = server.result(pending)
                except FileNotFoundError as e:
                    self._send_error_json(400, "bad_request", f"unknown shm segment: {e}")
                    return
                except Exception as e:  # noqa: BLE001 -- mapped to the typed answers
                    self._send_mapped(e)
                    return
                t0 = mono()
                region = np.ndarray(shape, np.uint8, buffer=seg.buf)
                np.clip(out, 0, 255, out=out)
                np.copyto(region, out.reshape(shape), casting="unsafe")
                del region
                server.observe_stage("serialize", mono() - t0)
                self._send_json(200, {"ok": True, "shm": name, "dtype": "uint8",
                                      "shape": list(shape), "digest": pending.served},
                                {DIGEST_HEADER: pending.served} if pending.served else None)
            finally:
                images = None  # drop our view so close() can release the map
                if pending is not None:
                    pending.images = None
                if seg is not None:
                    try:
                        seg.close()
                    except BufferError:
                        pass  # a live view still pins the map; the GC releases it

        def _do_augment_batch(self) -> None:
            """``POST /augment_batch``: N framed sub-requests in one body.
            All are submitted before any result is awaited, so they
            coalesce; the response frames carry per-part status/body."""
            body = self._read_body()
            if body is None:
                return
            try:
                parts = wire.decode_frames(body)
            except (ValueError, KeyError) as e:
                self._send_error_json(400, "bad_request", f"bad frame payload: {e}")
                return
            slots: list = [None] * len(parts)
            submitted: list = []

            def fail_part(i, e):
                resp = self._error_response(e)
                if resp is None:
                    raise e
                status, obj, headers = resp
                slots[i] = ({"status": status, "ctype": "application/json",
                             "headers": headers}, json.dumps(obj).encode())

            t0 = mono()
            for i, (meta, pbody) in enumerate(parts):
                try:
                    images, keys, was_raw = self._parse_images(
                        pbody, str(meta.get("ctype", "")).lower())
                    deadline_ms = meta.get("deadline_ms")
                    pending = server.submit(
                        images, keys,
                        deadline_ms=None if deadline_ms is None else float(deadline_ms),
                        digest=meta.get("digest"))
                    submitted.append((i, pending, was_raw))
                except Exception as e:  # noqa: BLE001 -- mapped per part
                    fail_part(i, e)
            server.observe_stage("decode", mono() - t0)
            for i, pending, was_raw in submitted:
                try:
                    out = server.result(pending)
                except Exception as e:  # noqa: BLE001 -- mapped per part
                    fail_part(i, e)
                    continue
                t1 = mono()
                pb, ct = self._encode_result(out, was_raw)
                server.observe_stage("serialize", mono() - t1)
                slots[i] = ({"status": 200, "ctype": ct,
                             "headers": {DIGEST_HEADER: pending.served} if pending.served
                             else {}}, pb)
            self._send(200, wire.encode_frames(slots), wire.FRAME_CONTENT_TYPE)

        def _do_reload(self) -> None:
            ok, req = self._read_json_body()
            if not ok:
                return
            if state is None:
                self._send_error_json(503, "not_configured", "reload not configured")
                return
            try:
                info = state.reload_policy(req.get("policy"))
            except BlockingIOError as e:
                self._send_error_json(409, "reload_in_progress", str(e))
                return
            except (KeyError, ValueError, OSError, RuntimeError) as e:
                self._send_error_json(400, "reload_failed", f"{type(e).__name__}: {e}")
                return
            self._send_json(200, {"reloaded": True, **info})

        def _do_tenant_warm(self) -> None:
            ok, req = self._read_json_body()
            if not ok:
                return
            if state is None:
                self._send_error_json(503, "not_configured", "tenancy warm not configured")
                return
            spec = req.get("policy")
            if not spec:
                self._send_error_json(400, "bad_request",
                                      'warm body must be JSON {"policy": PATH}')
                return
            try:
                info = state.warm_tenant(spec)
            except (KeyError, ValueError, OSError, RuntimeError) as e:
                self._send_error_json(400, "warm_failed", f"{type(e).__name__}: {e}")
                return
            self._send_json(200, {"warmed": True, **info})

        def do_POST(self):
            try:
                if self.path == "/augment":
                    self._do_augment()
                elif self.path == "/augment_batch":
                    self._do_augment_batch()
                elif self.path == "/reload":
                    self._do_reload()
                elif self.path == "/tenants/warm":
                    self._do_tenant_warm()
                else:
                    self._send_error_json(404, "unknown_path", f"unknown path {self.path}")
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


# ---------------------------------------------------- fleet integration


def _write_atomic(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)  # a reader never sees a partial record


def _write_beat(path: str, tag: str, done: bool = False) -> None:
    """One host beat in the fleet schema (``hosts/<tag>.json``), so a
    supervisor's heartbeat timeout can kill a wedged replica."""
    _write_atomic(path, {"owner": tag, "heartbeat": wall(), "done": done})


def _beat_loop(state: ServeState, beat_dir: str, tag: str, interval_s: float) -> None:
    host_dir = os.path.join(beat_dir, "hosts")
    os.makedirs(host_dir, exist_ok=True)
    path = os.path.join(host_dir, f"{tag}.json")
    try:
        _write_beat(path, tag)
    except OSError as e:
        logger.warning("host beat write failed: %s", e)
    while not state.stop_event.wait(interval_s):
        try:
            _write_beat(path, tag)
        except OSError as e:
            logger.warning("host beat write failed: %s", e)
    try:
        _write_beat(path, tag, done=True)
    except OSError as e:
        logger.warning("final host beat write failed: %s", e)


def _breaker_exit_loop(state: ServeState, poll_s: float = 0.2) -> None:
    """``--breaker-exit``: an open breaker turns into exit 77 ("restart
    me"), so a supervisor relaunches the replica instead of load balancers
    routing at a broken backend."""
    while not state.stop_event.wait(poll_s):
        if state.server.breaker.snapshot()["state"] == "open":
            logger.error("circuit breaker open with --breaker-exit: shutting down with "
                         "exit %d for supervised restart", PREEMPTED_EXIT_CODE)
            state.initiate_shutdown(drain=False, exit_code=PREEMPTED_EXIT_CODE)
            return


def _journal_exit(server, tag: str) -> None:
    """Journal the replica's last word (a no-op with the journal off): a
    ``mark`` with ``event="serve_exit"``, its device and its kernel launch
    counters beside what predicts them (dispatches, reloads, tenant
    admits), read after the server stopped, so no dispatch is in flight."""
    from fast_autoaugment_tpu_torch.core import telemetry
    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.serve.policy_server import warmup_launches

    st = server.stats()
    telemetry.emit("mark", f"serve:{tag}", event="serve_exit", replica=tag,
                   device=st["device"], shapes=st["shapes"], num_op=st["num_op"],
                   dispatches=st["dispatches"], reloads=st["reloads"],
                   tenancy=st.get("tenancy"), kernel_launches=_kernels.launch_counts(),
                   kernel_launches_warmup=warmup_launches())
    telemetry.journal_flush()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="fast-autoaugment policy-serving endpoint (PyTorch/CUDA)")
    p.add_argument("--policy", required=True,
                   help="final_policy.json path or a shipped archive name")
    p.add_argument("--image", type=int, default=32,
                   help="served image resolution (the client resizes)")
    p.add_argument("--shapes", default="1,8,32,128",
                   help="comma-separated padded batch shapes (one CUDA graph each)")
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
    p.add_argument("--compile-cache", default="off", metavar="{off,DIR}",
                   help="persistent build cache: a restarted server loads the "
                        "kernel library from DIR instead of running nvcc "
                        "(core/compilecache.py)")
    p.add_argument("--telemetry", default="off", metavar="{off,DIR}",
                   help="flight-recorder journal dir (core/telemetry.py): typed "
                        "dispatch/shed/breaker/reload/tenant events.  GET /metrics "
                        "exposes the in-memory registry either way")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the policy runs (default cuda; cpu exists for tests)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--queue-depth", type=int, default=4096,
                   help="bounded request queue; a full queue answers 429 at once")
    p.add_argument("--default-deadline-ms", type=float, default=None,
                   help=f"deadline for requests without an {DEADLINE_HEADER} "
                        "header; expired requests are shed before dispatch")
    p.add_argument("--lifo-depth", type=int, default=0,
                   help="queue depth at/above which draining flips to adaptive "
                        "LIFO (newest first).  0 = pure FIFO")
    p.add_argument("--lifo-age-ms", type=float, default=0.0,
                   help="oldest-queued-request age that flips draining to "
                        "adaptive LIFO.  0 = off")
    p.add_argument("--breaker-threshold", type=int, default=0,
                   help="consecutive dispatch failures that open the circuit "
                        "breaker (fail fast + /readyz 503).  0 = disabled")
    p.add_argument("--breaker-cooldown", type=float, default=5.0,
                   help="seconds an open breaker fails fast before one "
                        "half-open probe")
    p.add_argument("--dispatch-timeout", type=float, default=0.0,
                   help="dispatch wall above this counts as a breaker failure "
                        "even when results arrive.  0 = off")
    p.add_argument("--dispatch-floor-ms", type=float, default=0.0,
                   help="deliberate per-dispatch service-time floor in ms "
                        "(drills emulate a heavy model).  0 = off")
    p.add_argument("--breaker-exit", action="store_true",
                   help="exit 77 ('restart me') when the breaker opens")
    p.add_argument("--watchdog", default="off", metavar="{off,auto,SECONDS}",
                   help="deadline-guard each dispatch (core/watchdog.py); the "
                        "graphs are captured up front, so their labels get the "
                        "warm allowance, and a fired watchdog is a breaker failure")
    p.add_argument("--max-body-mb", type=int, default=DEFAULT_MAX_BODY_MB,
                   help="POST body bound; larger bodies answer 413")
    p.add_argument("--max-inflight", type=int, default=0,
                   help="bound on concurrent /augment handler threads; a burst "
                        "beyond it answers 503 at once.  0 = unbounded")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="seconds the graceful drain waits for queued requests")
    p.add_argument("--serve-seconds", type=float, default=0.0,
                   help="drain and exit 0 after this many seconds (0 = forever)")
    p.add_argument("--heartbeat-dir", default=None, metavar="DIR",
                   help="write fleet-schema host beats to DIR/hosts/<tag>.json")
    p.add_argument("--host-tag", default=None,
                   help="replica tag (default host<FAA_HOST_ID or 0>)")
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="write the bound port (supports --port 0) to PATH")
    p.add_argument("--port-dir", default=None, metavar="DIR",
                   help="atomically write DIR/<tag>.json ({tag, host, port, pid, "
                        "started_at}) on bind and remove it on exit: the "
                        "router's replica discovery")
    p.add_argument("--tenant-capacity", type=int, default=0,
                   help="resident-tenant LRU capacity: requests select a policy "
                        f"with the {DIGEST_HEADER} header.  0 = single policy")
    p.add_argument("--policy-dir", default=None, metavar="DIR",
                   help="cold-tenant recipes: a cold digest resolving to "
                        "DIR/<digest>.json (or any *.json with a matching "
                        "digest) starts a background warm")
    p.add_argument("--donate", action="store_true",
                   help="stage each batch into standing pinned double buffers "
                        "(no per-dispatch host allocation; bitwise equal)")
    p.add_argument("--double-buffer", action="store_true",
                   help="pipelined dispatch: batch k+1 is staged and dispatched "
                        "before batch k is read back")
    p.add_argument("--shm-ingest", action="store_true",
                   help="enable the same-host shared-memory lane "
                        "(application/x-faa-shm; same trust domain only)")
    p.add_argument("--traffic-stats", action="store_true",
                   help="publish served-traffic statistics: faa_serve_{input_mean,"
                        "input_std,reward_proxy} gauges and /stats 'traffic'")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from fast_autoaugment_tpu_torch.core.compilecache import (
        compile_cache_stats,
        configure_compile_cache,
    )
    from fast_autoaugment_tpu_torch.core.telemetry import configure_telemetry
    from fast_autoaugment_tpu_torch.core.watchdog import resolve_watchdog
    from fast_autoaugment_tpu_torch.serve.policy_server import (
        PolicyApplier,
        PolicyServer,
    )

    configure_compile_cache(args.compile_cache)
    configure_telemetry(args.telemetry)
    shapes = tuple(int(s) for s in str(args.shapes).split(",") if s)
    watchdog = resolve_watchdog(args.watchdog)

    def build_applier(policy_tensor):
        return PolicyApplier(
            policy_tensor, image=args.image, shapes=shapes, dispatch=args.dispatch,
            groups=args.groups, device=args.device,
            watchdog=watchdog if watchdog.enabled else None, donate=args.donate)

    try:
        applier = build_applier(build_policy_tensor(args.policy))
    except RuntimeError as e:
        print(f"serve_cli: {e}", file=sys.stderr)
        return 2
    server = PolicyServer(
        applier, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth, default_deadline_ms=args.default_deadline_ms,
        lifo_depth=args.lifo_depth, lifo_age_ms=args.lifo_age_ms,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown,
        dispatch_timeout_s=args.dispatch_timeout,
        tenant_capacity=args.tenant_capacity, traffic_stats=args.traffic_stats,
        double_buffer=args.double_buffer,
        dispatch_floor_ms=args.dispatch_floor_ms).start()
    state = ServeState(server, args.policy, build_applier, policy_dir=args.policy_dir)
    httpd = _ServeHTTPServer(
        (args.host, args.port),
        make_handler(server, max_body_bytes=args.max_body_mb * 1024 * 1024, state=state,
                     max_inflight=args.max_inflight, shm_ingest=args.shm_ingest))
    state.httpd = httpd
    bound_port = httpd.server_address[1]
    if args.port_file:
        tmp = f"{args.port_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(str(bound_port))
        os.replace(tmp, args.port_file)  # a poller never reads a partial port
    replica_tag = args.host_tag or f"host{os.environ.get('FAA_HOST_ID', '0')}"
    port_dir_path = None
    if args.port_dir:
        os.makedirs(args.port_dir, exist_ok=True)
        port_dir_path = os.path.join(args.port_dir, f"{replica_tag}.json")
        _write_atomic(port_dir_path, {"tag": replica_tag, "host": args.host,
                                      "port": bound_port, "pid": os.getpid(),
                                      "started_at": wall()})
    cc = compile_cache_stats()
    logger.info("serving %d sub-policies (dispatch=%s, device=%s) at http://%s:%d; "
                "graphs captured up front (%s; cache hits=%d misses=%d)",
                applier.num_sub, applier.dispatch, applier.device, args.host, bound_port,
                {s: r["sec"] for s, r in applier.compile_log.items()},
                cc["hits"], cc["misses"])

    def shutdown(signum, frame):
        logger.info("signal %d: draining and shutting down", signum)
        state.initiate_shutdown(drain=True, exit_code=0, drain_timeout=args.drain_timeout)

    def reload_sig(signum, frame):
        logger.info("SIGHUP: hot policy reload")

        def _go():
            try:
                state.reload_policy()
            except (BlockingIOError, ValueError, OSError, RuntimeError, KeyError) as e:
                logger.error("SIGHUP reload failed: %s", e)

        threading.Thread(target=_go, daemon=True, name="sighup-reload").start()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGHUP, reload_sig)
    if args.breaker_exit:
        threading.Thread(target=_breaker_exit_loop, args=(state,), daemon=True,
                         name="breaker-exit").start()
    if args.heartbeat_dir:
        threading.Thread(target=_beat_loop, args=(state, args.heartbeat_dir, replica_tag,
                                                  1.0),
                         daemon=True, name="host-beat").start()
    if args.serve_seconds > 0:
        timer = threading.Timer(args.serve_seconds, lambda: state.initiate_shutdown(
            drain=True, exit_code=0, drain_timeout=args.drain_timeout))
        timer.daemon = True
        timer.start()
    try:
        httpd.serve_forever()
    finally:
        state.stop_event.set()
        httpd.server_close()
        server.stop()
        _journal_exit(server, replica_tag)
        if port_dir_path is not None:
            try:
                os.remove(port_dir_path)  # no stale discovery record
            except OSError as e:
                logger.warning("could not remove port-dir record: %s", e)
    return state.exit_code


if __name__ == "__main__":
    sys.exit(main())
