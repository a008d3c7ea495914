"""Policy application over padded batch shapes + the batch-coalescing server.

The counterpart of ``fast_autoaugment_tpu/serve/policy_server.py``.  Two
layers:

:class:`PolicyApplier` holds one learned policy on the device and applies
it to batches padded up to a small fixed set of shapes.  The JAX
package's ``AotPolicyApplier`` compiles one executable per shape ahead of
time; here, on the card, the applier captures one CUDA graph per shape
when it is built, so the capture cost lands at load time and every
dispatch is a replay.  A shape's graph covers the sampler and the policy
application (the hand-written kernel ``csrc/augment.cu``) over static
device buffers; a dispatch copies its padded batch and its keys into
them, replays the graph and copies the real rows back into pinned host
memory without blocking, recording a CUDA event that the result waits on.
The dispatch modes follow the JAX package:

- ``exact``: one key per image.  Image i's sub-policy and draws come from
  its own key alone (:func:`~fast_autoaugment_tpu_torch.ops.augment.
  sample_exact`), so padded lanes cannot leak into results and a lane's
  output does not depend on which requests it was coalesced with.
- ``grouped``: one key per dispatch, drawn over the PADDED batch as the
  JAX package does: a permutation cut into chunks, one sub-policy per
  chunk (:func:`~fast_autoaugment_tpu_torch.ops.augment.sample_grouped`).
  The key is staged into the graph's key buffer, so each replay draws
  its own dispatch's permutation.
- ``auto``: exact for a single-sub policy, grouped otherwise.

:meth:`PolicyApplier.apply_eager` is the eager dispatch (pad on the
device, draw, apply, launch by launch): the CPU's path, and the card's
reference that the graphs are held against.  Nothing on the card's
serving path falls back to it; a capture that fails raises.  With
``donate`` the applier pads into two standing host staging slots per
shape (pinned on the card), flipping between them; before a slot is
rewritten the host waits for that slot's previous host-to-device copy
(the JAX package's double-buffer invariant).

:class:`PolicyServer` is the request front: a bounded queue with
fail-fast admission (typed :class:`ServerOverloadedError`), coalescing up
to ``max_batch`` images or ``max_wait_ms`` after the first queued
request, per-request deadlines that shed expired work before it reaches
the device, adaptive-LIFO drain order under sustained overload, a
circuit breaker (``core/resilience.py``) that contains a failing
backend, multi-policy tenancy (:class:`TenantPool`), hot reload
(:meth:`PolicyServer.swap_applier`) with no dropped request and no
half-policy batch, double-buffered dispatch (batch k+1 is staged and
dispatched before batch k is read back), served-traffic statistics, and
graceful drain.  Its counters live in the telemetry registry under the
JAX package's names (``faa_serve_*``, ``faa_tenant_*``), so ``/stats``
and a ``/metrics`` scrape read the same numbers.  The ``FAA_FAULT`` verbs
``serve_error``, ``serve_slow`` and ``drift`` are consulted at the
dispatch seam (``utils/faultinject.py``).

:meth:`PolicyApplier.export_serialized` writes one shape's program as a
blob of the port's own versioned format (there is no ``jax.export`` in
PyTorch): the policy tensor, the dispatch mode, the group count, the
image geometry and the padded shape.  :func:`deserialize_apply` rebuilds
``fn(images, keys)`` at that shape from it, bitwise equal to the
applier.  The blob holds no compiled code: the kernel library is built
from the package's sources (``ops/_kernels.py``) where the blob is
loaded, and the graph is captured there.
"""

from __future__ import annotations

import collections
import hashlib
import json
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from fast_autoaugment_tpu_torch.core import compilecache, telemetry
from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.core.resilience import CircuitBreaker, CircuitOpenError
from fast_autoaugment_tpu_torch.core.telemetry import mono
from fast_autoaugment_tpu_torch.core.watchdog import capture_guard, dispatch_enqueue_guard
from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.ops.augment import (
    apply_subpolicy_draws,
    check_policy,
    sample_draws,
    sample_exact,
    sample_grouped,
)
from fast_autoaugment_tpu_torch.ops.rng import fold_in
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["PolicyApplier", "PolicyServer", "ServeError",
           "ServerOverloadedError", "ServerStoppedError",
           "DeadlineExpiredError", "TenantNotResidentError",
           "CircuitOpenError", "TenantPool", "DEFAULT_SHAPES", "pick_shape",
           "policy_digest", "resolve_device", "deserialize_apply",
           "warmup_launches"]

logger = get_logger("faa_torch.serve")

#: padded batch shapes served by default: powers of four-ish so padding
#: waste stays < 4x at every load level
DEFAULT_SHAPES = (1, 8, 32, 128)

#: bucket schema for ``faa_serve_stage_seconds``: the data-plane stages
#: are µs-to-ms scale, below the registry's default 1 ms floor
_STAGE_BUCKETS = (1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5)

#: per-process server index: labels each PolicyServer's registry counters
#: so several instances in one process never share counts
_SERVER_SEQ = 0
_SERVER_SEQ_LOCK = threading.Lock()

#: kernel launches of the graphs' warm-up calls, process-wide: a capture
#: runs each shape's step once eagerly before it captures, and those
#: launches count in ``ops/_kernels.py``'s counters like any other (the
#: replays then count the captured launches once each)
_WARMUP = {"augment": 0, "cifar_stack": 0, "imagenet_stack": 0}
_WARMUP_LOCK = threading.Lock()

#: the export blob's magic and format version
EXPORT_MAGIC = b"FAAX1\n"
EXPORT_VERSION = 1


def warmup_launches() -> dict[str, int]:
    """The kernel launches the appliers' capture warm-ups made so far."""
    with _WARMUP_LOCK:
        return dict(_WARMUP)


class ServeError(RuntimeError):
    """A serving dispatch failed; carried to every coalesced request."""


class ServerOverloadedError(ServeError):
    """Admission refused: the bounded queue is full (HTTP 429)."""

    def __init__(self, msg: str, retry_after_s: float = 0.05):
        super().__init__(msg)
        self.retry_after_s = max(0.0, float(retry_after_s))


class ServerStoppedError(ServeError):
    """Admission refused or request abandoned: the server is stopped or
    draining (HTTP 503)."""


class DeadlineExpiredError(ServeError):
    """The request's deadline passed while it was queued; it was shed
    before dispatch (HTTP 503)."""


class TenantNotResidentError(ServeError):
    """The request named a policy digest with no resident applier on this
    replica (HTTP 503 ``tenant_cold``; the router's failover signal).
    Carries the requested `digest` and the replica's `resident` list."""

    def __init__(self, msg: str, digest: str | None = None,
                 resident: Sequence[str] = ()):
        super().__init__(msg)
        self.digest = digest
        self.resident = tuple(resident)


def pick_shape(shapes: Sequence[int], n: int) -> int:
    """The smallest padded shape holding `n` images (callers chunk at the
    largest shape first, so `n` <= max(shapes) always)."""
    for s in shapes:
        if s >= n:
            return s
    raise ValueError(f"batch of {n} exceeds the largest shape "
                     f"{max(shapes)}: chunk before dispatching")


def policy_digest(policy) -> str:
    """The canonical 12-hex policy identity: sha256 over the float32
    ``[num_sub, num_op, 3]`` tensor's shape and bytes (byte-compatible with
    the JAX package's ``policy_digest``).  One digest names one policy
    everywhere in the serving plane: the ``X-FAA-Policy-Digest`` header,
    the tenancy LRU and the router's rendezvous hash."""
    arr = np.ascontiguousarray(np.asarray(policy, np.float32))
    h = hashlib.sha256()
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()[:12]


def _acc_stage(stages: dict | None, name: str, sec: float) -> None:
    """Add one stage's seconds to the caller's per-dispatch stage dict
    (None = not recorded for this call)."""
    if stages is not None:
        stages[name] = stages.get(name, 0.0) + sec


#: a draw source: (dispatch, keys, batch, *, num_sub, num_op, height,
#: width, groups, device) -> (sub_idx [batch], draws [batch, num_op, 4])
DrawSource = Callable[..., tuple[torch.Tensor, torch.Tensor]]


class _Readback:
    """One replayed chunk in flight: the pinned host tensor its real rows
    are copied into and the event recorded after that copy."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event

    def wait(self) -> np.ndarray:
        self.event.synchronize()
        return self.host.numpy()


class _AsyncApply:
    """An :meth:`PolicyApplier.apply_async` result: every chunk has been
    dispatched, and on the card its rows are on their way to pinned host
    memory.  ``materialize()`` waits for each chunk's event (not for the
    device) and assembles the ``[n, H, W, C]`` float32 output.  The
    double-buffered server holds one of these per in-flight batch and
    materializes it after the NEXT batch has been staged and dispatched."""

    __slots__ = ("n", "tail", "parts")

    def __init__(self, n: int, tail: tuple, parts: list):
        self.n = int(n)
        self.tail = tuple(tail)
        self.parts = parts  # [(np.ndarray [hi-lo, ...] or _Readback, lo, hi), ...]

    def materialize(self, stages: dict | None = None) -> np.ndarray:
        t0 = mono()
        out = np.empty((self.n,) + self.tail, np.float32)
        for got, lo, hi in self.parts:
            out[lo:hi] = got.wait() if isinstance(got, _Readback) else got
        self.parts = []
        _acc_stage(stages, "scatter", mono() - t0)
        return out


class _EagerApply:
    """A materialized result behind the :class:`_AsyncApply` interface,
    for duck-typed appliers that expose only ``apply``."""

    __slots__ = ("out",)

    def __init__(self, out: np.ndarray):
        self.out = out

    def materialize(self, stages: dict | None = None) -> np.ndarray:
        return self.out


class _ShapeGraph:
    """One padded shape's captured graph: its static input, key and
    output buffers, the launches its capture recorded and the capture's
    seconds."""

    __slots__ = ("graph", "x", "k", "y", "tally", "sec")

    def __init__(self, graph, x, k, y, tally, sec):
        self.graph, self.x, self.k, self.y = graph, x, k, y
        self.tally, self.sec = tally, sec


class PolicyApplier:
    """One learned policy, applied on `device` over fixed padded shapes.

    ``policy`` is the ``[num_sub, num_op, 3]`` tensor
    (``policies.archive.policy_to_tensor``).  ``shapes`` are the padded
    batch sizes, ascending.  On a CUDA device the kernel library is built
    and one CUDA graph per shape is captured when the applier is made
    (:attr:`compile_log` holds each capture's seconds), so the first
    request pays for neither.  ``draw_source`` turns keys into draws for
    the eager path; the default is the port's counter-based sampler
    (:func:`~fast_autoaugment_tpu_torch.ops.augment.sample_draws`), and
    the tests pass one that replays the JAX key tree.  The graphs always
    draw with the port's sampler, so on the card a `draw_source` is
    refused.  ``watchdog`` (a :class:`~fast_autoaugment_tpu_torch.core.
    watchdog.DispatchWatchdog`) guards each dispatch under the label
    ``serve_{dispatch}_b{shape}``, marked compile-warm since the graphs
    are captured up front.  ``donate`` turns on the standing staging
    slots (module docstring)."""

    def __init__(self, policy, *, image: int = 32,
                 shapes: Sequence[int] = DEFAULT_SHAPES,
                 dispatch: str = "auto", groups: int = 8,
                 device="cuda", draw_source: DrawSource | None = None,
                 watchdog=None, donate: bool = False):
        arr = check_policy(policy)
        self.device = resolve_device(device)
        self.policy = torch.as_tensor(arr, device=self.device)
        #: the serving-plane identity of this applier's policy
        self.digest = policy_digest(arr)
        self.num_sub, self.num_op = int(arr.shape[0]), int(arr.shape[1])
        if dispatch == "auto":
            dispatch = "exact" if self.num_sub == 1 else "grouped"
        if dispatch not in ("exact", "grouped"):
            raise ValueError(f"dispatch must be exact/grouped/auto, got {dispatch!r}")
        self.dispatch = dispatch
        self.groups = max(1, int(groups))
        self.image, self.channels = int(image), 3  # the ops take RGB
        self.shapes = tuple(sorted(set(int(s) for s in shapes)))
        if not self.shapes or self.shapes[0] < 1:
            raise ValueError(f"need at least one positive shape, got {shapes!r}")
        self.max_batch = self.shapes[-1]
        self.graphed = self.device.type == "cuda"
        if self.graphed and draw_source is not None:
            raise ValueError("on the card the graphs draw with the port's sampler: "
                             "a draw_source runs on the CPU only")
        self.draw_source = draw_source or sample_draws
        self.donate = bool(donate)
        self._watchdog = watchdog
        # one dispatch at a time per applier: the graphs' static buffers
        # and the staging slots are shared by every dispatch of a shape
        self._lock = threading.RLock()
        #: per-shape capture evidence: {shape: {"sec", "verdict"}}
        self.compile_log: dict[int, dict] = {}
        self._graphs: dict[int, _ShapeGraph] = {}
        if self.graphed:
            _kernels.load_libraries()
            for s in self.shapes:
                self._graphs[s] = self._capture(s)
                self.compile_log[s] = {"sec": round(self._graphs[s].sec, 6),
                                       "verdict": "captured"}
        if watchdog is not None:
            for s in self.shapes:
                watchdog.mark_compile_warm(self.label(s))
        # two alternating host staging slots per shape (donated path):
        # batch k+1 stages into the slot batch k-1 used, after waiting for
        # that slot's host-to-device copy (the double-buffer invariant)
        self._staging: dict[int, list[np.ndarray]] = {}
        self._staging_keys: dict[int, list[np.ndarray]] = {}
        self._slot_tensors: dict[int, list[tuple]] = {}
        self._slot_h2d: dict[int, list] = {}
        self._slot = 0
        if self.donate:
            pin = self.graphed
            for s in self.shapes:
                geom = (s, self.image, self.image, self.channels)
                kgeom = (s, 2) if dispatch == "exact" else (2,)
                imgs = [torch.zeros(geom, dtype=torch.float32, pin_memory=pin)
                        for _ in range(2)]
                keys = [torch.zeros(kgeom, dtype=torch.int64, pin_memory=pin)
                        for _ in range(2)]
                self._slot_tensors[s] = list(zip(imgs, keys))
                self._staging[s] = [t.numpy() for t in imgs]
                self._staging_keys[s] = [t.numpy() for t in keys]
                self._slot_h2d[s] = [None, None]
        logger.info("policy applier ready: %d sub-policies, dispatch=%s, shapes=%s, "
                    "device=%s, donate=%s, capture %s", self.num_sub, dispatch,
                    list(self.shapes), self.device, self.donate,
                    {s: r["sec"] for s, r in self.compile_log.items()})

    def label(self, s: int) -> str:
        """The watchdog and compile-seam label of shape `s`."""
        return f"serve_{self.dispatch}_b{s}"

    # -------------------------------------------------------- graphs

    def _step(self, x: torch.Tensor, k: torch.Tensor, s: int) -> torch.Tensor:
        """The graphed step: draws from the staged keys, then the policy."""
        if self.dispatch == "exact":
            sub, draws = sample_exact(k, self.num_sub, self.num_op, self.image, self.image)
        else:
            sub, draws = sample_grouped(k, s, self.groups, self.num_sub, self.num_op,
                                        self.image, self.image)
        return apply_subpolicy_draws(x, self.policy, sub, draws)

    def _capture(self, s: int) -> _ShapeGraph:
        """Capture shape `s`'s graph: a warm-up call on a side stream, then
        the capture on it in ``thread_local`` mode, so the dispatch thread
        may go on replaying another applier's graphs meanwhile (a hot
        reload or a tenant warm-up captures off the dispatch thread).
        Captures take ``core/watchdog.py capture_guard``: one at a time in
        the process.  A failed capture raises."""
        dev = self.device
        t0 = time.perf_counter()
        with compilecache.timed_first(self.label(s)), dispatch_enqueue_guard(), \
                capture_guard():
            x = torch.zeros((s, self.image, self.image, self.channels),
                            dtype=torch.float32, device=dev)
            k = torch.zeros((s, 2) if self.dispatch == "exact" else (2,),
                            dtype=torch.int64, device=dev)
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._step(x, k, s)  # the warm-up: the kernels' one-time set-up
            side.synchronize()
            graph = torch.cuda.CUDAGraph()
            with _kernels.counting_capture() as tally, \
                    torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                y = self._step(x, k, s)
            main.wait_stream(side)
        with _WARMUP_LOCK:
            for name, n in tally.items():
                _WARMUP[name] += n  # the warm-up launched what the capture recorded
        return _ShapeGraph(graph, x, k, y, dict(tally), time.perf_counter() - t0)

    # ------------------------------------------------------- staging

    def _pad(self, arr: np.ndarray, target: int) -> np.ndarray:
        pad = target - arr.shape[0]
        if pad <= 0:
            return arr
        return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])

    def _stage(self, images: np.ndarray, keys: np.ndarray,
               s: int) -> tuple[np.ndarray, np.ndarray, int]:
        """Pad into the next standing staging slot (donated path): wait for
        the slot's previous host-to-device copy, copy the batch in, ZERO
        the pad rows (a reused slot must never leak the previous batch
        into the padded lanes), flip the slot."""
        n = images.shape[0]
        slot = self._slot
        self._slot = 1 - slot
        pending = self._slot_h2d[s][slot]
        if pending is not None:
            pending.synchronize()
            self._slot_h2d[s][slot] = None
        buf = self._staging[s][slot]
        np.copyto(buf[:n], images)
        if n < s:
            buf[n:] = 0.0
        kbuf = self._staging_keys[s][slot]
        if self.dispatch == "exact":
            np.copyto(kbuf[:n], keys)
            if n < s:
                kbuf[n:] = 0
        else:
            np.copyto(kbuf, keys.reshape(2))
        return buf, kbuf, slot

    # ------------------------------------------------------ dispatch

    def apply(self, images: np.ndarray, keys: np.ndarray,
              stages: dict | None = None) -> np.ndarray:
        """Apply the policy to ``images [n, H, W, C]`` (uint8 or integral
        float32 in [0, 255]) and return float32 integral images.

        ``exact``: `keys` is ``[n, 2]`` uint32, one key per image.
        ``grouped``: `keys` is one ``[2]`` key for the dispatch.  Batches
        larger than the largest shape are chunked (a grouped chunk after
        the first gets ``fold_in(key, chunk)``); smaller ones pad up with
        zero images and zero keys whose results are sliced away.
        `stages` (optional dict) accumulates per-stage seconds (pad /
        h2d / dispatch / scatter) for ``faa_serve_stage_seconds``."""
        return self.apply_async(images, keys, stages=stages).materialize(stages=stages)

    def apply_eager(self, images: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """The eager dispatch: pad on the device, draw with `draw_source`,
        apply, launch by launch, with no graph and no staging slot.  The
        CPU's path, and the card's reference for the graphs."""
        return self.apply_async(images, keys, eager=True).materialize()

    def _check(self, images, keys) -> tuple[np.ndarray, np.ndarray]:
        images = np.asarray(images)
        if images.ndim != 4:
            raise ValueError(f"images must be [n, H, W, C], got {images.shape}")
        expect = (self.image, self.image, self.channels)
        if images.shape[1:] != expect:
            raise ValueError(f"images are {images.shape[1:]}, this applier serves "
                             f"{expect}: resize/crop client-side")
        n = images.shape[0]
        keys = np.asarray(keys, np.uint32)
        keys = keys.reshape(n, 2) if self.dispatch == "exact" else keys.reshape(2)
        return images, keys

    def apply_async(self, images: np.ndarray, keys: np.ndarray,
                    stages: dict | None = None, *, eager: bool = False) -> _AsyncApply:
        """The pipelined half of :meth:`apply`: dispatches every chunk
        without waiting for its result and returns a handle whose
        ``materialize()`` waits and assembles.  A donated call of more than
        one chunk waits for each chunk in turn, since two staging slots
        guarantee one step of overlap only (the server's batches are one
        chunk)."""
        images, keys = self._check(images, keys)
        n = images.shape[0]
        parts: list = []
        for chunk, lo in enumerate(range(0, n, self.max_batch)):
            hi = min(lo + self.max_batch, n)
            if self.dispatch == "exact":
                k = keys[lo:hi]
            elif chunk == 0:
                k = keys
            else:
                # over-large grouped batches: a fresh key per chunk, or every
                # chunk would replay one permutation
                k = fold_in(torch.as_tensor(keys.astype(np.int64)), chunk)
                k = k.numpy().astype(np.uint32)
            if eager or not self.graphed:
                got = self._dispatch_eager(images[lo:hi], k, stages, staged=not eager)
            else:
                got = self._dispatch_graph(images[lo:hi], k, stages)
                if self.donate and n > self.max_batch:
                    got = np.array(got.wait())
            parts.append((got, lo, hi))
        return _AsyncApply(n, images.shape[1:], parts)

    def _dispatch_eager(self, images: np.ndarray, keys: np.ndarray,
                        stages: dict | None, staged: bool) -> np.ndarray:
        """Pad one chunk, draw, apply, copy the real rows back.  With
        `staged` and ``donate`` the chunk pads into a staging slot (the
        CPU's donated path); otherwise on the device, as the eager
        reference does."""
        n = images.shape[0]
        s = pick_shape(self.shapes, n)
        with self._lock:
            t0 = mono()
            if staged and self.donate:
                buf, kbuf, _ = self._stage(images, keys, s)
                x = torch.from_numpy(buf).to(self.device)
                keys = kbuf.astype(np.uint32)
            else:
                x = torch.zeros((s,) + images.shape[1:], dtype=torch.float32,
                                device=self.device)
                host = images.astype(np.float32, copy=not images.flags.writeable)
                x[:n] = torch.from_numpy(host)
                if self.dispatch == "exact":
                    keys = np.concatenate([keys, np.zeros((s - n, 2), np.uint32)])
            t1 = mono()
            _acc_stage(stages, "pad", t1 - t0)
            sub_idx, draws = self.draw_source(
                self.dispatch, keys, s, num_sub=self.num_sub, num_op=self.num_op,
                height=self.image, width=self.image, groups=self.groups,
                device=self.device)
            y = apply_subpolicy_draws(x, self.policy, sub_idx.to(self.device),
                                      draws.to(self.device))
            out = y[:n].cpu().numpy()
            _acc_stage(stages, "dispatch", mono() - t1)
        return out

    def _dispatch_graph(self, images: np.ndarray, keys: np.ndarray,
                        stages: dict | None) -> _Readback:
        """Stage one chunk into its shape's static buffers and replay the
        shape's graph; the real rows go to pinned host memory behind an
        event.  Nothing here waits for the device, except a fresh
        (undonated) host batch, whose copy from pageable memory is
        synchronous."""
        n = images.shape[0]
        s = pick_shape(self.shapes, n)
        g = self._graphs[s]
        with self._lock:
            t0 = mono()
            if self.donate:
                buf, kbuf, slot = self._stage(images, keys, s)
                x_src, k_src = self._slot_tensors[s][slot]
            else:
                host = images.astype(np.float32, copy=not images.flags.writeable)
                x_src = torch.from_numpy(self._pad(host, s))
                k = keys.astype(np.int64)
                k_src = torch.from_numpy(self._pad(k, s) if self.dispatch == "exact" else k)
            t1 = mono()
            _acc_stage(stages, "pad", t1 - t0)
            with dispatch_enqueue_guard():
                g.x.copy_(x_src, non_blocking=self.donate)
                g.k.copy_(k_src, non_blocking=self.donate)
                if self.donate:
                    h2d = torch.cuda.Event()
                    h2d.record()
                    self._slot_h2d[s][slot] = h2d
            t2 = mono()
            _acc_stage(stages, "h2d", t2 - t1)
            if self._watchdog is not None and self._watchdog.enabled:
                got = self._watchdog.run(self.label(s), self._replay, g, n)
            else:
                got = self._replay(g, n)
            _acc_stage(stages, "dispatch", mono() - t2)
        return got

    def _replay(self, g: _ShapeGraph, n: int) -> _Readback:
        host = torch.empty((n,) + tuple(g.y.shape[1:]), dtype=torch.float32,
                           pin_memory=True)
        with dispatch_enqueue_guard():
            g.graph.replay()
            host.copy_(g.y[:n], non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        _kernels.count_replays(g.tally)
        return _Readback(host, done)

    # ------------------------------------------------ export round-trip

    def export_serialized(self, shape: int | None = None) -> bytes:
        """One shape's program as a blob of the port's versioned format
        (module docstring); defaults to the largest shape."""
        s = self.shapes[-1] if shape is None else int(shape)
        if s not in self.shapes:
            raise KeyError(f"shape {s} not served (have {self.shapes})")
        pol = np.ascontiguousarray(self.policy.detach().cpu().numpy(), np.float32)
        head = {"format": "faa-policy-apply", "version": EXPORT_VERSION,
                "dispatch": self.dispatch, "groups": self.groups, "image": self.image,
                "channels": self.channels, "shape": s, "policy_shape": list(pol.shape),
                "digest": self.digest}
        return EXPORT_MAGIC + json.dumps(head, sort_keys=True).encode() + b"\n" + pol.tobytes()


def deserialize_apply(blob: bytes, device="cuda"):
    """Rebuild a :meth:`PolicyApplier.export_serialized` program on
    `device`: returns ``fn(images, keys) -> images`` at the exported
    padded shape (``images [shape, H, W, C]``, the full padded output),
    bitwise equal to an applier of the same policy."""
    blob = bytes(blob)
    if not blob.startswith(EXPORT_MAGIC):
        raise ValueError("not an exported policy program (bad magic)")
    nl = blob.find(b"\n", len(EXPORT_MAGIC))
    if nl < 0:
        raise ValueError("exported program header missing")
    head = json.loads(blob[len(EXPORT_MAGIC):nl])
    if head.get("format") != "faa-policy-apply" or head.get("version") != EXPORT_VERSION:
        raise ValueError(f"unsupported export format {head.get('format')!r} "
                         f"version {head.get('version')!r}")
    pshape = tuple(int(d) for d in head["policy_shape"])
    pol = np.frombuffer(blob, np.float32, count=int(np.prod(pshape)),
                        offset=nl + 1).reshape(pshape)
    if policy_digest(pol) != head["digest"]:
        raise ValueError("exported policy bytes do not match their digest")
    s = int(head["shape"])
    applier = PolicyApplier(pol.copy(), image=int(head["image"]), shapes=(s,),
                            dispatch=head["dispatch"], groups=int(head["groups"]),
                            device=device)

    def fn(images, keys):
        images = np.asarray(images)
        if images.shape[0] != s:
            raise ValueError(f"the exported program takes {s} images, got {images.shape[0]}")
        return applier.apply(images, keys)

    fn.applier = applier
    return fn


# ------------------------------------------------------------- tenancy


class TenantPool:
    """The multi-policy tenancy LRU: resident appliers keyed by policy
    digest.

    Admission (:meth:`admit`) takes an applier the caller built (and on
    the card captured) OFF TO THE SIDE: cold policies never capture on
    the dispatch path.  Over ``capacity`` the least-recently-used digest
    starts RETIRING: invisible to new submissions at once, while requests
    already queued under it still dispatch on its applier.  Its graphs and
    buffers are released only when the server worker :meth:`sweep`\\ s at
    a dispatch boundary after its queued work has drained.

    Thread-safe: HTTP handler threads look up, a warm thread admits, the
    server worker sweeps."""

    def __init__(self, capacity: int, server_id: str = "0"):
        self.capacity = max(1, int(capacity))
        self._server_id = str(server_id)
        self._lock = threading.Lock()
        self._resident: collections.OrderedDict[str, object] = collections.OrderedDict()
        self._retiring: dict[str, object] = {}
        self._inflight: dict[str, int] = {}
        reg = telemetry.registry()
        self._events = {name: reg.counter(
            "faa_tenant_events_total",
            "tenancy events (admit/evict/hit/miss) per server",
            event=name, server=self._server_id)
            for name in ("admit", "evict", "hit", "miss")}
        self._resident_gauge = reg.gauge(
            "faa_tenant_resident", "tenants resident in the LRU", server=self._server_id)

    def lookup_submit(self, digest: str):
        """Resident-only lookup (MRU bump) for NEW submissions: a retiring
        tenant reads as not resident."""
        with self._lock:
            ap = self._resident.get(digest)
            if ap is not None:
                self._resident.move_to_end(digest)
                self._events["hit"].inc()
                return ap
            self._events["miss"].inc()
            return None

    def lookup_dispatch(self, digest: str):
        """Resident-or-retiring lookup for the dispatch boundary."""
        with self._lock:
            ap = self._resident.get(digest)
            if ap is None:
                ap = self._retiring.get(digest)
            return ap

    def admit(self, digest: str, applier) -> list[str]:
        """Flip a built applier into the LRU; returns the digests that
        started retiring as a result."""
        with self._lock:
            already = digest in self._resident
            self._resident[digest] = applier
            self._resident.move_to_end(digest)
            self._retiring.pop(digest, None)  # a re-admit resurrects
            evicted: list[str] = []
            while len(self._resident) > self.capacity:
                old_digest, old_ap = self._resident.popitem(last=False)
                self._retiring[old_digest] = old_ap
                evicted.append(old_digest)
            if not already:
                self._events["admit"].inc()
            if evicted:
                self._events["evict"].inc(len(evicted))
            self._resident_gauge.set(len(self._resident))
            n_resident = len(self._resident)
        for old in evicted:
            telemetry.emit("tenant", f"serve{self._server_id}", action="evict", digest=old)
        telemetry.emit("tenant", f"serve{self._server_id}", action="admit", digest=digest,
                       resident=n_resident)
        return evicted

    def track_submit(self, digest: str) -> None:
        with self._lock:
            self._inflight[digest] = self._inflight.get(digest, 0) + 1

    def track_done(self, digest: str) -> None:
        with self._lock:
            n = self._inflight.get(digest, 0) - 1
            if n <= 0:
                self._inflight.pop(digest, None)
            else:
                self._inflight[digest] = n

    def sweep(self) -> list[str]:
        """Dispatch-boundary eviction: release retiring appliers whose
        queued work has drained.  Called by the server worker between
        dispatches, never while one is in flight."""
        with self._lock:
            dead = [d for d in self._retiring if self._inflight.get(d, 0) <= 0]
            for d in dead:
                del self._retiring[d]
        return dead

    def resident_digests(self) -> list[str]:
        """Resident digests, LRU-first / MRU-last."""
        with self._lock:
            return list(self._resident)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "resident": list(self._resident),
                "retiring": sorted(self._retiring),
                "admits": int(self._events["admit"].value),
                "evicts": int(self._events["evict"].value),
                "hits": int(self._events["hit"].value),
                "misses": int(self._events["miss"].value),
            }


# -------------------------------------------------------------- queue


class _Pending:
    """One admitted request: its images, keys, deadline, tenant digest and
    result slot."""

    __slots__ = ("images", "keys", "event", "result", "error", "t_submit",
                 "t_done", "deadline", "digest", "served")

    def __init__(self, images: np.ndarray, keys: np.ndarray | None,
                 deadline: float | None = None, digest: str | None = None):
        self.images = images
        self.keys = keys
        self.event = threading.Event()
        self.result: np.ndarray | None = None
        self.error: BaseException | None = None
        self.t_submit = mono()
        self.t_done = 0.0
        self.deadline = deadline
        self.digest = digest  # None = the server's pinned default applier
        self.served: str | None = None  # the digest of the applier that served it

    @property
    def n(self) -> int:
        return int(self.images.shape[0])

    def latency(self) -> float:
        return self.t_done - self.t_submit

    def expired(self, now: float | None = None) -> bool:
        if self.deadline is None:
            return False
        return (mono() if now is None else now) >= self.deadline


class _InflightBatch:
    """A coalesced batch dispatched but not read back (double-buffered
    mode): its requests, the async handle, a strong applier reference (so
    eviction or reload cannot retire the graphs mid-flight) and the stage
    seconds so far."""

    __slots__ = ("batch", "handle", "applier", "digest", "n_images", "t0",
                 "stages", "images")

    def __init__(self, batch, handle, applier, digest, n_images, t0, stages,
                 images=None):
        self.batch = batch
        self.handle = handle
        self.applier = applier
        self.digest = digest
        self.n_images = n_images
        self.t0 = t0
        self.stages = stages
        self.images = images  # kept only for the traffic statistics


class _RequestQueue:
    """Bounded request buffer with non-blocking admission and
    watermark-selected drain order.

    ``offer`` never blocks: it returns False on a full queue.  ``take``
    drains FIFO in clean weather; while the depth is at or above
    ``lifo_depth``, or the OLDEST queued request is older than
    ``lifo_age_ms``, it drains newest-first (adaptive LIFO: under
    sustained overload the oldest requests are the ones whose clients
    have most likely given up).  Both watermarks default to 0 = off."""

    def __init__(self, depth: int, *, lifo_depth: int = 0,
                 lifo_age_ms: float = 0.0, lifo_counter=None):
        self.depth = int(depth)
        self.lifo_depth = int(lifo_depth)
        self.lifo_age_ms = float(lifo_age_ms)
        self._items: collections.deque[_Pending] = collections.deque()
        self._cond = threading.Condition()
        self._lifo_counter = lifo_counter
        self._lifo_takes_local = 0

    @property
    def lifo_takes(self) -> int:
        if self._lifo_counter is not None:
            return int(self._lifo_counter.value)
        return self._lifo_takes_local

    def _count_lifo_take(self) -> None:
        if self._lifo_counter is not None:
            self._lifo_counter.inc()
        else:
            self._lifo_takes_local += 1

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def empty(self) -> bool:
        return len(self) == 0

    def offer(self, item: _Pending) -> bool:
        with self._cond:
            if len(self._items) >= self.depth:
                return False
            self._items.append(item)
            self._cond.notify()
            return True

    def _lifo_active(self) -> bool:
        if self.lifo_depth > 0 and len(self._items) >= self.lifo_depth:
            return True
        if self.lifo_age_ms > 0 and self._items:
            if (mono() - self._items[0].t_submit) * 1e3 >= self.lifo_age_ms:
                return True
        return False

    def take(self, timeout: float) -> _Pending | None:
        with self._cond:
            if not self._items:
                self._cond.wait(timeout=max(0.0, timeout))
            if not self._items:
                return None
            if self._lifo_active():
                self._count_lifo_take()
                return self._items.pop()
            return self._items.popleft()

    def drain(self) -> list[_Pending]:
        with self._cond:
            items = list(self._items)
            self._items.clear()
            return items


# ------------------------------------------------------------- server


class PolicyServer:
    """Batch-coalescing, overload-safe request front for a
    :class:`PolicyApplier` (module docstring).

    The worker collects requests until ``max_batch`` images are queued or
    ``max_wait_ms`` has passed since the first one, dispatches them as one
    padded batch and scatters the rows back in FIFO order.  A request that
    would overflow the batch, or that names another tenant, is carried
    whole to the next dispatch.  ``submit`` never blocks: a full queue
    raises :class:`ServerOverloadedError`, a stopped or draining server
    :class:`ServerStoppedError`, an open breaker
    :class:`~fast_autoaugment_tpu_torch.core.resilience.CircuitOpenError`,
    a cold tenant :class:`TenantNotResidentError`.  Every knob defaults
    off."""

    def __init__(self, applier: PolicyApplier, *,
                 max_batch: int | None = None, max_wait_ms: float = 5.0,
                 queue_depth: int = 4096, seed: int = 0,
                 default_deadline_ms: float | None = None,
                 lifo_depth: int = 0, lifo_age_ms: float = 0.0,
                 breaker_threshold: int = 0, breaker_cooldown_s: float = 5.0,
                 dispatch_timeout_s: float = 0.0, tenant_capacity: int = 0,
                 traffic_stats: bool = False, double_buffer: bool = False,
                 dispatch_floor_ms: float = 0.0):
        self.applier = applier
        self.max_batch = int(max_batch or applier.max_batch)
        if self.max_batch > applier.max_batch:
            raise ValueError(f"max_batch {self.max_batch} exceeds the largest "
                             f"shape {applier.max_batch}")
        # a deliberate per-dispatch service-time floor (drills emulate a
        # heavy model with it); 0 = off
        self.dispatch_floor_s = max(0.0, float(dispatch_floor_ms)) / 1e3
        self.max_wait_ms = float(max_wait_ms)
        self.queue_depth = int(queue_depth)
        global _SERVER_SEQ
        with _SERVER_SEQ_LOCK:
            self._server_id = str(_SERVER_SEQ)
            _SERVER_SEQ += 1
        reg = telemetry.registry()
        self._ctr = {name: reg.counter(
            "faa_serve_robustness_total",
            "serving robustness counters (admission/shed/breaker/reload)",
            counter=name, server=self._server_id) for name in (
            "admitted", "shed_overload", "shed_breaker", "shed_stopped",
            "expired", "deadline_misses", "lifo_takes", "reloads")}
        self._dispatches_ctr = reg.counter(
            "faa_serve_dispatches_total", "coalesced device dispatches",
            server=self._server_id)
        self._requests_ctr = reg.counter(
            "faa_serve_requests_total", "requests served", server=self._server_id)
        self._images_ctr = reg.counter(
            "faa_serve_images_total", "images served", server=self._server_id)
        self._q = _RequestQueue(self.queue_depth, lifo_depth=lifo_depth,
                                lifo_age_ms=lifo_age_ms,
                                lifo_counter=self._ctr["lifo_takes"])
        self._carry: _Pending | None = None
        self._stop = threading.Event()
        self._closed = threading.Event()  # admission gate (stop or drain)
        self._worker: threading.Thread | None = None
        self._seed = int(seed)
        self._auto_key_counter = 0
        self._lock = threading.Lock()
        self.default_deadline_ms = (None if default_deadline_ms is None
                                    else float(default_deadline_ms))
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self.breaker = CircuitBreaker(threshold=breaker_threshold,
                                      cooldown_s=breaker_cooldown_s,
                                      name=f"serve{self._server_id}")
        self.tenant_capacity = int(tenant_capacity)
        self._tenants = (TenantPool(self.tenant_capacity, self._server_id)
                         if self.tenant_capacity > 0 else None)
        self.default_digest = getattr(applier, "digest", None)
        self._tenant_ctrs: dict[str, tuple] = {}
        self._qdepth_gauge = reg.gauge(
            "faa_serve_queue_depth", "requests queued awaiting dispatch",
            server=self._server_id)
        self.double_buffer = bool(double_buffer)
        self._stage_hist: dict[str, object] = {}
        #: grace past a request's deadline that result() still waits
        self.deadline_grace_s = 1.0
        self.batch_sizes: list[int] = []
        self.dispatch_walls: list[float] = []
        self._dispatch_attempts = 0  # incl. fast-fails and injected errors
        self._wall_ema: float | None = None
        self.traffic_stats = bool(traffic_stats)
        self._traffic_ema: dict[str, float | None] = {
            "input_mean": None, "input_std": None, "reward_proxy": None}
        self._traffic_samples = 0
        self._traffic_gauges = None
        if self.traffic_stats:
            self._traffic_gauges = {name: reg.gauge(
                f"faa_serve_{name}",
                "served-traffic statistic (EMA over dispatches; the drift "
                "monitor / canary comparator signal)", server=self._server_id)
                for name in ("input_mean", "input_std", "reward_proxy")}

    # ------------------------------------------------------- lifecycle

    def start(self) -> "PolicyServer":
        if self._worker is not None and self._worker.is_alive():
            return self
        self._stop.clear()
        self._closed.clear()
        self._worker = threading.Thread(target=self._run, daemon=True, name="policy-server")
        self._worker.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._closed.set()
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=timeout)

    def begin_drain(self) -> None:
        """Stop admitting; queued requests still complete and the worker
        exits once the queue is empty."""
        self._closed.set()

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful drain: stop admitting, finish everything queued, stop
        the worker.  True when fully drained within `timeout`."""
        self.begin_drain()
        deadline = time.monotonic() + max(0.0, float(timeout))
        if self._worker is not None:
            while self._worker.is_alive():
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._worker.join(timeout=min(0.2, left))
        drained = self._q.empty() and self._carry is None \
            and (self._worker is None or not self._worker.is_alive())
        self._stop.set()
        return drained

    @property
    def draining(self) -> bool:
        return self._closed.is_set()

    @property
    def running(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    # --------------------------------------------------------- clients

    def _auto_keys(self, n: int) -> np.ndarray:
        """Server-derived keys: the 64-bit value ``seed * 2**32 + counter``
        over a process-monotonic counter, as (hi, lo) uint32 words -- a
        distinct key per image without client coordination."""
        with self._lock:
            base = self._auto_key_counter
            self._auto_key_counter += n
        k = [((self._seed << 32) + base + i) & 0xFFFFFFFFFFFFFFFF for i in range(n)]
        return np.array([[v >> 32, v & 0xFFFFFFFF] for v in k], np.uint32)

    def submit(self, images: np.ndarray, keys: np.ndarray | None = None, *,
               deadline_ms: float | None = None, digest: str | None = None) -> _Pending:
        """Queue ``images [n, H, W, C]`` (or one ``[H, W, C]`` image).

        `keys` (``[n, 2]`` uint32) pins the per-image draws; None lets the
        server derive them.  `deadline_ms` (relative; default the server's
        ``default_deadline_ms``) is the time after which the request is
        shed instead of dispatched.  `digest` pins the request to a
        resident tenant policy; None, or the default applier's own digest,
        serves the default.  Never blocks."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        n = images.shape[0]
        if n < 1:
            raise ValueError("empty request")
        if n > self.max_batch:
            raise ValueError(f"request of {n} images exceeds max_batch "
                             f"{self.max_batch}: split client-side")
        if digest is not None and digest == self.default_digest:
            digest = None
        if digest is not None:
            if self._tenants is None:
                raise TenantNotResidentError(
                    f"policy {digest} requested but this replica serves a single "
                    "policy (tenancy disabled)", digest,
                    resident=[self.default_digest] if self.default_digest else ())
            if self._tenants.lookup_submit(digest) is None:
                raise TenantNotResidentError(
                    f"policy {digest} is not resident on this replica", digest,
                    resident=self._tenants.resident_digests())
        if self._closed.is_set():
            self._ctr["shed_stopped"].inc()
            telemetry.emit("shed", f"serve{self._server_id}", reason="stopped", n=int(n))
            raise ServerStoppedError("server is stopped/draining: not admitting requests")
        if self.breaker.is_open():
            self._ctr["shed_breaker"].inc()
            telemetry.emit("shed", f"serve{self._server_id}", reason="breaker_open",
                           n=int(n))
            raise CircuitOpenError("circuit breaker open: backend failing, not "
                                   "admitting requests",
                                   retry_after_s=self.breaker.retry_after_s())
        if keys is None and self.applier.dispatch == "exact":
            keys = self._auto_keys(n)
        elif keys is not None:
            keys = np.asarray(keys, np.uint32).reshape(n, 2)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = None if deadline_ms is None else mono() + float(deadline_ms) / 1e3
        pending = _Pending(images, keys, deadline, digest)
        if not self._q.offer(pending):
            self._ctr["shed_overload"].inc()
            telemetry.emit("shed", f"serve{self._server_id}", reason="overload", n=int(n))
            raise ServerOverloadedError(
                f"queue full ({self.queue_depth} requests): shedding",
                retry_after_s=max(0.05, self.max_wait_ms / 1e3))
        self._ctr["admitted"].inc()
        if self._tenants is not None and digest is not None:
            self._tenants.track_submit(digest)
        self._qdepth_gauge.set(len(self._q))
        return pending

    def result(self, pending: _Pending, timeout: float = 60.0) -> np.ndarray:
        """Block for a submitted request's augmented images.  A request with
        a deadline never waits much past it."""
        if pending.deadline is not None:
            left = pending.deadline - mono()
            timeout = min(timeout, max(0.0, left) + self.deadline_grace_s)
        if not pending.event.wait(timeout=timeout):
            raise TimeoutError(f"no result within {timeout:.3f}s ({pending.n} images)")
        if pending.error is not None:
            if isinstance(pending.error, (ServeError, CircuitOpenError)):
                raise pending.error
            raise ServeError(str(pending.error)) from pending.error
        return pending.result

    def augment(self, images: np.ndarray, keys: np.ndarray | None = None,
                timeout: float = 60.0, deadline_ms: float | None = None,
                digest: str | None = None) -> np.ndarray:
        """Submit + wait: the one-call client path."""
        return self.result(self.submit(images, keys, deadline_ms=deadline_ms,
                                       digest=digest), timeout=timeout)

    # ------------------------------------------------------ hot reload

    def swap_applier(self, new_applier: PolicyApplier) -> dict:
        """Atomically swap the serving applier (hot policy reload).

        The caller builds (and on the card captures) `new_applier` OFF TO
        THE SIDE; this only flips the reference.  The worker binds
        ``self.applier`` once per dispatch, so every batch is served by
        exactly one policy and queued requests are never dropped.  The old
        graphs are released once their in-flight dispatch completes."""
        self._validate_applier(new_applier, verb="reload")
        digest = getattr(new_applier, "digest", None)
        with self._lock:
            self.applier = new_applier
            self.default_digest = digest
            self._ctr["reloads"].inc()
            n = self.reloads
        telemetry.emit("reload", f"serve{self._server_id}", reloads=n,
                       num_sub=new_applier.num_sub, digest=digest)
        logger.info("hot reload #%d: applier swapped (%d sub-policies, digest %s)",
                    n, new_applier.num_sub, digest)
        return {"reloads": n, "num_sub": new_applier.num_sub, "digest": digest}

    # ---------------------------------------------------------- tenancy

    def _validate_applier(self, new_applier, verb: str = "tenant") -> None:
        """The serving contract every applier entering this server must
        satisfy: equal geometry, the same dispatch mode, shapes covering
        max_batch."""
        old = self.applier
        if (new_applier.image, new_applier.channels) != (old.image, old.channels):
            raise ValueError(f"{verb} changes served geometry {(old.image, old.channels)} "
                             f"-> {(new_applier.image, new_applier.channels)}")
        if new_applier.dispatch != old.dispatch:
            raise ValueError(f"{verb} changes dispatch mode {old.dispatch!r} -> "
                             f"{new_applier.dispatch!r}: queued keys would not fit")
        if new_applier.max_batch < self.max_batch:
            raise ValueError(f"new applier's largest shape {new_applier.max_batch} is "
                             f"below the server's max_batch {self.max_batch}")

    @property
    def tenancy_enabled(self) -> bool:
        return self._tenants is not None

    def resident_tenants(self) -> list[str]:
        """Resident tenant digests (LRU-first), the default excluded."""
        return [] if self._tenants is None else self._tenants.resident_digests()

    def warm_tenant(self, new_applier) -> dict:
        """Admit a built applier as a resident TENANT (the 1 -> N
        generalization of :meth:`swap_applier`).  Over capacity the LRU
        tenant starts retiring; its graphs are released at the next
        dispatch boundary once its queued work has drained."""
        if self._tenants is None:
            raise RuntimeError("tenancy is disabled on this server (tenant_capacity=0)")
        digest = getattr(new_applier, "digest", None)
        if not digest:
            raise ValueError("tenant applier carries no policy digest")
        if digest == self.default_digest:
            raise ValueError(f"policy {digest} is the pinned default tenant: use "
                             "swap_applier/reload to change it")
        self._validate_applier(new_applier, verb="tenant admit")
        evicted = self._tenants.admit(digest, new_applier)
        info = {"digest": digest, "evicted": evicted,
                "resident": self._tenants.resident_digests()}
        logger.info("tenant %s admitted (%d sub-policies; evicted: %s)", digest,
                    getattr(new_applier, "num_sub", 0), ",".join(evicted) or "-")
        return info

    def _tenant_done(self, p: _Pending) -> None:
        if self._tenants is not None and p.digest is not None:
            self._tenants.track_done(p.digest)

    def _tenant_counters(self, digest: str) -> tuple:
        c = self._tenant_ctrs.get(digest)
        if c is None:
            reg = telemetry.registry()
            c = (reg.counter("faa_tenant_requests_total", "requests served per tenant",
                             digest=digest, server=self._server_id),
                 reg.counter("faa_tenant_images_total", "images served per tenant",
                             digest=digest, server=self._server_id))
            self._tenant_ctrs[digest] = c
        return c

    # ---------------------------------------------------------- worker

    def _take_first(self) -> _Pending | None:
        if self._carry is not None:
            first, self._carry = self._carry, None
            return first
        return self._q.take(timeout=0.05)  # the stop/drain flags are polled between waits

    def _shed(self, p: _Pending, now: float) -> None:
        p.error = DeadlineExpiredError(
            f"deadline passed {now - p.deadline:.3f}s ago while queued "
            f"({p.n} images): request shed before dispatch")
        p.t_done = now
        p.event.set()
        self._tenant_done(p)
        self._ctr["expired"].inc()
        telemetry.emit("shed", f"serve{self._server_id}", reason="deadline_expired",
                       n=int(p.n))

    def _collect(self, first: _Pending) -> list[_Pending]:
        """Coalesce up to ``max_batch`` images or ``max_wait_ms`` after the
        first request; expired requests are shed, never batched, and a
        batch holds one tenant digest only."""
        batch: list[_Pending] = []
        count = 0
        digest = first.digest
        now = mono()
        if first.expired(now):
            self._shed(first, now)
        else:
            batch.append(first)
            count = first.n
        deadline = mono() + self.max_wait_ms / 1e3
        while count < self.max_batch:
            remaining = deadline - mono()
            if remaining <= 0:
                break
            nxt = self._q.take(timeout=remaining)
            if nxt is None:
                break
            now = mono()
            if nxt.expired(now):
                self._shed(nxt, now)
                continue
            if not batch:
                digest = nxt.digest  # the first admitted member sets the tenant
            elif nxt.digest != digest or count + nxt.n > self.max_batch:
                self._carry = nxt  # never split a request or mix tenants; FIFO kept
                break
            batch.append(nxt)
            count += nxt.n
        self._qdepth_gauge.set(len(self._q))
        return batch

    def _fail_batch(self, batch: list[_Pending], err: BaseException) -> None:
        done = mono()
        for p in batch:
            p.error = err
            p.t_done = done
            p.event.set()
            self._tenant_done(p)

    def _injected_fault(self) -> tuple[str, float] | None:
        """Consult the FAA_FAULT serve verbs with the 1-based dispatch
        attempt counter."""
        from fast_autoaugment_tpu_torch.utils.faultinject import active_plan

        plan = active_plan()
        if plan is None:
            return None
        return plan.serve_fault(self._dispatch_attempts)

    def _injected_drift(self, images: np.ndarray) -> np.ndarray:
        """The ``drift@dispatch=N,shift=S`` seam: from the matching dispatch
        on, every input batch is shifted by S (clipped to [0, 255]) before
        statistics and device work."""
        from fast_autoaugment_tpu_torch.utils.faultinject import active_plan

        plan = active_plan()
        if plan is None:
            return images
        shift = plan.drift_shift(self._dispatch_attempts)
        if shift is None:
            return images
        return np.clip(images.astype(np.float32, copy=False) + shift, 0.0, 255.0)

    def _observe_traffic(self, images: np.ndarray, out: np.ndarray) -> dict:
        """Update the served-traffic EMAs and gauges from one dispatched
        batch and return the journal fields for its dispatch event."""
        m = float(np.mean(images))
        s = float(np.std(images))
        proxy = float(np.mean(np.abs(np.asarray(out, np.float32) - images))) / 255.0
        for name, v in (("input_mean", m), ("input_std", s), ("reward_proxy", proxy)):
            prev = self._traffic_ema[name]
            ema = v if prev is None else 0.2 * v + 0.8 * prev
            self._traffic_ema[name] = ema
            self._traffic_gauges[name].set(ema)
        self._traffic_samples += 1
        return {"input_mean": round(m, 4), "input_std": round(s, 4),
                "reward_proxy": round(proxy, 6)}

    def observe_stage(self, stage: str, sec: float) -> None:
        """One observation into ``faa_serve_stage_seconds{stage=}``
        (queue_wait / pad / h2d / dispatch / scatter here; decode /
        serialize from the HTTP front)."""
        h = self._stage_hist.get(stage)
        if h is None:
            h = telemetry.registry().histogram(
                "faa_serve_stage_seconds", "serving data-plane per-stage overhead (seconds)",
                buckets=_STAGE_BUCKETS, stage=stage, server=self._server_id)
            self._stage_hist[stage] = h
        h.observe(sec)

    def _dispatch(self, batch: list[_Pending]) -> None:
        """The sequential dispatch: stage, dispatch, read back, scatter."""
        inf = self._dispatch_begin(batch)
        if inf is not None:
            self._dispatch_finish(inf)

    def _dispatch_begin(self, batch: list[_Pending]) -> _InflightBatch | None:
        """Bind ONE applier, stage the batch and dispatch it without
        reading back.  None when the batch already failed (typed error
        delivered)."""
        digest = batch[0].digest
        if digest is None:
            applier = self.applier
        else:
            applier = (self._tenants.lookup_dispatch(digest)
                       if self._tenants is not None else None)
            if applier is None:
                self._fail_batch(batch, TenantNotResidentError(
                    f"policy {digest} was evicted before dispatch", digest,
                    resident=self._tenants.resident_digests() if self._tenants else ()))
                return None
        self._dispatch_attempts += 1
        if self.breaker.enabled and not self.breaker.allow():
            err = CircuitOpenError("circuit breaker open: dispatch failed fast",
                                   retry_after_s=self.breaker.retry_after_s())
            self._ctr["shed_breaker"].inc(len(batch))
            telemetry.emit("shed", f"serve{self._server_id}", reason="breaker_open",
                           n=len(batch))
            self._fail_batch(batch, err)
            return None
        stages: dict[str, float] = {"queue_wait": mono() - batch[0].t_submit}
        images = np.concatenate([p.images for p in batch])
        images = self._injected_drift(images)
        if applier.dispatch == "exact":
            keys = np.concatenate([p.keys for p in batch])
        else:
            keys = self._auto_keys(1)[0]  # one key per dispatch
        fault = self._injected_fault()
        t0 = mono()
        try:
            if fault is not None and fault[0] == "error":
                raise ServeError(f"faultinject: serve_error at dispatch "
                                 f"{self._dispatch_attempts}")
            if fault is not None and fault[0] == "slow":
                base = self._wall_ema if self._wall_ema else 1.0
                time.sleep(min(fault[1] * base, 300.0))
            if self.dispatch_floor_s > 0.0:
                time.sleep(self.dispatch_floor_s)
            fn = getattr(applier, "apply_async", None)
            if fn is not None:
                handle = fn(images, keys, stages=stages)
            else:
                handle = _EagerApply(applier.apply(images, keys))
        except Exception as e:  # noqa: BLE001 -- delivered to every caller
            logger.error("serving dispatch failed (%d images): %s", images.shape[0], e)
            self.breaker.record_failure()
            self._fail_batch(batch, e if isinstance(e, ServeError)
                             else ServeError(f"{type(e).__name__}: {e}"))
            return None
        return _InflightBatch(batch, handle, applier, digest, int(images.shape[0]), t0,
                              stages, images=images if self.traffic_stats else None)

    def _dispatch_finish(self, inf: _InflightBatch) -> None:
        """Read an in-flight batch back and scatter it (FIFO); the breaker
        verdict, counters, stage histograms and the dispatch journal event
        land here."""
        batch, digest = inf.batch, inf.digest
        try:
            out = inf.handle.materialize(stages=inf.stages)
        except Exception as e:  # noqa: BLE001 -- delivered to every caller
            logger.error("serving dispatch failed (%d images): %s", inf.n_images, e)
            self.breaker.record_failure()
            self._fail_batch(batch, ServeError(f"{type(e).__name__}: {e}"))
            return
        wall = mono() - inf.t0
        if self.dispatch_timeout_s > 0 and wall > self.dispatch_timeout_s:
            logger.warning("dispatch took %.3fs > dispatch_timeout %.3fs: counted as a "
                           "breaker failure", wall, self.dispatch_timeout_s)
            self.breaker.record_failure()
        else:
            self.breaker.record_success()
        t_sc = mono()
        lo, misses = 0, 0
        served = getattr(inf.applier, "digest", None)
        for p in batch:
            p.result = out[lo:lo + p.n]
            p.served = served
            lo += p.n
            p.t_done = t_sc
            misses += p.deadline is not None and t_sc > p.deadline
            p.event.set()
            self._tenant_done(p)
        _acc_stage(inf.stages, "scatter", mono() - t_sc)
        self._dispatches_ctr.inc()
        self._requests_ctr.inc(len(batch))
        self._images_ctr.inc(inf.n_images)
        if digest is not None:
            t_reqs, t_imgs = self._tenant_counters(digest)
            t_reqs.inc(len(batch))
            t_imgs.inc(inf.n_images)
        if misses:
            self._ctr["deadline_misses"].inc(misses)
        with self._lock:
            self.batch_sizes.append(inf.n_images)
            self.dispatch_walls.append(wall)
        for stage, sec in inf.stages.items():
            self.observe_stage(stage, sec)
        traffic = (self._observe_traffic(inf.images, out)
                   if self.traffic_stats and inf.images is not None else {})
        telemetry.record_dispatch("serve_dispatch", inf.t0, t_sc, batch=inf.n_images,
                                  requests=len(batch), **traffic)
        self._wall_ema = wall if self._wall_ema is None else 0.2 * wall + 0.8 * self._wall_ema

    def _run(self) -> None:
        # double-buffered mode: at most one batch is in flight while the
        # worker collects and stages the next; the in-flight handle holds a
        # strong applier reference, so the sweep stays safe at every boundary
        inflight: _InflightBatch | None = None
        while not self._stop.is_set():
            first = self._take_first()
            if first is None:
                if inflight is not None:
                    self._dispatch_finish(inflight)
                    inflight = None
                if self._closed.is_set():
                    break  # draining and the queue ran dry: done
                continue
            batch = self._collect(first)
            if batch:
                if self.double_buffer:
                    nxt = self._dispatch_begin(batch)
                    if inflight is not None:
                        self._dispatch_finish(inflight)  # k+1 is dispatched: read k back
                    inflight = nxt
                    if inflight is not None and self._carry is None and self._q.empty():
                        # nothing to overlap with: deliver now
                        self._dispatch_finish(inflight)
                        inflight = None
                else:
                    self._dispatch(batch)
            if self._tenants is not None:
                self._tenants.sweep()  # the dispatch boundary
        if inflight is not None:
            self._dispatch_finish(inflight)
        # stopped: in-flight clients must not hang
        leftovers = [self._carry] if self._carry is not None else []
        self._carry = None
        leftovers.extend(self._q.drain())
        if leftovers:
            self._ctr["shed_stopped"].inc(len(leftovers))
            telemetry.emit("shed", f"serve{self._server_id}", reason="stopped",
                           n=len(leftovers))
        for p in leftovers:
            p.error = ServerStoppedError("server stopped")
            p.t_done = mono()
            p.event.set()
            self._tenant_done(p)

    # ----------------------------------------------------------- stats

    @property
    def admitted(self) -> int:
        return int(self._ctr["admitted"].value)

    @property
    def shed_overload(self) -> int:
        return int(self._ctr["shed_overload"].value)

    @property
    def shed_breaker(self) -> int:
        return int(self._ctr["shed_breaker"].value)

    @property
    def shed_stopped(self) -> int:
        return int(self._ctr["shed_stopped"].value)

    @property
    def expired(self) -> int:
        return int(self._ctr["expired"].value)

    @property
    def deadline_misses(self) -> int:
        return int(self._ctr["deadline_misses"].value)

    @property
    def reloads(self) -> int:
        return int(self._ctr["reloads"].value)

    @property
    def dispatches(self) -> int:
        return int(self._dispatches_ctr.value)

    @property
    def requests(self) -> int:
        return int(self._requests_ctr.value)

    @property
    def images_served(self) -> int:
        return int(self._images_ctr.value)

    def stats(self) -> dict:
        with self._lock:
            sizes = list(self.batch_sizes)
            walls = list(self.dispatch_walls)
        applier = self.applier
        out = {
            "dispatches": self.dispatches,
            "requests": self.requests,
            "images_served": self.images_served,
            "max_batch": self.max_batch,
            "max_wait_ms": self.max_wait_ms,
            "dispatch": applier.dispatch,
            "shapes": list(applier.shapes),
            "num_op": getattr(applier, "num_op", None),
            "device": str(getattr(applier, "device", "")),
            "graphs": bool(getattr(applier, "graphed", False)),
            "admission": {
                "queue_depth": self.queue_depth,
                "queued": len(self._q),
                "admitted": self.admitted,
                "shed_overload": self.shed_overload,
                "shed_breaker": self.shed_breaker,
                "shed_stopped": self.shed_stopped,
                "expired": self.expired,
                "deadline_misses": self.deadline_misses,
                "lifo_takes": self._q.lifo_takes,
                "lifo_depth": self._q.lifo_depth,
                "lifo_age_ms": self._q.lifo_age_ms,
                "default_deadline_ms": self.default_deadline_ms,
            },
            "breaker": self.breaker.snapshot(),
            "reloads": self.reloads,
            "draining": self._closed.is_set(),
            "default_digest": self.default_digest,
            "policy_digest": self.default_digest,
        }
        if getattr(applier, "donate", False) or self.double_buffer:
            out["data_plane"] = {"donate": bool(getattr(applier, "donate", False)),
                                 "double_buffer": self.double_buffer}
        if self.traffic_stats:
            out["traffic"] = {"samples": self._traffic_samples,
                              **{k: (None if v is None else round(v, 6))
                                 for k, v in self._traffic_ema.items()}}
        if self._tenants is not None:
            out["tenancy"] = self._tenants.snapshot()
        if sizes:
            out["mean_batch"] = round(float(np.mean(sizes)), 2)
            out["mean_dispatch_ms"] = round(float(np.mean(walls)) * 1e3, 3)
        return out
