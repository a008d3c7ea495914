"""Policy application over padded batch shapes + the batch-coalescing server.

The counterpart of ``fast_autoaugment_tpu/serve/policy_server.py``.  Two
layers:

:class:`PolicyApplier` holds one learned policy on the device and applies
it to batches padded up to a small fixed set of shapes (the JAX package's
``AotPolicyApplier`` compiles one executable per shape; PyTorch runs
eagerly, so here each shape is simply one tensor path).  Its dispatch
modes follow the JAX package:

- ``exact``: one key per image.  Image i's sub-policy and draws come from
  its own key alone (:func:`~fast_autoaugment_tpu_torch.ops.augment.
  sample_exact`), so padded lanes cannot leak into results and a lane's
  output does not depend on which requests it was coalesced with.
- ``grouped``: one key per dispatch, drawn over the PADDED batch as the
  JAX package does: a permutation cut into chunks, one sub-policy per
  chunk (:func:`~fast_autoaugment_tpu_torch.ops.augment.sample_grouped`).
- ``auto``: exact for a single-sub policy, grouped otherwise.

Either way the batch goes through
:func:`~fast_autoaugment_tpu_torch.ops.augment.apply_subpolicy_draws`,
which on the card is the hand-written CUDA kernel.

:class:`PolicyServer` is the clean-weather core of the JAX server: a
bounded queue with fail-fast admission (typed
:class:`ServerOverloadedError`), coalescing up to ``max_batch`` images or
``max_wait_ms`` after the first queued request, per-request deadlines
that shed expired work before it reaches the device, FIFO scatter, and
graceful drain.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Callable, Sequence

import numpy as np
import torch

from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.core.telemetry import mono
from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.ops.augment import (
    apply_subpolicy_draws,
    check_policy,
    sample_draws,
)
from fast_autoaugment_tpu_torch.ops.rng import fold_in
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["PolicyApplier", "PolicyServer", "ServeError",
           "ServerOverloadedError", "ServerStoppedError",
           "DeadlineExpiredError", "DEFAULT_SHAPES", "pick_shape",
           "policy_digest", "resolve_device"]

logger = get_logger("faa_torch.serve")

#: padded batch shapes served by default: powers of four-ish so padding
#: waste stays < 4x at every load level
DEFAULT_SHAPES = (1, 8, 32, 128)

#: grace past a request's deadline that ``result()`` still waits, so the
#: shed pass can deliver the typed error
_DEADLINE_GRACE_S = 1.0


class ServeError(RuntimeError):
    """A serving dispatch failed; carried to every coalesced request."""


class ServerOverloadedError(ServeError):
    """Admission refused: the bounded queue is full (HTTP 429)."""

    def __init__(self, msg: str, retry_after_s: float = 0.05):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class ServerStoppedError(ServeError):
    """Admission refused or request abandoned: the server is stopped or
    draining (HTTP 503)."""


class DeadlineExpiredError(ServeError):
    """The request's deadline passed while it was queued; it was shed
    before dispatch (HTTP 503)."""


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
    the JAX package's ``policy_digest``)."""
    arr = np.ascontiguousarray(np.asarray(policy, np.float32))
    h = hashlib.sha256()
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()[:12]


#: a draw source: (dispatch, keys, batch, *, num_sub, num_op, height,
#: width, groups, device) -> (sub_idx [batch], draws [batch, num_op, 4])
DrawSource = Callable[..., tuple[torch.Tensor, torch.Tensor]]


class PolicyApplier:
    """One learned policy, applied on `device` over fixed padded shapes.

    ``policy`` is the ``[num_sub, num_op, 3]`` tensor
    (``policies.archive.policy_to_tensor``).  ``shapes`` are the padded
    batch sizes, ascending.  ``draw_source`` turns keys into draws; the
    default is the port's counter-based sampler
    (:func:`~fast_autoaugment_tpu_torch.ops.augment.sample_draws`), and
    the tests pass one that replays the JAX key tree.  On a CUDA device the
    kernel is built when the applier is made, so the first request does
    not pay for ``nvcc``.
    """

    def __init__(self, policy, *, image: int = 32,
                 shapes: Sequence[int] = DEFAULT_SHAPES,
                 dispatch: str = "auto", groups: int = 8,
                 device="cuda", draw_source: DrawSource | None = None):
        arr = check_policy(policy)
        self.device = resolve_device(device)
        self.policy = torch.as_tensor(arr, device=self.device)
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
        self.draw_source = draw_source or sample_draws
        if self.device.type == "cuda":
            _kernels.load_libraries()
        logger.info("policy applier ready: %d sub-policies, dispatch=%s, "
                    "shapes=%s, device=%s", self.num_sub, dispatch,
                    list(self.shapes), self.device)

    def apply(self, images: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """Apply the policy to ``images [n, H, W, C]`` (uint8 or integral
        float32 in [0, 255]) and return float32 integral images.

        ``exact``: `keys` is ``[n, 2]`` uint32, one key per image.
        ``grouped``: `keys` is one ``[2]`` key for the dispatch.  Batches
        larger than the largest shape are chunked (a grouped chunk after
        the first gets ``fold_in(key, chunk)``); smaller ones pad up with
        zero images and zero keys whose results are sliced away."""
        images = np.asarray(images)
        if images.ndim != 4:
            raise ValueError(f"images must be [n, H, W, C], got {images.shape}")
        expect = (self.image, self.image, self.channels)
        if images.shape[1:] != expect:
            raise ValueError(f"images are {images.shape[1:]}, this applier serves "
                             f"{expect}: resize/crop client-side")
        n = images.shape[0]
        keys = np.asarray(keys, np.uint32)
        if self.dispatch == "exact":
            keys = keys.reshape(n, 2)
        else:
            keys = keys.reshape(2)
        out = np.empty((n,) + expect, np.float32)
        for chunk, lo in enumerate(range(0, n, self.max_batch)):
            hi = min(lo + self.max_batch, n)
            if self.dispatch == "exact":
                k = keys[lo:hi]
            elif chunk == 0:
                k = keys
            else:
                k = fold_in(torch.as_tensor(keys.astype(np.int64)), chunk)
                k = k.numpy().astype(np.uint32)
            out[lo:hi] = self._dispatch_one(images[lo:hi], k)
        return out

    def _dispatch_one(self, images: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """Pad one chunk on the device, draw, apply, copy the real rows back."""
        n = images.shape[0]
        s = pick_shape(self.shapes, n)
        x = torch.zeros((s,) + images.shape[1:], dtype=torch.float32,
                        device=self.device)
        host = images.astype(np.float32, copy=not images.flags.writeable)
        x[:n] = torch.from_numpy(host)
        if self.dispatch == "exact":
            keys = np.concatenate([keys, np.zeros((s - n, 2), np.uint32)])
        sub_idx, draws = self.draw_source(
            self.dispatch, keys, s, num_sub=self.num_sub, num_op=self.num_op,
            height=self.image, width=self.image, groups=self.groups,
            device=self.device)
        y = apply_subpolicy_draws(x, self.policy, sub_idx.to(self.device),
                                  draws.to(self.device))
        return y[:n].cpu().numpy()


class _Pending:
    """One admitted request: its images, keys, deadline and result slot."""

    __slots__ = ("images", "keys", "deadline", "t_submit", "t_done",
                 "event", "result", "error")

    def __init__(self, images: np.ndarray, keys: np.ndarray | None,
                 deadline: float | None):
        self.images = images
        self.keys = keys
        self.deadline = deadline
        self.t_submit = mono()
        self.t_done: float | None = None
        self.event = threading.Event()
        self.result: np.ndarray | None = None
        self.error: BaseException | None = None

    @property
    def n(self) -> int:
        return int(self.images.shape[0])

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class _RequestQueue:
    """A bounded FIFO whose ``offer`` never blocks (a full queue refuses)."""

    def __init__(self, depth: int):
        self.depth = int(depth)
        self._items: collections.deque[_Pending] = collections.deque()
        self._cond = threading.Condition()

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def offer(self, item: _Pending) -> bool:
        with self._cond:
            if len(self._items) >= self.depth:
                return False
            self._items.append(item)
            self._cond.notify()
            return True

    def take(self, timeout: float) -> _Pending | None:
        with self._cond:
            if not self._items:
                self._cond.wait(timeout=max(0.0, timeout))
            return self._items.popleft() if self._items else None

    def drain(self) -> list[_Pending]:
        with self._cond:
            items = list(self._items)
            self._items.clear()
            return items


class PolicyServer:
    """Batch-coalescing, overload-safe request front for a
    :class:`PolicyApplier`.

    The worker collects requests until ``max_batch`` images are queued or
    ``max_wait_ms`` has passed since the first one, dispatches them as one
    padded batch and scatters the rows back in FIFO order.  A request that
    would overflow the batch is carried whole to the next dispatch.
    ``submit`` never blocks: a full queue raises
    :class:`ServerOverloadedError`, a stopped or draining server
    :class:`ServerStoppedError`.  A request whose deadline passes while
    queued is shed with :class:`DeadlineExpiredError` before dispatch.
    """

    def __init__(self, applier: PolicyApplier, *,
                 max_batch: int | None = None, max_wait_ms: float = 5.0,
                 queue_depth: int = 4096, seed: int = 0,
                 default_deadline_ms: float | None = None):
        self.applier = applier
        self.max_batch = int(max_batch or applier.max_batch)
        if self.max_batch > applier.max_batch:
            raise ValueError(f"max_batch {self.max_batch} exceeds the largest "
                             f"shape {applier.max_batch}")
        self.max_wait_ms = float(max_wait_ms)
        self.queue_depth = int(queue_depth)
        self.default_deadline_ms = (None if default_deadline_ms is None
                                    else float(default_deadline_ms))
        self._q = _RequestQueue(self.queue_depth)
        self._carry: _Pending | None = None
        self._stop = threading.Event()
        self._closed = threading.Event()  # admission gate (stop or drain)
        self._worker: threading.Thread | None = None
        self._seed = int(seed)
        self._auto_key_counter = 0
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(
            ("admitted", "shed_overload", "shed_stopped", "expired",
             "deadline_misses", "dispatches", "requests", "images_served"), 0)
        self._dispatch_wall_s = 0.0  # summed over dispatches, for the mean

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    # ------------------------------------------------------- lifecycle

    def start(self) -> "PolicyServer":
        if self._worker is not None and self._worker.is_alive():
            return self
        self._stop.clear()
        self._closed.clear()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="policy-server")
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
        if self._worker is not None:
            self._worker.join(timeout=max(0.0, float(timeout)))
        drained = len(self._q) == 0 and self._carry is None \
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
               deadline_ms: float | None = None) -> _Pending:
        """Queue ``images [n, H, W, C]`` (or one ``[H, W, C]`` image).

        `keys` (``[n, 2]`` uint32) pins the per-image draws; None lets the
        server derive them.  `deadline_ms` (relative; default the server's
        ``default_deadline_ms``) is the time after which the request is
        shed instead of dispatched.  Never blocks."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        n = images.shape[0]
        if n < 1:
            raise ValueError("empty request")
        if n > self.max_batch:
            raise ValueError(f"request of {n} images exceeds max_batch "
                             f"{self.max_batch}: split client-side")
        if self._closed.is_set():
            self._count("shed_stopped")
            raise ServerStoppedError("server is stopped/draining: not admitting requests")
        if keys is None and self.applier.dispatch == "exact":
            keys = self._auto_keys(n)
        elif keys is not None:
            keys = np.asarray(keys, np.uint32).reshape(n, 2)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = None if deadline_ms is None else mono() + float(deadline_ms) / 1e3
        pending = _Pending(images, keys, deadline)
        if not self._q.offer(pending):
            self._count("shed_overload")
            raise ServerOverloadedError(
                f"queue full ({self.queue_depth} requests): shedding",
                retry_after_s=max(0.05, self.max_wait_ms / 1e3))
        self._count("admitted")
        return pending

    def result(self, pending: _Pending, timeout: float = 60.0) -> np.ndarray:
        """Block for a submitted request's augmented images.  A request with
        a deadline never waits much past it."""
        if pending.deadline is not None:
            left = pending.deadline - mono()
            timeout = min(timeout, max(0.0, left) + _DEADLINE_GRACE_S)
        if not pending.event.wait(timeout=timeout):
            raise TimeoutError(f"no result within {timeout:.3f}s ({pending.n} images)")
        if pending.error is not None:
            if isinstance(pending.error, ServeError):
                raise pending.error
            raise ServeError(str(pending.error)) from pending.error
        return pending.result

    def augment(self, images: np.ndarray, keys: np.ndarray | None = None,
                timeout: float = 60.0, deadline_ms: float | None = None) -> np.ndarray:
        """Submit + wait: the one-call client path."""
        return self.result(self.submit(images, keys, deadline_ms=deadline_ms),
                           timeout=timeout)

    # ---------------------------------------------------------- worker

    def _take_first(self) -> _Pending | None:
        if self._carry is not None:
            first, self._carry = self._carry, None
            return first
        return self._q.take(timeout=0.05)  # the stop/drain flags are polled between waits

    def _finish(self, p: _Pending, *, result=None, error=None) -> None:
        p.result, p.error = result, error
        p.t_done = mono()
        p.event.set()

    def _shed(self, p: _Pending, now: float) -> None:
        self._finish(p, error=DeadlineExpiredError(
            f"deadline passed {now - p.deadline:.3f}s ago while queued "
            f"({p.n} images): request shed before dispatch"))
        self._count("expired")

    def _collect(self, first: _Pending) -> list[_Pending]:
        """Coalesce up to ``max_batch`` images or ``max_wait_ms`` after the
        first request; expired requests are shed, never batched."""
        batch: list[_Pending] = []
        count = 0
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
            if count + nxt.n > self.max_batch:
                self._carry = nxt  # never split a request; FIFO kept
                break
            batch.append(nxt)
            count += nxt.n
        return batch

    def _dispatch(self, batch: list[_Pending]) -> None:
        images = np.concatenate([p.images for p in batch])
        if self.applier.dispatch == "exact":
            keys = np.concatenate([p.keys for p in batch])
        else:
            keys = self._auto_keys(1)[0]  # one key per dispatch
        t0 = mono()
        try:
            out = self.applier.apply(images, keys)
        except Exception as e:  # noqa: BLE001 -- delivered to every caller
            logger.exception("serving dispatch failed (%d images)", images.shape[0])
            err = e if isinstance(e, ServeError) else ServeError(f"{type(e).__name__}: {e}")
            for p in batch:
                self._finish(p, error=err)
            return
        done = mono()
        lo, misses = 0, 0
        for p in batch:
            self._finish(p, result=out[lo:lo + p.n])
            lo += p.n
            misses += p.deadline is not None and done > p.deadline
        with self._lock:
            self._counts["dispatches"] += 1
            self._counts["requests"] += len(batch)
            self._counts["images_served"] += int(images.shape[0])
            self._counts["deadline_misses"] += misses
            self._dispatch_wall_s += done - t0

    def _run(self) -> None:
        while not self._stop.is_set():
            first = self._take_first()
            if first is None:
                if self._closed.is_set():
                    break  # draining and the queue ran dry: done
                continue
            batch = self._collect(first)
            if batch:
                self._dispatch(batch)
        # stopped: in-flight clients must not hang
        leftovers = [self._carry] if self._carry is not None else []
        self._carry = None
        leftovers.extend(self._q.drain())
        self._count("shed_stopped", len(leftovers))
        for p in leftovers:
            self._finish(p, error=ServerStoppedError("server stopped"))

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            c = dict(self._counts)
            wall_s = self._dispatch_wall_s
        out = {
            "dispatches": c["dispatches"],
            "requests": c["requests"],
            "images_served": c["images_served"],
            "max_batch": self.max_batch,
            "max_wait_ms": self.max_wait_ms,
            "dispatch": self.applier.dispatch,
            "shapes": list(self.applier.shapes),
            "num_op": self.applier.num_op,
            "device": str(self.applier.device),
            "admission": {
                "queue_depth": self.queue_depth,
                "queued": len(self._q),
                "admitted": c["admitted"],
                "shed_overload": c["shed_overload"],
                "shed_stopped": c["shed_stopped"],
                "expired": c["expired"],
                "deadline_misses": c["deadline_misses"],
                "default_deadline_ms": self.default_deadline_ms,
            },
            "draining": self._closed.is_set(),
            "policy_digest": self.applier.digest,
        }
        if c["dispatches"]:
            out["mean_batch"] = round(c["images_served"] / c["dispatches"], 2)
            out["mean_dispatch_ms"] = round(wall_s / c["dispatches"] * 1e3, 3)
        return out
