"""Deterministic shared-filesystem fault seam: ``FAA_FSFAULT``.

The port's copy of ``fast_autoaugment_tpu/core/fsfault.py``, with the
same grammar and the same behaviour.  The serving plane's shared
directories (the router's ``--port-dir`` replica records, the replicas'
``--heartbeat-dir`` beats) run over a directory every host mounts, and
silently assume that directory is POSIX-honest: writes become visible
everywhere immediately, re-reads never go backwards, reads never fail
transiently, and every host's wall clock agrees.  Real shared
substrates (NFS attribute caches, object-store gateways, preempted VMs
with drifting clocks) break every one of those assumptions routinely.

This module is the single seam through which those layers read, list
and write shared files, and the place those assumptions are
deliberately broken, under a seeded, deterministic plan, so the
hardening in those layers is driven by tests instead of trusted on
faith (the ``FAA_FAULT`` discipline of ``utils/faultinject.py``,
extended to the filesystem).

Grammar — semicolon-separated specs, ``kind@key=value[,key=value]``::

    FAA_FSFAULT="lag@dir=work,secs=2;skew@host=1,offset=45;eio@p=0.05,seed=7"

``lag@dir=GLOB,secs=S``
    Delayed cross-host visibility: files under a directory whose NAME
    matches GLOB (component-wise fnmatch) are INVISIBLE to reads,
    listings and stats until S seconds after their mtime — except to
    the process that wrote them through this seam (close-to-open
    consistency: the writer always sees its own writes, remote hosts
    lag).  Models an NFS attribute/lookup cache or an async-replicated
    share.
``stale@dir=GLOB,window=S``
    Stale re-reads: a re-read of a matched file within S seconds of
    its last modification returns the PREVIOUS version this process
    observed (per-process content cache) instead of the fresh bytes —
    the classic stale-attribute-cache read.  After the window, reads
    see the new version.
``eio@p=P,seed=N``
    Transient read/list errors: every seam read/list consult draws
    from the seeded Bernoulli stream and raises ``OSError(EIO)`` with
    probability P.  The seam itself retries transient EIO/ESTALE a
    bounded number of times (that retry IS the hardening — remote
    filesystems return these for real), so callers see a failure only
    on an unlucky streak.
``skew@host=H,offset=±S``
    Per-host wall-clock offset, applied at the telemetry ``wall()``
    seam (``core/telemetry.py``) when ``FAA_HOST_ID`` matches H: every
    wall stamp this host writes (lease heartbeats, journal events,
    completion markers) is S seconds off.  Monotonic clocks are
    untouched, so observer-local staleness checks survive it.
``torn@path=GLOB``
    Truncated tails: the FIRST seam read of each file whose basename
    (or full path) matches GLOB returns the content with its tail cut
    off — the half-flushed file a reader can catch on a live share.
    Later reads see the full content (the write completed).

With ``FAA_FSFAULT`` unset every primitive is a thin passthrough
behind one cached ``None`` check — no new artifact keys, no behavior
change, and the ``wall()`` consult is a dict lookup.  Tests call
:func:`reset` after mutating the env var, exactly like
``faultinject.reset``.

Injections are counted per kind (``faa_fsfault_injections_total``
registry counter + a typed ``fsfault`` journal event per injection), so
a drill's journal shows what the substrate did to it.
"""

from __future__ import annotations

import errno
import fnmatch
import json
import os
import random
import threading
import time

from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["FsFaultPlan", "active_plan", "reset", "parse_fsfault_spec",
           "wall_offset", "read_bytes", "read_json", "load_json",
           "read_from", "listdir", "glob_files", "getsize", "exists",
           "write_json_atomic", "ENV_VAR"]

logger = get_logger("faa_torch.fsfault")

ENV_VAR = "FAA_FSFAULT"

_KINDS = {
    "lag": ("dir", "secs"),
    "stale": ("dir", "window"),
    "eio": ("p", "seed"),
    "skew": ("host", "offset"),
    "torn": ("path",),
}
_FLOAT_KEYS = {"secs", "window", "p", "offset"}
_STR_KEYS = {"dir", "path", "host"}
_OPTIONAL = {"seed"}

#: bounded in-seam retries for transient EIO/ESTALE (real remote
#: filesystems surface these; the retry is the hardening under test)
_TRANSIENT_ERRNOS = (errno.EIO, getattr(errno, "ESTALE", errno.EIO))
_READ_RETRIES = 3
_RETRY_SLEEP_S = 0.02


def parse_fsfault_spec(spec: str) -> list[dict]:
    """Parse the ``FAA_FSFAULT`` grammar.  Raises ValueError on unknown
    kinds/keys or malformed values — a typo must fail loudly, never
    silently inject nothing (the ``FAA_FAULT`` contract)."""
    faults = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise ValueError(
                f"bad fsfault spec {part!r}: expected "
                "kind@key=value[,key=value]")
        kind, _, argstr = part.partition("@")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fsfault kind {kind!r}: known {sorted(_KINDS)}")
        args: dict = {}
        for kv in argstr.split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(f"bad fsfault arg {kv!r} in {part!r}")
            key, _, val = kv.partition("=")
            key = key.strip()
            if key not in _KINDS[kind]:
                raise ValueError(
                    f"fsfault {kind!r} takes keys {_KINDS[kind]}, "
                    f"got {key!r}")
            if key in _FLOAT_KEYS:
                args[key] = float(val)
            elif key in _STR_KEYS:
                val = val.strip()
                if not val:
                    raise ValueError(
                        f"fsfault {kind!r} key {key!r} is empty")
                args[key] = val
            else:
                args[key] = int(val)
        missing = [k for k in _KINDS[kind]
                   if k not in args and k not in _OPTIONAL]
        if missing:
            raise ValueError(f"fsfault {kind!r} missing keys {missing}")
        if kind == "eio":
            args.setdefault("seed", 0)
            if not 0.0 <= args["p"] <= 1.0:
                raise ValueError(f"eio p={args['p']} outside [0, 1]")
        faults.append({"kind": kind, **args})
    return faults


def _dir_matches(path: str, pattern: str) -> bool:
    """True when any DIRECTORY component of `path` fnmatches `pattern`
    (``lag@dir=work`` hits every file under any ``work/``)."""
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    return any(fnmatch.fnmatch(p, pattern) for p in parts[:-1] if p)


class FsFaultPlan:
    """The parsed plan plus per-kind trigger state (one per process,
    cached by env value like ``faultinject.FaultPlan``)."""

    def __init__(self, faults: list[dict]):
        self.faults = faults
        self._lag = [f for f in faults if f["kind"] == "lag"]
        self._stale = [f for f in faults if f["kind"] == "stale"]
        self._torn = [f for f in faults if f["kind"] == "torn"]
        self._eio_rng = None
        self._eio_p = 0.0
        for f in faults:
            if f["kind"] == "eio":
                self._eio_rng = random.Random(int(f["seed"]))
                self._eio_p = float(f["p"])
        #: the wall offset for THIS host (resolved once per plan —
        #: tests that flip FAA_HOST_ID call reset())
        self.wall_offset = 0.0
        hid = str(os.environ.get("FAA_HOST_ID", "0"))
        for f in faults:
            if f["kind"] == "skew" and str(f["host"]) in (hid, f"host{hid}"):
                self.wall_offset += float(f["offset"])
        #: paths THIS process wrote through the seam (the writer always
        #: sees its own writes; only cross-host visibility lags)
        self.own_writes: set[str] = set()
        self._stale_cache: dict[str, bytes] = {}
        self._torn_fired: set[str] = set()
        #: injection counts per kind (mirrored to the metrics registry)
        self.injected: dict[str, int] = {}

    # ----------------------------------------------------------- record
    def _record(self, kind: str, path: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1
        try:  # lazy: telemetry imports this module for the wall() seam
            from fast_autoaugment_tpu_torch.core import telemetry

            telemetry.registry().counter(
                "faa_fsfault_injections_total",
                "shared-filesystem faults injected by the FAA_FSFAULT "
                "seam", kind=kind).inc()
            telemetry.emit("fsfault", kind, path=path)
        except Exception as e:  # noqa: BLE001 — accounting never breaks a read
            logger.debug("fsfault: injection accounting failed (%s)", e)

    # ---------------------------------------------------------- verdicts
    def eio_now(self) -> bool:
        if self._eio_rng is None:
            return False
        return self._eio_rng.random() < self._eio_p

    def lag_hidden(self, path: str, mtime: float) -> bool:
        """True when the file is not yet visible to THIS observer."""
        if not self._lag or os.path.abspath(path) in self.own_writes:
            return False
        now = time.time()
        for f in self._lag:
            if _dir_matches(path, f["dir"]) and mtime > now - f["secs"]:
                return True
        return False

    def stale_view(self, path: str, data: bytes, mtime: float) -> bytes:
        """The bytes this observer sees: the PREVIOUS version while a
        matched file's change is inside the stale window."""
        apath = os.path.abspath(path)
        matched = [f for f in self._stale if _dir_matches(path, f["dir"])
                   and apath not in self.own_writes]
        if matched:
            cached = self._stale_cache.get(apath)
            now = time.time()
            if cached is not None and cached != data and any(
                    mtime > now - f["window"] for f in matched):
                self._record("stale", path)
                return cached
            self._stale_cache[apath] = data
        return data

    def torn_view(self, path: str, data: bytes) -> bytes:
        """First read of a matched path loses its tail (latched per
        path: the torn state is transient, later reads see it whole)."""
        if not self._torn or not data:
            return data
        apath = os.path.abspath(path)
        if apath in self._torn_fired:
            return data
        base = os.path.basename(path)
        for f in self._torn:
            if fnmatch.fnmatch(base, f["path"]) \
                    or fnmatch.fnmatch(apath, f["path"]):
                self._torn_fired.add(apath)
                self._record("torn", path)
                cut = max(1, min(64, len(data) // 2))
                return data[:-cut]
        return data


_plan: FsFaultPlan | None = None
_plan_env: str | None = None


def active_plan() -> FsFaultPlan | None:
    """The process-wide plan, or None when ``FAA_FSFAULT`` is unset —
    parsed once per env VALUE (tests flip it between cases)."""
    global _plan, _plan_env
    env = os.environ.get(ENV_VAR, "")
    if env != _plan_env:
        _plan_env = env
        _plan = FsFaultPlan(parse_fsfault_spec(env)) if env.strip() else None
        if _plan is not None:
            logger.warning("fsfault: ACTIVE with %d fault(s): %s "
                           "(wall offset %+gs on this host)",
                           len(_plan.faults), env, _plan.wall_offset)
    return _plan


def reset() -> None:
    """Forget the cached plan and all trigger state (test isolation)."""
    global _plan, _plan_env
    _plan = None
    _plan_env = None


def wall_offset() -> float:
    """This host's injected wall-clock offset (the ``skew`` verb),
    consulted by ``telemetry.wall()``.  0.0 when no plan is active."""
    plan = active_plan()
    return plan.wall_offset if plan is not None else 0.0


# --------------------------------------------------------------------------
# shared-dir primitives — the ONLY file operations the shared-dir
# layers (the router's port dir, the replicas' beats) use
# --------------------------------------------------------------------------


def _consult_eio(plan: FsFaultPlan | None, path: str) -> None:
    if plan is not None and plan.eio_now():
        plan._record("eio", path)
        raise OSError(errno.EIO,
                      "injected transient I/O error (FAA_FSFAULT eio)")


def _with_retries(fn, path: str):
    """Run one read primitive with bounded retries on transient
    EIO/ESTALE — the seam-side hardening every remote filesystem
    needs.  Non-transient OSErrors (ENOENT, ...) propagate at once."""
    for attempt in range(_READ_RETRIES):
        try:
            return fn()
        except OSError as e:
            if e.errno in _TRANSIENT_ERRNOS and attempt < _READ_RETRIES - 1:
                time.sleep(_RETRY_SLEEP_S * (attempt + 1))
                continue
            raise


def read_bytes(path: str) -> bytes:
    """Read a shared file's bytes through the fault seam.  Raises
    OSError exactly like ``open`` would (a lag-hidden file raises
    ENOENT — it does not exist yet for this observer)."""
    plan = active_plan()
    if plan is None:
        with open(path, "rb") as fh:
            return fh.read()

    def _read():
        _consult_eio(plan, path)
        st = os.stat(path)
        if plan.lag_hidden(path, st.st_mtime):
            plan._record("lag", path)
            raise OSError(errno.ENOENT,
                          "not yet visible to this host "
                          "(FAA_FSFAULT lag)", path)
        with open(path, "rb") as fh:
            data = fh.read()
        data = plan.stale_view(path, data, st.st_mtime)
        return plan.torn_view(path, data)

    return _with_retries(_read, path)


def read_json(path: str) -> dict | None:
    """Absorbing JSON read: missing, mid-replace, torn or unparseable
    -> None (every shared-dir writer is atomic, so this is transient —
    the historical ``workqueue._read_json`` contract)."""
    try:
        data = read_bytes(path)
        return json.loads(data.decode())
    except (OSError, ValueError):
        return None


def load_json(path: str):
    """Strict JSON read: OSError/ValueError propagate (resume paths
    that must fail loudly on a missing or corrupt artifact)."""
    return json.loads(read_bytes(path).decode())


def read_from(path: str, offset: int) -> str:
    """Incremental tail read from `offset` (journal tailing).  Applies
    eio + torn (a torn tail is re-served whole on the next poll);
    raises OSError like ``open``/``seek`` would."""
    plan = active_plan()
    if plan is None:
        with open(path) as fh:
            fh.seek(offset)
            return fh.read()
    _consult_eio(plan, path)
    with open(path, "rb") as fh:
        fh.seek(offset)
        data = fh.read()
    return plan.torn_view(path, data).decode(errors="replace")


def listdir(d: str) -> list[str]:
    """Sorted directory listing through the seam: lag-hidden entries
    are omitted (they do not exist yet for this observer).  Raises
    OSError like ``os.listdir``."""
    plan = active_plan()
    if plan is None:
        return sorted(os.listdir(d))

    def _list():
        _consult_eio(plan, d)
        names = sorted(os.listdir(d))
        if not plan._lag:
            return names
        out = []
        for name in names:
            path = os.path.join(d, name)
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue  # vanished mid-listing: not visible
            if plan.lag_hidden(path, mtime):
                plan._record("lag", path)
                continue
            out.append(name)
        return out

    return _with_retries(_list, d)


def glob_files(pattern: str, recursive: bool = True) -> list[str]:
    """Sorted glob through the seam (journal-segment discovery):
    lag-hidden files are omitted; transient errors absorb to the
    already-visible set (the next poll retries)."""
    import glob as _glob

    plan = active_plan()
    paths = sorted(_glob.glob(pattern, recursive=recursive))
    if plan is None:
        return paths
    out = []
    for path in paths:
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            continue
        if plan.lag_hidden(path, mtime):
            plan._record("lag", path)
            continue
        out.append(path)
    return out


def getsize(path: str) -> int:
    """File size through the seam (lag-hidden -> ENOENT)."""
    plan = active_plan()
    if plan is None:
        return os.path.getsize(path)

    def _size():
        _consult_eio(plan, path)
        st = os.stat(path)
        if plan.lag_hidden(path, st.st_mtime):
            plan._record("lag", path)
            raise OSError(errno.ENOENT,
                          "not yet visible to this host "
                          "(FAA_FSFAULT lag)", path)
        return st.st_size

    return _with_retries(_size, path)


def exists(path: str) -> bool:
    """Existence through the seam (lag-hidden -> False)."""
    plan = active_plan()
    if plan is None:
        return os.path.exists(path)
    try:
        return getsize(path) >= 0
    except OSError:
        return False


def write_json_atomic(path: str, obj) -> None:
    """The canonical fsync-then-rename atomic write, recording the path as an own-write
    so the ``lag`` verb never hides a host's writes from itself.  The
    temporary file is the writer's own (pid and thread in its name), so
    hosts that write one shared path at once never rename each other's
    temporary away."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    plan = active_plan()
    if plan is not None:
        plan.own_writes.add(os.path.abspath(path))
