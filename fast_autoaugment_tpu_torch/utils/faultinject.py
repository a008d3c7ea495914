"""Deterministic fault injection: ``FAA_FAULT`` -> seeded trigger points
(the port's copy of ``fast_autoaugment_tpu/utils/faultinject.py``).

The grammar is the JAX package's, unchanged, so one spec string drives
both packages: semicolon-separated specs, each
``kind@key=value[,key=value]``::

    FAA_FAULT="nan_loss@step=7;sigterm@step=12;torn_ckpt@save=3"

Every kind of the JAX grammar parses (a typo fails loudly).  The port's
seams consult these:

``nan_loss@step=K``
    The epoch whose step range covers global step K reads back a NaN
    train loss (the trainer's loss readout).
``sigterm@step=K`` / ``sigusr1@step=K`` / ``sigkill@step=K``
    The signal is delivered to this process once global step >= K
    (consulted after every dispatch or batch).
``torn_ckpt@save=N`` / ``corrupt_ckpt@save=N``
    The N-th ``save_checkpoint`` writes half its payload under the full
    payload's digest (a torn write), or flips a byte after the digest.
``trial_error@trial=K``
    Phase 2 raises at trial K (per fold): the quarantine path.
``sigkill_trial@trial=K``
    SIGKILL once a phase-2 evaluation covers trial K or later.
``hang@step=K``
    The dispatch covering step K sleeps forever inside the watched region
    (``core/watchdog.py``).
``slow@step=K,factor=F``
    The dispatch covering step K takes F x the watchdog's EMA for its
    label (F seconds before any observation).

The serving plane consults these:

``serve_error@dispatch=N`` / ``serve_slow@dispatch=N,factor=F``
    The policy server's N-th dispatch attempt (1-based) raises a serving
    error, or sleeps F x the dispatch-wall EMA first (F seconds before
    any observation) (``serve/policy_server.py``).
``drift@dispatch=N,shift=S``
    From the policy server's N-th dispatch on, every input batch is
    shifted by S pixel levels (clipped to [0, 255]) before statistics and
    device work; it latches (drifted traffic stays drifted).
``replica_down@request=N``
    The router declares its first replica (sorted by tag) down once N
    requests were routed, for good (``serve/router.py``).
``readyz_flap@period=P``
    The router's readiness verdict for that replica alternates every P
    health-poll rounds from its first consult on.

The work queue consults this one:

``stale_lease@unit=NAME``
    Heartbeat renewals of lease unit NAME are silently dropped from the
    first match on (a wedged heartbeat thread): the stale-lease reclaim
    path (``launch/workqueue.py``).  It latches.

``io_error`` belongs to a seam the port does not have and is parsed but
never consulted.  Pinned specs fire
once per process; every kind that lists it takes an optional
``attempt=N`` gate (it fires only when ``FAA_ATTEMPT`` equals N).
Tests call :func:`reset` after changing ``os.environ['FAA_FAULT']``.
"""

from __future__ import annotations

import os

from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["FaultPlan", "active_plan", "reset", "parse_fault_spec",
           "current_attempt", "ATTEMPT_ENV_VAR"]

logger = get_logger("faa_torch.faultinject")

ENV_VAR = "FAA_FAULT"

_KINDS = {
    "nan_loss": ("step",),
    "sigterm": ("step", "attempt"),
    "sigusr1": ("step", "attempt"),
    "sigkill": ("step", "attempt"),
    "torn_ckpt": ("save",),
    "corrupt_ckpt": ("save",),
    "io_error": ("p", "seed"),
    "trial_error": ("trial",),
    "sigkill_trial": ("trial", "attempt"),
    "hang": ("step", "attempt"),
    "slow": ("step", "factor", "attempt"),
    "stale_lease": ("unit",),
    "serve_error": ("dispatch", "attempt"),
    "serve_slow": ("dispatch", "factor", "attempt"),
    "replica_down": ("request", "attempt"),
    "readyz_flap": ("period", "attempt"),
    "drift": ("dispatch", "shift", "attempt"),
}

# keys that are optional for their kind (everything else is required)
_OPTIONAL_KEYS = {"attempt"}
# value parsers: default int
_FLOAT_KEYS = {"p", "factor", "shift"}
_STR_KEYS = {"unit"}

#: env var carrying the per-host launch counter (fleet exports it on
#: every (re)launch; absent = attempt 1)
ATTEMPT_ENV_VAR = "FAA_ATTEMPT"


def current_attempt() -> int:
    try:
        return int(os.environ.get(ATTEMPT_ENV_VAR, "1") or 1)
    except ValueError:
        logger.warning("%s=%r is not an integer — treating as attempt 1",
                       ATTEMPT_ENV_VAR, os.environ.get(ATTEMPT_ENV_VAR))
        return 1


def parse_fault_spec(spec: str) -> list[dict]:
    """Parse the ``FAA_FAULT`` grammar into a list of fault dicts.

    Raises ValueError on unknown kinds, missing/unknown keys or
    malformed values — a typo in a fault spec must fail loudly, never
    silently inject nothing.
    """
    faults = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise ValueError(
                f"bad fault spec {part!r}: expected kind@key=value[,key=value]")
        kind, _, argstr = part.partition("@")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}: known {sorted(_KINDS)}")
        args: dict = {}
        for kv in argstr.split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(f"bad fault arg {kv!r} in {part!r}")
            key, _, val = kv.partition("=")
            key = key.strip()
            if key not in _KINDS[kind]:
                raise ValueError(
                    f"fault {kind!r} takes keys {_KINDS[kind]}, got {key!r}")
            if key in _FLOAT_KEYS:
                args[key] = float(val)
            elif key in _STR_KEYS:
                val = val.strip()
                if not val:
                    raise ValueError(f"fault {kind!r} key {key!r} is empty")
                args[key] = val
            else:
                args[key] = int(val)
        required = {"io_error": ("p",)}.get(
            kind, tuple(k for k in _KINDS[kind] if k not in _OPTIONAL_KEYS))
        missing = [k for k in required if k not in args]
        if missing:
            raise ValueError(f"fault {kind!r} missing keys {missing}")
        if kind == "io_error":
            args.setdefault("seed", 0)
            if not 0.0 <= args["p"] <= 1.0:
                raise ValueError(f"io_error p={args['p']} outside [0, 1]")
        faults.append({"kind": kind, **args, "fired": False})
    return faults


class FaultPlan:
    """The parsed plan plus per-kind trigger state."""

    def __init__(self, faults: list[dict]):
        self.faults = faults
        self.save_count = 0  # process-wide save_checkpoint counter

    # -- counter-pinned kinds -----------------------------------------
    def _take(self, kind: str, key: str, value: int,
              at_least: bool = False) -> dict | None:
        """Consume-once match of a pinned spec against a coordinate."""
        for f in self.faults:
            if f["kind"] != kind or f["fired"]:
                continue
            if "attempt" in f and current_attempt() != f["attempt"]:
                continue  # gated to a different process-chain attempt
            hit = value >= f[key] if at_least else value == f[key]
            if hit:
                f["fired"] = True
                logger.warning("faultinject: firing %s@%s=%d (at %s=%d)",
                               kind, key, f[key], key, value)
                return f
        return None

    def nan_loss_in(self, step_lo: int, step_hi: int) -> bool:
        """True when a nan_loss spec's step falls in [step_lo, step_hi)
        — the step range the just-finished epoch covered."""
        for f in self.faults:
            if f["kind"] == "nan_loss" and not f["fired"] \
                    and step_lo <= f["step"] < step_hi:
                f["fired"] = True
                logger.warning(
                    "faultinject: injecting NaN loss (step %d in epoch "
                    "range [%d, %d))", f["step"], step_lo, step_hi)
                return True
        return False

    def maybe_signal(self, step: int) -> None:
        """Deliver any pending sig* spec whose step has been reached
        (consulted after each dispatch/batch)."""
        import signal as _signal

        for kind, signum in (("sigterm", _signal.SIGTERM),
                             ("sigusr1", _signal.SIGUSR1),
                             ("sigkill", _signal.SIGKILL)):
            if self._take(kind, "step", step, at_least=True):
                os.kill(os.getpid(), signum)

    def next_save(self) -> int:
        self.save_count += 1
        return self.save_count

    def torn_at(self, save_n: int) -> bool:
        return self._take("torn_ckpt", "save", save_n) is not None

    def corrupt_at(self, save_n: int) -> bool:
        return self._take("corrupt_ckpt", "save", save_n) is not None

    def trial_error_at(self, trial: int) -> bool:
        return self._take("trial_error", "trial", trial) is not None

    def maybe_kill_trial(self, trial: int) -> None:
        """Deliver the sigkill_trial verb once an evaluation covers a
        trial index at or past the spec's coordinate (consulted at the
        search pipeline's round seam)."""
        if self._take("sigkill_trial", "trial", trial, at_least=True):
            import signal as _signal

            os.kill(os.getpid(), _signal.SIGKILL)

    def dispatch_delay(self, step: int) -> tuple[str, float] | None:
        """Consult the hang/slow verbs at the dispatch seam (with the
        step the dispatch will reach).  Returns ``("hang", inf)``,
        ``("slow", factor)``, or None.  The caller (the watchdog seam)
        turns "slow" into ``factor x EMA`` seconds."""
        if self._take("hang", "step", step, at_least=True):
            return ("hang", float("inf"))
        f = self._take("slow", "step", step, at_least=True)
        if f is not None:
            return ("slow", float(f["factor"]))
        return None

    def serve_fault(self, dispatch_n: int) -> tuple[str, float] | None:
        """Consult the serve_error/serve_slow verbs at the policy
        server's dispatch seam with the 1-based dispatch-attempt
        counter.  Returns ``("error", 0.0)``, ``("slow", factor)``, or
        None."""
        if self._take("serve_error", "dispatch", dispatch_n):
            return ("error", 0.0)
        f = self._take("serve_slow", "dispatch", dispatch_n)
        if f is not None:
            return ("slow", float(f["factor"]))
        return None

    def drift_shift(self, dispatch_n: int) -> float | None:
        """The active injected distribution shift for the policy
        server's `dispatch_n`-th dispatch, or None.  LATCHES from the
        first matching dispatch onward; honors the ``attempt=N`` gate."""
        for f in self.faults:
            if f["kind"] != "drift":
                continue
            if "attempt" in f and current_attempt() != f["attempt"]:
                continue
            if dispatch_n < f["dispatch"]:
                continue
            if not f["fired"]:
                f["fired"] = True
                logger.warning(
                    "faultinject: input distribution SHIFTED by %+g from "
                    "dispatch %d onward (drift)", f["shift"], dispatch_n)
            return float(f["shift"])
        return None

    def replica_down_now(self, request_n: int) -> bool:
        """Consulted at the router's health-poll seam with the routed-
        request counter.  Fires ONCE when the counter reaches the spec's
        coordinate; the router latches the verdict itself."""
        return self._take("replica_down", "request", request_n,
                          at_least=True) is not None

    def readyz_flap_period(self) -> int | None:
        """The active readyz_flap period, or None.  LATCHES: the flap
        governs every later poll round (the router applies
        ``((round-1)//P) % 2`` to its own counter)."""
        for f in self.faults:
            if f["kind"] != "readyz_flap":
                continue
            if "attempt" in f and current_attempt() != f["attempt"]:
                continue
            if not f["fired"]:
                f["fired"] = True
                logger.warning(
                    "faultinject: readyz verdict flapping every %d "
                    "health-poll round(s) from now on", f["period"])
            return int(f["period"])
        return None

    def lease_stale(self, unit: str) -> bool:
        """True when heartbeat renewals for `unit` must be dropped.
        LATCHES: after the first match every later renewal for the unit
        stays dropped (a wedged heartbeat thread never comes back)."""
        for f in self.faults:
            if f["kind"] != "stale_lease" or f["unit"] != unit:
                continue
            if not f["fired"]:
                f["fired"] = True
                logger.warning(
                    "faultinject: dropping heartbeats for lease unit %r "
                    "from now on (stale_lease)", unit)
            return True
        return False


_plan: FaultPlan | None = None
_plan_env: str | None = None


def active_plan() -> FaultPlan | None:
    """The process-wide plan, or None when ``FAA_FAULT`` is unset/empty.

    Parsed once and cached; the cache is invalidated automatically when
    the env var's VALUE changes (tests flip it between cases), but
    trigger state within one value is preserved across consults.
    """
    global _plan, _plan_env
    env = os.environ.get(ENV_VAR, "")
    if env != _plan_env:
        _plan_env = env
        _plan = FaultPlan(parse_fault_spec(env)) if env.strip() else None
        if _plan is not None:
            logger.warning("faultinject: ACTIVE with %d fault(s): %s",
                           len(_plan.faults), env)
    return _plan


def reset() -> None:
    """Forget the cached plan and all trigger state (test isolation)."""
    global _plan, _plan_env
    _plan = None
    _plan_env = None
