"""Warm-started incremental re-search + candidate provenance.

Stage two of the control loop: when the drift monitor trips, the loop
does NOT search from scratch — it warm-starts the TPE from the
persisted trial log through the ``replay_trial_log`` ledger seam
(``search_policies(topup_trials=N, resume=True, async_pipeline="on")``)
and runs a bounded TOP-UP search, so the device cost of reacting to
drift is ``topup_trials`` TTA rounds, not a full search (on the card:
K7, K1 and K5 for each new trial's TTA calls and the audit; K8 only
where a fold must retrain).  ``topup_trials=0`` degenerates to a plain
resume: the candidate ``final_policy.json`` is byte-identical to the
one-shot artifact (pinned by tests — the defaults-safety contract).

Every candidate carries a PROVENANCE SIDECAR
(``final_policy.provenance.json`` next to the policy): the policy's
tensor digest, the base artifacts it warm-started from, the trial
budget split, and the drift verdict that triggered it.  serve_cli
attaches the sidecar to ``/stats`` and the ``/reload`` response, which
is how the canary comparator verifies WHICH policy generation actually
answered (``control/canary.py``).
"""

from __future__ import annotations

import os
import shutil

from fast_autoaugment_tpu_torch.core import fsfault, telemetry
from fast_autoaugment_tpu_torch.core.telemetry import wall
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["provenance_path", "write_provenance", "load_provenance",
           "policy_file_digest", "seed_research_dir", "warm_started_research",
           "PROVENANCE_SCHEMA_VERSION"]

logger = get_logger("faa_torch.control.research")

PROVENANCE_SCHEMA_VERSION = 1


def provenance_path(policy_path: str) -> str:
    """``.../final_policy.json`` -> ``.../final_policy.provenance.json``
    (non-.json paths get the suffix appended — never shadow the policy
    file itself)."""
    p = str(policy_path)
    if p.endswith(".json"):
        return p[:-len(".json")] + ".provenance.json"
    return p + ".provenance.json"


def policy_file_digest(policy_path: str) -> str:
    """The canonical serving-plane digest of a policy FILE — the same
    12-hex ``policy_digest`` the tenancy LRU, the router's rendezvous
    hash and the reload echo all use (``serve/policy_server.py``)."""
    from fast_autoaugment_tpu_torch.policies.archive import policy_to_tensor
    from fast_autoaugment_tpu_torch.serve.policy_server import policy_digest

    raw = fsfault.load_json(policy_path)
    if not raw:
        raise ValueError(f"{policy_path} holds an empty policy set")
    subs = [[(str(op), float(p), float(lv)) for op, p, lv in sub]
            for sub in raw]
    return policy_digest(policy_to_tensor(subs))


def write_provenance(policy_path: str, stamp: dict) -> str:
    """Write the provenance sidecar for `policy_path` (digest computed
    here so the stamp can never disagree with the bytes it describes).
    Returns the sidecar path."""
    out = {
        "schema_version": PROVENANCE_SCHEMA_VERSION,
        "policy_digest": policy_file_digest(policy_path),
        "created_at": wall(),
        "host": f"host{os.environ.get('FAA_HOST_ID', '0')}",
        **stamp,
    }
    path = provenance_path(policy_path)
    _write_json_atomic(path, out)
    return path


def _write_json_atomic(path: str, obj) -> None:
    """The fsync-then-rename idiom through the fsfault seam (host-only
    — importing search.driver here would pull torch and the model zoo
    into a pure-bookkeeping path)."""
    fsfault.write_json_atomic(path, obj)


def load_provenance(policy_path: str) -> dict | None:
    """The sidecar for `policy_path`, or None (missing/unreadable —
    provenance bookkeeping must never break a caller)."""
    path = provenance_path(policy_path)
    if not os.path.exists(path):
        return None
    prov = fsfault.read_json(path)
    if prov is None:
        logger.warning("unreadable provenance sidecar %s", path)
        return None
    return prov if isinstance(prov, dict) else None


def seed_research_dir(base_dir: str, out_dir: str) -> list[str]:
    """Copy the warm-start substrate from a completed search dir into
    `out_dir`: per-fold trial logs, per-fold checkpoints (+ sidecars /
    chain links), and the cached audit records resume reads.  The base
    dir is never written — re-search must not disturb the serving
    fleet's provenance trail."""
    os.makedirs(out_dir, exist_ok=True)
    copied: list[str] = []
    try:
        names = fsfault.listdir(base_dir)
    except OSError as e:
        raise ValueError(f"unreadable base search dir {base_dir}: {e}")
    # everything resume reads comes along (trial logs, fold
    # checkpoints + chain links/sidecars, audit caches); the DERIVED
    # outputs stay behind so a half-finished re-search can never serve
    # a stale candidate, and journal segments stay with their run
    skip_prefixes = ("final_policy", "random_final_policy",
                     "search_result", "journal-")
    for name in names:
        src = os.path.join(base_dir, name)
        if not os.path.isfile(src):
            continue
        if name.startswith(skip_prefixes) or ".tmp" in name:
            continue
        shutil.copy2(src, os.path.join(out_dir, name))
        copied.append(name)
    if not any(n.startswith("search_trials") for n in copied):
        raise ValueError(
            f"base search dir {base_dir} holds no trial log "
            "(search_trials*.json) — nothing to warm-start from")
    return copied


def warm_started_research(conf, dataroot: str, base_dir: str,
                          out_dir: str, *, topup_trials: int,
                          drift: dict | None = None,
                          **search_kwargs) -> dict:
    """Run the incremental re-search: seed `out_dir` from `base_dir`'s
    persisted artifacts, top up the trial budget, and stamp the
    candidate's provenance sidecar.

    `search_kwargs` must name the SAME search geometry the base run
    used (num_search, cv_num, trial_batch, seed, ...) — the replay is
    only exact against the log it wrote.  ``async_pipeline`` defaults
    on so the warm start routes through the ``replay_trial_log``
    ledger (the RNG stream continues exactly where the base run left
    it).  Returns ``{"policy": path, "provenance": dict,
    "result": SearchResult}``."""
    from fast_autoaugment_tpu_torch.search.driver import search_policies

    copied = seed_research_dir(base_dir, out_dir)
    search_kwargs.setdefault("async_pipeline", "on")
    search_kwargs.setdefault("resume", True)
    t0 = telemetry.mono()
    result = search_policies(
        conf, dataroot, out_dir,
        topup_trials=max(0, int(topup_trials)),
        **search_kwargs)
    policy_path = os.path.join(out_dir, "final_policy.json")
    stamp = {
        "kind": "warm_started_research",
        "base_dir": os.path.abspath(base_dir),
        "seeded_files": copied,
        "topup_trials": max(0, int(topup_trials)),
        "warm_start": result.get("warm_start"),
        "num_sub_policies": result.get("num_sub_policies"),
        "drift": drift,
        "research_wall_sec": round(telemetry.mono() - t0, 3),
    }
    sidecar = write_provenance(policy_path, stamp)
    prov = load_provenance(policy_path)
    telemetry.emit("research", "warm_start",
                   candidate=policy_path,
                   digest=prov.get("policy_digest") if prov else None,
                   topup_trials=stamp["topup_trials"],
                   base_dir=stamp["base_dir"],
                   wall_sec=stamp["research_wall_sec"],
                   drift_id=(drift or {}).get("id"))
    logger.info("re-search complete: candidate %s (digest %s, sidecar "
                "%s)", policy_path,
                prov.get("policy_digest") if prov else "?", sidecar)
    return {"policy": policy_path, "provenance": prov, "result": result}
