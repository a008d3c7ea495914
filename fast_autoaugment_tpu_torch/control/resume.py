"""Crash-resumable control loop: journal-as-WAL reconstruction.

The control loop's journal events were designed as an audit trail;
this module treats them as a WRITE-AHEAD LOG.  Every stage
transition the loop makes is journaled BEFORE its effects matter
(``drift`` before research starts, ``research`` before the rollout,
``canary``/rollout before the gate window, ``promote``/``rollback``/
terminal ``mark``s when an episode closes), and every stage action is
idempotent (reloads echo digests, ``POST /canary`` replaces the
split), so a controller that dies at ANY point can be restarted with
``control_cli --resume``: the journal names the dangling episode and
the stage it reached, the live router/replica state is re-asserted by
re-entering that stage, and the episode terminates in a journaled
promote or rollback instead of splitting traffic forever.

Reconstruction is read-only over the shared journal (through the
``core/fsfault.py`` seam — a resuming controller is exactly the kind
of reader a hostile share bites) and pure given the record stream, so
it is drivable in tests without any live fleet.
"""

from __future__ import annotations

import json
import os

from fast_autoaugment_tpu_torch.core import fsfault
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["read_control_events", "reconstruct_inflight_episode",
           "CONTROL_EVENT_TYPES", "TERMINAL_MARKS"]

logger = get_logger("faa_torch.control.resume")

#: the journal event types that carry control-loop WAL state
CONTROL_EVENT_TYPES = ("drift", "research", "canary", "promote",
                       "rollback", "mark")

#: ``mark`` events that CLOSE an episode without a promote/rollback
TERMINAL_MARKS = ("research_failed", "candidate_is_baseline")

#: journal-envelope keys stripped when a drift event is turned back
#: into the verdict dict the loop carries
_ENVELOPE_KEYS = ("type", "label", "host", "pid", "tid", "thread",
                  "seq", "t_wall", "t_mono", "attempt")


def read_control_events(journal_dir: str) -> list[dict]:
    """Every control-relevant journal record under `journal_dir`, in
    (host, pid, seq) order — one controller writes them, so this is
    the WAL's append order."""
    pattern = os.path.join(journal_dir, "**", "journal-*.jsonl")
    records: list[dict] = []
    for path in fsfault.glob_files(pattern):
        try:
            data = fsfault.read_from(path, 0)
        except OSError:
            continue  # transient (injected eio / half-visible file)
        for line in data.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn line from the killed writer
            if isinstance(rec, dict) \
                    and rec.get("type") in CONTROL_EVENT_TYPES:
                records.append(rec)
    records.sort(key=lambda r: (str(r.get("host")), r.get("pid", 0),
                                r.get("seq", 0)))
    return records


def _verdict_from_event(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in _ENVELOPE_KEYS}


def reconstruct_inflight_episode(events: list[dict]) -> dict | None:
    """The dangling episode a dead controller left behind, or None
    when the WAL is clean (every drift episode reached a terminal
    promote / rollback / terminal mark).

    Returns ``{"verdict", "stage", "candidate", "digest",
    "provenance"}`` with stage ``research`` (drift seen, no candidate
    yet) or ``canary`` (candidate known — rollout may or may not have
    completed; re-entering the rollout is idempotent either way)."""
    episode: dict | None = None
    for rec in events:
        etype = rec.get("type")
        if etype == "drift":
            episode = {"verdict": _verdict_from_event(rec),
                       "stage": "research", "candidate": None,
                       "digest": None, "provenance": {}}
        elif episode is None:
            continue
        elif etype == "research":
            if rec.get("candidate") and rec.get("digest"):
                episode.update(candidate=rec["candidate"],
                               digest=rec["digest"], stage="canary")
        elif etype == "canary" and rec.get("action") in ("rollout",
                                                         "split_set"):
            episode["stage"] = "canary"
        elif etype in ("promote", "rollback"):
            episode = None
        elif etype == "mark" and rec.get("event") in TERMINAL_MARKS:
            episode = None
    if episode is None:
        return None
    # the provenance sidecar (if the candidate file survived) rides
    # along so the resumed rollout re-verifies the same digest chain
    if episode.get("candidate"):
        try:
            from fast_autoaugment_tpu_torch.control.research import (
                load_provenance,
            )

            episode["provenance"] = load_provenance(
                episode["candidate"]) or {}
        except Exception as e:  # noqa: BLE001 — provenance is best-effort
            logger.warning("resume: provenance sidecar unreadable for "
                           "%s (%s)", episode["candidate"], e)
            episode["provenance"] = {}
    logger.warning(
        "journal WAL shows a DANGLING control episode: drift %s at "
        "stage %s (candidate %s, digest %s)",
        (episode.get("verdict") or {}).get("id"), episode.get("stage"),
        episode.get("candidate"), episode.get("digest"))
    return episode
