"""Typed failures shared by the port's layers (the port's copy of the part
of ``fast_autoaugment_tpu/core/resilience.py`` that it needs).

Only :class:`CheckpointCorruptError` is copied: ``core/checkpoint.py``
raises it.  The preemption flag, the exit-code contract and the circuit
breaker belong to the runtime seams (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

__all__ = ["CheckpointCorruptError"]


class CheckpointCorruptError(RuntimeError):
    """A checkpoint payload failed its integrity check (digest or size
    mismatch against the ``.meta.json`` sidecar, or an unreadable /
    truncated payload).  ``load_checkpoint_chain`` treats this as "walk
    back one link"; bare ``load_checkpoint`` propagates it."""
