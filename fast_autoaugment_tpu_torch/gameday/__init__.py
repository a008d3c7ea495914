"""Trace-driven game days: deterministic scenario drills with
journaled verdicts (docs/GAMEDAYS.md), over the port's serving plane.

The port's copy of ``fast_autoaugment_tpu/gameday/``:

- ``scenario``: composable frozen specs + the named-scenario registry;
- ``workload``: the seeded open-loop schedule and its replay driver;
- ``runner``: spec -> live plane (the port's replicas on the card) ->
  workload -> verdict record;
- ``verdict``: the journal-driven predicate catalog.

``python -m fast_autoaugment_tpu_torch.launch.gameday_cli`` fronts it.
"""

from .scenario import (Kill, Plane, SCENARIOS, Scenario, Traffic,
                       scaled, suite_names)
from .verdict import PREDICATES, evaluate, render_table
from .workload import Offered, build_schedule, schedule_digest

__all__ = [
    "Kill", "Plane", "SCENARIOS", "Scenario", "Traffic", "scaled",
    "suite_names", "PREDICATES", "evaluate", "render_table",
    "Offered", "build_schedule", "schedule_digest",
]
