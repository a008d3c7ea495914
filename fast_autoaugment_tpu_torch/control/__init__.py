"""Closed-loop control plane: drift detection, warm-started re-search,
canary rollout, gated promotion.

Host-only orchestration over the seams the rest of the port provides:
the telemetry journal (``core/telemetry.py``), the ``replay_trial_log``
TPE ledger (``search/pipeline.py``), ``serve_cli``'s ``POST /reload``
and the digest-affinity router (``serve/router.py``).  Nothing here
touches a device: the loop decides WHEN to search and WHAT to serve,
and the processes it drives (the re-search, the replicas) launch the
kernels."""

from fast_autoaugment_tpu_torch.control.canary import (
    CanaryController,
    PromotionGate,
    ReplicaQualityScraper,
    compare_arms,
    select_canary_replicas,
)
from fast_autoaugment_tpu_torch.control.drift import (
    CusumMeanShift,
    DriftMonitor,
    TrafficSampleReader,
)
from fast_autoaugment_tpu_torch.control.loop import ControlLoop
from fast_autoaugment_tpu_torch.control.resume import (
    read_control_events,
    reconstruct_inflight_episode,
)
from fast_autoaugment_tpu_torch.control.research import (
    load_provenance,
    policy_file_digest,
    provenance_path,
    warm_started_research,
    write_provenance,
)

__all__ = [
    "CanaryController",
    "ControlLoop",
    "CusumMeanShift",
    "DriftMonitor",
    "PromotionGate",
    "ReplicaQualityScraper",
    "TrafficSampleReader",
    "compare_arms",
    "load_provenance",
    "policy_file_digest",
    "provenance_path",
    "read_control_events",
    "reconstruct_inflight_episode",
    "select_canary_replicas",
    "warm_started_research",
    "write_provenance",
]
