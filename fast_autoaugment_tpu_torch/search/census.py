"""The graph census of the search's TTA steps
(``fast_autoaugment_tpu/search/census.py``).

The policy-as-tensor design promises one executable per argument shape for
the whole search.  In the JAX package that is one compiled program per
shape; on the card it is one CUDA graph per policy shape and batch shape,
captured at first use and replayed for every trial after
(``search/tta.py``).  On the CPU the steps
run eagerly and hold no graph.  :func:`executable_census` is how the driver
proves the count in ``search_result.json``.
"""

from __future__ import annotations

from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["executable_census"]

logger = get_logger("faa_torch.census")


def executable_census(step) -> int | None:
    """The number of CUDA graphs `step` holds (``step.num_graphs()``), or
    None, after a warning, when the step has no such probe: None means the
    count CANNOT be asserted, never "one"."""
    probe = getattr(step, "num_graphs", None)
    if callable(probe):
        return int(probe())
    logger.warning("graph census UNAVAILABLE for %r: it has no num_graphs() probe - the "
                   "one-graph-per-shape invariant is NOT being verified for this step", step)
    return None
