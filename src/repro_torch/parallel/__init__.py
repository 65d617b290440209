"""Distribution layer: mesh axes, logical sharding rules, parallel plans and
the activation-sharding context (``repro.parallel``'s counterpart on
``torch.distributed``'s ``DeviceMesh`` and DTensor placements)."""

from repro_torch.parallel.sharding import (
    LANES_AXIS,
    ParallelPlan,
    batch_shardings,
    cache_shardings,
    lane_mesh,
    param_shardings,
    placements,
    plan_for,
)

__all__ = [
    "LANES_AXIS",
    "ParallelPlan",
    "batch_shardings",
    "cache_shardings",
    "lane_mesh",
    "param_shardings",
    "placements",
    "plan_for",
]
