"""Distribution layer, single-card part: the parallel plan's fields that
one card uses (``repro.parallel``'s mesh, sharding rules and FSDP are
not ported)."""

from repro_torch.parallel.sharding import ParallelPlan, plan_for

__all__ = ["ParallelPlan", "plan_for"]
