"""Sweep results and the port's sweep front door.

``ScenarioResult`` and ``SweepResult`` are copies of ``repro.sim.sweep``'s
records (same fields, same metric keys), so a result of the port reads
like one of the JAX package. :func:`run_sweep` is a thin front door that
forwards ``backend="torch"`` to ``repro_torch.sim.batched.run_sweep_torch``;
the result cache, the resilient job path, the worker fleet, lane chunking,
series capture and sharding are not part of the port yet and their knobs
are rejected.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence

if TYPE_CHECKING:
    from repro_torch.core.scenarios import ScenarioSpec


@dataclass
class ScenarioResult:
    """Outcome of one simulated configuration."""

    spec: ScenarioSpec
    metrics: Dict[str, float]
    storage_usd: float
    network_usd: float
    ops_usd: float
    wall_s: float
    events: int
    series: Dict[str, Dict[str, float]] = field(default_factory=dict)
    #: Raw per-month billing inputs: ``{"gb_seconds": [...], "egress_bytes":
    #: [...], "class_a": [...], "class_b": [...], "full_months": int}``;
    #: pricing-independent, so ``bills_from_monthly_totals`` re-bills them
    #: under any cost model.
    monthly: Dict[str, Any] = field(default_factory=dict)

    @property
    def cost_usd(self) -> float:
        return self.storage_usd + self.network_usd + self.ops_usd

    @property
    def jobs_done(self) -> float:
        return self.metrics["jobs_done"]

    @property
    def jobs_per_day(self) -> float:
        return self.jobs_done / self.spec.days

    def row(self) -> Dict[str, Any]:
        """Flat record for tabulation."""
        m = self.metrics
        r: Dict[str, Any] = {"label": self.spec.label}
        r.update(self.spec.to_dict())
        del r["curves"]
        r.update(
            jobs_done=m["jobs_done"],
            jobs_per_day=self.jobs_per_day,
            job_waiting_h_mean=m["job_waiting_h_mean"],
            download_pb=m["download_pb"],
            tape_to_disk_pb=sum(v for k, v in m.items()
                                if k.endswith(".tape_to_disk_pb")),
            gcs_to_disk_pb=m["gcs_to_disk_pb"],
            disk_to_gcs_pb=m["disk_to_gcs_pb"],
            gcs_used_pb=m["gcs_used_pb"],
            storage_usd=self.storage_usd,
            network_usd=self.network_usd,
            ops_usd=self.ops_usd,
            cost_usd=self.cost_usd,
            cost_per_kjob=1e3 * self.cost_usd / max(m["jobs_done"], 1.0),
            wall_s=self.wall_s,
            events=self.events,
        )
        return r


def pareto_indices(costs: Sequence[float],
                   values: Sequence[float]) -> List[int]:
    """Indices of the non-dominated (min cost, max value) points, sorted by
    cost ascending; of identical (cost, value) points only the first."""
    if len(costs) != len(values):
        raise ValueError("costs and values must have equal length")
    order = sorted(range(len(costs)), key=lambda i: (costs[i], -values[i]))
    front: List[int] = []
    best = float("-inf")
    for i in order:
        if values[i] > best:
            front.append(i)
            best = values[i]
    return front


@dataclass
class SweepResult:
    """Ordered results of one sweep (same order as the input specs)."""

    results: List[ScenarioResult]
    wall_s: float = 0.0

    #: Below this wall-clock floor a throughput rate is noise, not signal.
    WALL_S_FLOOR = 1e-3

    def __len__(self) -> int:
        return len(self.results)

    @property
    def configs_per_sec(self) -> Optional[float]:
        """Throughput, or ``None`` when ``wall_s`` is under 1 ms."""
        if self.wall_s < self.WALL_S_FLOOR:
            return None
        return len(self.results) / self.wall_s

    def pareto_front(self) -> List[ScenarioResult]:
        """Cost/throughput frontier: min cloud cost, max jobs done."""
        idx = pareto_indices([r.cost_usd for r in self.results],
                             [r.jobs_done for r in self.results])
        return [self.results[i] for i in idx]

    def rows(self) -> List[Dict[str, Any]]:
        front = {id(r) for r in self.pareto_front()}
        out = []
        for r in self.results:
            row = r.row()
            row["pareto"] = int(id(r) in front)
            out.append(row)
        return out


#: Knobs of ``repro.sim.sweep.run_sweep`` that the port does not run yet.
_LATER_KNOBS = ("cache", "retry", "faults", "transport", "lane_chunk",
                "record_series", "shard")


def run_sweep(specs: Sequence["ScenarioSpec"], backend: str = "torch",
              tick: float = 10.0, tick_impl: str = "auto",
              device=None, **knobs: Any) -> SweepResult:
    """Run a spec grid on the port's batched program.

    ``backend`` must be ``"torch"``; ``tick`` is the clock step in seconds,
    ``tick_impl`` the kernel implementation (``repro_torch.kernels.
    registry``), ``device`` where it runs (``cuda`` when None). Any of
    ``cache``, ``retry``, ``faults``, ``transport``, ``lane_chunk``,
    ``record_series`` or ``shard`` raises ``ValueError``.
    """
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (the port runs "
                         "backend='torch' only)")
    for name in knobs:
        if name in _LATER_KNOBS:
            raise ValueError(f"{name}= is not supported by the torch "
                             "backend yet")
        raise TypeError(f"run_sweep() got an unexpected keyword argument "
                        f"{name!r}")
    from repro_torch.sim.batched import run_sweep_torch

    return run_sweep_torch(specs, tick=tick, tick_impl=tick_impl,
                           device=device)
