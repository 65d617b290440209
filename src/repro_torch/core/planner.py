"""Decision tool (paper §6): simulate before you buy, copied from
``repro.core.planner``.

``sweep`` runs the HCDC scenario on the event engine across a grid of disk
limits and returns the (jobs done, disk used, cloud cost) frontier;
``recommend`` picks the cheapest configuration that reaches a target
fraction of the unlimited-disk baseline's job throughput (configuration
I).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.hcdc import HCDCScenario, make_config
from repro_torch.sim.engine import DAY
from repro_torch.sim.infrastructure import TB


@dataclass
class SweepPoint:
    disk_limit_tb: float
    gcs_limited: bool
    jobs_done: float
    download_pb: float
    disk_used_pb: float
    gcs_used_pb: float
    cloud_cost_usd: float

    @property
    def cost_per_job(self) -> float:
        return self.cloud_cost_usd / max(self.jobs_done, 1.0)


def run_point(disk_limit_tb: Optional[float], use_gcs: bool,
              days: int = 30, n_files: int = 200_000, seed: int = 0) -> SweepPoint:
    cfg = make_config("III" if use_gcs else ("I" if disk_limit_tb is None else "II"),
                      simulated_time=days * DAY, n_files_per_site=n_files,
                      seed=seed)
    if disk_limit_tb is not None:
        for s in cfg.sites:
            s.disk_limit = disk_limit_tb * TB
    m = HCDCScenario(cfg).run()
    cost = sum(v for k, v in m.items()
               if k.endswith("storage_usd") or k.endswith("network_usd"))
    return SweepPoint(
        disk_limit_tb=disk_limit_tb if disk_limit_tb is not None else float("inf"),
        gcs_limited=not use_gcs,
        jobs_done=m["jobs_done"],
        download_pb=m["download_pb"],
        disk_used_pb=m["Site-1.disk_used_pb"] + m["Site-2.disk_used_pb"],
        gcs_used_pb=m["gcs_used_pb"],
        cloud_cost_usd=cost,
    )


def sweep(disk_limits_tb: List[float], days: int = 30,
          n_files: int = 200_000, seed: int = 0) -> List[SweepPoint]:
    points = [run_point(None, False, days, n_files, seed)]  # baseline (cfg I)
    for lim in disk_limits_tb:
        points.append(run_point(lim, True, days, n_files, seed))
    return points


def recommend(points: List[SweepPoint],
              min_throughput_frac: float = 0.98) -> SweepPoint:
    base = points[0].jobs_done
    feasible = [p for p in points[1:]
                if p.jobs_done >= min_throughput_frac * base]
    if not feasible:
        return points[0]
    return min(feasible, key=lambda p: (p.disk_used_pb, p.cloud_cost_usd))
