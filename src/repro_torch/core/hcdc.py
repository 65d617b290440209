"""HCDC scenario configuration (paper §5, Tables 3-5), copied from the
config half of ``repro.core.hcdc``.

Two grid sites, each with tape (archival) and a disk hot tier, share one
GCS bucket as the cold tier. Configurations (Table 5): I — unlimited disk,
GCS disabled; II — 100 TB disk, GCS disabled; III — 100 TB disk, unlimited
GCS. The event-driven engine of ``repro.core.hcdc`` is not carried over:
the port runs the batched fixed-tick program only.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

from repro_torch.core.hotcold import (
    ColdDeletionPolicy,
    MigrationPolicy,
    PopularityModel,
)
from repro_torch.sim.cloud import GCSCostModel
from repro_torch.sim.infrastructure import TB, GiB
from repro_torch.sim.workload import SteadyPoisson, WorkloadModel

#: Simulation clock units (integer seconds, as in ``repro.sim.engine``).
MINUTE = 60
DAY = 24 * 60 * MINUTE


@dataclass
class SiteSpec:
    name: str
    tape_to_disk_mb_s: float  # Table 4
    disk_limit: Optional[float]  # Table 5


@dataclass
class HCDCConfig:
    simulated_time: int = 90 * DAY
    gen_interval: int = 10
    n_files_per_site: int = 1_000_000
    # input file size ~ Exp(lambda) GiB clamped (Table 3)
    size_lam: float = 0.026
    size_lo: float = 9.76e6 / GiB
    size_hi: float = 134e9 / GiB
    # jobs submitted per tick per site ~ TruncNormal (Table 3)
    jobs_mu: float = 0.63366
    jobs_sigma: float = 0.37292
    # job duration ~ Exp(lambda) s, clamped below (Table 3)
    dur_lam: float = 0.00409
    dur_lo: float = 1000.0  # 16.666 minutes
    popularity: PopularityModel = field(default_factory=PopularityModel)
    # access-pattern shape (repro_torch.sim.workload; steady is a no-op)
    workload: WorkloadModel = field(default_factory=SteadyPoisson)
    # network (Table 4), bytes/s
    gcs_to_disk: float = 294.00e6
    disk_to_gcs: float = 500.00e6
    download: float = 88.24e6
    max_active: int = 100
    tape_latency: float = 30 * MINUTE
    tape_latency_sigma: float = 0.0  # >0: normal-random latency (paper §5.4)
    sites: List[SiteSpec] = field(default_factory=lambda: [
        SiteSpec("Site-1", 22.62e6, 100 * TB),
        SiteSpec("Site-2", 62.35e6, 100 * TB),
    ])
    gcs_limit: Optional[float] = None  # None = unlimited, 0.0 = disabled
    cost_model: GCSCostModel = field(default_factory=GCSCostModel)
    migration_policy: MigrationPolicy = field(default_factory=MigrationPolicy)
    cold_deletion_policy: ColdDeletionPolicy = field(default_factory=ColdDeletionPolicy)
    seed: int = 0
    curves: bool = False  # record Fig 6/8 time series (event engine only)

    @property
    def gcs_enabled(self) -> bool:
        return self.gcs_limit is None or self.gcs_limit > 0


def _cfg(disk_limit, gcs_limit) -> HCDCConfig:
    c = HCDCConfig(gcs_limit=gcs_limit)
    c.sites = [
        SiteSpec("Site-1", 22.62e6, disk_limit),
        SiteSpec("Site-2", 62.35e6, disk_limit),
    ]
    return c


CONFIG_I = _cfg(None, 0.0)
CONFIG_II = _cfg(100 * TB, 0.0)
CONFIG_III = _cfg(100 * TB, None)


def make_config(name: str, **overrides) -> HCDCConfig:
    base = {"I": CONFIG_I, "II": CONFIG_II, "III": CONFIG_III}[name]
    cfg = replace(base, **overrides)
    # ``replace`` copies fields shallowly: re-wrap every mutable sub-config
    # the caller did not supply, so tweaking one config never reaches the
    # module-level CONFIG_* constants.
    for attr in ("cost_model", "popularity", "migration_policy",
                 "cold_deletion_policy"):
        if attr not in overrides:
            setattr(cfg, attr, replace(getattr(cfg, attr)))
    if "sites" not in overrides:
        cfg.sites = [replace(s) for s in cfg.sites]
    return cfg
