"""HCDC scenario: Hot/Cold Data Carousel simulation (paper §5), copied
from ``repro.core.hcdc``: the configuration (Tables 3-5) and the
event-driven engine that runs it (``HCDCScenario``, the reference of
Tables 6-8 and of ``backend="process"``).

Infrastructure (Fig. 4): two grid sites, each with TAPE (archival), DISK
(hot, the carousel window), WORKER and OUTPUT storage elements, plus one
shared GCS bucket (cold). Directional throughput-mode links per Table 4.
Jobs follow the Fig. 5 state machine:

  waiting -> transferring -> queued -> active -> running -> (done)

Each generator tick (10 s) per site:
  1. deletions: obsolete disk replicas (no live consumer) are deleted if
     already on GCS, else migrated disk->GCS then deleted (only when the
     disk is limited; configuration I keeps everything);
  2. submission: a truncated-normal number of jobs is submitted, each
     selecting an input file by popularity;
  3. waiting queue: FIFO admission into the disk window as space frees.

Jobs whose input is already on disk skip straight to queued; queued jobs
start at once (no job-slot limit); active jobs download disk->worker at
fixed throughput, then run for an exponential duration, then finish.
Several jobs waiting on the same file share one transfer.

Configurations (Table 5): I — unlimited disk, GCS disabled; II — 100 TB
disk, GCS disabled; III — 100 TB disk, unlimited GCS.

The engine is host code: plain Python on numpy draws, in ``repro``'s order
of draws, events and set iteration, so a run here is bitwise ``repro``'s
(``tests/test_torch_hcdc.py``). It imports neither torch nor a device.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.carousel import SlidingWindow
from repro_torch.core.hotcold import (
    ColdDeletionPolicy,
    MigrationPolicy,
    PopularityModel,
)
from repro_torch.sim.cloud import GCSBucket, GCSCostModel
from repro_torch.sim.distributions import (
    BoundedExponential,
    FractionalCounter,
    TruncatedNormalCount,
)
from repro_torch.sim.engine import (
    DAY,
    HOUR,
    MINUTE,
    BaseSimulation,
    Schedulable,
)
from repro_torch.sim.infrastructure import (
    TB,
    File,
    GiB,
    NetworkLink,
    Site,
    StorageElement,
)
from repro_torch.sim.output import OutputCollector
from repro_torch.sim.transfer import EventDrivenTransferService
from repro_torch.sim.workload import SteadyPoisson, WorkloadModel

# File location states (per site, per file).
ABSENT, IN_FLIGHT, PRESENT = 0, 1, 2


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
    curves: bool = False  # record Fig 6/8 time series

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


class _Job:
    __slots__ = ("fid", "submitted", "queued_at", "resolved")

    def __init__(self, fid: int, submitted: int):
        self.fid = fid
        self.submitted = submitted
        self.queued_at: Optional[int] = None
        self.resolved = False  # left the waiting queue out-of-band


class _SiteState:
    """Per-site runtime state over fixed file arrays."""

    def __init__(self, scenario: "HCDCScenario", spec: SiteSpec, rng):
        cfg = scenario.cfg
        n = cfg.n_files_per_site
        self.spec = spec
        self.site = Site(spec.name)
        self.tape = StorageElement(
            "TAPE", self.site,
            access_latency=cfg.tape_latency,
            latency_sampler=(
                (lambda r: float(np.clip(r.normal(cfg.tape_latency,
                                                  cfg.tape_latency_sigma), 0, 90 * MINUTE)))
                if cfg.tape_latency_sigma > 0 else None
            ),
        )
        self.disk = StorageElement("DISK", self.site, limit=spec.disk_limit)
        self.worker = StorageElement("WORKER", self.site)
        self.output = StorageElement("OUTPUT", self.site)
        # file attributes
        size_dist = BoundedExponential(cfg.size_lam, cfg.size_lo, cfg.size_hi, unit=GiB)
        self.sizes = size_dist.sample(rng, n)
        self.pop = cfg.popularity.sample_popularity(rng, n)
        self.popularity = cfg.popularity
        self.cum_w = cfg.popularity.selection_cdf(self.pop)
        self._cum_w_cache: Dict[float, np.ndarray] = {}
        # location state
        self.disk_state = np.zeros(n, dtype=np.int8)
        self.gcs_state = np.zeros(n, dtype=np.int8)
        self.consumers = np.zeros(n, dtype=np.int32)
        # bookkeeping
        self.window = SlidingWindow(spec.disk_limit)
        self.waiting: deque = deque()
        self.waiting_by_fid: Dict[int, List[_Job]] = {}
        self.jobs_for_fid: Dict[int, List[_Job]] = {}
        self.deletable: set = set()
        self.counters = FractionalCounter()
        # links
        self.l_tape_disk = NetworkLink(self.tape, self.disk,
                                       throughput=spec.tape_to_disk_mb_s,
                                       max_active=cfg.max_active)
        self.l_gcs_disk: Optional[NetworkLink] = None
        self.l_disk_gcs: Optional[NetworkLink] = None
        self.l_download = NetworkLink(self.disk, self.worker, throughput=cfg.download)
        # stats
        self.jobs_done = 0
        self.jobs_submitted = 0
        self.running = 0  # jobs between data-ready and completion
        self.download_bytes = 0.0
        self.tape_disk_bytes = 0.0
        self.gcs_disk_bytes = 0.0
        self.disk_gcs_bytes = 0.0
        self.gcs_recalls = np.zeros(n, dtype=np.int32)

    def select_file(self, u: float, power: Optional[float] = None) -> int:
        return int(np.searchsorted(self.cum_w_for(power), u, side="right"))

    def cum_w_for(self, power: Optional[float]) -> np.ndarray:
        """Selection CDF for a workload-scheduled popularity power.

        ``None`` keeps the precomputed base CDF (the stationary fast path);
        drifting workloads quantize the power into a handful of
        piecewise-constant values, so the cache stays tiny.
        """
        if power is None:
            return self.cum_w
        cw = self._cum_w_cache.get(power)
        if cw is None:
            cw = self.popularity.selection_cdf(self.pop, power=power)
            self._cum_w_cache[power] = cw
        return cw


class HCDCScenario:
    def __init__(self, cfg: HCDCConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.sim = BaseSimulation(seed=cfg.seed)
        self.out = OutputCollector()
        self.svc = EventDrivenTransferService(self.sim, self.rng)
        gcs_site = Site("GCS")
        self.gcs = GCSBucket("BUCKET", gcs_site,
                             limit=(None if cfg.gcs_limit is None else cfg.gcs_limit),
                             cost_model=cfg.cost_model)
        self.sites = [_SiteState(self, s, self.rng) for s in cfg.sites]
        for st in self.sites:
            st.l_gcs_disk = NetworkLink(self.gcs, st.disk,
                                        throughput=cfg.gcs_to_disk,
                                        max_active=cfg.max_active)
            st.l_disk_gcs = NetworkLink(st.disk, self.gcs,
                                        throughput=cfg.disk_to_gcs,
                                        max_active=cfg.max_active)
        # Pre-sample job streams (throughput optimization; statistically
        # identical to per-tick sampling), then modulate them with the
        # workload schedule. The schedule draws no randomness and the
        # steady default multiplies by exactly 1.0, so the stationary
        # workload stays bit-identical to the pre-workload engine.
        n_ticks = cfg.simulated_time // cfg.gen_interval + 1
        self._job_counts = TruncatedNormalCount(cfg.jobs_mu, cfg.jobs_sigma).sample(
            self.rng, (len(self.sites), n_ticks))
        sched = cfg.workload.compile(n_ticks, cfg.gen_interval)
        self._job_counts = self._job_counts * sched.rate_mult
        self._sel_power = sched.sel_power
        self._dur_dist = BoundedExponential(cfg.dur_lam, lo=cfg.dur_lo)

    # ------------------------------------------------------------------ jobs
    def _submit_job(self, sim: BaseSimulation, now: int, st: _SiteState,
                    power: Optional[float] = None) -> None:
        fid = st.select_file(float(self.rng.random()), power)
        job = _Job(fid, now)
        st.jobs_submitted += 1
        st.consumers[fid] += 1
        st.deletable.discard(fid)
        ds = st.disk_state[fid]
        if ds == PRESENT:
            self._job_data_ready(sim, now, st, job)
        elif ds == IN_FLIGHT:
            st.jobs_for_fid.setdefault(fid, []).append(job)  # transferring
        else:
            if not self._try_start_input_transfer(sim, now, st, job):
                st.waiting.append(job)
                st.waiting_by_fid.setdefault(fid, []).append(job)

    def _try_start_input_transfer(self, sim: BaseSimulation, now: int,
                                  st: _SiteState, job: _Job) -> bool:
        """Allocate disk space + submit the tape/GCS -> disk transfer."""
        fid = job.fid
        if st.disk_state[fid] == PRESENT:
            self._job_data_ready(sim, now, st, job)
            return True
        if st.disk_state[fid] == IN_FLIGHT:
            st.jobs_for_fid.setdefault(fid, []).append(job)
            return True
        size = float(st.sizes[fid])
        if not st.disk.can_allocate(size):
            return False
        from_gcs = self.cfg.gcs_enabled and st.gcs_state[fid] == PRESENT
        link = st.l_gcs_disk if from_gcs else st.l_tape_disk
        file = File(fid, size, popularity=int(st.pop[fid]))
        st.disk_state[fid] = IN_FLIGHT
        st.jobs_for_fid.setdefault(fid, []).append(job)
        # All jobs waiting on this data enter the transferring state (paper
        # §5.2 'Waiting'): pull them from the FIFO out-of-band.
        for w in st.waiting_by_fid.pop(fid, []):
            if not w.resolved and w is not job:
                w.resolved = True
                st.jobs_for_fid[fid].append(w)

        def done(sim_, now_, t, st=st, fid=fid, from_gcs=from_gcs):
            st.disk_state[fid] = PRESENT
            if from_gcs:
                st.gcs_disk_bytes += t.file.size
                st.gcs_recalls[fid] += 1
            else:
                st.tape_disk_bytes += t.file.size
            for j in st.jobs_for_fid.pop(fid, []):
                self._job_data_ready(sim_, now_, st, j)
            if st.consumers[fid] == 0 and st.disk.limit is not None:
                st.deletable.add(fid)

        self.svc.submit(file, link, on_complete=done)
        return True

    def _gcs_off(self, st: _SiteState) -> int:
        """Global fid offset so the shared bucket keys files per site."""
        return self.sites.index(st) * self.cfg.n_files_per_site

    def _job_data_ready(self, sim: BaseSimulation, now: int,
                        st: _SiteState, job: _Job) -> None:
        """queued -> active -> running -> done, collapsed into one event.

        Downloads are unlimited-concurrency fixed-throughput and job slots
        are unlimited (paper §5.3), so no resource interaction happens
        between 'queued' and completion; the job finishes at
        now + size/download_rate + run_duration.
        """
        job.queued_at = now
        self.out.hist("job_waiting_h").record((now - job.submitted) / HOUR)
        size = float(st.sizes[job.fid])
        dl = size / self.cfg.download
        run = float(self._dur_dist.sample(self.rng))
        st.download_bytes += size
        st.l_download.traffic += size
        st.running += 1

        def finish(sim_, now_, st=st, fid=job.fid):
            st.jobs_done += 1
            st.running -= 1
            st.consumers[fid] -= 1
            if (st.consumers[fid] == 0 and st.disk_state[fid] == PRESENT
                    and st.disk.limit is not None):
                st.deletable.add(fid)

        sim.call_at(now + max(1, int(dl + run)), lambda s, n_: finish(s, n_))

    # ------------------------------------------------------------- deletions
    def _process_deletions(self, sim: BaseSimulation, now: int,
                           st: _SiteState) -> None:
        if st.disk.limit is None or not st.deletable:
            return
        gcs_on = self.cfg.gcs_enabled
        done_fids = []
        for fid in st.deletable:
            if st.consumers[fid] != 0 or st.disk_state[fid] != PRESENT:
                done_fids.append(fid)
                continue
            gfid = fid + self._gcs_off(st)
            if not gcs_on:
                st.disk.delete(fid)
                st.disk_state[fid] = ABSENT
                done_fids.append(fid)
                continue
            if st.gcs_state[fid] == PRESENT:
                st.disk.delete(fid)
                st.disk_state[fid] = ABSENT
                done_fids.append(fid)
            elif st.gcs_state[fid] == ABSENT:
                if not self.cfg.migration_policy.should_migrate(int(st.pop[fid])):
                    st.disk.delete(fid)
                    st.disk_state[fid] = ABSENT
                    done_fids.append(fid)
                    continue
                if not self.gcs.can_allocate(float(st.sizes[fid])):
                    continue  # cold tier full; retry next tick
                st.gcs_state[fid] = IN_FLIGHT
                file = File(gfid, float(st.sizes[fid]), popularity=int(st.pop[fid]))

                def migrated(sim_, now_, t, st=st, fid=fid):
                    st.gcs_state[fid] = PRESENT
                    st.disk_gcs_bytes += t.file.size
                    # delete the hot copy unless it is needed again
                    if st.consumers[fid] == 0 and st.disk_state[fid] == PRESENT:
                        st.disk.delete(fid)
                        st.disk_state[fid] = ABSENT

                self.svc.submit(file, st.l_disk_gcs, on_complete=migrated)
                done_fids.append(fid)
            else:
                done_fids.append(fid)  # migration already in flight
        for fid in done_fids:
            st.deletable.discard(fid)

    # --------------------------------------------------------------- waiting
    def _process_waiting(self, sim: BaseSimulation, now: int,
                         st: _SiteState) -> None:
        while st.waiting:
            job = st.waiting[0]
            if job.resolved:  # left out-of-band (transfer appeared for its data)
                st.waiting.popleft()
                continue
            if self._try_start_input_transfer(sim, now, st, job):
                st.waiting.popleft()
                job.resolved = True
            else:
                break  # strict FIFO for window space (paper §5.2)

    # ------------------------------------------------------------------ tick
    def _make_generator(self) -> Schedulable:
        scenario = self

        class Generator(Schedulable):
            def __init__(self) -> None:
                super().__init__(interval=scenario.cfg.gen_interval)
                self.tick = 0

            def on_update(self, sim: BaseSimulation, now: int) -> None:
                power = (None if scenario._sel_power is None
                         else float(scenario._sel_power[self.tick]))
                for i, st in enumerate(scenario.sites):
                    scenario._process_deletions(sim, now, st)
                    n = st.counters.emit(scenario._job_counts[i][self.tick])
                    for _ in range(n):
                        scenario._submit_job(sim, now, st, power)
                    scenario._process_waiting(sim, now, st)
                if scenario.cfg.curves and self.tick % 360 == 0:  # hourly
                    for st in scenario.sites:
                        scenario.out.ts(f"{st.spec.name}.disk_used").record(now, st.disk.used)
                        scenario.out.ts(f"{st.spec.name}.running_jobs").record(now, st.running)
                    scenario.out.ts("gcs_used").record(now, scenario.gcs.used)
                self.tick += 1

        return Generator()

    # ------------------------------------------------------------------- run
    def run(self) -> Dict[str, float]:
        self.sim.schedule(self._make_generator(), 0)
        self.sim.run(self.cfg.simulated_time)
        self.gcs.finalize(self.cfg.simulated_time)
        return self.metrics()

    def metrics(self) -> Dict[str, float]:
        m: Dict[str, float] = {
            "jobs_done": sum(st.jobs_done for st in self.sites),
            "jobs_submitted": sum(st.jobs_submitted for st in self.sites),
            "download_pb": sum(st.download_bytes for st in self.sites) / 1e15,
            "gcs_to_disk_pb": sum(st.gcs_disk_bytes for st in self.sites) / 1e15,
            "disk_to_gcs_pb": sum(st.disk_gcs_bytes for st in self.sites) / 1e15,
            "gcs_used_pb": self.gcs.used / 1e15,
            "job_waiting_h_mean": self.out.hist("job_waiting_h").mean,
        }
        for st in self.sites:
            m[f"{st.spec.name}.tape_to_disk_pb"] = st.tape_disk_bytes / 1e15
            m[f"{st.spec.name}.jobs_done"] = st.jobs_done
            m[f"{st.spec.name}.disk_used_pb"] = st.disk.used / 1e15
        for i, bill in enumerate(self.gcs.bills):
            m[f"month{i+1}.storage_usd"] = bill.storage_usd
            m[f"month{i+1}.network_usd"] = bill.network_usd
        return m


# Paper reference values (Tables 6/7/8) for benchmark comparison.
PAPER_TABLE6 = {
    "I": {"jobs_done": 996_000, "download_pb": 41.11},
    "II": {"jobs_done": 853_000, "download_pb": 35.28},
    "III": {"jobs_done": 996_000, "download_pb": 41.02},
}
PAPER_TABLE7 = {
    "I": {"Site-1.tape_to_disk_pb": 6.75, "Site-2.tape_to_disk_pb": 6.74},
    "II": {"Site-1.tape_to_disk_pb": 8.85, "Site-2.tape_to_disk_pb": 13.04},
    "III": {"Site-1.tape_to_disk_pb": 6.74, "Site-2.tape_to_disk_pb": 6.75,
            "gcs_to_disk_pb": 24.99},
}
PAPER_TABLE8 = {
    "month1.storage_usd": 82_000, "month1.network_usd": 330_000,
    "month2.storage_usd": 211_000, "month2.network_usd": 729_000,
    "month3.storage_usd": 293_000, "month3.network_usd": 807_000,
}


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
