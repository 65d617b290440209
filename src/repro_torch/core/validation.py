"""Validation scenario (paper §4.2, Tables 1 and 2), copied from
``repro.core.validation``.

Three sites, 1000 initial replicas each, two outgoing links per site (a
full mesh of 6 directional links), per-transfer throughput 8.10 MB/s.
Each generator tick (10 s), per link, a number of transfers is generated
from the fitted exponential (lambda = 3.33437); source files are selected
uniformly among files not already at (or in flight to) the destination;
after a completed transfer the destination replica is deleted so the file
becomes selectable again. File sizes ~ Exp(lambda = 0.61972) GiB clamped
to [10.23 MB, 13.73 GB].

Unit note: the internally consistent reading of Table 2 is a *per-second*
total transfer rate of 1.80 (traffic 3.11 GB/s = 1.80/s x 1.73 GB), i.e.
per link-tick the generated count has mean 0.29995 x 10.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.sim.distributions import BoundedExponential, FractionalCounter
from repro_torch.sim.engine import DAY, HOUR, BaseSimulation, Schedulable
from repro_torch.sim.infrastructure import (
    GB,
    File,
    GiB,
    NetworkLink,
    Site,
    StorageElement,
)
from repro_torch.sim.output import OutputCollector
from repro_torch.sim.transfer import EventDrivenTransferService


@dataclass
class ValidationConfig:
    simulated_time: int = 59 * DAY + 19 * HOUR
    gen_interval: int = 10
    n_sites: int = 3
    initial_replicas: int = 1000
    throughput: float = 8.10e6  # bytes/s per transfer (MB = 1e6)
    size_lam: float = 0.61972  # per GiB
    size_lo: float = 10.23e6 / GiB  # GiB
    size_hi: float = 13.73e9 / GiB  # GiB
    rate_lam: float = 3.33437  # exp sample; mean 0.29995 per link per second
    per_second_rate: bool = True  # see unit note above
    seed: int = 0


class ValidationScenario:
    """Builds and runs the §4.2 scenario; exposes Table-2 metrics."""

    def __init__(self, cfg: ValidationConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.sim = BaseSimulation(seed=cfg.seed)
        self.out = OutputCollector()
        self.sites: List[Site] = []
        self.links: List[NetworkLink] = []
        self._size_dist = BoundedExponential(
            cfg.size_lam, cfg.size_lo, cfg.size_hi, unit=GiB
        )
        self._next_fid = 0
        self._files: Dict[str, List[File]] = {}  # per-site file pools
        self._in_flight: Set[Tuple[int, str]] = set()  # (fid, dst SE)
        self._build()

    # -- infrastructure -------------------------------------------------------
    def _build(self) -> None:
        cfg = self.cfg
        ses: List[StorageElement] = []
        for i in range(cfg.n_sites):
            site = Site(f"site-{i+1}")
            se = StorageElement("DATADISK", site)
            self.sites.append(site)
            ses.append(se)
            pool = []
            for _ in range(cfg.initial_replicas):
                f = self._new_file()
                se.add_complete_replica(f)
                pool.append(f)
            self._files[se.site.name] = pool
        for i, src in enumerate(ses):
            for j, dst in enumerate(ses):
                if i != j:
                    self.links.append(
                        NetworkLink(src, dst, throughput=cfg.throughput)
                    )
        self.svc = EventDrivenTransferService(self.sim, self.rng)

    def _new_file(self) -> File:
        self._next_fid += 1
        size = float(self._size_dist.sample(self.rng))
        return File(self._next_fid, size)

    # -- generator ------------------------------------------------------------
    def _make_generator(self) -> Schedulable:
        scenario = self

        class Generator(Schedulable):
            def __init__(self) -> None:
                super().__init__(interval=scenario.cfg.gen_interval)
                self.counters = {ln.name: FractionalCounter()
                                 for ln in scenario.links}

            def on_update(self, sim: BaseSimulation, now: int) -> None:
                cfg = scenario.cfg
                scale = cfg.gen_interval if cfg.per_second_rate else 1
                for link in scenario.links:
                    x = scenario.rng.exponential(1.0 / cfg.rate_lam) * scale
                    n = self.counters[link.name].emit(x)
                    for _ in range(n):
                        scenario._generate_transfer(sim, now, link)

        return Generator()

    def _generate_transfer(self, sim: BaseSimulation, now: int,
                           link: NetworkLink) -> None:
        pool = self._files[link.src.site.name]
        dst = link.dst
        # Uniform-randomly select a source file not already at / in flight to
        # the destination; create a new file if the candidate does not qualify
        # (paper §4.2: "In case no replica meets the select conditions, a new
        # replica is created"). A single draw (rather than retrying) is the
        # reading that reproduces Table 2's unbiased 1.73 GB mean: retrying
        # around in-flight files biases selection against large files, whose
        # transfers occupy the in-flight set longer.
        file: Optional[File] = None
        cand = pool[int(self.rng.integers(len(pool)))]
        if cand.fid not in dst.replicas and (cand.fid, dst.name) not in self._in_flight:
            file = cand
        if file is None:
            file = self._new_file()
            link.src.add_complete_replica(file)
            pool.append(file)
        self._in_flight.add((file.fid, dst.name))
        self.out.count("transfers_created")

        def done(sim: BaseSimulation, t_now: int, t) -> None:
            self._in_flight.discard((file.fid, dst.name))
            self.out.count("transfers_done")
            self.out.count("bytes_done", file.size)
            self.out.hist("file_size").record(file.size)
            self.out.hist("duration").record(t.duration)
            # Delete the destination replica again so the file can be
            # re-transferred (paper §4.2).
            dst.delete(file.fid)

        self.svc.submit(file, link, on_complete=done)

    # -- run + metrics ---------------------------------------------------------
    def run(self) -> Dict[str, float]:
        self.sim.schedule(self._make_generator(), 0)
        self.sim.run(self.cfg.simulated_time)
        return self.metrics()

    def metrics(self) -> Dict[str, float]:
        t = max(self.sim.now, 1)
        done = self.out.counters.get("transfers_done", 0.0)
        vol = self.out.counters.get("bytes_done", 0.0)
        return {
            # Table 2 rows (simulated):
            "file_size_gb": self.out.hist("file_size").mean / GB,
            "transfers_per_s": done / t,
            "throughput_mb_s": self.cfg.throughput / 1e6,
            "traffic_gb_s": vol / t / GB,
            "duration_s": self.out.hist("duration").mean,
            "transfers_done": done,
        }


# Paper Table 2 reference values (simulated column).
PAPER_TABLE2 = {
    "file_size_gb": 1.73,
    "transfers_per_s": 1.80,
    "throughput_mb_s": 8.01,
    "traffic_gb_s": 3.11,
    "duration_s": 214.10,
}
