"""HCDC tiered store: the paper's model as a production data-path feature.
A copy of ``repro.data.tiered_store`` on the port's own ``core.carousel``,
``core.hotcold`` and ``sim.cloud``: host code, no torch, its statistics
and prefetch waits equal to ``repro``'s on the same schedule
(``tests/test_torch_ckpt_data.py``).

Training shards live in three tiers mirroring the paper's QoS categories:

  archival (tape / cold object store)  — every shard, high latency
  cold     (cloud bucket)              — popularity-driven cache, elastic
  hot      (local disk/SSD)            — the carousel sliding window

``SlidingWindowPrefetcher`` is the data-carousel: it keeps the hot window
full of upcoming shards (allocate -> fetch -> consume -> evict), preferring
cold-tier hits over archival reads (the HCDC claim: equal throughput at a
fraction of hot storage). Evicted-but-popular shards migrate hot -> cold
(popularity threshold from ``core.hotcold.MigrationPolicy``); the
cold tier trims via ``ColdDeletionPolicy`` (beyond-paper §6 feature). The
paper's GCS cost model meters cold-tier bills so a training run reports
its cloud cost alongside throughput.

Straggler mitigation: fetches outstanding longer than ``straggler_factor``
x the EWMA fetch latency are re-issued against the other tier (duplicate
fetch), the data-layer analogue of backup tasks — motivated directly by
the paper's Fig. 7 backlog analysis.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.carousel import LRUTracker, SlidingWindow
from repro_torch.core.hotcold import ColdDeletionPolicy, MigrationPolicy
from repro_torch.sim.cloud import GCSCostModel


@dataclass
class TierSpec:
    name: str
    limit: Optional[float]           # bytes; None = unbounded
    latency_s: float                 # access latency
    bandwidth: float                 # bytes/s
    cost_model: Optional[GCSCostModel] = None  # billed tier (cold/cloud)


@dataclass
class Shard:
    sid: int
    size: float
    popularity: int = 1  # expected epochs-until-reuse proxy


class _Clock:
    """Injectable clock (tests use a manual clock)."""

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self.fn = fn or time.monotonic

    def now(self) -> float:
        return self.fn()


class TieredStore:
    def __init__(self, archival: TierSpec, cold: TierSpec, hot: TierSpec,
                 migration: MigrationPolicy = MigrationPolicy(),
                 cold_deletion: ColdDeletionPolicy = ColdDeletionPolicy(0.9),
                 clock: Optional[Callable[[], float]] = None):
        self.archival = archival
        self.cold = cold
        self.hot = hot
        self.migration = migration
        self.cold_deletion = cold_deletion
        self.clock = _Clock(clock)
        self.hot_window = SlidingWindow(hot.limit)
        self.cold_window = SlidingWindow(cold.limit)
        self.cold_lru = LRUTracker()
        self.shards: Dict[int, Shard] = {}
        # metrics
        self.stats = {
            "archival_reads": 0, "cold_hits": 0, "hot_hits": 0,
            "archival_bytes": 0.0, "cold_bytes": 0.0,
            "migrated_bytes": 0.0, "evicted_bytes": 0.0,
            "cold_egress_usd": 0.0, "straggler_refetches": 0,
        }

    def register(self, shards: List[Shard]) -> None:
        for s in shards:
            self.shards[s.sid] = s

    # ------------------------------------------------------------ fetch path
    def locate(self, sid: int) -> str:
        if sid in self.hot_window:
            return "hot"
        if sid in self.cold_window:
            return "cold"
        return "archival"

    def fetch_latency(self, sid: int) -> float:
        """Simulated fetch time into the hot tier."""
        s = self.shards[sid]
        tier = self.locate(sid)
        if tier == "hot":
            return 0.0
        src = self.cold if tier == "cold" else self.archival
        return src.latency_s + s.size / src.bandwidth

    def fetch_to_hot(self, sid: int) -> Tuple[str, float]:
        """Bring a shard into the hot window. Returns (source, latency)."""
        s = self.shards[sid]
        tier = self.locate(sid)
        if tier == "hot":
            self.stats["hot_hits"] += 1
            return "hot", 0.0
        if not self.hot_window.allocate(sid, s.size):
            raise RuntimeError("hot window full: evict before fetch")
        lat = self.fetch_latency(sid)
        if tier == "cold":
            self.stats["cold_hits"] += 1
            self.stats["cold_bytes"] += s.size
            if self.cold.cost_model is not None:
                self.stats["cold_egress_usd"] += \
                    self.cold.cost_model.egress_cost(s.size)
            self.cold_lru.touch(sid)
        else:
            self.stats["archival_reads"] += 1
            self.stats["archival_bytes"] += s.size
        return tier, lat

    # ------------------------------------------------------------- eviction
    def evict_from_hot(self, sid: int) -> None:
        """Carousel deallocation; popular shards migrate to cold first."""
        s = self.shards[sid]
        size = self.hot_window.release(sid)
        self.stats["evicted_bytes"] += size
        if sid in self.cold_window:
            return
        if not self.migration.should_migrate(s.popularity):
            return
        self._trim_cold(s.size)
        if self.cold_window.allocate(sid, s.size):
            self.stats["migrated_bytes"] += s.size
            self.cold_lru.touch(sid)

    def _trim_cold(self, incoming: float) -> None:
        """Beyond-paper cold-tier deletion (paper §6 'essential feature')."""
        target = self.cold_deletion.trim_target(
            self.cold_window.limit,
            self.cold_window.used + incoming)
        if target <= 0:
            return
        victims = []
        for sid in self.cold_lru.evict_candidates():
            if target <= 0:
                break
            sz = self.shards[sid].size
            victims.append(sid)
            target -= sz
        for sid in victims:
            self.cold_window.release(sid)
            self.cold_lru.drop(sid)


class SlidingWindowPrefetcher:
    """The data carousel over a schedule of shard ids.

    Keeps the hot window filled with the next shards of the schedule;
    ``next_batch`` blocks (simulated latency accounting) until the head
    shard is resident, then consumes + evicts it. Duplicate-fetch
    straggler mitigation re-sources fetches that exceed
    ``straggler_factor`` x EWMA latency.
    """

    def __init__(self, store: TieredStore, schedule: List[int],
                 straggler_factor: float = 3.0):
        self.store = store
        self.schedule = list(schedule)
        self.straggler_factor = straggler_factor
        self._inflight: Dict[int, float] = {}  # sid -> expected latency
        self._ewma: float = 0.0
        self.pos = 0
        self.total_wait_s = 0.0

    def _prefetch(self) -> None:
        i = self.pos
        while i < len(self.schedule):
            sid = self.schedule[i]
            s = self.store.shards[sid]
            if sid in self.store.hot_window or sid in self._inflight:
                i += 1
                continue
            if not self.store.hot_window.can_allocate(s.size):
                break
            src, lat = self.store.fetch_to_hot(sid)
            if lat > 0:
                # straggler check: a fetch predicted far beyond EWMA gets
                # re-sourced if the other tier is faster (duplicate fetch)
                if (self._ewma > 0 and
                        lat > self.straggler_factor * self._ewma and
                        src == "archival" and sid in self.store.cold_window):
                    self.store.stats["straggler_refetches"] += 1
                    lat = self.store.cold.latency_s + s.size / self.store.cold.bandwidth
                self._inflight[sid] = lat
                self._ewma = 0.8 * self._ewma + 0.2 * lat if self._ewma else lat
            i += 1

    def next_shard(self) -> Tuple[int, float]:
        """Consume the next scheduled shard. Returns (sid, wait_s)."""
        if self.pos >= len(self.schedule):
            raise StopIteration
        sid = self.schedule[self.pos]
        self._prefetch()
        wait = self._inflight.pop(sid, 0.0)
        self.total_wait_s += wait
        self.pos += 1
        # consumed: carousel eviction (hot -> cold migration inside)
        self.store.evict_from_hot(sid)
        return sid, wait

    def drain(self) -> Dict[str, float]:
        while self.pos < len(self.schedule):
            self.next_shard()
        return dict(self.store.stats, total_wait_s=self.total_wait_s)
