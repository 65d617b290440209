"""Transfers and transfer managers of the event-driven engine (paper
§4.1), and the dense link table of the fixed-tick program, copied from
``repro.sim.transfer``.

The event engine has two kinds of event: *transfer generators* (the model
logic, one per scenario in ``repro_torch.core``) and *transfer managers*
(which update the active transfers each tick). Two tick managers exist:

- ``BandwidthTransferManager``: each tick advances every active transfer
  by ``rate * dt``, the rate being the link's shared-bandwidth share or its
  fixed per-transfer throughput;
- ``DurationTransferManager``: advances each transfer by a fixed increment
  so it completes after a configured duration.

``EventDrivenTransferService`` is the analytic path for throughput-mode
links (the only mode the HCDC scenario uses): a transfer completes at
``start + access_latency + size/throughput`` under a FIFO ``max_active``
slot queue, so it schedules completion events directly instead of ticking.

``LinkTickTable`` holds the same links as dense arrays for the batched
tick program (``repro_torch.sim.batched``).
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.sim.cloud import GCSBucket
from repro_torch.sim.engine import BaseSimulation, Schedulable
from repro_torch.sim.infrastructure import File, NetworkLink, Replica


class TransferState(enum.Enum):
    QUEUED = 0
    LATENCY = 1  # slot held, deferred by tape access latency
    ACTIVE = 2
    DONE = 3


class Transfer:
    __slots__ = (
        "file", "link", "dst_replica", "state", "created", "started",
        "completed", "latency", "on_complete", "rate",
    )

    def __init__(self, file: File, link: NetworkLink, dst_replica: Replica,
                 created: int):
        self.file = file
        self.link = link
        self.dst_replica = dst_replica
        self.state = TransferState.QUEUED
        self.created = created
        self.started: Optional[int] = None
        self.completed: Optional[int] = None
        self.latency: float = 0.0
        self.rate: float = 0.0
        self.on_complete: List[Callable[[BaseSimulation, int, "Transfer"], None]] = []

    @property
    def duration(self) -> Optional[float]:
        """Transfer duration excluding queue wait (Table 2 metric)."""
        if self.completed is None or self.started is None:
            return None
        return self.completed - self.started


def _finish(sim: BaseSimulation, now: int, t: Transfer) -> None:
    t.state = TransferState.DONE
    t.completed = now
    t.dst_replica.size_done = t.file.size
    t.link.active -= 1
    t.link.traffic += t.file.size
    src, dst = t.link.src, t.link.dst
    if isinstance(src, GCSBucket):
        src.record_egress(now, t.file.size)
    if isinstance(dst, GCSBucket):
        dst.record_ingress(now, t.file.size)
    for cb in list(t.on_complete):
        cb(sim, now, t)


class EventDrivenTransferService:
    """Analytic completion scheduling for throughput-mode links."""

    def __init__(self, sim: BaseSimulation, rng):
        self.sim = sim
        self.rng = rng
        self._queues: Dict[int, deque] = {}  # by id(link): names repeat across sites
        self.completed_count = 0
        self.completed_bytes = 0.0
        self.durations_sum = 0.0

    def submit(self, file: File, link: NetworkLink,
               on_complete: Optional[Callable] = None) -> Transfer:
        if link.throughput is None:
            raise ValueError("EventDrivenTransferService requires throughput links")
        dst_replica = link.dst.allocate(file)
        t = Transfer(file, link, dst_replica, self.sim.now)
        if on_complete is not None:
            t.on_complete.append(on_complete)
        q = self._queues.setdefault(id(link), deque())
        if link.has_slot():
            self._start(t)
        else:
            link.queued += 1
            q.append(t)
        return t

    def _start(self, t: Transfer) -> None:
        link = t.link
        link.active += 1
        t.latency = link.src.sample_latency(self.rng)
        t.rate = link.throughput
        t.state = TransferState.LATENCY if t.latency > 0 else TransferState.ACTIVE
        t.started = self.sim.now + int(round(t.latency))
        done_at = t.started + max(1, int(round(t.file.size / t.rate)))
        self.sim.call_at(done_at, lambda sim, now, t=t: self._complete(sim, now, t))

    def _complete(self, sim: BaseSimulation, now: int, t: Transfer) -> None:
        _finish(sim, now, t)
        self.completed_count += 1
        self.completed_bytes += t.file.size
        self.durations_sum += t.duration
        q = self._queues.get(id(t.link))
        while q and t.link.has_slot():
            nxt = q.popleft()
            t.link.queued -= 1
            self._start(nxt)


@dataclass(frozen=True)
class LinkTickTable:
    """Link ``m`` advances an active transfer by ``bw[m] * dt`` bytes per
    tick (throughput mode) or ``bw[m]/count * dt`` (shared mode), holds at
    most ``slots[m]`` concurrent transfers, and defers progress by
    ``latency[m]`` seconds after a slot is taken (tape access latency)."""

    bw: np.ndarray  # [M] f32, bytes/s
    slots: np.ndarray  # [M] f32, max concurrent transfers (inf = unlimited)
    latency: np.ndarray  # [M] f32, seconds before progress starts
    mode: np.ndarray  # [M] i32, 1 = per-transfer throughput, 0 = shared

    @classmethod
    def from_values(cls, rates: Sequence[float],
                    slots: Sequence[Optional[float]],
                    latencies: Sequence[float],
                    modes: Optional[Sequence[int]] = None) -> "LinkTickTable":
        m = len(rates)
        if modes is None:
            modes = [1] * m
        return cls(
            bw=np.asarray(rates, dtype=np.float32),
            slots=np.asarray([np.inf if s is None else float(s)
                              for s in slots], dtype=np.float32),
            latency=np.asarray(latencies, dtype=np.float32),
            mode=np.asarray(modes, dtype=np.int32),
        )

    @classmethod
    def from_links(cls, links: Sequence[NetworkLink]) -> "LinkTickTable":
        return cls.from_values(
            rates=[ln.throughput if ln.throughput is not None
                   else ln.bandwidth for ln in links],
            slots=[ln.max_active for ln in links],
            latencies=[ln.src.access_latency for ln in links],
            modes=[1 if ln.throughput is not None else 0 for ln in links],
        )

    def __len__(self) -> int:
        return int(self.bw.shape[0])


class BandwidthTransferManager(Schedulable):
    """Tick manager #1: progress by link rate x dt.

    Handles both link modes (shared bandwidth divided among active
    transfers, fixed per-transfer throughput), and enforces ``max_active``
    FIFO slot queues and tape access latency.
    """

    def __init__(self, interval: int = 1, rng=None):
        super().__init__(interval=interval, priority=-1)  # run before generators
        self.rng = rng
        self.active: List[Transfer] = []
        self._queues: Dict[int, deque] = {}  # by id(link): names repeat across sites
        self._last_update: Optional[int] = None
        self.completed_count = 0
        self.completed_bytes = 0.0
        self.durations_sum = 0.0
        self.tick_traffic: float = 0.0  # bytes moved during the last tick

    def submit(self, sim: BaseSimulation, file: File, link: NetworkLink,
               on_complete: Optional[Callable] = None) -> Transfer:
        dst_replica = link.dst.allocate(file)
        t = Transfer(file, link, dst_replica, sim.now)
        if on_complete is not None:
            t.on_complete.append(on_complete)
        if link.has_slot():
            self._activate(sim, t)
        else:
            link.queued += 1
            self._queues.setdefault(id(link), deque()).append(t)
        return t

    def _activate(self, sim: BaseSimulation, t: Transfer) -> None:
        link = t.link
        link.active += 1
        t.latency = link.src.sample_latency(self.rng)
        t.started = sim.now + int(round(t.latency))
        t.state = TransferState.LATENCY if t.latency > 0 else TransferState.ACTIVE
        self.active.append(t)

    def on_update(self, sim: BaseSimulation, now: int) -> None:
        last = self._last_update if self._last_update is not None else now - self.interval
        dt = now - last
        self._last_update = now
        if dt <= 0:
            return
        self.tick_traffic = 0.0
        # Count active (past-latency) transfers per link first — the share
        # each transfer gets this tick.
        n_active: Dict[int, int] = {}
        for t in self.active:
            if now >= t.started:
                t.state = TransferState.ACTIVE
                n_active[id(t.link)] = n_active.get(id(t.link), 0) + 1
        finished: List[Transfer] = []
        for t in self.active:
            if t.state is not TransferState.ACTIVE:
                continue
            rate = t.link.rate_per_transfer(n_active[id(t.link)])
            t.rate = rate
            inc = min(rate * dt, t.file.size - t.dst_replica.size_done)
            t.dst_replica.size_done += inc
            self.tick_traffic += inc
            if t.dst_replica.size_done >= t.file.size:
                finished.append(t)
        for t in finished:
            self.active.remove(t)
            _finish(sim, now, t)
            self.completed_count += 1
            self.completed_bytes += t.file.size
            self.durations_sum += t.duration
            q = self._queues.get(id(t.link))
            while q and t.link.has_slot():
                nxt = q.popleft()
                t.link.queued -= 1
                self._activate(sim, nxt)


class DurationTransferManager(Schedulable):
    """Tick manager #2: a fixed increment per tick, so the replica
    completes after a configured duration."""

    def __init__(self, duration: int, interval: int = 1):
        super().__init__(interval=interval, priority=-1)
        self.duration = max(1, int(duration))
        self.active: List[Transfer] = []
        self.completed_count = 0

    def submit(self, sim: BaseSimulation, file: File, link: NetworkLink,
               on_complete: Optional[Callable] = None) -> Transfer:
        dst_replica = link.dst.allocate(file)
        t = Transfer(file, link, dst_replica, sim.now)
        if on_complete is not None:
            t.on_complete.append(on_complete)
        t.started = sim.now
        t.state = TransferState.ACTIVE
        t.link.active += 1
        self.active.append(t)
        return t

    def on_update(self, sim: BaseSimulation, now: int) -> None:
        finished = []
        for t in self.active:
            inc = t.file.size * self.interval / self.duration
            t.dst_replica.size_done = min(t.file.size, t.dst_replica.size_done + inc)
            if now - t.started >= self.duration:
                t.dst_replica.size_done = t.file.size
                finished.append(t)
        for t in finished:
            self.active.remove(t)
            _finish(sim, now, t)
            self.completed_count += 1
