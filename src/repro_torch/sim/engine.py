"""Event loop, clock and schedulables of the event-driven engine (paper
§4), copied from ``repro.sim.engine``.

Events (subprograms) are scheduled at integer time points (one second is
the smallest step). Each iteration of the loop executes every event of the
current time point, ordered by ``(priority, schedule order)``, and then
jumps the clock to the next scheduled time point: it does not tick through
empty seconds. The heap order ``(time, priority, seq)`` is ``repro``'s, so
a scenario run here executes its events in the same order as there.

``Schedulable`` is the base class of every event; on execution it may
reschedule itself (``interval``) or schedule new events. ``BaseSimulation``
owns the heap, the clock and the run loop. The engine is host code (plain
Python on numpy draws); it imports neither torch nor a device.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.obs.metrics import get_registry

SECOND = 1
MINUTE = 60 * SECOND
HOUR = 60 * MINUTE
DAY = 24 * HOUR


class Schedulable:
    """Base class of every event scheduled during a run.

    Subclasses implement ``on_update(sim, now)``. With ``interval`` set the
    event reschedules itself every ``interval`` seconds (the transfer
    generator / transfer manager pattern).
    """

    def __init__(self, interval: Optional[int] = None, priority: int = 0):
        self.interval = interval
        self.priority = priority
        self.cancelled = False

    def on_update(self, sim: "BaseSimulation", now: int) -> None:
        raise NotImplementedError

    def cancel(self) -> None:
        self.cancelled = True


@dataclass(order=True)
class _HeapEntry:
    time: int
    priority: int
    seq: int
    event: Schedulable = field(compare=False)


class BaseSimulation:
    """Owns the clock and the event heap; executes the event loop.

    Every iteration pops all events of the earliest time point, executes
    them (by ``priority``, then schedule order), and lets self-rescheduling
    events re-enter the heap.
    """

    def __init__(self, seed: int = 0):
        self._heap: list[_HeapEntry] = []
        self._seq = itertools.count()
        self.now: int = 0
        self.seed = seed
        self._stop_time: Optional[int] = None
        self.events_executed: int = 0  # run-loop work metric (sweep rows)

    # -- scheduling ---------------------------------------------------------
    def schedule(self, event: Schedulable, at: int) -> None:
        if at < self.now:
            raise ValueError(f"cannot schedule in the past ({at} < {self.now})")
        heapq.heappush(
            self._heap, _HeapEntry(int(at), event.priority, next(self._seq), event)
        )

    def schedule_in(self, event: Schedulable, delay: int) -> None:
        self.schedule(event, self.now + int(delay))

    def call_at(self, when: int, fn: Callable[["BaseSimulation", int], None],
                priority: int = 0) -> Schedulable:
        ev = _FnEvent(fn, priority=priority)
        self.schedule(ev, when)
        return ev

    # -- run loop -----------------------------------------------------------
    def run(self, until: int) -> None:
        """Run the event loop until the clock passes ``until`` (seconds)."""
        self._stop_time = int(until)
        executed_before = self.events_executed
        heap = self._heap
        while heap and heap[0].time <= self._stop_time:
            now = heap[0].time
            self.now = now
            # Execute every event of this time point.
            while heap and heap[0].time == now:
                entry = heapq.heappop(heap)
                ev = entry.event
                if ev.cancelled:
                    continue
                self.events_executed += 1
                ev.on_update(self, now)
                if ev.interval is not None and not ev.cancelled:
                    self.schedule(ev, now + ev.interval)
        self.now = self._stop_time
        # One increment per run() call, not per event: the loop body stays
        # free of registry calls.
        get_registry().inc("engine.events",
                           self.events_executed - executed_before,
                           help="Event-loop pops executed")

    def pending_events(self) -> int:
        return sum(1 for e in self._heap if not e.event.cancelled)


class _FnEvent(Schedulable):
    def __init__(self, fn: Callable[[BaseSimulation, int], None], priority: int = 0):
        super().__init__(interval=None, priority=priority)
        self._fn = fn

    def on_update(self, sim: BaseSimulation, now: int) -> None:
        self._fn(sim, now)
