"""The data-carousel sliding window (paper §2.1), copied from
``repro.core.carousel``.

The carousel stages data through a bounded window of fast storage: data
*allocates* space in the window, is transferred in, processed, then
*deallocated*. Only window-sized fast storage is needed at any one time.
``SlidingWindow`` is the byte-budget accounting object the HCDC scenario
keeps for each site's disk; ``LRUTracker`` orders window members by last
use (the LRU replacement of §6, future work (v)).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Hashable, Optional


class SlidingWindow:
    """Bounded byte-budget window with FIFO waiter admission.

    Of the paper's window-size limits (§2.1: available storage, input
    volume, source throughput, compute) this object enforces only the
    storage budget — throughput/compute pressure shows up as waiters
    queueing.
    """

    def __init__(self, limit: Optional[float]):
        self.limit = limit  # bytes; None = unbounded (configuration I)
        self.used: float = 0.0
        self._members: Dict[Hashable, float] = {}

    def can_allocate(self, size: float) -> bool:
        return self.limit is None or self.used + size <= self.limit

    def allocate(self, key: Hashable, size: float) -> bool:
        if key in self._members:
            return True
        if not self.can_allocate(size):
            return False
        self._members[key] = size
        self.used += size
        return True

    def release(self, key: Hashable) -> float:
        size = self._members.pop(key, 0.0)
        self.used -= size
        return size

    def __contains__(self, key: Hashable) -> bool:
        return key in self._members

    def __len__(self) -> int:
        return len(self._members)

    @property
    def free(self) -> float:
        return float("inf") if self.limit is None else self.limit - self.used


class LRUTracker:
    """Least-recently-used ordering over window members."""

    def __init__(self) -> None:
        self._order: "OrderedDict[Hashable, None]" = OrderedDict()

    def touch(self, key: Hashable) -> None:
        self._order.pop(key, None)
        self._order[key] = None

    def evict_candidates(self):
        """Keys, least recently used first."""
        return iter(self._order.keys())

    def drop(self, key: Hashable) -> None:
        self._order.pop(key, None)

    def __len__(self) -> int:
        return len(self._order)
