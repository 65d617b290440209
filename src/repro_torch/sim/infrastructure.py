"""Infrastructure of the event-driven engine (paper §4.1): sites, storage
elements, links, files and replicas, copied from
``repro.sim.infrastructure``.

- ``StorageElement``: a storage area with runtime data (used volume,
  stored replicas), on one ``Site``; it may have a capacity limit (the
  HCDC disk limit of Table 5) and a tape-style access latency.
- ``NetworkLink``: a directional connection between two storage elements
  that tracks traffic and active transfers; either a shared ``bandwidth``
  (divided among active transfers) or a per-transfer ``throughput``, plus
  an optional ``max_active`` slot limit (Table 4: 100).
- ``File``: size, expiration and popularity; ``Replica``: a file at a
  storage element, with a partial ``size_done`` while transferring.

The byte units are shared with the batched program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional

KB = 1000.0
MB = 1000.0**2
GB = 1000.0**3
TB = 1000.0**4
PB = 1000.0**5

KiB = 1024.0
MiB = 1024.0**2
GiB = 1024.0**3
TiB = 1024.0**4


@dataclass
class File:
    """A transferable data object (size + expiration time)."""

    fid: int
    size: float  # bytes
    expires_at: Optional[int] = None
    popularity: int = 1  # times the file will be processed (HCDC metric)


class Replica:
    """A file stored (fully or partially) at a storage element."""

    __slots__ = ("file", "se", "size_done")

    def __init__(self, file: File, se: "StorageElement", size_done: float = 0.0):
        self.file = file
        self.se = se
        self.size_done = size_done

    @property
    def complete(self) -> bool:
        return self.size_done >= self.file.size

    def __repr__(self) -> str:  # pragma: no cover
        return f"Replica({self.file.fid}@{self.se.name}, {self.size_done}/{self.file.size})"


class StorageElement:
    """A storage area with QoS properties and runtime accounting."""

    def __init__(
        self,
        name: str,
        site: "Site",
        limit: Optional[float] = None,
        access_latency: float = 0.0,
        latency_sampler=None,
    ):
        self.name = name
        self.site = site
        self.limit = limit  # bytes; None = unlimited
        self.access_latency = access_latency  # seconds (tape mount/position)
        self.latency_sampler = latency_sampler  # optional callable -> seconds
        self.used: float = 0.0  # bytes allocated (incl. in-flight reservations)
        self.replicas: Dict[int, Replica] = {}
        site.storage_elements[name] = self

    # -- capacity accounting -------------------------------------------------
    def can_allocate(self, size: float) -> bool:
        return self.limit is None or self.used + size <= self.limit

    def allocate(self, file: File) -> Replica:
        """Reserve space and create an (initially empty) replica."""
        if file.fid in self.replicas:
            raise ValueError(f"{file.fid} already at {self.name}")
        if not self.can_allocate(file.size):
            raise RuntimeError(f"{self.name} over limit")
        self.used += file.size
        r = Replica(file, self)
        self.replicas[file.fid] = r
        return r

    def add_complete_replica(self, file: File) -> Replica:
        r = self.allocate(file)
        r.size_done = file.size
        return r

    def delete(self, fid: int) -> None:
        r = self.replicas.pop(fid)
        self.used -= r.file.size

    def has_complete(self, fid: int) -> bool:
        r = self.replicas.get(fid)
        return r is not None and r.complete

    def sample_latency(self, rng) -> float:
        if self.latency_sampler is not None:
            return float(self.latency_sampler(rng))
        return float(self.access_latency)

    def __repr__(self) -> str:  # pragma: no cover
        return f"SE({self.name}, used={self.used/TB:.2f}TB)"


class Site:
    """A data centre pooling storage elements (WLCG 'site')."""

    def __init__(self, name: str):
        self.name = name
        self.storage_elements: Dict[str, StorageElement] = {}

    def se(self, name: str) -> StorageElement:
        return self.storage_elements[name]


class NetworkLink:
    """Directional link between two storage elements.

    Exactly one of ``bandwidth`` (shared; divided among active transfers)
    or ``throughput`` (per transfer; independent of concurrency) is set —
    the two link modes of §4.1.
    """

    def __init__(
        self,
        src: StorageElement,
        dst: StorageElement,
        bandwidth: Optional[float] = None,  # bytes/s shared
        throughput: Optional[float] = None,  # bytes/s per transfer
        max_active: Optional[int] = None,
    ):
        if (bandwidth is None) == (throughput is None):
            raise ValueError("configure exactly one of bandwidth/throughput")
        self.src = src
        self.dst = dst
        self.bandwidth = bandwidth
        self.throughput = throughput
        self.max_active = max_active
        self.active: int = 0  # currently active transfers
        self.queued: int = 0  # transfers waiting for a slot
        self.traffic: float = 0.0  # total bytes moved over this link

    @property
    def name(self) -> str:
        return f"{self.src.name}->{self.dst.name}"

    def rate_per_transfer(self, n_active: Optional[int] = None) -> float:
        """Current bytes/s seen by one active transfer."""
        n = self.active if n_active is None else n_active
        if self.throughput is not None:
            return self.throughput
        if n <= 0:
            return self.bandwidth
        return self.bandwidth / n

    def has_slot(self) -> bool:
        return self.max_active is None or self.active < self.max_active

    def __repr__(self) -> str:  # pragma: no cover
        return f"Link({self.name}, active={self.active})"


def link_table(links: Iterable[NetworkLink]) -> Dict[tuple, NetworkLink]:
    return {(ln.src.name, ln.dst.name): ln for ln in links}
