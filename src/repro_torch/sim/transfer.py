"""Dense link-parameter table of the fixed-tick engine, copied from
``repro.sim.transfer.LinkTickTable`` (``from_values`` only)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


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
