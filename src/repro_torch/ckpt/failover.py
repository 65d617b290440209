"""Failure detection + elastic rescale planning, a copy of
``repro.ckpt.failover`` (pure host logic).

- ``FailureDetector``: heartbeat registry; a worker silent past
  ``timeout_s`` is declared failed. The training driver polls
  ``failed_workers()`` each step.
- ``ElasticPlanner``: given surviving device count, picks the largest
  feasible mesh (data axis shrinks first — TP size is fixed by the model's
  head/ffn divisibility), rescales the global batch or the microbatch
  count, and reports the re-lower spec. Restart resumes from the latest
  durable checkpoint step + the data pipeline position (both in the
  checkpoint manifest), so a failure costs at most one checkpoint
  interval. The port trains on one card; the planner's arithmetic is
  ``repro``'s, for the multi-GPU design that will read it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


class FailureDetector:
    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self._last: Dict[str, float] = {}
        self._failed: set = set()

    def heartbeat(self, worker: str, now: float) -> None:
        if worker not in self._failed:
            self._last[worker] = now

    def failed_workers(self, now: float) -> List[str]:
        for w, t in self._last.items():
            if now - t > self.timeout_s:
                self._failed.add(w)
        return sorted(self._failed)

    def healthy(self, now: float) -> List[str]:
        bad = set(self.failed_workers(now))
        return sorted(w for w in self._last if w not in bad)


@dataclass
class RescalePlan:
    data: int
    model: int
    pods: int
    global_batch: int
    microbatches: int
    note: str = ""

    @property
    def devices(self) -> int:
        return self.data * self.model * self.pods


class ElasticPlanner:
    """Choose a new mesh after failures (or scale-up)."""

    def __init__(self, model_tp: int = 16, chips_per_host: int = 4):
        self.model_tp = model_tp
        self.chips_per_host = chips_per_host

    def plan(self, surviving_chips: int, global_batch: int,
             pods: int = 1) -> RescalePlan:
        tp = self.model_tp
        per_pod = surviving_chips // pods
        data = max(1, per_pod // tp)
        # data axis must divide the global batch; shrink to the largest
        # power-of-two divisor if needed
        while data > 1 and global_batch % (data * pods):
            data -= 1
        micro = max(1, global_batch // (data * pods))
        return RescalePlan(
            data=data, model=tp, pods=pods, global_batch=global_batch,
            microbatches=micro,
            note=(f"rescaled to {pods}x{data}x{tp} from {surviving_chips} "
                  f"surviving chips"),
        )
