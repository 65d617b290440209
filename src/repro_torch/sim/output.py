"""Export helpers of the port's sweep results, copied from
``repro.sim.output``: atomic text commits, CSV rows, the paper's
Table 6/7/8 mean and error across runs, and the downsampled
``TimeSeries`` that per-tick series capture
(``repro_torch.sim.batched.series_from_capture``) produces."""

from __future__ import annotations

import csv
import io
import os
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def atomic_write_text(path: str, text: str) -> None:
    """Write a text file via tmp-file + ``os.replace`` atomic commit.

    A reader sees either the previous complete file or the new complete
    file, never a truncated prefix, and an interrupted writer leaves the
    original untouched (plus at most a ``.tmp.`` orphan).
    """
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "w", newline="") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def write_csv(path: str, rows: Sequence[Dict[str, object]],
              fieldnames: Optional[Sequence[str]] = None) -> None:
    """Write dict rows as CSV; columns default to first-seen key order.
    Committed atomically (``atomic_write_text``)."""
    if fieldnames is None:
        seen: Dict[str, None] = {}
        for r in rows:
            for k in r:
                seen.setdefault(k)
        fieldnames = list(seen)
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=list(fieldnames), restval="")
    w.writeheader()
    w.writerows(rows)
    atomic_write_text(path, buf.getvalue())


def mean_and_error(per_run_values: List[float]) -> Tuple[float, float, float]:
    """(mean, std%, standard-error%) across runs — the paper's Table 6/7/8
    presentation."""
    a = np.asarray(per_run_values, dtype=np.float64)
    m = float(a.mean())
    if len(a) < 2 or m == 0.0:
        return m, 0.0, 0.0
    sd = float(a.std(ddof=1))
    se = sd / np.sqrt(len(a))
    return m, 100.0 * sd / m, 100.0 * se / m


@dataclass
class TimeSeries:
    """Downsampled (time, value) series — used volume, transfers/hour, ..."""

    name: str
    times: List[int] = field(default_factory=list)
    values: List[float] = field(default_factory=list)

    def record(self, t: int, v: float) -> None:
        self.times.append(t)
        self.values.append(v)

    def to_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return np.asarray(self.times), np.asarray(self.values)

    def summary(self) -> Dict[str, float]:
        """Scalar digest (min/mean/max/last) — per-config sweep reporting."""
        if not self.values:
            return {"n": 0.0, "min": 0.0, "mean": 0.0, "max": 0.0, "last": 0.0}
        a = np.asarray(self.values, dtype=np.float64)
        return {
            "n": float(len(a)),
            "min": float(a.min()),
            "mean": float(a.mean()),
            "max": float(a.max()),
            "last": float(a[-1]),
        }
