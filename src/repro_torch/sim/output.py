"""Output module (paper §4.1), copied from ``repro.sim.output``: atomic
text commits, CSV rows, the paper's Table 6/7/8 mean and error across
runs, the downsampled ``TimeSeries`` (the event engine's Fig. 6/8 curves,
and what per-tick series capture, ``repro_torch.sim.batched.
series_from_capture``, produces), and the event engine's metric sink
(``OutputCollector``: counters, series, and the ``Histogram`` of the
Fig. 7 waiting times)."""

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


@dataclass
class Histogram:
    name: str
    samples: List[float] = field(default_factory=list)

    def record(self, x: float) -> None:
        self.samples.append(x)

    def counts(self, bins: int = 30):
        return np.histogram(np.asarray(self.samples), bins=bins)

    @property
    def mean(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0


class OutputCollector:
    """Scenario-level metric sink of the event engine."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.series: Dict[str, TimeSeries] = {}
        self.hists: Dict[str, Histogram] = {}

    def count(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def ts(self, name: str) -> TimeSeries:
        if name not in self.series:
            self.series[name] = TimeSeries(name)
        return self.series[name]

    def hist(self, name: str) -> Histogram:
        if name not in self.hists:
            self.hists[name] = Histogram(name)
        return self.hists[name]

    def summary(self) -> Dict[str, float]:
        out = dict(self.counters)
        for name, h in self.hists.items():
            out[f"{name}.mean"] = h.mean
            out[f"{name}.n"] = float(len(h.samples))
        return out
