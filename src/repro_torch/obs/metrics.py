"""Labeled metrics registry with process-safe snapshots, copied from
``repro.obs.metrics``.

The decision workflow's operational story — "is the cache warm?", "how
many lanes did this run simulate?", "how long did packing and the graph
capture take?" — goes into one sink: a registry of labeled Counters,
Gauges, and Histograms that every layer of the port increments, exported
as Prometheus text exposition format (``to_prometheus``) or JSON
(``snapshot``/``to_json_dict``). ``merge`` folds another registry's
snapshot in — counters and histograms add, gauges last-write-wins — and
``snapshot_and_reset`` is the delta a worker process would hand back.

The registry is stdlib only. A disabled registry (``enabled = False``)
turns every ``inc``/``set_gauge``/``observe`` into an early-out attribute
check, and the enabled path is one dict update under a lock.

Naming: metric names are dotted (``cache.hits``, ``lanes.simulated``);
the Prometheus exporter rewrites characters outside ``[a-zA-Z0-9_:]``
to ``_`` (``cache_hits``). Snapshot keys keep the dotted form; labeled
series append ``{k=v,...}`` with label keys sorted. Labels are plain
keyword arguments, so the parameter names of the mutators (``name``,
``amount``, ``value``, ``help``, ``buckets``, ``default``) are reserved
and cannot be label keys.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

#: Default histogram bucket upper bounds (seconds-flavoured; the +Inf
#: bucket is implicit). Matches the Prometheus convention of cumulative
#: ``le`` buckets.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)

_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _label_key(labels: Mapping[str, Any]) -> str:
    """Canonical series key for a label set ('' = unlabeled)."""
    if not labels:
        return ""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def _series_name(name: str, label_key: str) -> str:
    """Snapshot key of one series: ``name`` or ``name{k=v,...}``."""
    return name if not label_key else f"{name}{{{label_key}}}"


def split_series_name(series: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of the snapshot key: ``name{k=v}`` -> (name, labels)."""
    if not series.endswith("}") or "{" not in series:
        return series, {}
    name, _, rest = series.partition("{")
    labels = {}
    for part in rest[:-1].split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


class _Hist:
    """One histogram series: cumulative bucket counts + sum + count."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last bucket = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for i, b in enumerate(self.bounds):
            if value <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.sum += value
        self.count += 1

    def as_dict(self) -> Dict[str, Any]:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}

    def merge(self, other: Mapping[str, Any]) -> None:
        if list(other.get("bounds", [])) != list(self.bounds):
            # Different bucketing cannot be merged bucket-wise; fold the
            # mass into sum/count so totals stay right.
            self.sum += float(other.get("sum", 0.0))
            self.count += int(other.get("count", 0))
            return
        for i, c in enumerate(other.get("counts", [])):
            if i < len(self.counts):
                self.counts[i] += int(c)
        self.sum += float(other.get("sum", 0.0))
        self.count += int(other.get("count", 0))


class MetricsRegistry:
    """Process-local registry of labeled counters, gauges, histograms.

    All mutation goes through ``inc``/``set_gauge``/``observe`` (or the
    bound helpers returned by ``counter``/``gauge``/``histogram``);
    ``snapshot`` returns a JSON-safe dict and ``merge`` folds another
    snapshot in.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[str, float]] = {}
        self._gauges: Dict[str, Dict[str, float]] = {}
        self._hists: Dict[str, Dict[str, _Hist]] = {}
        self._help: Dict[str, str] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}

    # -- switches -----------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # -- mutation -----------------------------------------------------------
    def inc(self, name: str, amount: float = 1.0, help: str = "",
            **labels: Any) -> None:
        """Add ``amount`` to a counter series (creating it at 0)."""
        if not self.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + amount

    def set_gauge(self, name: str, value: float, help: str = "",
                  **labels: Any) -> None:
        """Set a gauge series to ``value`` (last write wins)."""
        if not self.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            self._gauges.setdefault(name, {})[key] = float(value)

    def observe(self, name: str, value: float, help: str = "",
                buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                **labels: Any) -> None:
        """Record one observation into a histogram series."""
        if not self.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            bounds = self._buckets.setdefault(name, tuple(buckets))
            series = self._hists.setdefault(name, {})
            h = series.get(key)
            if h is None:
                h = series[key] = _Hist(bounds)
            h.observe(float(value))

    # -- lookup -------------------------------------------------------------
    def value(self, name: str, default: float = 0.0,
              **labels: Any) -> float:
        """Current value of a counter or gauge series (tests/benches)."""
        key = _label_key(labels)
        with self._lock:
            for store in (self._counters, self._gauges):
                if name in store and key in store[name]:
                    return store[name][key]
        return default

    # -- snapshot / merge ---------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe image of every series (the worker/export payload)."""
        with self._lock:
            return {
                "counters": {_series_name(n, k): v
                             for n, s in sorted(self._counters.items())
                             for k, v in sorted(s.items())},
                "gauges": {_series_name(n, k): v
                           for n, s in sorted(self._gauges.items())
                           for k, v in sorted(s.items())},
                "histograms": {_series_name(n, k): s[k].as_dict()
                               for n, s in sorted(self._hists.items())
                               for k in sorted(s)},
            }

    def merge(self, snap: Optional[Mapping[str, Any]]) -> None:
        """Fold a snapshot in: counters/histograms add, gauges assign."""
        if not snap:
            return
        for series, v in snap.get("counters", {}).items():
            name, labels = split_series_name(series)
            was, self.enabled = self.enabled, True
            try:
                self.inc(name, float(v), **labels)
            finally:
                self.enabled = was
        for series, v in snap.get("gauges", {}).items():
            name, labels = split_series_name(series)
            key = _label_key(labels)
            with self._lock:
                self._gauges.setdefault(name, {})[key] = float(v)
        for series, doc in snap.get("histograms", {}).items():
            name, labels = split_series_name(series)
            key = _label_key(labels)
            with self._lock:
                bounds = self._buckets.setdefault(
                    name, tuple(doc.get("bounds", DEFAULT_BUCKETS)))
                h = self._hists.setdefault(name, {}).get(key)
                if h is None:
                    h = self._hists[name][key] = _Hist(bounds)
                h.merge(doc)

    def reset(self) -> None:
        """Drop every recorded value (metric help/bucket defs survive)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- exporters ----------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""

        def prom(name: str) -> str:
            return _PROM_NAME.sub("_", name)

        def labelstr(key: str, extra: str = "") -> str:
            parts = []
            if key:
                for part in key.split(","):
                    k, _, v = part.partition("=")
                    v = v.replace("\\", r"\\").replace('"', r"\"")
                    parts.append(f'{prom(k)}="{v}"')
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        lines = []
        with self._lock:
            for kind, store in (("counter", self._counters),
                                ("gauge", self._gauges)):
                for name, series in sorted(store.items()):
                    p = prom(name)
                    if name in self._help:
                        lines.append(f"# HELP {p} {self._help[name]}")
                    lines.append(f"# TYPE {p} {kind}")
                    for key, v in sorted(series.items()):
                        lines.append(f"{p}{labelstr(key)} {v:g}")
            for name, series in sorted(self._hists.items()):
                p = prom(name)
                if name in self._help:
                    lines.append(f"# HELP {p} {self._help[name]}")
                lines.append(f"# TYPE {p} histogram")
                for key, h in sorted(series.items()):
                    acc = 0
                    for bound, c in zip(h.bounds, h.counts):
                        acc += c
                        le = 'le="%g"' % bound
                        lines.append(f"{p}_bucket{labelstr(key, le)} {acc}")
                    inf = 'le="+Inf"'
                    lines.append(f"{p}_bucket{labelstr(key, inf)} {h.count}")
                    lines.append(f"{p}_sum{labelstr(key)} {h.sum:g}")
                    lines.append(f"{p}_count{labelstr(key)} {h.count}")
        return "\n".join(lines) + "\n"

    def to_json_dict(self) -> Dict[str, Any]:
        """Snapshot plus export metadata (for ``--metrics-out *.json``)."""
        doc = self.snapshot()
        doc["exported_unix"] = time.time()
        return doc

    def dump(self, path: str) -> None:
        """Write the registry to ``path``: Prometheus text unless the
        path ends in ``.json``."""
        if path.endswith(".json"):
            data = json.dumps(self.to_json_dict(), indent=2)
        else:
            data = self.to_prometheus()
        with open(path, "w") as f:
            f.write(data)


#: Process-global registry — every layer's default sink.
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global :class:`MetricsRegistry`."""
    return _REGISTRY


def snapshot_and_reset(registry: Optional[MetricsRegistry] = None
                       ) -> Dict[str, Any]:
    """Snapshot then clear — a worker's delta for ``merge``."""
    reg = registry or _REGISTRY
    snap = reg.snapshot()
    reg.reset()
    return snap


__all__: Iterable[str] = [
    "DEFAULT_BUCKETS", "MetricsRegistry", "get_registry",
    "snapshot_and_reset", "split_series_name",
]
