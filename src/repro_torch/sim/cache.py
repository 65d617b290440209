"""Persistent, content-addressed scenario-result cache of the port, a copy
of ``repro.sim.cache`` in the same on-disk entry format.

- **Key** (``repro_torch.core.scenarios.cache_key``): sha256 over the
  canonical JSON of ``(RESULT_SCHEMA_VERSION, engine fingerprint,
  dynamics_key(spec))``. The fingerprint names the port's engine
  (``torch:<tick>`` for the plain tick, ``torch:<tick>:cuda`` for the
  kernels), so its entries never serve the JAX package's ``jax:*`` or
  ``process`` entries, nor each other, even in one directory.
  Pricing-only spec fields are stripped by ``dynamics_key``, so every
  pricing variant of a lane shares one entry.
- **Entry**: one JSON file holding the pricing-independent payload — the
  dynamics metrics (per-month bill keys stripped), the raw monthly
  billing inputs, events, wall time, series digests — plus a provenance
  manifest (spec, engine, port/torch/python/numpy versions, host,
  creation time). Serving a spec re-bills the stored monthly totals
  through the spec's own cost model (``bills_from_monthly_totals``),
  bit-identical to a fresh run on the same engine.
- **Durability**: entries are committed via write-to-temp + ``os.replace``
  (atomic on POSIX). Reads treat any malformed entry (truncated,
  zero-byte, garbage, wrong schema version) as a miss: the entry is
  deleted and the caller recomputes, rewriting a valid one. A cache can
  lose work, never correctness.
- **Backends**: ``StorageBackend`` is a three-method protocol
  (read/write/delete over opaque names); ``LocalDirBackend`` implements
  it on a directory.

``run_sweep(cache=...)`` and ``SweepDriver(cache=...)`` read through this
module (get-or-compute), so refinement rounds and the ``decide()`` solvers
share one store.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
import uuid
from dataclasses import asdict, dataclass

from typing import (Any, Dict, Iterable, Iterator, List, Optional, Protocol,
                    Tuple, Union, runtime_checkable)

import numpy as np
import torch

from repro_torch.core.scenarios import (
    RESULT_SCHEMA_VERSION,
    ScenarioSpec,
    build_config,
    cache_key,
    dynamics_key,
    engine_fingerprint,
)
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.sim.cloud import bills_from_monthly_totals
from repro_torch.sim.sweep import ScenarioResult
from repro_torch.version import __version__

#: Metric-key prefix of the pricing-dependent per-month bill entries the
#: batched program adds (``month1.storage_usd`` ...). Stripped before an
#: entry is stored and recomputed from the spec's cost model at serve time.
_MONTH_METRIC_PREFIX = "month"

#: Keys every stored ``monthly`` block must carry, all list-valued and of
#: equal length (one element per closed billing month).
_MONTHLY_ARRAYS = ("gb_seconds", "egress_bytes", "class_a", "class_b")


@runtime_checkable
class StorageBackend(Protocol):
    """Minimal blob-store interface the cache runs on.

    Names are opaque relative identifiers (``ab/ab12...f.json``). ``write``
    MUST be atomic-visibility: a concurrent ``read`` sees either a previous
    complete blob or the new complete blob, never a prefix — on a local
    filesystem that is write-to-temp + rename; on an object store, a
    single-request put. ``read`` returns ``None`` for a missing name and
    ``delete`` ignores one: the cache treats every storage hiccup as a
    miss, never an error.
    """

    def read(self, name: str) -> Optional[bytes]:
        ...

    def write(self, name: str, data: bytes) -> None:
        ...

    def delete(self, name: str) -> None:
        ...


class LocalDirBackend:
    """``StorageBackend`` on a local directory (one file per entry)."""

    def __init__(self, root: Union[str, os.PathLike]):
        self.root = os.fspath(root)

    def __repr__(self) -> str:
        return f"LocalDirBackend({self.root!r})"

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def read(self, name: str) -> Optional[bytes]:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except OSError:
            return None

    def write(self, name: str, data: bytes) -> None:
        path = self._path(name)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # Unique temp name per writer (pid + random suffix), published via
        # os.replace: atomic on POSIX, so a reader never observes a torn
        # entry and concurrent same-key writers race to an arbitrary but
        # *complete* winner. A killed writer leaves only a .tmp. orphan,
        # which readers never look at.
        tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def delete(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except OSError:
            pass

    def names(self) -> Iterator[str]:
        """All published entry names (maintenance/stats; not part of the
        ``StorageBackend`` protocol)."""
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".json") and ".tmp." not in fn:
                    yield os.path.relpath(os.path.join(dirpath, fn),
                                          self.root)


@dataclass
class CacheStats:
    """Counters for one ``ResultCache`` instance's lifetime."""

    hits: int = 0
    misses: int = 0
    corrupt: int = 0  # entries rejected (and deleted) on read
    writes: int = 0

    def as_dict(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "corrupt": self.corrupt, "writes": self.writes}


def entry_name(key: str) -> str:
    """Relative storage name of a key's entry, sharded by prefix so a
    local backend never accumulates millions of files in one directory."""
    return f"{key[:2]}/{key}.json"


class _BadEntry(ValueError):
    """An entry failed structural validation (treated as corrupt)."""


def _validate_entry(doc: Any) -> Dict[str, Any]:
    """Structural validation of a decoded entry; raises ``_BadEntry``.

    Anything that would make the serve path crash or lie — wrong shape,
    wrong schema version, mismatched monthly arrays, non-numeric values —
    rejects the entry so the caller recomputes instead.
    """
    if not isinstance(doc, dict):
        raise _BadEntry("entry is not an object")
    if doc.get("schema_version") != RESULT_SCHEMA_VERSION:
        raise _BadEntry(f"schema_version {doc.get('schema_version')!r} != "
                        f"{RESULT_SCHEMA_VERSION}")
    payload = doc.get("payload")
    if not isinstance(payload, dict):
        raise _BadEntry("missing payload")
    if not isinstance(payload.get("metrics"), dict):
        raise _BadEntry("missing metrics")
    if not all(isinstance(v, (int, float))
               for v in payload["metrics"].values()):
        raise _BadEntry("non-numeric metric")
    monthly = payload.get("monthly")
    if not isinstance(monthly, dict):
        raise _BadEntry("missing monthly totals")
    n = None
    for k in _MONTHLY_ARRAYS:
        v = monthly.get(k)
        if not isinstance(v, list) or \
                not all(isinstance(x, (int, float)) for x in v):
            raise _BadEntry(f"monthly.{k} is not a numeric list")
        if n is None:
            n = len(v)
        elif len(v) != n:
            raise _BadEntry("monthly arrays disagree in length")
    if not isinstance(monthly.get("full_months"), int):
        raise _BadEntry("monthly.full_months is not an int")
    if not isinstance(payload.get("events"), int):
        raise _BadEntry("events is not an int")
    if not isinstance(payload.get("series", {}), dict):
        raise _BadEntry("series is not an object")
    return doc


def _dynamics_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """The pricing-independent metrics: per-month bill keys stripped."""
    return {k: v for k, v in metrics.items()
            if not (k.startswith(_MONTH_METRIC_PREFIX)
                    and (k.endswith(".storage_usd")
                         or k.endswith(".network_usd")))}


def _serve(spec: ScenarioSpec, payload: Dict[str, Any]) -> ScenarioResult:
    """Materialize a stored dynamics payload as the *requested* spec's
    result: re-bill the raw monthly totals through the spec's own cost
    model. Bit-identical to a fresh run on the same engine — the stored
    floats round-trip JSON exactly and pass through the same formulas."""
    cost_model = build_config(spec).cost_model
    mo = payload["monthly"]
    bills = bills_from_monthly_totals(
        cost_model, mo["gb_seconds"], mo["egress_bytes"],
        mo["class_a"], mo["class_b"], mo["full_months"])
    metrics = dict(payload["metrics"])
    for i, bill in enumerate(bills):
        metrics[f"month{i+1}.storage_usd"] = bill.storage_usd
        metrics[f"month{i+1}.network_usd"] = bill.network_usd
    return ScenarioResult(
        spec=spec,
        metrics=metrics,
        storage_usd=sum(b.storage_usd for b in bills),
        network_usd=sum(b.network_usd for b in bills),
        ops_usd=sum(b.ops_usd for b in bills),
        wall_s=float(payload.get("wall_s", 0.0)),
        events=int(payload["events"]),
        series={k: dict(v) for k, v in payload.get("series", {}).items()},
        monthly={"gb_seconds": list(mo["gb_seconds"]),
                 "egress_bytes": list(mo["egress_bytes"]),
                 "class_a": list(mo["class_a"]),
                 "class_b": list(mo["class_b"]),
                 "full_months": mo["full_months"]},
    )


class ResultCache:
    """Get-or-compute front of the persistent result store.

    ``get``/``put`` move single results; ``fetch``/``store`` are the batch
    forms ``run_sweep``/``SweepDriver`` use. All reads are fail-open: a
    missing, unreadable, or invalid entry is a miss (invalid ones are
    deleted so the recompute's ``put`` repairs the store), and ``stats``
    counts hits/misses/corrupt/writes for reporting.
    """

    def __init__(self, backend: Union[StorageBackend, str, os.PathLike]):
        if isinstance(backend, (str, os.PathLike)):
            backend = LocalDirBackend(backend)
        self.backend = backend
        self.stats = CacheStats()

    def __repr__(self) -> str:
        return f"ResultCache({self.backend!r}, stats={self.stats.as_dict()})"

    # -- single-entry interface ---------------------------------------------
    def get(self, spec: ScenarioSpec, backend: str = "torch",
            tick: Optional[float] = None,
            tick_impl: Optional[str] = None) -> Optional[ScenarioResult]:
        """The spec's result served from the store, or ``None`` (miss).

        ``tick_impl`` must be a *resolved* implementation name
        (``"torch"``, the default ``None``, or ``"cuda"``); it is part of
        the key, so entries of the plain tick and of the kernels never
        serve each other (``engine_fingerprint``).
        """
        key = cache_key(spec, backend=backend, tick=tick,
                        tick_impl=tick_impl)
        reg = get_registry()
        with get_tracer().span("cache.get", key=key[:12]):
            data = self.backend.read(entry_name(key))
            if data is None:
                self.stats.misses += 1
                reg.inc("cache.misses", help="Result-cache lookup misses")
                return None
            try:
                doc = _validate_entry(json.loads(data.decode("utf-8")))
                with get_tracer().span("cache.rebill", key=key[:12]):
                    result = _serve(spec, doc["payload"])
            except Exception:
                # Truncated/garbage JSON, wrong schema version, structural
                # rot: never crash, never serve bad data — drop the entry
                # and let the caller recompute (whose put() rewrites a
                # valid one).
                self.stats.corrupt += 1
                self.stats.misses += 1
                reg.inc("cache.corrupt",
                        help="Result-cache entries dropped as invalid")
                reg.inc("cache.misses", help="Result-cache lookup misses")
                self.backend.delete(entry_name(key))
                return None
            self.stats.hits += 1
            reg.inc("cache.hits", help="Result-cache lookup hits")
            return result

    def put(self, spec: ScenarioSpec, result: ScenarioResult,
            backend: str = "torch", tick: Optional[float] = None,
            tick_impl: Optional[str] = None) -> bool:
        """Store a result's dynamics payload under the spec's key.

        Returns ``False`` (and stores nothing) for results without raw
        monthly totals — synthetic ``ScenarioResult``s that never
        simulated cannot be re-billed and must not populate the store.
        """
        if not result.monthly:
            return False
        key = cache_key(spec, backend=backend, tick=tick,
                        tick_impl=tick_impl)
        self._write_entry(key, spec, result, backend, tick, tick_impl)
        return True

    # -- batch interface (what run_sweep/SweepDriver call) ------------------
    def fetch(self, specs: Iterable[ScenarioSpec],
              backend: str = "torch", tick: Optional[float] = None,
              tick_impl: Optional[str] = None
              ) -> Dict[ScenarioSpec, ScenarioResult]:
        """Served results for every spec with a stored entry (hits only)."""
        out: Dict[ScenarioSpec, ScenarioResult] = {}
        for spec in dict.fromkeys(specs):
            result = self.get(spec, backend=backend, tick=tick,
                              tick_impl=tick_impl)
            if result is not None:
                out[spec] = result
        return out

    def store(self, pairs: Iterable[Tuple[ScenarioSpec, ScenarioResult]],
              backend: str = "torch", tick: Optional[float] = None,
              tick_impl: Optional[str] = None) -> int:
        """Store a batch of (spec, result) pairs; one write per distinct
        key (pricing variants of a lane collapse to one entry). Returns
        the number of entries written."""
        written = 0
        done = set()
        for spec, result in pairs:
            if not result.monthly:
                continue
            key = cache_key(spec, backend=backend, tick=tick,
                            tick_impl=tick_impl)
            if key in done:
                continue
            done.add(key)
            self._write_entry(key, spec, result, backend, tick, tick_impl)
            written += 1
        return written

    # -- entry codec --------------------------------------------------------
    def _write_entry(self, key: str, spec: ScenarioSpec,
                     result: ScenarioResult, backend: str,
                     tick: Optional[float],
                     tick_impl: Optional[str] = None) -> None:
        doc = {
            "schema_version": RESULT_SCHEMA_VERSION,
            "key": key,
            "manifest": {
                "spec": asdict(dynamics_key(spec)),
                "engine": engine_fingerprint(backend, tick, tick_impl),
                "backend": backend,
                "tick": float(10.0 if tick is None else tick),
                "tick_impl": tick_impl or "torch",
                "package_version": __version__,
                "python": sys.version.split()[0],
                "numpy": np.__version__,
                "torch": torch.__version__,
                "host": socket.gethostname(),
                "created_unix": time.time(),
                "wall_s": result.wall_s,
            },
            "payload": {
                "metrics": _dynamics_metrics(result.metrics),
                "monthly": result.monthly,
                "events": int(result.events),
                "wall_s": result.wall_s,
                "series": result.series,
            },
        }
        with get_tracer().span("cache.put", key=key[:12]):
            self.backend.write(entry_name(key),
                               json.dumps(doc).encode("utf-8"))
        self.stats.writes += 1
        get_registry().inc("cache.writes",
                           help="Result-cache entries written")


def as_cache(cache: Union["ResultCache", StorageBackend, str, os.PathLike,
                          None]) -> Optional["ResultCache"]:
    """Coerce a user-supplied cache argument into a ``ResultCache``."""
    if cache is None or isinstance(cache, ResultCache):
        return cache
    return ResultCache(cache)


__all__: List[str] = [
    "StorageBackend", "LocalDirBackend", "CacheStats", "ResultCache",
    "as_cache", "entry_name",
]
