"""Sweep results and the port's sweep front door (paper §5.3 decision
workflow), copied from ``repro.sim.sweep`` for ``backend="torch"``.

- ``ScenarioResult`` / ``SweepResult``: the same records, metric keys and
  exports (CSV/JSON, Pareto front, seed aggregation in the paper's Table
  6/7/8 mean/sd% presentation) as the JAX package's;
- ``run_sweep(specs, cache=...)``: one grid on the port's batched program
  (``repro_torch.sim.batched.run_sweep_torch``), get-or-compute through
  the persistent result cache (``repro_torch.sim.cache``) when one is
  given;
- ``SweepDriver``: the iterative front end the decision layer
  (``repro_torch.sim.decide``) calls in a loop — memo -> cache ->
  simulate, with its books in the metrics registry.

The resilient job path, the worker fleet, lane chunking, series capture
and sharding are not part of the port yet: their knobs raise
``ValueError``.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.scenarios import ScenarioSpec, dynamics_key
from repro_torch.kernels.registry import resolve_device, resolve_tick_impl
from repro_torch.obs.metrics import get_registry
from repro_torch.sim.output import atomic_write_text, mean_and_error, write_csv


@dataclass
class ScenarioResult:
    """Outcome of one simulated configuration."""

    spec: ScenarioSpec
    metrics: Dict[str, float]
    storage_usd: float
    network_usd: float
    ops_usd: float
    wall_s: float
    events: int
    series: Dict[str, Dict[str, float]] = field(default_factory=dict)
    #: Raw per-month billing inputs: ``{"gb_seconds": [...], "egress_bytes":
    #: [...], "class_a": [...], "class_b": [...], "full_months": int}``;
    #: pricing-independent, so ``bills_from_monthly_totals`` re-bills them
    #: bit-exactly under any cost model, which is how the result cache
    #: serves pricing variants of one stored dynamics lane. Empty for
    #: synthetic results that never simulated.
    monthly: Dict[str, Any] = field(default_factory=dict)

    @property
    def cost_usd(self) -> float:
        return self.storage_usd + self.network_usd + self.ops_usd

    @property
    def jobs_done(self) -> float:
        return self.metrics["jobs_done"]

    @property
    def jobs_per_day(self) -> float:
        return self.jobs_done / self.spec.days

    def row(self) -> Dict[str, Any]:
        """Flat record for CSV/JSON export."""
        m = self.metrics
        r: Dict[str, Any] = {"label": self.spec.label}
        r.update(self.spec.to_dict())
        del r["curves"]
        r.update(
            jobs_done=m["jobs_done"],
            jobs_per_day=self.jobs_per_day,
            job_waiting_h_mean=m["job_waiting_h_mean"],
            download_pb=m["download_pb"],
            tape_to_disk_pb=sum(v for k, v in m.items()
                                if k.endswith(".tape_to_disk_pb")),
            gcs_to_disk_pb=m["gcs_to_disk_pb"],
            disk_to_gcs_pb=m["disk_to_gcs_pb"],
            gcs_used_pb=m["gcs_used_pb"],
            storage_usd=self.storage_usd,
            network_usd=self.network_usd,
            ops_usd=self.ops_usd,
            cost_usd=self.cost_usd,
            cost_per_kjob=1e3 * self.cost_usd / max(m["jobs_done"], 1.0),
            wall_s=self.wall_s,
            events=self.events,
        )
        return r


def pareto_indices(costs: Sequence[float],
                   values: Sequence[float]) -> List[int]:
    """Indices of the non-dominated (min cost, max value) points, sorted by
    cost ascending; of identical (cost, value) points only the first."""
    if len(costs) != len(values):
        raise ValueError("costs and values must have equal length")
    order = sorted(range(len(costs)), key=lambda i: (costs[i], -values[i]))
    front: List[int] = []
    best = float("-inf")
    for i in order:
        if values[i] > best:
            front.append(i)
            best = values[i]
    return front


@dataclass
class SweepResult:
    """Ordered results of one sweep (same order as the input specs)."""

    results: List[ScenarioResult]
    wall_s: float = 0.0
    #: Distinct dynamics lanes actually *simulated* to answer this call
    #: (``None`` when the call ran without that accounting). A fully warm
    #: cache read reports 0 here.
    lanes_simulated: Optional[int] = None
    #: Distinct requested specs answered from the persistent result cache.
    cache_hits: int = 0
    #: Reports of abandoned work, as in the JAX package's record; the port
    #: has no retrying job path yet, so this stays empty.
    failures: List[Any] = field(default_factory=list)

    #: Below this wall-clock floor a throughput rate is noise, not signal.
    WALL_S_FLOOR = 1e-3

    def __len__(self) -> int:
        return len(self.results)

    @property
    def ok(self) -> bool:
        """True when no sweep work was abandoned."""
        return not self.failures

    @property
    def configs_per_sec(self) -> Optional[float]:
        """Throughput, or ``None`` when ``wall_s`` is under 1 ms (a fully
        cache-warm sweep)."""
        if self.wall_s < self.WALL_S_FLOOR:
            return None
        return len(self.results) / self.wall_s

    # -- frontier ------------------------------------------------------------
    def pareto_front(self) -> List[ScenarioResult]:
        """Cost/throughput frontier: min cloud cost, max jobs done."""
        idx = pareto_indices([r.cost_usd for r in self.results],
                             [r.jobs_done for r in self.results])
        return [self.results[i] for i in idx]

    # -- tabulation ----------------------------------------------------------
    def rows(self) -> List[Dict[str, Any]]:
        front = {id(r) for r in self.pareto_front()}
        out = []
        for r in self.results:
            row = r.row()
            row["pareto"] = int(id(r) in front)
            out.append(row)
        return out

    def aggregate_seeds(self) -> List[Dict[str, Any]]:
        """Group by spec-minus-seed; mean and sd% across seeds (the paper's
        Table 6/7/8 multi-run presentation)."""
        groups: Dict[ScenarioSpec, List[ScenarioResult]] = {}
        for r in self.results:
            groups.setdefault(replace(r.spec, seed=0), []).append(r)
        rows = []
        for key, rs in groups.items():
            jobs_m, jobs_sd, _ = mean_and_error([r.jobs_done for r in rs])
            cost_m, cost_sd, _ = mean_and_error([r.cost_usd for r in rs])
            row: Dict[str, Any] = {"label": key.label.rsplit(",seed=", 1)[0]}
            row.update(key.to_dict())
            del row["curves"], row["seed"]
            row.update(n_seeds=len(rs), jobs_done_mean=jobs_m,
                       jobs_done_sd_pct=jobs_sd, cost_usd_mean=cost_m,
                       cost_usd_sd_pct=cost_sd,
                       cost_per_kjob_mean=1e3 * cost_m / max(jobs_m, 1.0))
            rows.append(row)
        return rows

    # -- export --------------------------------------------------------------
    def to_csv(self, path: str) -> None:
        write_csv(path, self.rows())

    def pareto_to_csv(self, path: str) -> None:
        write_csv(path, [r.row() for r in self.pareto_front()])

    def to_json(self, path: str) -> None:
        """JSON export, committed atomically (tmp file + ``os.replace``)."""
        doc = {
            "wall_s": self.wall_s,
            "rows": self.rows(),
            "pareto": [r.spec.label for r in self.pareto_front()],
            "series": {r.spec.label: r.series
                       for r in self.results if r.series},
        }
        if self.configs_per_sec is not None:
            doc["configs_per_sec"] = self.configs_per_sec
        if self.lanes_simulated is not None:
            doc["lanes_simulated"] = self.lanes_simulated
            doc["cache_hits"] = self.cache_hits
        if self.failures:
            doc["failures"] = list(self.failures)
        atomic_write_text(path, json.dumps(doc, indent=2))


#: Knobs of ``repro.sim.sweep.run_sweep`` / ``SweepDriver`` that the port
#: does not run yet.
_LATER_KNOBS = ("retry", "faults", "transport", "lane_chunk",
                "record_series", "shard")


def _check_knobs(where: str, backend: str, knobs: Dict[str, Any]) -> None:
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (the port runs "
                         "backend='torch' only)")
    for name in knobs:
        if name in _LATER_KNOBS:
            raise ValueError(f"{name}= is not supported by the torch "
                             "backend yet")
        raise TypeError(f"{where}() got an unexpected keyword argument "
                        f"{name!r}")


def run_sweep(specs: Sequence[ScenarioSpec], backend: str = "torch",
              tick: float = 10.0, tick_impl: str = "auto",
              device=None, cache: Optional[Any] = None,
              **knobs: Any) -> SweepResult:
    """Run a spec grid on the port's batched program; results keep the
    input order.

    ``backend`` must be ``"torch"``; ``tick`` is the clock step in seconds,
    ``tick_impl`` the kernel implementation (``repro_torch.kernels.
    registry``), ``device`` where it runs (``cuda`` when None).

    ``cache`` (a ``repro_torch.sim.cache.ResultCache`` or a directory)
    turns the call into get-or-compute: specs whose dynamics entry is
    stored are served from it (re-billed for their pricing fields,
    bit-identical to a fresh run on the same engine), only the misses are
    simulated, and their results are stored back. ``tick_impl`` is
    resolved before keying, so the plain tick's and the kernels' entries
    never serve each other. ``SweepResult.lanes_simulated``/``cache_hits``
    report the split.

    Any of ``retry``, ``faults``, ``transport``, ``lane_chunk``,
    ``record_series`` or ``shard`` raises ``ValueError``.
    """
    _check_knobs("run_sweep", backend, knobs)
    # deferred: batched and cache import this module
    from repro_torch.sim.batched import run_sweep_torch

    impl = resolve_tick_impl(tick_impl, device).name
    if cache is None:
        return run_sweep_torch(specs, tick=tick, tick_impl=impl,
                               device=device)
    from repro_torch.sim.cache import as_cache

    cache = as_cache(cache)
    specs = list(specs)
    t0 = time.perf_counter()
    hits = cache.fetch(specs, backend=backend, tick=tick, tick_impl=impl)
    miss = [s for s in dict.fromkeys(specs) if s not in hits]
    computed: Dict[ScenarioSpec, ScenarioResult] = {}
    if miss:
        res = run_sweep_torch(miss, tick=tick, tick_impl=impl, device=device)
        computed = {r.spec: r for r in res.results}
        cache.store(computed.items(), backend=backend, tick=tick,
                    tick_impl=impl)
    merged = {**hits, **computed}
    return SweepResult(
        results=[merged[s] for s in specs],
        wall_s=time.perf_counter() - t0,
        lanes_simulated=len({dynamics_key(s) for s in computed}),
        cache_hits=len(hits))


class SweepDriver:
    """Iterative ``run_sweep`` front end with cross-round memoization.

    The decision layer (``repro_torch.sim.decide``) calls the sweep in a
    loop — adaptive grid refinement, break-even bisection — where
    successive rounds re-request many already-simulated specs plus a few
    new ones. The driver runs only the unseen specs (one ``run_sweep``
    call a round, so new specs still pack into one grid) and answers the
    rest from memory.

    ``tick_impl`` is resolved for ``device`` once, here
    (``repro_torch.kernels.registry.resolve_tick_impl``), and pinned for
    the driver's lifetime; ``self.tick_impl`` is the resolved name
    (``"torch"`` or ``"cuda"``) and keys the cache.

    The books the decision layer reports on:

    - ``lanes_simulated``: distinct dynamics lanes ever simulated (the
      ``dynamics_key`` identity). The memo is per exact spec: pricing-only
      variants of a memoized spec arriving in a later call re-simulate
      their lane unless a persistent cache serves them;
    - ``configs_run`` / ``sweep_calls`` / ``wall_s``: raw work counters —
      cache-served specs never count as work;
    - ``cache_hits``: specs answered from the persistent result cache.

    ``cache`` adds a persistent tier between the memo and the engine:
    memo -> cache -> simulate. Simulated results are stored back, so a
    re-run of the same workflow answers from disk (``lanes_simulated``
    stays 0). Any of ``retry``, ``faults``, ``transport``, ``lane_chunk``,
    ``record_series`` or ``shard`` raises ``ValueError``.
    """

    def __init__(self, backend: str = "torch", tick: float = 10.0,
                 tick_impl: str = "auto", device=None,
                 cache: Optional[Any] = None, **knobs: Any):
        _check_knobs("SweepDriver", backend, knobs)
        self.backend = backend
        self.tick = tick
        self.device = resolve_device(device)
        self.tick_impl = resolve_tick_impl(tick_impl, self.device).name
        if cache is not None:
            from repro_torch.sim.cache import as_cache

            cache = as_cache(cache)
        self.cache = cache
        self._memo: Dict[ScenarioSpec, ScenarioResult] = {}
        self._lane_keys: set = set()
        self.sweep_calls = 0
        self.configs_run = 0
        self.cache_hits = 0
        self.wall_s = 0.0
        #: kept for the decision layer, which degrades its claims on any
        #: abandoned work; always empty in the port
        self.failures: List[Any] = []

    @property
    def lanes_simulated(self) -> int:
        return len(self._lane_keys)

    def __call__(self, specs: Sequence[ScenarioSpec]) -> SweepResult:
        return self.run(specs)

    def run(self, specs: Sequence[ScenarioSpec]) -> SweepResult:
        """Results for ``specs`` in order, simulating only the unseen ones."""
        specs = list(specs)
        new = [s for s in dict.fromkeys(specs) if s not in self._memo]
        t0 = time.perf_counter()
        hits = 0
        if new and self.cache is not None:
            served = self.cache.fetch(new, backend=self.backend,
                                      tick=self.tick,
                                      tick_impl=self.tick_impl)
            self._memo.update(served)
            hits = len(served)
            self.cache_hits += hits
            new = [s for s in new if s not in served]
        lanes_before = len(self._lane_keys)
        if new:
            res = run_sweep(new, backend=self.backend, tick=self.tick,
                            tick_impl=self.tick_impl, device=self.device)
            self.sweep_calls += 1
            self.configs_run += len(res.results)
            self.wall_s += res.wall_s
            for result in res.results:
                self._memo[result.spec] = result
                self._lane_keys.add(dynamics_key(result.spec))
            if self.cache is not None:
                self.cache.store(((r.spec, r) for r in res.results),
                                 backend=self.backend, tick=self.tick,
                                 tick_impl=self.tick_impl)
        reg = get_registry()
        reg.set_gauge("lanes.simulated", self.lanes_simulated,
                      help="Distinct dynamics lanes simulated by the "
                           "driver (0 = fully cache-warm)")
        reg.set_gauge("configs.run", self.configs_run,
                      help="Specs actually executed by the driver")
        reg.set_gauge("sweep.calls", self.sweep_calls,
                      help="run_sweep invocations issued by the driver")
        reg.set_gauge("sweep.wall_s", self.wall_s,
                      help="Cumulative driver simulation wall time (s)")
        return SweepResult(results=[self._memo[s] for s in specs],
                           wall_s=time.perf_counter() - t0,
                           lanes_simulated=len(self._lane_keys) - lanes_before,
                           cache_hits=hits)
