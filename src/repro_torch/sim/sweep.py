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

Both take the JAX package's execution knobs with its meaning: series
capture (``record_series``), lane chunks and device round-robin
(``lane_chunk``, ``devices``), the resilient job path (``retry``,
``faults``, ``job_timeout``; completed chunks journaled into the cache as
they land) and the worker fleet (``transport``, ``workers``). ``shard``
(the JAX package's ``shard_map`` lane mesh) has no counterpart in the
port and raises ``ValueError``.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.scenarios import ScenarioSpec, cache_key, dynamics_key
from repro_torch.kernels.registry import resolve_tick_impl
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
    #: Structured reports of jobs that exhausted their retry budget
    #: (``repro_torch.sim.jobs.JobFailure``); empty for a complete sweep.
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
            doc["failures"] = [f.as_dict() for f in self.failures]
        atomic_write_text(path, json.dumps(doc, indent=2))


def _check_backend(backend: str, shard: bool) -> None:
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (the port runs "
                         "backend='torch' only)")
    from repro_torch.sim.batched import _check_shard  # imports this module

    _check_shard(shard)


def _jobs_engaged(retry: Any, faults: Any, transport: Any) -> bool:
    """Whether this call routes through the ``repro_torch.sim.jobs`` layer:
    only when resilience or fleet execution was asked for
    (``retry``/``faults``/``transport``); the plain path runs the whole
    grid as one program and stays untouched otherwise."""
    return retry is not None or faults is not None or transport is not None


def _journal_to_cache(cache: Any, backend: str, tick: float,
                      tick_impl: Optional[str]) -> Callable:
    """A per-job completion hook that checkpoints results into the
    persistent cache as they finish (the resume mechanism: a killed run
    re-executed with the same cache recomputes only unfinished jobs).

    Dedups by cache key across calls so pricing variants of one dynamics
    lane still produce a single write, exactly like the bulk
    ``cache.store`` the non-journaled path uses.
    """
    seen: set = set()

    def journal(pairs) -> None:
        fresh = []
        for spec, result in pairs:
            if not result.monthly:
                continue
            key = cache_key(spec, backend=backend, tick=tick,
                            tick_impl=tick_impl)
            if key not in seen:
                seen.add(key)
                fresh.append((spec, result))
        if fresh:
            cache.store(fresh, backend=backend, tick=tick,
                        tick_impl=tick_impl)

    return journal


def run_sweep(specs: Sequence[ScenarioSpec],
              workers: Optional[int] = None,
              progress: Optional[Callable[[int, int, ScenarioResult], None]]
              = None, backend: str = "torch",
              tick: float = 10.0, tick_impl: str = "auto",
              lane_chunk: Optional[int] = None,
              devices: Optional[Sequence[Any]] = None,
              cache: Optional[Any] = None,
              record_series=None,
              retry: Optional[Any] = None,
              faults: Optional[Any] = None,
              job_timeout: Optional[float] = None,
              transport: Optional[Any] = None,
              shard: bool = False,
              device=None,
              _journal: Optional[Callable] = None) -> SweepResult:
    """Run a spec grid on the port's batched program; results keep the
    input order. The JAX package's signature, and ``device``.

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

    ``lane_chunk``/``devices``: chunked execution in bounded device
    memory, dealt round-robin over devices; ``record_series``: per-tick
    series capture, each result carrying its digests in ``.series`` (see
    ``repro_torch.sim.batched``). ``retry``/``faults``/``job_timeout``:
    the lane chunks as retryable jobs (``repro_torch.sim.jobs``, faults
    from ``repro_torch.sim.faults``); work that exhausts its retries is
    dropped, not fatal, and reported in ``SweepResult.failures``. With
    ``cache`` set, completed chunks are journaled into it as they land, so
    a re-run recomputes only the unfinished ones; ``faults`` with
    ``corrupt > 0`` reads the cache through a ``FaultyBackend``.
    ``transport``/``workers``: the chunk jobs on a worker fleet
    (``repro_torch.sim.runners``; ``"subprocess"``, ``"local"`` or a
    factory). ``shard=True`` raises ``ValueError``.
    """
    _check_backend(backend, shard)
    # deferred: batched and cache import this module
    from repro_torch.sim.batched import _resolve_devices, run_sweep_torch
    from repro_torch.sim.faults import as_faults

    faults = as_faults(faults)
    impl = resolve_tick_impl(tick_impl,
                             _resolve_devices(device, devices)[0]).name
    engaged = _jobs_engaged(retry, faults, transport)
    knobs = dict(progress=progress, lane_chunk=lane_chunk, devices=devices,
                 record_series=record_series, retry=retry, faults=faults,
                 job_timeout=job_timeout, workers=workers,
                 transport=transport, device=device)
    if cache is None:
        return run_sweep_torch(specs, tick=tick, tick_impl=impl,
                               journal=_journal, **knobs)
    from repro_torch.sim.cache import ResultCache, as_cache

    cache = as_cache(cache)
    if faults is not None and faults.corrupt > 0.0:
        # Corrupt-read injection wraps a *local* view of the caller's
        # backend (the caller's ResultCache object is not mutated); the
        # cache detects the garbage, drops the entry, recomputes.
        from repro_torch.sim.faults import FaultyBackend

        cache = ResultCache(FaultyBackend(cache.backend, faults))
    specs = list(specs)
    t0 = time.perf_counter()
    hits = cache.fetch(specs, backend=backend, tick=tick, tick_impl=impl)
    miss = [s for s in dict.fromkeys(specs) if s not in hits]
    computed: Dict[ScenarioSpec, ScenarioResult] = {}
    failures: List[Any] = []
    if miss:
        journal = (_journal_to_cache(cache, backend, tick, impl)
                   if engaged else None)
        res = run_sweep_torch(miss, tick=tick, tick_impl=impl,
                              journal=journal, **knobs)
        # Key by result spec, not input order: a partial result has
        # fewer entries than ``miss``.
        computed = {r.spec: r for r in res.results}
        failures = list(res.failures)
        if not engaged:  # the plain path has no journal; store in bulk
            cache.store(computed.items(), backend=backend, tick=tick,
                        tick_impl=impl)
    merged = {**hits, **computed}
    return SweepResult(
        results=[merged[s] for s in specs if s in merged],
        wall_s=time.perf_counter() - t0,
        lanes_simulated=len({dynamics_key(s) for s in computed}),
        cache_hits=len(hits),
        failures=failures)


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
    stays 0).

    The execution knobs (``workers``, ``lane_chunk``, ``devices``,
    ``progress``, ``record_series``, ``retry``, ``faults``,
    ``job_timeout``, ``transport``) pass through to every ``run_sweep``
    call, as :func:`run_sweep` takes them; with a cache and the job path
    engaged, each round's completed chunks are journaled into the cache as
    they land. ``failures`` accumulates every round's ``JobFailure``
    reports, which the decision layer reads to degrade its claims.
    ``shard=True`` raises ``ValueError``.
    """

    def __init__(self, backend: str = "torch", tick: float = 10.0,
                 workers: Optional[int] = None,
                 tick_impl: str = "auto",
                 lane_chunk: Optional[int] = None,
                 devices: Optional[Sequence[Any]] = None,
                 progress: Optional[Callable[[int, int, ScenarioResult],
                                             None]] = None,
                 cache: Optional[Any] = None,
                 record_series=None,
                 retry: Optional[Any] = None,
                 faults: Optional[Any] = None,
                 job_timeout: Optional[float] = None,
                 transport: Optional[Any] = None,
                 shard: bool = False,
                 device=None):
        _check_backend(backend, shard)
        from repro_torch.sim.batched import _resolve_devices
        from repro_torch.sim.faults import as_faults

        self.backend = backend
        self.tick = tick
        self.devices = devices
        self.device = _resolve_devices(device, devices)[0]
        self.tick_impl = resolve_tick_impl(tick_impl, self.device).name
        self.workers = workers
        self.lane_chunk = lane_chunk
        self.progress = progress
        self.record_series = record_series
        self.retry = retry
        self.faults = as_faults(faults)
        self.job_timeout = job_timeout
        self.transport = transport
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
        #: cumulative ``JobFailure`` reports across every round; the
        #: decision layer reads this to degrade its claims
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
        round_failures: List[Any] = []
        if new:
            engaged = _jobs_engaged(self.retry, self.faults, self.transport)
            journal = None
            if self.cache is not None and engaged:
                journal = _journal_to_cache(self.cache, self.backend,
                                            self.tick, self.tick_impl)
            res = run_sweep(new, workers=self.workers,
                            progress=self.progress, backend=self.backend,
                            tick=self.tick, tick_impl=self.tick_impl,
                            lane_chunk=self.lane_chunk, devices=self.devices,
                            record_series=self.record_series,
                            retry=self.retry, faults=self.faults,
                            job_timeout=self.job_timeout,
                            transport=self.transport,
                            device=None if self.devices else self.device,
                            _journal=journal)
            self.sweep_calls += 1
            self.configs_run += len(res.results)
            self.wall_s += res.wall_s
            # key by result spec, not request order: a partial result has
            # fewer entries than ``new``
            for result in res.results:
                self._memo[result.spec] = result
                self._lane_keys.add(dynamics_key(result.spec))
            round_failures = list(res.failures)
            self.failures.extend(round_failures)
            if self.cache is not None and not engaged:
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
        return SweepResult(results=[self._memo[s] for s in specs
                                    if s in self._memo],
                           wall_s=time.perf_counter() - t0,
                           lanes_simulated=len(self._lane_keys) - lanes_before,
                           cache_hits=hits, failures=round_failures)
