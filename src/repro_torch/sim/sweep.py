"""Sweep results and the port's sweep front door (paper §5.3 decision
workflow), copied from ``repro.sim.sweep``.

- ``ScenarioResult`` / ``SweepResult``: the same records, metric keys and
  exports (CSV/JSON, Pareto front, seed aggregation in the paper's Table
  6/7/8 mean/sd% presentation) as the JAX package's;
- ``run_scenario(spec)``: one spec on the event-driven reference engine
  (``repro_torch.core.hcdc.HCDCScenario``), the unit of work of
  ``backend="process"``;
- ``run_sweep(specs, backend=...)``: a grid on the port's batched program
  (``backend="torch"``, the default; ``repro_torch.sim.batched.
  run_sweep_torch``) or on the event engine, one job per spec
  (``backend="process"``: serial, a spawned process pool with crash
  recovery, or the worker fleet), get-or-compute through the persistent
  result cache (``repro_torch.sim.cache``) when one is given;
- ``SweepDriver``: the iterative front end the decision layer
  (``repro_torch.sim.decide``) calls in a loop — memo -> cache ->
  simulate, with its books in the metrics registry.

Both take the JAX package's execution knobs with its meaning: series
capture (``record_series``), lane chunks and device round-robin
(``lane_chunk``, ``devices``), the resilient job path (``retry``,
``faults``, ``job_timeout``; completed jobs journaled into the cache as
they land) and the worker fleet (``transport``, ``workers``). The batched
program's knobs (``tick_impl``, ``device``, ``record_series``,
``lane_chunk``, ``devices``) raise on ``backend="process"``, as they do in
the JAX package. ``shard`` runs the lanes over the lane mesh of the local
devices (``repro_torch.sim.batched.simulate_packed``); it applies to
``backend="torch"`` only and raises on ``"process"``, as in the JAX
package.

The event engine is host code: this module, the engine and the process
backend's workers import neither torch nor a device (the batched program
is imported where it runs), so a spawned worker never holds a CUDA
context.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.scenarios import ScenarioSpec, cache_key, dynamics_key
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.sim.cloud import sum_bills
from repro_torch.sim.output import atomic_write_text, mean_and_error, write_csv

#: The engines ``run_sweep`` and ``SweepDriver`` take.
BACKENDS = ("torch", "process")


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


def _worker_init() -> None:
    """Initializer of the process backend's spawned workers: a fresh
    baseline for the worker's process-global metrics registry, so the
    per-task snapshot deltas it returns hold only its own work. The
    workers need numpy only; nothing here touches CUDA or hides a card."""
    get_registry().reset()


def run_scenario(spec: ScenarioSpec) -> ScenarioResult:
    """Build and run one configuration on the event engine; the process
    backend's unit of work.

    Top-level (not a closure) so a process pool can pickle it; all
    randomness derives from ``spec.seed``, so the result does not depend on
    which process runs it.
    """
    from repro_torch.core.hcdc import HCDCScenario
    from repro_torch.core.scenarios import build_config

    cfg = build_config(spec)
    t0 = time.perf_counter()
    with get_tracer().span("run_scenario", label=spec.label):
        scenario = HCDCScenario(cfg)
        metrics = scenario.run()
    wall = time.perf_counter() - t0
    reg = get_registry()
    reg.inc("scenario.runs", help="Event-engine scenario executions")
    reg.observe("scenario.wall_s", wall,
                help="Per-scenario event-engine wall time (s)")
    bill = sum_bills(scenario.gcs.bills)
    series = {name: ts.summary() for name, ts in scenario.out.series.items()}
    raw = scenario.gcs.monthly_raw
    monthly = {
        "gb_seconds": [float(r[0]) for r in raw],
        "egress_bytes": [float(r[1]) for r in raw],
        "class_a": [int(r[2]) for r in raw],
        "class_b": [int(r[3]) for r in raw],
        "full_months": int(scenario.gcs.full_months_closed),
    }
    return ScenarioResult(
        spec=spec,
        metrics=metrics,
        storage_usd=bill.storage_usd,
        network_usd=bill.network_usd,
        ops_usd=bill.ops_usd,
        wall_s=wall,
        events=scenario.sim.events_executed,
        series=series,
        monthly=monthly,
    )


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
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected 'torch' "
                         "or 'process')")
    if shard and backend != "torch":
        raise ValueError("shard applies to backend='torch' only")


def _check_process_knobs(backend: str, tick_impl: str, device, devices,
                         lane_chunk, record_series) -> None:
    """The batched program's knobs raise on the event engine, as in the
    JAX package's ``run_sweep``."""
    if backend != "process":
        return
    if tick_impl != "auto":
        raise ValueError("tick_impl applies to backend='torch' only")
    if device is not None:
        raise ValueError("device applies to backend='torch' only (the "
                         "event engine runs on the host)")
    if record_series not in (None, False):
        raise ValueError("record_series applies to backend='torch' only "
                         "(the process backend records curves via "
                         "spec.curves)")
    if lane_chunk is not None or devices is not None:
        raise ValueError("lane_chunk/devices apply to backend='torch' only")


def _jobs_engaged(backend: str, retry: Any, faults: Any,
                  transport: Any) -> bool:
    """Whether this call routes through the ``repro_torch.sim.jobs`` layer.

    The process backend always does: crash recovery and partial results
    cost it nothing. The batched program engages only when resilience or
    fleet execution was asked for (``retry``/``faults``/``transport``);
    its plain path runs the whole grid as one program and stays untouched
    otherwise."""
    return (backend == "process" or retry is not None or faults is not None
            or transport is not None)


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
    """Run a spec grid; results keep the input order. The JAX package's
    signature, and ``device``.

    ``backend`` selects the engine:

    - ``"torch"`` (default): the port's batched fixed-tick program.
      ``tick`` is its clock step in seconds, ``tick_impl`` the kernel
      implementation (``repro_torch.kernels.registry``), ``device`` where
      it runs (``cuda`` when None). It needs uniform ``days``/``n_files``
      across the grid and agrees with the event engine statistically
      (Table 2 tolerance), not bitwise.
    - ``"process"``: the event-driven reference engine
      (``repro_torch.core.hcdc``), one job per distinct spec, bitwise
      ``repro``'s ``"process"`` backend. ``workers``: ``None`` uses all
      CPUs (capped at the batch size), ``0``/``1`` runs serially in this
      process, more runs a spawned process pool with crash recovery
      (``repro_torch.sim.jobs.run_process_jobs``). It always runs through
      the job layer: a worker crash costs retries, not the sweep.
      ``tick_impl``, ``device``, ``record_series``, ``lane_chunk`` and
      ``devices`` raise.

    ``cache`` (a ``repro_torch.sim.cache.ResultCache`` or a directory)
    turns the call into get-or-compute: specs whose dynamics entry is
    stored are served from it (re-billed for their pricing fields,
    bit-identical to a fresh run on the same engine), only the misses are
    simulated, and their results are stored back. ``tick_impl`` is
    resolved before keying, so the plain tick's, the kernels' and the
    event engine's entries never serve each other.
    ``SweepResult.lanes_simulated``/``cache_hits`` report the split.

    ``lane_chunk``/``devices``: chunked execution in bounded device
    memory, dealt round-robin over devices; ``record_series``: per-tick
    series capture, each result carrying its digests in ``.series`` (see
    ``repro_torch.sim.batched``; the process backend records curves via
    ``spec.curves``). ``retry``/``faults``/``job_timeout``: the jobs (lane
    chunks, or specs on the process backend) as retryable jobs
    (``repro_torch.sim.jobs``, faults from ``repro_torch.sim.faults``);
    work that exhausts its retries is dropped, not fatal, and reported in
    ``SweepResult.failures``. With ``cache`` set, completed jobs are
    journaled into it as they land, so a re-run recomputes only the
    unfinished ones; ``faults`` with ``corrupt > 0`` reads the cache
    through a ``FaultyBackend``. ``transport``/``workers``: the jobs on a
    worker fleet (``repro_torch.sim.runners``; ``"subprocess"``,
    ``"local"`` or a factory). ``shard`` (``backend="torch"`` only): the
    lanes over the lane mesh of the local devices, one contiguous block a
    device, bitwise the unsharded results.
    """
    _check_backend(backend, shard)
    _check_process_knobs(backend, tick_impl, device, devices, lane_chunk,
                         record_series)
    from repro_torch.sim.faults import as_faults

    faults = as_faults(faults)
    engaged = _jobs_engaged(backend, retry, faults, transport)
    if backend == "process":
        impl = None

        def simulate(todo, journal) -> SweepResult:
            return _run_process(todo, workers=workers, progress=progress,
                                retry=retry, faults=faults,
                                job_timeout=job_timeout,
                                transport=transport, journal=journal)
    else:
        # deferred: batched imports this module, and the registry imports
        # torch, which the process backend's workers never need
        from repro_torch.kernels.registry import resolve_tick_impl
        from repro_torch.sim.batched import _resolve_devices, run_sweep_torch

        impl = resolve_tick_impl(tick_impl,
                                 _resolve_devices(device, devices)[0]).name
        knobs = dict(progress=progress, lane_chunk=lane_chunk,
                     devices=devices, record_series=record_series,
                     retry=retry, faults=faults, job_timeout=job_timeout,
                     workers=workers, transport=transport, device=device,
                     shard=shard)

        def simulate(todo, journal) -> SweepResult:
            return run_sweep_torch(todo, tick=tick, tick_impl=impl,
                                   journal=journal, **knobs)
    if cache is None:
        return simulate(specs, _journal)
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
        res = simulate(miss, journal)
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


def _run_process(specs: Sequence[ScenarioSpec], *, workers: Optional[int],
                 progress, retry, faults, job_timeout, transport,
                 journal: Optional[Callable]) -> SweepResult:
    """The process backend: one job per distinct spec (duplicates in the
    request are answered from the same result), executed through the job
    registry so a worker failure costs retries — never the completed part
    of the sweep."""
    from repro_torch.sim import jobs as joblib

    specs = list(specs)
    if workers is None:
        workers = min(len(specs), os.cpu_count() or 1)
    t0 = time.perf_counter()
    unique = list(dict.fromkeys(specs))
    policy = retry if retry is not None else joblib.RetryPolicy()
    jobs_list = [joblib.Job(job_id=f"spec{i:04d}", payload=s,
                            labels=(s.label,), timeout_s=job_timeout)
                 for i, s in enumerate(unique)]
    on_done = None
    if journal is not None:
        def on_done(job, result):
            journal([(job.payload, result)])
    if transport is not None:
        from repro_torch.sim.runners import run_fleet_jobs

        _res, registry = run_fleet_jobs(
            jobs_list, workers=max(1, min(workers, len(unique))),
            transport=transport, ctx={"kind": "scenario"},
            policy=policy, faults=faults,
            progress=progress, on_done=on_done)
    elif workers <= 1 or len(unique) <= 1:
        def run_one(job):
            return run_scenario(job.payload)

        _res, registry = joblib.run_local_jobs(
            jobs_list, run_one, policy=policy, faults=faults,
            progress=progress, on_done=on_done)
    else:
        # A spawned (not forked) pool: the caller may hold a CUDA context,
        # which a forked child must not inherit; the workers need numpy
        # only, so spawn startup stays cheap.
        _res, registry = joblib.run_process_jobs(
            jobs_list, workers=workers, policy=policy, faults=faults,
            progress=progress, on_done=on_done)
    by_spec = {job.payload: job.result for job in registry.jobs.values()
               if job.state == joblib.DONE}
    return SweepResult(
        results=[by_spec[s] for s in specs if s in by_spec],
        wall_s=time.perf_counter() - t0,
        failures=registry.failures())


class SweepDriver:
    """Iterative ``run_sweep`` front end with cross-round memoization.

    The decision layer (``repro_torch.sim.decide``) calls the sweep in a
    loop — adaptive grid refinement, break-even bisection — where
    successive rounds re-request many already-simulated specs plus a few
    new ones. The driver runs only the unseen specs (one ``run_sweep``
    call a round, so new specs still pack into one grid) and answers the
    rest from memory.

    ``backend`` is ``"torch"`` (default) or ``"process"`` (the event
    engine; its driver has no device and ``tick_impl`` is None). On
    ``"torch"``, ``tick_impl`` is resolved for ``device`` once, here
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
    engaged (always on ``"process"``), each round's completed jobs are
    journaled into the cache as they land. ``failures`` accumulates every round's ``JobFailure``
    reports, which the decision layer reads to degrade its claims.
    ``shard`` passes through to every ``run_sweep`` call.
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
        _check_process_knobs(backend, tick_impl, device, devices,
                             lane_chunk, record_series)
        from repro_torch.sim.faults import as_faults

        self.backend = backend
        self.tick = tick
        self.devices = devices
        self.device = None
        self.tick_impl: Optional[str] = None
        if backend == "torch":
            from repro_torch.kernels.registry import resolve_tick_impl
            from repro_torch.sim.batched import _resolve_devices

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
        self.shard = shard
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
            engaged = _jobs_engaged(self.backend, self.retry, self.faults,
                                    self.transport)
            journal = None
            if self.cache is not None and engaged:
                journal = _journal_to_cache(self.cache, self.backend,
                                            self.tick, self.tick_impl)
            res = run_sweep(new, workers=self.workers,
                            progress=self.progress, backend=self.backend,
                            tick=self.tick,
                            tick_impl=self.tick_impl or "auto",
                            lane_chunk=self.lane_chunk, devices=self.devices,
                            record_series=self.record_series,
                            retry=self.retry, faults=self.faults,
                            job_timeout=self.job_timeout,
                            transport=self.transport, shard=self.shard,
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
