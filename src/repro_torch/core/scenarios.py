"""Scenario specs and grid packing (paper §5.3 decision workflow), copied
from ``repro.core.scenarios``.

``ScenarioSpec`` is the flat, picklable description of one HCDC variant
(cache size, egress option, storage price, job rate, workload, seed);
``build_config`` materialises it into an ``HCDCConfig``; ``expand_grid``
produces the Cartesian product of spec axes; ``pack_specs`` packs a grid
into the dense per-lane arrays the batched tick program consumes;
``cache_key`` content-addresses a spec's result for ``repro_torch.sim.
cache``, and the continuous-axis helpers (``axis_value``, ``with_axis``,
``refine_levels``) serve ``repro_torch.sim.decide``.

The numpy RNG draw order is ``repro``'s exactly, so both packages pack
bit-identical grids from the same specs (``tests/test_torch_pack.py``).
``packed_grid_from_arrays`` carries a grid packed elsewhere across, so one
grid can feed both engines.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import math
from dataclasses import asdict, dataclass, fields, replace
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.hcdc import DAY, HCDCConfig, make_config
from repro_torch.sim.cloud import MONTH_SECONDS, PEERING_PRICES, GCSCostModel
from repro_torch.sim.distributions import BoundedExponential, TruncatedNormalCount
from repro_torch.sim.infrastructure import TB, GiB
from repro_torch.sim.transfer import LinkTickTable
from repro_torch.sim.workload import parse_workload

#: Valid ``ScenarioSpec.egress`` values: tiered internet egress or one of
#: the paper's §5.3 peering alternatives.
EGRESS_OPTIONS = ("internet",) + tuple(sorted(PEERING_PRICES))


@dataclass(frozen=True)
class ScenarioSpec:
    """One point of the §5.3 decision grid.

    ``None`` always means "keep the base configuration's value"; use
    ``float('inf')`` to request an explicitly unlimited cache/cold tier.
    """

    base: str = "III"  # Table 5 configuration name: I | II | III
    days: float = 2.0  # simulated horizon
    n_files: int = 20_000  # catalogue size per site
    seed: int = 0
    cache_tb: Optional[float] = None  # per-site hot (disk) cache limit, TB
    gcs_limit_tb: Optional[float] = None  # cold-tier limit, TB (0 = disabled)
    egress: str = "internet"  # internet | direct | interconnect
    storage_price: Optional[float] = None  # USD per GB-month override
    egress_price: Optional[float] = None  # flat USD/GiB egress override
    job_rate_scale: float = 1.0  # scales the job arrival rate
    # access-pattern model: "steady" | "diurnal" | "campaign" | "zipf-drift"
    # | "trace:PATH", with optional "name:key=value,..." parameters
    # (repro_torch.sim.workload.parse_workload syntax; docs/workloads.md)
    workload: str = "steady"
    curves: bool = False  # record Fig 6/8 time series

    def __post_init__(self) -> None:
        if self.base not in ("I", "II", "III"):
            raise ValueError(f"unknown base configuration {self.base!r}")
        if self.egress not in EGRESS_OPTIONS:
            raise ValueError(
                f"egress must be one of {EGRESS_OPTIONS}, got {self.egress!r}")
        if not self.days or self.days <= 0:
            raise ValueError(f"days must be > 0, got {self.days!r}")
        if self.n_files <= 0:
            raise ValueError(f"n_files must be > 0, got {self.n_files!r}")
        if not self.job_rate_scale or self.job_rate_scale <= 0:
            raise ValueError(
                f"job_rate_scale must be > 0, got {self.job_rate_scale!r}")
        if self.egress_price is not None and self.egress_price < 0:
            raise ValueError(
                f"egress_price must be >= 0, got {self.egress_price!r}")
        # Unknown workload names, bad parameters, and missing/malformed
        # trace CSVs fail here — at spec-parse time — not in a worker.
        parse_workload(self.workload)

    @property
    def label(self) -> str:
        """Compact human-readable identifier, stable across runs."""
        cache = ("base" if self.cache_tb is None
                 else "inf" if math.isinf(self.cache_tb)
                 else f"{self.cache_tb:g}TB")
        parts = [f"cfg{self.base}", f"cache={cache}", f"egress={self.egress}"]
        if self.gcs_limit_tb is not None:
            gcs = "inf" if math.isinf(self.gcs_limit_tb) else f"{self.gcs_limit_tb:g}TB"
            parts.append(f"gcs={gcs}")
        if self.storage_price is not None:
            parts.append(f"stor={self.storage_price:g}")
        if self.egress_price is not None:
            parts.append(f"egp={self.egress_price:g}")
        if self.job_rate_scale != 1.0:
            parts.append(f"rate={self.job_rate_scale:g}x")
        if self.workload != "steady":
            parts.append(f"wl={self.workload}")
        parts.append(f"seed={self.seed}")
        return ",".join(parts)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def build_config(spec: ScenarioSpec) -> HCDCConfig:
    """Materialise a spec into a fully independent ``HCDCConfig``."""
    cfg = make_config(spec.base,
                      simulated_time=int(spec.days * DAY),
                      n_files_per_site=spec.n_files,
                      seed=spec.seed,
                      curves=spec.curves)
    if spec.cache_tb is not None:
        limit = None if math.isinf(spec.cache_tb) else spec.cache_tb * TB
        for site in cfg.sites:
            site.disk_limit = limit
    if spec.gcs_limit_tb is not None:
        cfg.gcs_limit = (None if math.isinf(spec.gcs_limit_tb)
                         else spec.gcs_limit_tb * TB)
    if spec.egress != "internet":
        cfg.cost_model = replace(cfg.cost_model, peering=spec.egress)
    if spec.storage_price is not None:
        cfg.cost_model = replace(cfg.cost_model,
                                 storage_per_gb_month=spec.storage_price)
    if spec.egress_price is not None:
        cfg.cost_model = replace(cfg.cost_model,
                                 flat_egress_per_gib=spec.egress_price)
    if spec.job_rate_scale != 1.0:
        # Scaling mu and sigma together scales the truncated-normal mean
        # exactly: max(kX, 0) = k max(X, 0) for k > 0.
        cfg.jobs_mu *= spec.job_rate_scale
        cfg.jobs_sigma *= spec.job_rate_scale
    cfg.workload = parse_workload(spec.workload)
    return cfg


_SPEC_FIELDS = {f.name for f in fields(ScenarioSpec)}


def expand_grid(axes: Mapping[str, Any]) -> List[ScenarioSpec]:
    """Cartesian product of spec axes into a spec list.

    Values may be scalars (fixed for the whole sweep) or sequences (swept).
    ``{"cache_tb": [50, 100], "egress": ["internet", "direct"], "seed":
    [0, 1], "days": 1}`` expands to 2 x 2 x 2 = 8 specs. Axis order in the
    result follows the mapping's iteration order, last axis fastest.
    """
    unknown = set(axes) - _SPEC_FIELDS
    if unknown:
        raise ValueError(f"unknown spec fields: {sorted(unknown)} "
                         f"(valid: {sorted(_SPEC_FIELDS)})")
    names: List[str] = []
    levels: List[Sequence[Any]] = []
    for name, value in axes.items():
        if isinstance(value, (list, tuple)):
            names.append(name)
            levels.append(value)
        else:
            names.append(name)
            levels.append([value])
    return [ScenarioSpec(**dict(zip(names, combo)))
            for combo in itertools.product(*levels)]


def with_seeds(specs: Iterable[ScenarioSpec], n_seeds: int,
               first_seed: int = 0) -> List[ScenarioSpec]:
    """Replicate each spec across ``n_seeds`` consecutive seeds.

    On the batched backend each seed replica is a dedicated dynamics lane
    (the seed feeds the catalogue/job-stream draw), so an N-seed grid packs
    as N× the lanes and every reported metric can carry a seed-level
    mean ± CI.
    """
    if n_seeds < 1:
        raise ValueError(f"n_seeds must be >= 1, got {n_seeds!r}")
    return [replace(s, seed=first_seed + k)
            for s in specs for k in range(n_seeds)]


#: Spec fields that enter only the bill, never the simulated dynamics.
#: Specs differing only here share one simulated lane on the batched
#: backend and are billed separately (``pack_specs``); the decision layer
#: exploits the same fact to price-sweep a lane for free.
PRICING_FIELDS = ("egress", "storage_price", "egress_price")


def dynamics_key(spec: ScenarioSpec) -> ScenarioSpec:
    """Canonical per-lane identity: the spec with pricing-only fields reset.

    Two specs with equal dynamics keys simulate identically (same catalogue,
    same job stream, same tick dynamics) and differ at most in how the run
    is billed. ``seed`` is *not* stripped: seed replicas are distinct lanes.
    """
    return replace(spec, egress="internet", storage_price=None,
                   egress_price=None)


def strip_seed(spec: ScenarioSpec) -> ScenarioSpec:
    """Canonical across-seed group identity (seed reset to 0)."""
    return replace(spec, seed=0)


#: Version of the persisted result-entry schema (``repro_torch.sim.cache``),
#: the same number and entry format as the JAX package's. Part of every
#: cache key and stored inside every entry: bump it whenever the meaning of
#: a stored payload changes, and every stale entry becomes unreachable (new
#: keys) and rejected on direct reads.
RESULT_SCHEMA_VERSION = 1


def engine_fingerprint(backend: str = "torch",
                       tick: Optional[float] = None,
                       tick_impl: Optional[str] = None) -> str:
    """Canonical engine identity of the port for result caching.

    The batched program's outputs depend on its clock step, so the tick
    value is part of the fingerprint: ``"torch:60"`` is the plain PyTorch
    tick (``tick_impl="torch"``, or ``None``), ``"torch:60:cuda"`` the
    hand-written kernels. The kernels differ from the plain tick at
    GCS-admission ties within 16 ulps of the limit, so the two are not
    bitwise and their entries never serve each other; nor do they serve
    the JAX package's ``jax:*`` or ``process`` entries (the engines agree
    statistically, not bitwise). ``"auto"`` is rejected: resolve it
    (``repro_torch.kernels.registry.resolve_tick_impl``) before keying, or
    one key could name two programs on two machines.
    """
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (the port's engine "
                         "is backend='torch')")
    t = 10.0 if tick is None else float(tick)
    impl = "torch" if tick_impl is None else str(tick_impl)
    if impl == "torch":
        return f"torch:{t:g}"
    if impl == "cuda":
        return f"torch:{t:g}:cuda"
    raise ValueError(
        f"tick_impl {tick_impl!r} cannot be fingerprinted (expected a "
        "resolved implementation, 'torch' or 'cuda'; resolve 'auto' first)")


def cache_key(spec: ScenarioSpec, backend: str = "torch",
              tick: Optional[float] = None,
              tick_impl: Optional[str] = None) -> str:
    """Content address of a spec's dynamics result (sha256 hex digest).

    The key hashes the canonical JSON of ``(schema version, engine
    fingerprint, dynamics_key(spec))``, as the JAX package's does:
    pricing-only fields are reset first, so every pricing variant of one
    simulated lane maps to the same entry and is re-billed at read time;
    any dynamics-affecting field, seed included, lands on a different key.
    """
    doc = {
        "schema": RESULT_SCHEMA_VERSION,
        "engine": engine_fingerprint(backend, tick, tick_impl),
        "spec": asdict(dynamics_key(spec)),
    }
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


# --------------------------------------------------------------------------
# Continuous-axis refinement helpers (the ``repro_torch.sim.decide``
# vocabulary).
# --------------------------------------------------------------------------

#: Spec axes that take ordered scalar values and can therefore be bisected
#: by the adaptive refinement / break-even solvers. ``None`` entries (keep
#: the base config) and ``inf`` (unlimited) are valid grid levels but are
#: never interpolated against.
CONTINUOUS_AXES = ("cache_tb", "gcs_limit_tb", "storage_price",
                   "egress_price", "job_rate_scale")


def axis_value(spec: ScenarioSpec, axis: str) -> Optional[float]:
    """The spec's value on a continuous axis (``None`` = base default)."""
    if axis not in CONTINUOUS_AXES:
        raise ValueError(f"axis must be one of {CONTINUOUS_AXES}, "
                         f"got {axis!r}")
    return getattr(spec, axis)


def with_axis(spec: ScenarioSpec, axis: str, value: float) -> ScenarioSpec:
    """The spec moved to ``value`` on a continuous axis (re-validated)."""
    if axis not in CONTINUOUS_AXES:
        raise ValueError(f"axis must be one of {CONTINUOUS_AXES}, "
                         f"got {axis!r}")
    return replace(spec, **{axis: value})


def refine_levels(values: Sequence[float], anchors: Sequence[float],
                  rel_tol: float) -> List[float]:
    """Midpoints to add around ``anchors`` in a sorted axis-level set.

    For every anchor value (an axis coordinate of a frontier point) the
    midpoint towards each finite neighbor in ``values`` is proposed, unless
    the gap is already within ``rel_tol`` of the finite axis span. The
    returned midpoints are deduplicated and sorted; non-finite levels and
    ``None`` levels are never interpolated.
    """
    finite = sorted({float(v) for v in values
                     if v is not None and math.isfinite(v)})
    if len(finite) < 2:
        return []
    span = finite[-1] - finite[0]
    if span <= 0:
        return []
    out = set()
    for a in anchors:
        if a is None or not math.isfinite(a) or a not in finite:
            continue
        i = finite.index(a)
        for j in (i - 1, i + 1):
            if 0 <= j < len(finite):
                gap = abs(finite[j] - a)
                if gap > rel_tol * span:
                    out.add((a + finite[j]) / 2.0)
    return sorted(out)


# --------------------------------------------------------------------------
# Spec grid -> dense lane arrays (the batched tick program's input).
# --------------------------------------------------------------------------

def _pow2_bucket(n: int) -> int:
    """Round ``n`` up to the next power of two (0 stays 0).

    Bucketing the data-dependent job-window dimensions (K, J) keeps one
    bursty lane from changing the program's shapes for every grid it
    touches.
    """
    return 1 << (n - 1).bit_length() if n > 0 else 0


@dataclass
class PackedGrid:
    """A spec grid packed into dense per-lane arrays for
    ``repro_torch.sim.batched``.

    Lane ``l`` is one ``ScenarioSpec``. All catalogue randomness (file sizes,
    popularity) and the per-tick job-count stream replicate the event-driven
    engine's host RNG draw order exactly (``repro.core.hcdc``), so every
    engine simulates the same files and the same arrival process; per-job
    file selection and run durations are drawn from the continuation of the
    same per-lane stream.

    Shapes: L lanes, S sites, F files/site, J jobs/site (padded),
    M = 3*S links (per site: tape->disk, gcs->disk, disk->gcs),
    T simulation ticks, Mo 30-day month buckets.
    """

    specs: List[ScenarioSpec]
    site_names: List[str]
    horizon: int  # simulated seconds
    tick: float  # simulation step dt (seconds)
    n_months: int  # month buckets covering the horizon
    full_months: int  # complete 30-day months (always billed)
    max_jobs_per_tick: int  # K bound for the per-tick submission loop
    #: spec index -> dynamics lane. The ``PRICING_FIELDS`` (egress option,
    #: storage price, flat egress price) only enter the bill, never the
    #: simulated dynamics, so specs that differ only in pricing (equal
    #: ``dynamics_key``) share one simulated lane and are billed separately
    #: (the paper's §5.3 "compare pricing options on the same workload").
    #: The ``workload`` axis *does* change the dynamics (it reshapes the
    #: packed job stream), so workload-only-differing specs never share a
    #: lane.
    lane_of: np.ndarray  # [n_specs] i32
    # per-lane scenario parameters
    disk_limit: np.ndarray  # [L,S] f32 bytes (inf = unlimited)
    gcs_enabled: np.ndarray  # [L] bool
    gcs_limit: np.ndarray  # [L] f32 bytes (inf = unlimited)
    min_migrate_pop: np.ndarray  # [L] f32 (migration-policy threshold)
    link_bw: np.ndarray  # [L,M] f32 bytes/s
    link_slots: np.ndarray  # [L,M] f32 (inf = unlimited)
    link_latency: np.ndarray  # [L,M] f32 seconds
    link_mode: np.ndarray  # [L,M] i32 (1 = per-transfer throughput)
    # per-lane catalogue + job stream
    sizes: np.ndarray  # [L,S,F] f32 bytes
    pop: np.ndarray  # [L,S,F] f32
    job_fid: np.ndarray  # [L,S,J] i32
    job_submit_tick: np.ndarray  # [L,S,J] i32 (== T for padding)
    job_submit_time: np.ndarray  # [L,S,J] f32 seconds
    job_tail: np.ndarray  # [L,S,J] f32: download + run duration, seconds
    jobs_per_tick: np.ndarray  # [L,T,S] i32
    n_jobs: np.ndarray  # [L,S] i32 (true, unpadded counts)
    #: compiled per-lane workload schedule: the arrival-rate multiplier on
    #: each *generator* tick (gen_interval spacing, not the simulation
    #: tick). Already folded into ``jobs_per_tick``/``job_*`` above — kept
    #: for inspection and cross-backend schedule tests.
    rate_mult: np.ndarray  # [L,G] f32
    # tick grid (shared by every lane)
    times: np.ndarray  # [T] f32 tick clock values (times[0] == 0)
    dts: np.ndarray  # [T] f32 step durations (dts[0] == 0)
    month_idx: np.ndarray  # [T] i32 month bucket per tick
    # host-side billing
    cost_models: List[Any]  # GCSCostModel per lane

    @property
    def n_specs(self) -> int:
        return len(self.specs)

    @property
    def n_lanes(self) -> int:
        """Distinct simulated dynamics lanes (<= ``n_specs``)."""
        return int(self.sizes.shape[0])

    @property
    def n_ticks(self) -> int:
        return int(self.times.shape[0])


def _require_uniform(name: str, values: Sequence[Any]) -> Any:
    distinct = set(values)
    if len(distinct) > 1:
        raise ValueError(
            f"the batched program requires a uniform {name!r} across the grid "
            f"(lanes share one tick/array layout), got {sorted(distinct)}")
    return values[0]


def pack_specs(specs: Sequence[ScenarioSpec], tick: float = 10.0,
               bucket: bool = True) -> PackedGrid:
    """Pack a spec grid into the dense arrays the batched backend consumes.

    Every lane must share ``days`` and ``n_files`` (they set the shared tick
    count and file-array width); all other axes — cache/GCS limits, egress
    pricing, storage price, job rate, workload model, seed — vary freely
    per lane (the workload schedule reshapes the packed job stream, so
    workload-differing specs get distinct dynamics lanes; only pricing-only
    variants share one). ``curves`` is not supported (time series live on
    the event engine, which this package does not include).

    Catalogue and job-stream sampling is memoized per (base, seed,
    n_files, rate, workload) draw key: lanes that differ only in capacity
    limits (``cache_tb``/``gcs_limit_tb``) replicate the reference
    engine's RNG stream *identically*, so the host draw runs once and the
    arrays are shared.

    ``bucket=True`` (default) rounds the data-dependent job-window shapes
    — K (``max_jobs_per_tick``) and J (padded jobs/site) — up to powers of
    two. Padding slots carry ``job_submit_tick == T`` (never reached), so
    the simulated per-lane state is bitwise unchanged (the two f32
    aggregates summed over the J axis move by reduction-order ulp only)
    while grids of similar shape keep one array layout.
    """
    specs = list(specs)
    if not specs:
        raise ValueError("cannot pack an empty spec list")
    if tick <= 0:
        raise ValueError(f"tick must be > 0 seconds, got {tick!r}")
    _require_uniform("days", [s.days for s in specs])
    _require_uniform("n_files", [s.n_files for s in specs])
    if any(s.curves for s in specs):
        raise ValueError("curves=True is not supported by the batched "
                         "program (it records no time series)")

    all_cfgs = [build_config(s) for s in specs]
    _require_uniform("site count", [len(c.sites) for c in all_cfgs])
    _require_uniform("gen_interval", [c.gen_interval for c in all_cfgs])
    for cfg in all_cfgs:
        if cfg.tape_latency_sigma > 0:
            raise ValueError("tape_latency_sigma > 0 is not supported "
                             "by the batched program")
        if cfg.cold_deletion_policy.capacity_threshold is not None:
            raise ValueError("cold-deletion trimming is not supported "
                             "by the batched program")

    # Deduplicate dynamics: the ``PRICING_FIELDS`` (egress choice, storage
    # price, flat egress price) feed only the cost model (``build_config``
    # touches nothing else for them), so specs that differ only there
    # simulate as one lane and are billed per spec.
    lane_index: Dict[ScenarioSpec, int] = {}
    lane_of = np.zeros(len(specs), dtype=np.int32)
    cfgs = []
    lane_specs: List[ScenarioSpec] = []
    for i, spec in enumerate(specs):
        key = dynamics_key(spec)
        if key not in lane_index:
            lane_index[key] = len(cfgs)
            cfgs.append(all_cfgs[i])
            lane_specs.append(key)
        lane_of[i] = lane_index[key]

    L = len(cfgs)
    S = len(cfgs[0].sites)
    F = cfgs[0].n_files_per_site
    horizon = cfgs[0].simulated_time

    # Shared tick grid: 0, tick, 2*tick, ..., horizon (final step may be
    # shorter so the horizon endpoint is always simulated, like the event
    # engine's ``run(until=horizon)``).
    grid = np.arange(0, horizon + 1e-9, tick, dtype=np.float64)
    if grid[-1] < horizon:
        grid = np.append(grid, float(horizon))
    times = grid.astype(np.float32)
    dts = np.diff(grid, prepend=0.0).astype(np.float32)
    T = len(times)
    n_months = max(1, int(np.ceil(horizon / MONTH_SECONDS)))
    full_months = int(horizon // MONTH_SECONDS)
    month_idx = np.minimum((grid // MONTH_SECONDS).astype(np.int32),
                           n_months - 1)

    disk_limit = np.full((L, S), np.inf, dtype=np.float32)
    gcs_enabled = np.zeros(L, dtype=bool)
    gcs_limit = np.full(L, np.inf, dtype=np.float32)
    min_pop = np.zeros(L, dtype=np.float32)
    sizes = np.zeros((L, S, F), dtype=np.float32)
    pop = np.zeros((L, S, F), dtype=np.float32)
    tables = []
    per_lane_jobs = []  # (fid, submit_tick, submit_time, tail) per site
    rate_mults = []  # [G] per lane: compiled workload arrival schedule

    def _draw_lane(cfg):
        """Host-side RNG work for one dynamics lane: catalogue (sizes,
        popularity) and the pre-sampled job stream. Replicates the event
        engine's draw order; memoized below because lanes differing only
        in capacity limits consume an identical stream."""
        rng = np.random.default_rng(cfg.seed)
        size_dist = BoundedExponential(cfg.size_lam, cfg.size_lo, cfg.size_hi,
                                       unit=GiB)
        l_sizes = np.zeros((S, F), dtype=np.float32)
        l_pop = np.zeros((S, F), dtype=np.float32)
        cum_ws = []
        for si in range(S):
            # Same draw order as ``hcdc._SiteState``: sizes, then popularity.
            l_sizes[si] = size_dist.sample(rng, F)
            l_pop[si] = cfg.popularity.sample_popularity(rng, F)
            cum_ws.append(cfg.popularity.selection_cdf(l_pop[si]))
        # Same draw as ``HCDCScenario.__init__``: the pre-sampled job
        # stream, modulated by the (deterministic, RNG-free) workload
        # schedule exactly as the event engine modulates its own stream.
        n_gen = cfg.simulated_time // cfg.gen_interval + 1
        counts = TruncatedNormalCount(cfg.jobs_mu, cfg.jobs_sigma).sample(
            rng, (S, n_gen))
        sched = cfg.workload.compile(n_gen, cfg.gen_interval)
        counts = counts * sched.rate_mult
        gen_times = np.arange(n_gen, dtype=np.float64) * cfg.gen_interval
        dur_dist = BoundedExponential(cfg.dur_lam, lo=cfg.dur_lo)
        lane_jobs = []
        for si in range(S):
            emitted = np.diff(np.floor(np.cumsum(counts[si])),
                              prepend=0.0).astype(np.int64)
            j_times = np.repeat(gen_times, emitted)
            u = rng.random(len(j_times))
            durs = dur_dist.sample(rng, len(j_times))
            if sched.sel_power is None:
                fid = np.searchsorted(cum_ws[si], u,
                                      side="right").astype(np.int32)
            else:
                # Popularity drift: each job selects with the power of its
                # generator tick. Powers are piecewise constant (a few
                # distinct values), so one CDF per value suffices — the
                # same quantization the event engine's cum_w cache uses.
                j_power = sched.sel_power[np.repeat(np.arange(n_gen),
                                                    emitted)]
                fid = np.zeros(len(u), dtype=np.int32)
                for p in np.unique(j_power):
                    cdf = cfg.popularity.selection_cdf(l_pop[si],
                                                      power=float(p))
                    sel = j_power == p
                    fid[sel] = np.searchsorted(cdf, u[sel], side="right")
            dl = l_sizes[si, fid].astype(np.float64) / cfg.download
            tail = np.maximum(1, (dl + durs).astype(np.int64))
            j_tick = np.searchsorted(grid, j_times, side="left").astype(np.int32)
            lane_jobs.append((fid, j_tick, j_times.astype(np.float32),
                              tail.astype(np.float32)))
        return l_sizes, l_pop, lane_jobs, sched.rate_mult.astype(np.float32)

    draw_cache: Dict[ScenarioSpec, tuple] = {}
    for li, cfg in enumerate(cfgs):
        # Capacity limits never touch the RNG stream: lanes that differ
        # only in cache_tb/gcs_limit_tb share one host-side draw.
        draw_key = replace(lane_specs[li], cache_tb=None, gcs_limit_tb=None)
        if draw_key not in draw_cache:
            draw_cache[draw_key] = _draw_lane(cfg)
        l_sizes, l_pop, lane_jobs, rate_mult = draw_cache[draw_key]
        sizes[li] = l_sizes
        pop[li] = l_pop
        per_lane_jobs.append(lane_jobs)
        rate_mults.append(rate_mult)
        for si, site in enumerate(cfg.sites):
            disk_limit[li, si] = (np.inf if site.disk_limit is None
                                  else site.disk_limit)

        gcs_enabled[li] = cfg.gcs_enabled
        gcs_limit[li] = np.inf if cfg.gcs_limit is None else cfg.gcs_limit
        min_pop[li] = cfg.migration_policy.min_popularity
        rates, slots, lats = [], [], []
        for site in cfg.sites:
            rates += [site.tape_to_disk_mb_s, cfg.gcs_to_disk, cfg.disk_to_gcs]
            slots += [cfg.max_active] * 3
            lats += [cfg.tape_latency, 0.0, 0.0]
        tables.append(LinkTickTable.from_values(rates, slots, lats))

    J = max(len(j[0]) for lane in per_lane_jobs for j in lane)
    if bucket:
        J = _pow2_bucket(J)
    job_fid = np.zeros((L, S, J), dtype=np.int32)
    job_submit_tick = np.full((L, S, J), T, dtype=np.int32)
    job_submit_time = np.zeros((L, S, J), dtype=np.float32)
    job_tail = np.zeros((L, S, J), dtype=np.float32)
    jobs_per_tick = np.zeros((L, T, S), dtype=np.int32)
    n_jobs = np.zeros((L, S), dtype=np.int32)
    for li, lane_jobs in enumerate(per_lane_jobs):
        for si, (fid, j_tick, j_time, tail) in enumerate(lane_jobs):
            n = len(fid)
            n_jobs[li, si] = n
            job_fid[li, si, :n] = fid
            job_submit_tick[li, si, :n] = j_tick
            job_submit_time[li, si, :n] = j_time
            job_tail[li, si, :n] = tail
            jobs_per_tick[li, :, si] = np.bincount(j_tick, minlength=T)
    max_jobs_per_tick = int(jobs_per_tick.max()) if jobs_per_tick.size else 0
    if bucket:
        # Extra window slots read padded/later-tick entries, which the
        # kernel's validity mask rejects — bitwise no-op, stable trace.
        max_jobs_per_tick = _pow2_bucket(max_jobs_per_tick)

    return PackedGrid(
        specs=specs,
        site_names=[s.name for s in cfgs[0].sites],
        horizon=horizon,
        tick=float(tick),
        n_months=n_months,
        full_months=full_months,
        max_jobs_per_tick=max_jobs_per_tick,
        lane_of=lane_of,
        disk_limit=disk_limit,
        gcs_enabled=gcs_enabled,
        gcs_limit=gcs_limit,
        min_migrate_pop=min_pop,
        link_bw=np.stack([t.bw for t in tables]),
        link_slots=np.stack([t.slots for t in tables]),
        link_latency=np.stack([t.latency for t in tables]),
        link_mode=np.stack([t.mode for t in tables]),
        sizes=sizes,
        pop=pop,
        job_fid=job_fid,
        job_submit_tick=job_submit_tick,
        job_submit_time=job_submit_time,
        job_tail=job_tail,
        jobs_per_tick=jobs_per_tick,
        n_jobs=n_jobs,
        rate_mult=np.stack(rate_mults),
        times=times,
        dts=dts,
        month_idx=month_idx,
        cost_models=[c.cost_model for c in all_cfgs],
    )


#: Array attributes of ``PackedGrid`` (everything but the specs, the site
#: names, the scalar shape fields and the cost models).
_ARRAY_FIELDS = ("lane_of", "disk_limit", "gcs_enabled", "gcs_limit",
                 "min_migrate_pop", "link_bw", "link_slots", "link_latency",
                 "link_mode", "sizes", "pop", "job_fid", "job_submit_tick",
                 "job_submit_time", "job_tail", "jobs_per_tick", "n_jobs",
                 "rate_mult", "times", "dts", "month_idx")


def _copy_dataclass(cls, obj):
    """Rebuild ``cls`` from any object carrying its field names."""
    return cls(**{f.name: getattr(obj, f.name) for f in fields(cls)
                  if f.init})


def packed_grid_from_arrays(obj: Any) -> PackedGrid:
    """Build this package's ``PackedGrid`` from any object that has the
    attribute names of ``PackedGrid`` (e.g. a grid packed by the JAX
    package).

    Only numpy arrays and plain fields are read: arrays are copied, the
    specs and cost models are rebuilt from their dataclass fields. This is
    how one packed grid feeds both engines in the cross-package tests.
    """
    arrays = {name: np.array(getattr(obj, name)) for name in _ARRAY_FIELDS}
    return PackedGrid(
        specs=[_copy_dataclass(ScenarioSpec, s) for s in obj.specs],
        site_names=[str(n) for n in obj.site_names],
        horizon=int(obj.horizon),
        tick=float(obj.tick),
        n_months=int(obj.n_months),
        full_months=int(obj.full_months),
        max_jobs_per_tick=int(obj.max_jobs_per_tick),
        cost_models=[_copy_dataclass(GCSCostModel, c)
                     for c in obj.cost_models],
        **arrays,
    )
