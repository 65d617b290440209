"""Pluggable access-pattern (workload) generators, copied from
``repro.sim.workload``.

A ``WorkloadModel`` compiles to a ``WorkloadSchedule`` — a
per-generator-tick arrival-rate multiplier plus an optional per-tick
file-selection power (popularity skew). ``repro_torch.core.scenarios.
pack_specs`` applies it host-side while building the per-lane packed job
stream (``jobs_per_tick`` et al.), exactly as ``repro``'s packer does, so
the device tick program never sees the workload; the compiled multipliers
are exported as ``PackedGrid.rate_mult`` ``[n_lanes, n_gen_ticks]``.

Models (catalogue in ``docs/workloads.md``):

======================  ====================================================
``steady``              multiplier 1 everywhere — bit-exact default that
                        reproduces the pre-workload behaviour
``diurnal``             sinusoidal day/night modulation, mean-preserving
                        over whole periods
``campaign``            bursty reprocessing waves (square wave with a
                        configurable duty cycle)
``zipf-drift``          time-varying file-popularity skew: the selection
                        power drifts ``power_start`` -> ``power_end`` in
                        piecewise-constant steps (arrival rate unchanged)
``trace``               per-tick rate table replayed from a CSV
                        (``time_s,rate_mult`` header; step function,
                        last value held)
======================  ====================================================

Schedules are deterministic (no RNG draws), so adding a workload never
perturbs a scenario's random streams: ``workload="steady"`` multiplies the
count stream by exactly 1.0 and is regression-identical to pre-workload
results. Models are frozen dataclasses — hashable, comparable, safely
shared between configs. This module depends only on numpy.
"""

from __future__ import annotations

import csv
import functools
import math
import os
from dataclasses import dataclass, field, fields
from typing import Dict, Optional, Tuple, Type

import numpy as np

HOUR_S = 3600.0

#: Parsed trace tables keyed on (path, mtime_ns, size) — see
#: ``TraceReplay._parse``.
_TRACE_CACHE: Dict[tuple, Tuple[Tuple[float, float], ...]] = {}


@dataclass(frozen=True)
class WorkloadSchedule:
    """A workload model compiled onto a concrete generator-tick grid.

    ``rate_mult[g]`` multiplies the job-count sample of generator tick
    ``g`` (the 10 s paper interval, *not* the batched backend's simulation
    tick); ``sel_power`` is the per-tick file-selection power, or ``None``
    to keep the base ``PopularityModel.selection_power`` (the common case;
    ``None`` lets both engines keep their precomputed selection weights).
    """

    rate_mult: np.ndarray  # [G] float64, >= 0
    sel_power: Optional[np.ndarray] = None  # [G] float64, > 0


@dataclass(frozen=True)
class WorkloadModel:
    """Base class: a picklable, hashable access-pattern description."""

    def compile(self, n_ticks: int, tick_s: float) -> WorkloadSchedule:
        raise NotImplementedError

    @staticmethod
    def _times(n_ticks: int, tick_s: float) -> np.ndarray:
        if n_ticks <= 0:
            raise ValueError(f"n_ticks must be > 0, got {n_ticks!r}")
        if tick_s <= 0:
            raise ValueError(f"tick_s must be > 0, got {tick_s!r}")
        return np.arange(n_ticks, dtype=np.float64) * tick_s


@dataclass(frozen=True)
class SteadyPoisson(WorkloadModel):
    """The stationary default: multiplier exactly 1.0 on every tick.

    (The base arrival process is the paper's truncated-normal count
    stream; "Poisson" names the workload *shape* — stationary, memoryless
    in time — not the marginal distribution.)
    """

    def compile(self, n_ticks: int, tick_s: float) -> WorkloadSchedule:
        self._times(n_ticks, tick_s)  # argument validation only
        return WorkloadSchedule(np.ones(n_ticks, dtype=np.float64))


@dataclass(frozen=True)
class Diurnal(WorkloadModel):
    """Sinusoidal day/night rate modulation.

    ``mult(t) = 1 + amplitude * sin(2 pi (t/3600 - phase_h) / period_h)``
    — mean-preserving over whole periods, never negative (amplitude is
    capped at 1).
    """

    amplitude: float = 0.5
    period_h: float = 24.0
    phase_h: float = 0.0

    def __post_init__(self) -> None:
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(
                f"diurnal amplitude must be in [0, 1], got {self.amplitude!r}")
        if self.period_h <= 0:
            raise ValueError(
                f"diurnal period_h must be > 0, got {self.period_h!r}")

    def compile(self, n_ticks: int, tick_s: float) -> WorkloadSchedule:
        t_h = self._times(n_ticks, tick_s) / HOUR_S
        mult = 1.0 + self.amplitude * np.sin(
            2.0 * math.pi * (t_h - self.phase_h) / self.period_h)
        return WorkloadSchedule(np.maximum(mult, 0.0))


@dataclass(frozen=True)
class Campaign(WorkloadModel):
    """Bursty reprocessing waves: a square wave with a duty cycle.

    The first ``duty`` fraction of every ``period_h``-hour period runs at
    ``peak`` x the base rate; the remainder idles at ``off`` x. The
    defaults (3x for a quarter of the period, 0.5x otherwise) keep the
    long-run mean above the base rate, like a reprocessing campaign layered
    on steady analysis traffic.
    """

    period_h: float = 24.0
    duty: float = 0.25
    peak: float = 3.0
    off: float = 0.5

    def __post_init__(self) -> None:
        if not 0.0 < self.duty <= 1.0:
            raise ValueError(
                f"campaign duty must be in (0, 1], got {self.duty!r}")
        if self.period_h <= 0:
            raise ValueError(
                f"campaign period_h must be > 0, got {self.period_h!r}")
        if self.peak < 0 or self.off < 0:
            raise ValueError("campaign peak/off rates must be >= 0, got "
                             f"peak={self.peak!r} off={self.off!r}")

    def compile(self, n_ticks: int, tick_s: float) -> WorkloadSchedule:
        t_h = self._times(n_ticks, tick_s) / HOUR_S
        phase = np.mod(t_h, self.period_h) / self.period_h
        return WorkloadSchedule(np.where(phase < self.duty,
                                         float(self.peak), float(self.off)))


@dataclass(frozen=True)
class ZipfDrift(WorkloadModel):
    """Time-varying popularity skew layered on ``PopularityModel``.

    The file-selection power (jobs pick files with probability proportional
    to ``popularity ** power``) drifts linearly from ``power_start`` (the
    calibrated ``PopularityModel`` default) to ``power_end`` across the
    horizon, quantized into ``steps`` piecewise-constant segments so both
    engines need only ``steps`` distinct selection-weight tables. The
    arrival *rate* is untouched; only *which* files are hot drifts — e.g.
    ``power_end < power_start`` flattens the popularity distribution over
    time, widening the unique-file footprint and stressing the caches.
    """

    power_start: float = 3.5
    power_end: float = 1.5
    steps: int = 8

    def __post_init__(self) -> None:
        if self.power_start <= 0 or self.power_end <= 0:
            raise ValueError("zipf-drift powers must be > 0, got "
                             f"power_start={self.power_start!r} "
                             f"power_end={self.power_end!r}")
        if int(self.steps) != self.steps or self.steps < 2:
            raise ValueError(
                f"zipf-drift steps must be an integer >= 2 (a drift needs "
                f"at least its two endpoint segments), got {self.steps!r}")
        object.__setattr__(self, "steps", int(self.steps))

    def compile(self, n_ticks: int, tick_s: float) -> WorkloadSchedule:
        self._times(n_ticks, tick_s)  # argument validation only
        # Segments shorter than a tick can't be realised: clamp so the
        # last tick always lands in the final segment — the schedule ends
        # at power_end on any horizon of >= 2 ticks.
        steps = min(self.steps, n_ticks) if n_ticks > 1 else 1
        seg = np.minimum((np.arange(n_ticks) * steps) // max(n_ticks, 1),
                         steps - 1).astype(np.float64)
        frac = seg / max(steps - 1, 1)
        power = self.power_start + (self.power_end - self.power_start) * frac
        return WorkloadSchedule(np.ones(n_ticks, dtype=np.float64),
                                sel_power=power)


@dataclass(frozen=True)
class TraceReplay(WorkloadModel):
    """Arrival-rate multipliers replayed from a CSV table.

    The file must have a ``time_s,rate_mult`` header followed by rows of
    two numbers: the multiplier takes effect at ``time_s`` (seconds from
    scenario start, strictly increasing, >= 0) and holds until the next
    row; the last value holds to the end of the horizon, and ticks before
    the first row use the first value. The CSV is parsed and validated at
    construction time — i.e. at *spec-parse* time, not deep inside a sweep
    worker — so malformed traces fail the whole sweep up front.
    """

    path: str
    _table: Tuple[Tuple[float, float], ...] = field(
        init=False, repr=False, compare=False, default=())

    def __post_init__(self) -> None:
        object.__setattr__(self, "_table", self._parse(self.path))

    @staticmethod
    def _parse(path: str) -> Tuple[Tuple[float, float], ...]:
        """Parse + validate, cached on (path, mtime, size): spec grids
        re-trigger parsing many times per sweep (``__post_init__`` runs on
        every ``dataclasses.replace``), but an *edited* file changes its
        stat signature and is re-read and re-validated."""
        if not os.path.isfile(path):
            raise ValueError(f"workload trace CSV {path!r} not found")
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
        hit = _TRACE_CACHE.get(key)
        if hit is None:
            if len(_TRACE_CACHE) >= 64:
                _TRACE_CACHE.clear()
            hit = _TRACE_CACHE[key] = TraceReplay._parse_file(path)
        return hit

    @staticmethod
    def _parse_file(path: str) -> Tuple[Tuple[float, float], ...]:
        def bad(why: str) -> ValueError:
            return ValueError(
                f"malformed workload trace CSV {path!r}: {why} "
                "(expected a 'time_s,rate_mult' header, then rows of two "
                "numbers with strictly increasing times >= 0 and "
                "multipliers >= 0)")

        with open(path, newline="") as f:
            reader = csv.reader(f)
            try:
                header = next(reader)
            except StopIteration:
                raise bad("file is empty") from None
            cols = [c.strip().lower() for c in header[:2]]
            if cols != ["time_s", "rate_mult"]:
                raise bad(f"header is {header!r}")
            rows = []
            for i, row in enumerate(reader, start=2):
                if not row or not any(c.strip() for c in row):
                    continue  # blank line
                if len(row) < 2:
                    raise bad(f"line {i} has {len(row)} column(s)")
                try:
                    t, r = float(row[0]), float(row[1])
                except ValueError:
                    raise bad(f"line {i} is not numeric: {row!r}") from None
                if not (math.isfinite(t) and math.isfinite(r)):
                    raise bad(f"line {i} is not finite: {row!r}")
                if t < 0:
                    raise bad(f"line {i} has negative time {t!r}")
                if r < 0:
                    raise bad(f"line {i} has negative rate_mult {r!r}")
                if rows and t <= rows[-1][0]:
                    raise bad(f"line {i} time {t!r} does not increase")
                rows.append((t, r))
        if not rows:
            raise bad("no data rows")
        return tuple(rows)

    def compile(self, n_ticks: int, tick_s: float) -> WorkloadSchedule:
        times = self._times(n_ticks, tick_s)
        t_pts = np.array([t for t, _ in self._table])
        rates = np.array([r for _, r in self._table])
        idx = np.maximum(np.searchsorted(t_pts, times, side="right") - 1, 0)
        return WorkloadSchedule(rates[idx])


#: Registry backing ``parse_workload`` and the ``ScenarioSpec.workload``
#: axis; the key is the spec-string name.
WORKLOADS: Dict[str, Type[WorkloadModel]] = {
    "steady": SteadyPoisson,
    "diurnal": Diurnal,
    "campaign": Campaign,
    "zipf-drift": ZipfDrift,
    "trace": TraceReplay,
}


def _parse_number(name: str, key: str, text: str):
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        raise ValueError(f"workload {name!r}: parameter {key}={text!r} "
                         "is not a number") from None


def parse_workload(text: str) -> WorkloadModel:
    """Parse a workload spec string into a validated model.

    Syntax: ``name`` or ``name:key=value,key=value`` (``trace`` takes the
    CSV path directly: ``trace:/path/to/trace.csv``). Unknown names,
    unknown or non-numeric parameters, out-of-range values, and missing or
    malformed trace CSVs all raise ``ValueError`` here — i.e. at
    spec-parse time (``ScenarioSpec.__post_init__``), never deep inside a
    sweep worker. Pure-parameter models are cached (frozen, safe to
    share); ``trace`` models are re-parsed every call so an edited CSV is
    re-read and re-validated rather than served stale from the cache.
    """
    if not isinstance(text, str) or not text.strip():
        raise ValueError(f"workload must be a non-empty string, got {text!r}")
    if text.strip().partition(":")[0].strip() == "trace":
        return _parse_workload(text)
    return _parse_workload_cached(text)


def _parse_workload(text: str) -> WorkloadModel:
    name, sep, body = text.strip().partition(":")
    name = name.strip()
    if name not in WORKLOADS:
        raise ValueError(
            f"unknown workload {name!r} (valid: {sorted(WORKLOADS)}; "
            "parameters attach as 'name:key=value,key=value', e.g. "
            "'diurnal:amplitude=0.8,period_h=24' or 'trace:/path.csv')")
    cls = WORKLOADS[name]
    kwargs: Dict[str, object] = {}
    if sep:
        if name == "trace":
            # the remainder is the CSV path (paths may contain '=' / ',');
            # an explicit 'path=' prefix is also accepted
            path = body[len("path="):] if body.startswith("path=") else body
            if not path.strip():
                raise ValueError(
                    "workload 'trace' needs a CSV path: 'trace:/path.csv'")
            kwargs["path"] = path.strip()
        else:
            for item in body.split(","):
                key, eq, value = item.partition("=")
                key = key.strip()
                if not eq or not key:
                    raise ValueError(
                        f"workload {name!r}: malformed parameter {item!r} "
                        "(expected key=value)")
                kwargs[key] = _parse_number(name, key, value.strip())
    if name == "trace" and "path" not in kwargs:
        raise ValueError(
            "workload 'trace' needs a CSV path: 'trace:/path.csv'")
    valid = {f.name for f in fields(cls) if f.init}
    unknown = set(kwargs) - valid
    if unknown:
        raise ValueError(f"workload {name!r}: unknown parameter(s) "
                         f"{sorted(unknown)} (valid: {sorted(valid)})")
    try:
        return cls(**kwargs)
    except TypeError as e:  # e.g. 'trace' with no path
        raise ValueError(f"workload {name!r}: {e}") from None


_parse_workload_cached = functools.lru_cache(maxsize=128)(_parse_workload)
