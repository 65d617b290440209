"""The packer of the batched sweep, frozen for the benchmark: a spec grid
and its deployment into the dense per-lane arrays of the tick program.

Everything a lane draws comes from one numpy generator seeded with the
spec's seed, in this order (the paper's engine's order): per site the
file sizes (exponential in GiB, clamped) then the popularity (geometric,
clamped); the per-generator-tick job counts of every site (normal,
truncated at 0, times the workload's rate multiplier); then per site the
jobs' selection draws and durations. The deployment's numbers come from
its configuration file (``portbench/configs/<name>.json``), not from the
system under test. Specs that differ only in pricing share one lane.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

TB = 1000.0 ** 4
GiB = 1024.0 ** 3
DAY = 24 * 3600
HOUR_S = 3600.0
MONTH_SECONDS = 30 * DAY


# -- workload schedules (the arrival-rate multiplier and the selection
# power on each generator tick) ----------------------------------------

def schedule(workload: Dict, n_gen: int, gen_s: float):
    """``(rate_mult [G] float64, sel_power [G] float64 or None)`` of a
    workload given as ``{"name": ..., parameters}``."""
    name = workload["name"]
    p = {k: v for k, v in workload.items() if k != "name"}
    t = np.arange(n_gen, dtype=np.float64) * gen_s
    if name == "steady":
        return np.ones(n_gen, dtype=np.float64), None
    if name == "diurnal":
        amp = p.get("amplitude", 0.5)
        period = p.get("period_h", 24.0)
        phase = p.get("phase_h", 0.0)
        mult = 1.0 + amp * np.sin(
            2.0 * math.pi * (t / HOUR_S - phase) / period)
        return np.maximum(mult, 0.0), None
    if name == "campaign":
        period = p.get("period_h", 24.0)
        duty = p.get("duty", 0.25)
        ph = np.mod(t / HOUR_S, period) / period
        return np.where(ph < duty, float(p.get("peak", 3.0)),
                        float(p.get("off", 0.5))), None
    if name == "zipf-drift":
        start = p.get("power_start", 3.5)
        end = p.get("power_end", 1.5)
        steps = int(p.get("steps", 8))
        steps = min(steps, n_gen) if n_gen > 1 else 1
        seg = np.minimum((np.arange(n_gen) * steps) // max(n_gen, 1),
                         steps - 1).astype(np.float64)
        power = start + (end - start) * (seg / max(steps - 1, 1))
        return np.ones(n_gen, dtype=np.float64), power
    raise ValueError(f"unknown workload {name!r}")


def workload_string(workload: Dict) -> str:
    """The workload as the sweep's spec strings name it
    (``name:key=value,...``)."""
    params = ",".join(f"{k}={v}" for k, v in workload.items() if k != "name")
    return workload["name"] + (":" + params if params else "")


# -- the packed grid --------------------------------------------------

@dataclass
class Grid:
    specs: List[Dict]
    horizon: int
    n_months: int
    full_months: int
    max_jobs_per_tick: int
    lane_of: np.ndarray
    disk_limit: np.ndarray
    gcs_enabled: np.ndarray
    gcs_limit: np.ndarray
    min_migrate_pop: np.ndarray
    link_bw: np.ndarray
    link_slots: np.ndarray
    link_latency: np.ndarray
    link_mode: np.ndarray
    sizes: np.ndarray
    pop: np.ndarray
    job_fid: np.ndarray
    job_submit_tick: np.ndarray
    job_submit_time: np.ndarray
    job_tail: np.ndarray
    jobs_per_tick: np.ndarray
    n_jobs: np.ndarray
    times: np.ndarray
    dts: np.ndarray
    month_idx: np.ndarray
    site_names: List[str]

    @property
    def n_lanes(self) -> int:
        return int(self.sizes.shape[0])

    @property
    def n_ticks(self) -> int:
        return int(self.times.shape[0])


def tick_grid(days: float, tick: float) -> np.ndarray:
    """The shared clock: 0, tick, 2 tick, ... and the horizon itself
    (float64 seconds)."""
    horizon = int(days * DAY)
    grid = np.arange(0, horizon + 1e-9, tick, dtype=np.float64)
    if grid[-1] < horizon:
        grid = np.append(grid, float(horizon))
    return grid


def n_ticks(days: float, tick: float) -> int:
    return len(tick_grid(days, tick))


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 0 else 0


PRICING_KEYS = ("egress", "storage_price")


def dynamics_key(spec: Dict) -> tuple:
    return tuple(sorted((k, repr(v)) for k, v in spec.items()
                        if k not in PRICING_KEYS))


def _draw_lane(cfg: Dict, seed: int, workload: Dict, S: int, F: int,
               horizon: int, grid: np.ndarray):
    rng = np.random.default_rng(seed)
    size = cfg["file_size_gib"]
    pop_cfg = cfg["popularity"]
    l_sizes = np.zeros((S, F), dtype=np.float32)
    l_pop = np.zeros((S, F), dtype=np.float32)
    cum_ws = []
    for si in range(S):
        x = rng.exponential(1.0 / size["lam"], size=F)
        l_sizes[si] = np.clip(x, size["lo"], size["hi"]) * GiB
        l_pop[si] = np.clip(rng.geometric(pop_cfg["p"], F), pop_cfg["lo"],
                            pop_cfg["hi"] - 1)
        cw = np.cumsum(l_pop[si].astype(float) ** pop_cfg["selection_power"])
        cum_ws.append(cw / cw[-1])
    gen = cfg["gen_interval_s"]
    n_gen = horizon // gen + 1
    jobs = cfg["jobs_per_tick"]
    counts = np.maximum(rng.normal(jobs["mu"], jobs["sigma"],
                                   size=(S, n_gen)), 0.0)
    rate_mult, sel_power = schedule(workload, n_gen, gen)
    counts = counts * rate_mult
    gen_times = np.arange(n_gen, dtype=np.float64) * gen
    dur = cfg["job_duration_s"]
    lane_jobs = []
    for si in range(S):
        emitted = np.diff(np.floor(np.cumsum(counts[si])),
                          prepend=0.0).astype(np.int64)
        j_times = np.repeat(gen_times, emitted)
        u = rng.random(len(j_times))
        durs = np.clip(rng.exponential(1.0 / dur["lam"], size=len(j_times)),
                       dur["lo"], np.inf)
        if sel_power is None:
            fid = np.searchsorted(cum_ws[si], u, side="right").astype(
                np.int32)
        else:
            j_power = sel_power[np.repeat(np.arange(n_gen), emitted)]
            fid = np.zeros(len(u), dtype=np.int32)
            for pw in np.unique(j_power):
                cw = np.cumsum(l_pop[si].astype(float) ** float(pw))
                sel = j_power == pw
                fid[sel] = np.searchsorted(cw / cw[-1], u[sel], side="right")
        dl = l_sizes[si, fid].astype(np.float64) / cfg["download_b_s"]
        tail = np.maximum(1, (dl + durs).astype(np.int64))
        j_tick = np.searchsorted(grid, j_times, side="left").astype(np.int32)
        lane_jobs.append((fid, j_tick, j_times.astype(np.float32),
                          tail.astype(np.float32)))
    return l_sizes, l_pop, lane_jobs


def pack(cfg: Dict, specs: Sequence[Dict], days: float, tick: float) -> Grid:
    """Pack ``specs`` (dicts with ``seed``, ``cache_tb``, ``egress``,
    ``storage_price`` and ``workload``) of the deployment ``cfg`` into one
    grid of ``days`` at a clock step of ``tick`` seconds."""
    specs = list(specs)
    sites = cfg["sites"]
    S = len(sites)
    F = int(cfg["files_per_site"])
    horizon = int(days * DAY)
    lane_index: Dict[tuple, int] = {}
    lane_of = np.zeros(len(specs), dtype=np.int32)
    lanes: List[Dict] = []
    for i, spec in enumerate(specs):
        key = dynamics_key(spec)
        if key not in lane_index:
            lane_index[key] = len(lanes)
            lanes.append(spec)
        lane_of[i] = lane_index[key]
    L = len(lanes)

    grid = tick_grid(days, tick)
    times = grid.astype(np.float32)
    dts = np.diff(grid, prepend=0.0).astype(np.float32)
    T = len(times)
    n_months = max(1, int(np.ceil(horizon / MONTH_SECONDS)))
    full_months = int(horizon // MONTH_SECONDS)
    month_idx = np.minimum((grid // MONTH_SECONDS).astype(np.int32),
                           n_months - 1)

    gcs_tb = cfg["gcs_limit_tb"]
    gcs_on = gcs_tb is None or gcs_tb > 0
    disk_limit = np.full((L, S), np.inf, dtype=np.float32)
    sizes = np.zeros((L, S, F), dtype=np.float32)
    pop = np.zeros((L, S, F), dtype=np.float32)
    rates, slots, lats = [], [], []
    links = cfg["links"]
    for site in sites:
        rates += [site["tape_to_disk_b_s"], links["gcs_to_disk_b_s"],
                  links["disk_to_gcs_b_s"]]
        slots += [float(links["max_active"])] * 3
        lats += [links["tape_latency_s"], 0.0, 0.0]
    draws: Dict[tuple, tuple] = {}
    per_lane_jobs = []
    for li, spec in enumerate(lanes):
        wl = spec.get("workload", {"name": "steady"})
        dkey = (int(spec["seed"]), repr(sorted(wl.items())))
        if dkey not in draws:
            draws[dkey] = _draw_lane(cfg, int(spec["seed"]), wl, S, F,
                                     horizon, grid)
        l_sizes, l_pop, lane_jobs = draws[dkey]
        sizes[li] = l_sizes
        pop[li] = l_pop
        per_lane_jobs.append(lane_jobs)
        cache_tb = spec.get("cache_tb")
        for si, site in enumerate(sites):
            tb = site["disk_tb"] if cache_tb is None else cache_tb
            disk_limit[li, si] = (np.inf if tb is None or math.isinf(tb)
                                  else tb * TB)

    J = _pow2(max(len(j[0]) for lane in per_lane_jobs for j in lane))
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
    K = _pow2(int(jobs_per_tick.max()) if jobs_per_tick.size else 0)

    return Grid(
        specs=specs, horizon=horizon, n_months=n_months,
        full_months=full_months, max_jobs_per_tick=K, lane_of=lane_of,
        disk_limit=disk_limit,
        gcs_enabled=np.full(L, gcs_on, dtype=bool),
        gcs_limit=np.full(L, np.inf if gcs_tb is None else gcs_tb * TB,
                          dtype=np.float32),
        min_migrate_pop=np.full(L, cfg["migrate_min_popularity"],
                                dtype=np.float32),
        link_bw=np.tile(np.asarray(rates, dtype=np.float32), (L, 1)),
        link_slots=np.tile(np.asarray(slots, dtype=np.float32), (L, 1)),
        link_latency=np.tile(np.asarray(lats, dtype=np.float32), (L, 1)),
        link_mode=np.ones((L, 3 * S), dtype=np.int32),
        sizes=sizes, pop=pop, job_fid=job_fid,
        job_submit_tick=job_submit_tick, job_submit_time=job_submit_time,
        job_tail=job_tail, jobs_per_tick=jobs_per_tick, n_jobs=n_jobs,
        times=times, dts=dts, month_idx=month_idx,
        site_names=[s["name"] for s in sites],
    )
