"""Runner of the batched sweep's cells: whole calls of
``repro_torch.sim.sweep.run_sweep(specs, backend="torch", tick_impl=...,
cache=None)`` back to back, the front door the CLIs and the decision layer
use, packing and billing included.

- Set-up: the port's import, then one warm call of the cell's own grid
  on call 0's seeds (which loads or, in a fresh checkout, builds the
  kernels into ``build/repro_torch``); no window call uses them.
- Window: calls 1, 2, ... each on fresh seeds, until the first call that
  ends after ``--seconds``; the device's peak memory over the window.
  Traced: the program's spans and instants on, and the first window call
  under ``torch.profiler``.
- Check: :data:`REF_LANES` lanes of the window's calls, drawn from the
  seed (traced: every lane of the profiled call), simulated again by the
  plain reference from the same specs, every spec of them compared
  (``portbench.compare``). The traced run also keeps, at
  :data:`SAMPLE_TICKS` ticks of that call, the reference's state before
  and after each phase, for the byte counts of the rooflines.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from portbench import compare, devtrace, rooflines
from portbench.grid import call_specs
from portbench.reference import billing, packer
from portbench.reference import tick as ref_tick

#: Ticks of the checked call at which the traced run counts the bytes
#: the tick needs (spread over the replayed ticks).
SAMPLE_TICKS = 16


def _program_specs(run, specs: List[Dict]):
    from repro_torch.core.scenarios import ScenarioSpec

    cfg = run.cfg
    return [ScenarioSpec(base=cfg["base"], days=cfg["days"],
                         n_files=cfg["files_per_site"], seed=s["seed"],
                         cache_tb=s["cache_tb"], egress=s["egress"],
                         storage_price=s["storage_price"],
                         workload=packer.workload_string(s["workload"]))
            for s in specs]


def _sweep(run, specs: List[Dict]):
    from repro_torch.sim.sweep import run_sweep

    return run_sweep(_program_specs(run, specs), backend="torch",
                     tick=run.cfg["tick_s"], tick_impl=run.tick_impl,
                     device=run.device, cache=None)


def _cuda(run) -> bool:
    return run.device != "cpu"


def setup(run) -> None:
    import torch

    _sweep(run, call_specs(run.traffic, run.seed, 0))
    if _cuda(run):
        torch.cuda.synchronize()


def window(run) -> None:
    import torch

    tracer = None
    if run.trace:
        from repro_torch.obs.trace import get_tracer

        tracer = get_tracer()
        tracer.reset()
        tracer.enable()
    if _cuda(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    i = 1
    while True:
        specs = call_specs(run.traffic, run.seed, i)
        if run.trace and i == 1 and _cuda(run):
            with devtrace.profiled_call(run.record):
                res = _sweep(run, specs)
        else:
            res = _sweep(run, specs)
        run.calls.append({"index": i, "specs": specs, "result": res,
                          "n_results": len(res.results),
                          "end_s": time.perf_counter() - t0})
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    if _cuda(run):
        run.peak_bytes = int(torch.cuda.max_memory_allocated())
    if tracer is not None:
        tracer.disable()
        run.record["events"] = tracer.events
        tracer.reset()
    if "prof" in run.record:
        red = devtrace.reduce(run.record.pop("prof"),
                              run.record.pop("host_ns"))
        run.record["devtrace"] = red
        if red:
            spans = devtrace.spans_on_clock(run.record["events"],
                                            red["offset_ns"])
            run.record["breakdown"] = devtrace.breakdown(red, spans)
            run.record["ticks"] = devtrace.ticks(
                red["kernels"], red["replays"], devtrace.port_kernels(),
                packer.n_ticks(run.cfg["days"], run.cfg["tick_s"]))


def device_info(run) -> Dict:
    import torch

    if not _cuda(run):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": None}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(run.cell["chips"]),
            "memory_peak_bytes": run.peak_bytes}
    red = run.record.get("devtrace")
    if red:
        lo, hi = red["window"]
        info["busy_s"] = devtrace.busy_ns(red["kernels"], lo, hi) / 1e9
        info["window_s"] = (hi - lo) / 1e9
    return info


def attempted(run):
    n = sum(len(c["specs"]) for c in run.calls)
    done = sum(c["n_results"] for c in run.calls)
    return n, n - done


def _as_dict(r) -> Dict:
    return {"metrics": r.metrics, "storage_usd": r.storage_usd,
            "network_usd": r.network_usd, "ops_usd": r.ops_usd,
            "monthly": r.monthly}


#: Lanes the reference simulates again in a run without the trace, drawn
#: from the seed among all the window's lanes.
REF_LANES = 4


def lane_key(spec: Dict) -> tuple:
    return packer.dynamics_key(spec)


def checked(run):
    """``(specs, program results)`` the reference checks: every spec of
    the profiled call in a traced run, else every spec of
    :data:`REF_LANES` lanes drawn from the seed among the window's lanes
    (of any call)."""
    if run.trace:
        picks = [(0, None)]
    else:
        lanes = [(ci, k) for ci, c in enumerate(run.calls)
                 for k in dict.fromkeys(lane_key(s) for s in c["specs"])]
        n = min(REF_LANES, len(lanes))
        rng = np.random.default_rng([int(run.seed) % 2 ** 64, 1])
        picks = [lanes[i] for i in sorted(rng.choice(len(lanes), n,
                                                     replace=False))]
    specs, got = [], []
    for ci, key in picks:
        call = run.calls[ci]
        by_label = {r.spec.label: _as_dict(r)
                    for r in call["result"].results}
        for s, ps in zip(call["specs"], _program_specs(run, call["specs"])):
            if key is None or lane_key(s) == key:
                specs.append(s)
                got.append(by_label.get(ps.label))
    return specs, got


def sample_ticks(replayed) -> List[int]:
    """:data:`SAMPLE_TICKS` ticks spread over the ``replayed`` ticks the
    trace timed, the first replay left out."""
    ts = sorted(replayed)[1:]
    if not ts:
        return []
    return sorted({int(t) for t in np.linspace(ts[0], ts[-1],
                                               SAMPLE_TICKS)})


def reference(run, specs: List[Dict], bf16: bool = False,
              probe_ticks=()) -> List[Dict]:
    """The plain reference's results for ``specs`` (and, at each of
    ``probe_ticks``, the byte counts of that tick in ``run.record``)."""
    import torch

    cfg = run.cfg
    grid = packer.pack(cfg, specs, cfg["days"], cfg["tick_s"])
    loop = ref_tick.Loop(grid, run.device, bf16=bf16)
    counts = []
    try:
        for t in probe_ticks:
            loop.advance(t - loop.t)
            probe: Dict = {}
            loop.step(probe)
            counts.append({"tick": t,
                           **rooflines.phase_bytes(probe, grid.n_months),
                           "whole": rooflines.tick_bytes(
                               probe, probe["pre"], probe["post"])})
            del probe
        loop.advance(grid.n_ticks - loop.t)
        out = loop.result()
    finally:
        loop.close()
        if _cuda(run):
            torch.cuda.empty_cache()
    if probe_ticks:
        run.record["tick_bytes"] = counts
    return billing.results(cfg, grid, out)


def check(run):
    """The checked call's results against the reference's, spec by spec:
    ``({name: (value, limit)}, worst gaps)``."""
    import torch

    specs, got = checked(run)
    for c in run.calls:  # the program's results are all read: free them
        c["result"] = None
    if _cuda(run):
        torch.cuda.empty_cache()
    probe = (sample_ticks(run.record["ticks"])
             if run.trace and run.record.get("ticks") else ())
    want = reference(run, specs, probe_ticks=probe)
    numbers, worst = compare.compare(got, want)
    # a spec the window returned no result for, in any call
    numbers["missing"] = (attempted(run)[1], numbers["missing"][1])
    return numbers, worst
