"""The port's telemetry layer (``repro_torch.obs``) on the CPU: the metrics
registry against ``repro.obs.metrics`` on the same operations, the tracer,
the logging setup, and what the sweep front door and ``SweepDriver``
record (spans, the ``sweep.torch`` instant, counters and gauges)."""

import json
import logging

import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs

import repro.obs.metrics as jx_metrics
from repro_torch.core.scenarios import ScenarioSpec, with_seeds
from repro_torch.obs import setup_logging
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    MetricsRegistry,
    get_registry,
    snapshot_and_reset,
    split_series_name,
)
from repro_torch.obs.trace import Tracer, get_tracer
from repro_torch.sim.batched import run_sweep_torch
from repro_torch.sim.sweep import SweepDriver
from torch_threads import one_torch_thread  # noqa: F401

# ------------------------------------------------------------------ metrics
_ops = hs.lists(hs.tuples(
    hs.sampled_from(["inc", "set_gauge", "observe"]),
    hs.sampled_from(["cache.hits", "lanes.simulated", "sweep.wall_s"]),
    hs.floats(0.0, 100.0),
    hs.dictionaries(hs.sampled_from(["impl", "site"]),
                    hs.sampled_from(["torch", "cuda", "1"]), max_size=2)),
    max_size=30)


def _apply(reg, ops):
    for op, name, value, labels in ops:
        getattr(reg, op)(name, value, **labels)


@settings(max_examples=50, deadline=None)
@given(ops=_ops, more=_ops)
def test_registry_equals_reference_on_the_same_operations(ops, more):
    port, ref = MetricsRegistry(), jx_metrics.MetricsRegistry()
    for reg in (port, ref):
        _apply(reg, ops)
    assert port.snapshot() == ref.snapshot()
    assert port.to_prometheus() == ref.to_prometheus()
    # merge folds a worker's delta in the same way
    delta_port, delta_ref = MetricsRegistry(), jx_metrics.MetricsRegistry()
    _apply(delta_port, more)
    _apply(delta_ref, more)
    port.merge(snapshot_and_reset(delta_port))
    ref.merge(jx_metrics.snapshot_and_reset(delta_ref))
    assert port.snapshot() == ref.snapshot()
    assert delta_port.snapshot() == {"counters": {}, "gauges": {},
                                     "histograms": {}}


def test_registry_lookup_labels_and_switches(tmp_path):
    r = MetricsRegistry()
    r.inc("x", b="2", a="1")
    r.inc("x", a="1", b="2")
    assert r.snapshot()["counters"] == {"x{a=1,b=2}": 2.0}
    assert split_series_name("x{a=1,b=2}") == ("x", {"a": "1", "b": "2"})
    assert r.value("x", a="1", b="2") == 2.0 and r.value("y") == 0.0
    r.observe("h", 0.02, help="a histogram")
    h = r.snapshot()["histograms"]["h"]
    assert h["bounds"] == list(DEFAULT_BUCKETS) and h["count"] == 1
    assert "# HELP h a histogram" in r.to_prometheus()
    r.disable()
    r.inc("x", a="1", b="2")
    assert r.value("x", a="1", b="2") == 2.0
    r.enable()
    r.reset()
    assert r.value("x", a="1", b="2") == 0.0
    r.set_gauge("g", 3)
    r.dump(str(tmp_path / "m.json"))
    assert json.loads((tmp_path / "m.json").read_text())["gauges"] == \
        {"g": 3.0}
    r.dump(str(tmp_path / "m.prom"))
    assert "# TYPE g gauge" in (tmp_path / "m.prom").read_text()


# ------------------------------------------------------------------ tracing
def test_tracer_spans_instants_and_export(tmp_path):
    t = Tracer(run_id="abc")
    with t.span("off"):
        pass
    t.instant("off")
    assert t.events == []  # disabled by default: records nothing
    t.enable()
    with t.span("outer", n=1):
        with t.span("inner"):
            pass
    with pytest.raises(RuntimeError):
        with t.span("boom"):
            raise RuntimeError("x")
    t.instant("mark", k=2)
    names = [e["name"] for e in t.events]
    assert names == ["obs.clock", "inner", "outer", "boom", "mark"]
    ev = {e["name"]: e for e in t.events}
    assert ev["outer"]["ph"] == "X" and ev["outer"]["args"] == \
        {"n": 1, "run_id": "abc", "id": ev["outer"]["args"]["id"],
         "parent": None, "root": ev["outer"]["args"]["id"]}
    assert ev["boom"]["args"]["error"] is True
    assert ev["mark"]["ph"] == "i" and ev["mark"]["args"]["k"] == 2
    path = tmp_path / "trace.json"
    t.dump(str(path))
    doc = json.loads(path.read_text())
    assert len(doc["traceEvents"]) == 5
    assert doc["otherData"]["run_id"] == "abc"
    t.reset()
    assert t.events == []


def test_tracer_ids_parents_and_roots():
    """Each span has its own id and its enclosing span's as ``parent`` (per
    thread); everything inside :meth:`Tracer.root` carries that root, else
    its outermost span's; ``record_span`` nests like a span opened where
    it is recorded."""
    import threading

    t = Tracer(run_id="ids")
    t.enable()
    with t.span("alone"):
        t.instant("in_alone")
    with t.root() as rid:
        with t.span("outer"):
            with t.span("inner") as t0:
                t.instant("mark")
            t.record_span("recorded", t0, t0 + 2_000_000, n=3)
        t.instant("after")

        def other():
            with t.span("thread"):
                pass

        th = threading.Thread(target=other)
        th.start()
        th.join()
    ev = {e["name"]: e["args"] for e in t.events}
    assert ev["alone"]["parent"] is None
    assert ev["alone"]["root"] == ev["alone"]["id"]
    assert ev["in_alone"]["parent"] == ev["alone"]["id"]
    assert ev["in_alone"]["root"] == ev["alone"]["id"]
    assert ev["outer"]["parent"] is None and ev["outer"]["root"] == rid
    assert ev["inner"]["parent"] == ev["outer"]["id"]
    assert ev["mark"]["parent"] == ev["inner"]["id"]
    assert ev["recorded"]["parent"] == ev["outer"]["id"]
    assert ev["recorded"]["n"] == 3
    recorded = [e for e in t.events if e["name"] == "recorded"][0]
    assert recorded["ts"] == t0 // 1000 and recorded["dur"] == 2000
    for name in ("inner", "mark", "recorded", "after"):
        assert ev[name]["root"] == rid, name
    assert ev["after"]["parent"] is None
    # another thread has a stack and a root of its own
    assert ev["thread"]["parent"] is None
    assert ev["thread"]["root"] == ev["thread"]["id"]
    ids = [e["args"]["id"] for e in t.events if e["ph"] == "X"]
    assert len(set(ids)) == len(ids) and rid not in ids
    t.disable()
    with t.root() as none:
        assert none is None


def test_obs_clock_places_host_spans_on_the_profiler_clock():
    """``obs.clock``'s offset against ``torch.profiler``: a
    ``record_function`` range's start on the profiler's clock less its
    start on ``perf_counter`` plus the offset, the median of several, is
    within 100 us."""
    import statistics
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    t = Tracer()
    t.enable()
    (clock,) = [e["args"] for e in t.events if e["name"] == "obs.clock"]
    assert clock["clock"] == "time.time_ns" and clock["spread_ns"] >= 0
    gaps = []
    for i in range(7):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            host = time.perf_counter_ns()
            with record_function(f"obs_clock_{i}"):
                pass
        (start,) = [e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == f"obs_clock_{i}"]
        gaps.append(start - (host + clock["offset_ns"]))
    assert abs(statistics.median(gaps)) < 100_000, gaps


def test_setup_logging_shares_the_run_id_with_the_tracer():
    root = logging.getLogger()
    saved = (root.level, list(root.handlers))
    try:
        rid = setup_logging("debug", run_id="r123")
        assert rid == "r123" and get_tracer().run_id == "r123"
        assert root.level == logging.DEBUG
        assert "[r123]" in root.handlers[0].formatter._fmt
    finally:
        root.handlers[:] = saved[1]
        root.setLevel(saved[0])


# ----------------------------------------- what the sweep layers record
@pytest.fixture
def traced():
    tracer = get_tracer()
    tracer.reset()
    tracer.enable()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.reset()


def test_run_sweep_torch_records_spans_instant_and_counters(traced):
    reg = get_registry()
    runs = reg.value("sweep.torch.runs")
    lanes = reg.value("sweep.torch.lanes")
    specs = with_seeds([ScenarioSpec(base="III", days=0.05, n_files=300,
                                     cache_tb=5.0)], 2)
    specs += [ScenarioSpec(base="III", days=0.05, n_files=300,
                           cache_tb=5.0, egress="direct")]
    res = run_sweep_torch(specs, tick=60.0, tick_impl="torch", device="cpu")
    assert res.lanes_simulated == 2  # the direct variant shares seed 0's
    assert reg.value("sweep.torch.runs") == runs + 1
    assert reg.value("sweep.torch.lanes") == lanes + 2
    ev = {e["name"]: e for e in traced.events}
    assert ev["pack_specs"]["args"]["n_specs"] == 3
    assert ev["simulate_packed"]["args"]["lanes"] == 2
    assert ev["simulate_packed"]["args"]["tick_impl"] == "torch"
    info = ev["sweep.torch"]["args"]
    assert (info["specs"], info["lanes"], info["ticks"]) == (3, 2, 73)
    assert info["capture_s"] == 0.0 and info["pool_bytes"] == 0
    assert 0.0 < info["pack_s"] < info["sweep_s"]
    assert info["sweep_s"] == res.wall_s


def test_run_sweep_torch_events_share_their_call_root(traced):
    """Every span and instant of one ``run_sweep_torch`` call carries the
    call's root, another call's another; the loop's ``tick.setup`` and
    ``sweep.torch.tick`` sit inside ``simulate_packed``, ``billing`` after
    it, and a loop on the CPU records no ``tick.replays``."""
    spec = ScenarioSpec(base="III", days=0.02, n_files=300, cache_tb=5.0)
    for _ in range(2):
        run_sweep_torch([spec], tick=60.0, tick_impl="torch", device="cpu")
    calls = [e for e in traced.events if e["name"] != "obs.clock"]
    roots = [e["args"]["root"] for e in calls]
    assert len(set(roots)) == 2 and roots[0] is not None
    first = [e for e in calls if e["args"]["root"] == roots[0]]
    names = [e["name"] for e in first]
    assert names == ["pack_specs", "tick.setup", "sweep.torch.tick",
                     "simulate_packed", "sweep.torch", "billing"]
    ev = {e["name"]: e["args"] for e in first}
    for name in ("tick.setup", "sweep.torch.tick"):
        assert ev[name]["parent"] == ev["simulate_packed"]["id"], name
    for name in ("pack_specs", "simulate_packed", "sweep.torch", "billing"):
        assert ev[name]["parent"] is None, name
    assert ev["billing"]["specs"] == 1
    assert ev["tick.setup"]["graph"] is False


def test_sweep_driver_sets_its_gauges():
    reg = get_registry()
    drv = SweepDriver(tick=60.0, tick_impl="torch", device="cpu")
    spec = ScenarioSpec(base="III", days=0.05, n_files=300, cache_tb=5.0)
    drv.run([spec])
    drv.run([spec])  # memoized: no second call
    assert drv.sweep_calls == 1 and drv.configs_run == 1
    assert reg.value("sweep.calls") == 1.0
    assert reg.value("lanes.simulated") == 1.0
    assert reg.value("configs.run") == 1.0
    assert reg.value("sweep.wall_s") == drv.wall_s > 0.0
