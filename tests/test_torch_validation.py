"""The port's §4.2 validation scenario and §6 planner
(``repro_torch.core.{validation,planner}``) bitwise against ``repro``'s,
and the copied samplers and sinks they run on."""

import dataclasses

import numpy as np
import pytest

from repro.core import planner as jx_planner
from repro.core import validation as jx_validation
from repro.sim import distributions as jx_dist
from repro.sim import output as jx_output
from repro_torch.core import planner, validation
from repro_torch.core.carousel import LRUTracker, SlidingWindow
from repro_torch.sim import distributions, output


def test_validation_scenario_one_day_bitwise_to_reference():
    cfg = dict(simulated_time=86400, seed=1)
    want = jx_validation.ValidationScenario(jx_validation.ValidationConfig(**cfg))
    got = validation.ValidationScenario(validation.ValidationConfig(**cfg))
    m_want, m_got = want.run(), got.run()
    assert m_got == m_want
    assert got.sim.events_executed == want.sim.events_executed
    assert got.out.counters == want.out.counters
    for name in ("file_size", "duration"):
        assert got.out.hist(name).samples == want.out.hist(name).samples
    # Table 2's rows at a day: about 1.8 transfers/s of 1.6-1.8 GB files
    assert 1.6 < m_got["transfers_per_s"] < 2.0
    assert 1.4 < m_got["file_size_gb"] < 2.0
    assert validation.PAPER_TABLE2 == jx_validation.PAPER_TABLE2
    assert dataclasses.asdict(validation.ValidationConfig()) == \
        dataclasses.asdict(jx_validation.ValidationConfig())


@pytest.mark.parametrize("use_gcs,limit", [(False, None), (False, 3.0),
                                           (True, 3.0)])
def test_planner_run_point_bitwise_to_reference(use_gcs, limit):
    kw = dict(days=1, n_files=500, seed=4)
    got = planner.run_point(limit, use_gcs, **kw)
    want = jx_planner.run_point(limit, use_gcs, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.cost_per_job == want.cost_per_job


def test_planner_sweep_and_recommend_bitwise_to_reference():
    kw = dict(days=1, n_files=500, seed=2)
    got = planner.sweep([2.0, 20.0], **kw)
    want = jx_planner.sweep([2.0, 20.0], **kw)
    assert [dataclasses.asdict(p) for p in got] == \
        [dataclasses.asdict(p) for p in want]
    assert len(got) == 3 and got[0].disk_limit_tb == float("inf")
    for frac in (0.5, 0.98, 1.5):
        assert dataclasses.asdict(planner.recommend(got, frac)) == \
            dataclasses.asdict(jx_planner.recommend(want, frac))
    # nothing feasible: the baseline
    assert planner.recommend(got, 10.0) is got[0]


def test_samplers_bitwise_to_reference():
    for make in (lambda m: m.BoundedGeometric(0.1, 1, 50),
                 lambda m: m.BoundedExponential(0.026, 0.01, 125.0, unit=2.0),
                 lambda m: m.TruncatedNormalCount(0.63366, 0.37292)):
        a = make(distributions).sample(np.random.default_rng(5), 1000)
        b = make(jx_dist).sample(np.random.default_rng(5), 1000)
        assert np.array_equal(a, b)
    for make in (lambda m: m.BoundedExponential(0.61972, 0.0095, 12.8),
                 lambda m: m.BoundedExponential(0.026),
                 lambda m: m.TruncatedNormalCount(0.63366, 0.37292)):
        assert make(distributions).mean == make(jx_dist).mean
    xs = np.random.default_rng(2).normal(0.6, 0.4, 500)
    ca, cb = distributions.FractionalCounter(), jx_dist.FractionalCounter()
    assert [ca.emit(x) for x in xs] == [cb.emit(x) for x in xs]
    assert ca.acc == cb.acc


def test_output_collector_and_window():
    col, ref = output.OutputCollector(), jx_output.OutputCollector()
    for c in (col, ref):
        c.count("a")
        c.count("a", 2.5)
        for x in (1.0, 4.0, 7.0):
            c.hist("h").record(x)
        c.ts("s").record(10, 3.0)
    assert col.summary() == ref.summary() == {"a": 3.5, "h.mean": 4.0,
                                              "h.n": 3.0}
    assert col.hist("empty").mean == 0.0
    counts, edges = col.hist("h").counts(bins=3)
    assert counts.tolist() == [1, 1, 1]

    w = SlidingWindow(10.0)
    assert w.allocate("x", 6.0) and w.allocate("x", 6.0)
    assert not w.allocate("y", 5.0) and w.free == 4.0
    assert "x" in w and len(w) == 1 and w.release("x") == 6.0
    assert SlidingWindow(None).free == float("inf")
    lru = LRUTracker()
    for k in ("a", "b", "a", "c"):
        lru.touch(k)
    lru.drop("c")
    assert list(lru.evict_candidates()) == ["b", "a"] and len(lru) == 2
