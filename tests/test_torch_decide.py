"""The port's decision layer (``repro_torch.sim.decide``) against the JAX
package's (``repro.sim.decide``) on the CPU.

- the helpers (``Interval``, ``summarize``, ``ci_dominates``,
  ``ci_frontier``, ``refine_levels``, ``with_axis``, ``strip_seed``,
  ``axis_value``) equal to ``repro``'s on hypothesis inputs;
- ``decide()`` of both packages on the same synthetic evaluator (the
  saturating jobs/cost model of ``tests/test_decide.py``, each package's
  evaluator returning its own ``SweepResult``): equal ``to_json_dict()``
  outside the driver's timings and the registry snapshot;
- ``decide()`` on the port's plain path
  (``SweepDriver(backend="torch", tick_impl="torch", device="cpu")``)
  against ``repro``'s jnp program on one small grid: equal decisions,
  floats at the rtol 1e-5 of ``tests/test_torch_batched.py``;
- ``SweepResult``'s seed aggregation and exports equal to ``repro``'s.
"""

import csv
import dataclasses
import json
import math

import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs

import repro.core.scenarios as jx
import repro.sim.decide as jx_decide
import repro.sim.sweep as jx_sweep
import repro_torch.core.scenarios as pt
import repro_torch.sim.decide as pt_decide
import repro_torch.sim.sweep as pt_sweep
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5  # tests/test_torch_batched.py's float bar against jnp

PACKAGES = {"jax": (jx, jx_decide, jx_sweep),
            "torch": (pt, pt_decide, pt_sweep)}


def _spec(pkg, **kw):
    return PACKAGES[pkg][0].ScenarioSpec(**kw)


def _synth(pkg, spec, jobs, cost):
    """``tests/test_decide.py``'s synthetic result, in ``pkg``'s types."""
    return PACKAGES[pkg][2].ScenarioResult(
        spec=spec,
        metrics={"jobs_done": jobs,
                 "Site-1.disk_used_pb": 0.004, "Site-2.disk_used_pb": 0.004},
        storage_usd=cost, network_usd=0.0, ops_usd=0.0, wall_s=0.0,
        events=0)


def _sat_jobs(spec):
    c = spec.cache_tb if spec.cache_tb is not None else 100.0
    return 1000.0 * (1.0 - math.exp(-c / 15.0)) + 2.0 * (spec.seed % 2)


def _sat_cost(spec):
    c = spec.cache_tb if spec.cache_tb is not None else 100.0
    price = spec.egress_price if spec.egress_price is not None else 0.08
    return 20.0 + 2000.0 * price * math.exp(-c / 30.0)


def _make_eval(pkg, jobs_fn, cost_fn, log=None):
    sweep = PACKAGES[pkg][2]

    def evaluate(specs):
        if log is not None:
            log.extend(dataclasses.asdict(s) for s in specs)
        return sweep.SweepResult(results=[
            _synth(pkg, s, jobs_fn(s), cost_fn(s)) for s in specs])
    return evaluate


def _interval(iv):
    return (iv.mean, iv.sd, iv.n, iv.lo, iv.hi)


def _point_key(p):
    return (dataclasses.asdict(p.spec), _interval(p.jobs), _interval(p.cost))


def _comparable(doc):
    """A report's JSON without what differs by package or by run: the
    registry snapshot, the driver's wall time and its backend name."""
    doc = json.loads(json.dumps(doc))
    stats = doc.pop("stats")
    for k in ("metrics", "sweep_wall_s", "backend", "tick_impl"):
        stats.pop(k, None)
    doc["stats"] = stats
    return doc


def _assert_close_docs(a, b, path=""):
    """Equal structure and non-float leaves; floats within ``RTOL``."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_close_docs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_close_docs(u, v, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-9), (path, a, b)
    else:
        assert a == b, (path, a, b)


# ------------------------------------------------------------------ helpers
_samples = hs.lists(hs.floats(-1e6, 1e6, allow_nan=False), min_size=1,
                    max_size=6)


@settings(max_examples=60, deadline=None)
@given(xs=_samples, ys=_samples, z=hs.sampled_from([1.0, 1.96, 2.58]),
       delta=hs.floats(-1e3, 1e3))
def test_interval_equals_reference(xs, ys, z, delta):
    a = {p: PACKAGES[p][1].Interval.from_samples(xs, z) for p in PACKAGES}
    b = {p: PACKAGES[p][1].Interval.from_samples(ys, z) for p in PACKAGES}
    assert _interval(a["torch"]) == _interval(a["jax"])
    assert a["torch"].overlaps(b["torch"]) == a["jax"].overlaps(b["jax"])
    assert _interval(a["torch"].shifted(delta)) == \
        _interval(a["jax"].shifted(delta))
    assert format(a["torch"], ".3f") == format(a["jax"], ".3f")


_point_samples = hs.lists(
    hs.tuples(hs.sampled_from([5.0, 10.0, 20.0]),
              hs.sampled_from([None, 0.02, 0.03]),
              hs.integers(0, 2),
              hs.floats(0.0, 1e3), hs.floats(0.0, 1e3)),
    min_size=1, max_size=12)


def _results(pkg, rows):
    return [_synth(pkg, _spec(pkg, base="III", days=0.1, n_files=100,
                              cache_tb=c, storage_price=price, seed=seed),
                   jobs, cost)
            for c, price, seed, jobs, cost in rows]


@settings(max_examples=40, deadline=None)
@given(rows=_point_samples)
def test_summarize_dominance_and_frontier_equal_reference(rows):
    points = {p: PACKAGES[p][1].summarize(_results(p, rows))
              for p in PACKAGES}
    assert [_point_key(q) for q in points["torch"]] == \
        [_point_key(q) for q in points["jax"]]
    n = len(points["torch"])
    for i in range(n):
        for j in range(n):
            assert pt_decide.ci_dominates(points["torch"][i],
                                          points["torch"][j]) == \
                jx_decide.ci_dominates(points["jax"][i], points["jax"][j])
    onprem = {p: PACKAGES[p][1].OnPremDisk(7.0) for p in PACKAGES}
    for cost_of in (None, "total_interval"):
        fronts = {}
        for p in PACKAGES:
            kw = ({} if cost_of is None
                  else {"cost_of": getattr(onprem[p], cost_of)})
            fronts[p] = PACKAGES[p][1].ci_frontier(points[p], **kw)
        assert [_point_key(q) for q in fronts["torch"]] == \
            [_point_key(q) for q in fronts["jax"]]


_levels = hs.lists(hs.one_of(hs.none(), hs.just(math.inf),
                             hs.floats(0.0, 200.0)), max_size=8)


@settings(max_examples=80, deadline=None)
@given(values=_levels, picks=hs.lists(hs.integers(0, 7), max_size=4),
       rel_tol=hs.floats(0.0, 0.5))
def test_refine_levels_equals_reference(values, picks, rel_tol):
    anchors = [values[i] for i in picks if i < len(values)] + [None, 1e9]
    assert pt.refine_levels(values, anchors, rel_tol) == \
        jx.refine_levels(values, anchors, rel_tol)


_spec_fields = hs.fixed_dictionaries({
    "base": hs.sampled_from(["I", "II", "III"]),
    "seed": hs.integers(0, 5),
    "cache_tb": hs.one_of(hs.none(), hs.floats(1.0, 100.0)),
    "egress": hs.sampled_from(["internet", "direct", "interconnect"]),
    "storage_price": hs.one_of(hs.none(), hs.floats(0.01, 0.05)),
    "egress_price": hs.one_of(hs.none(), hs.floats(0.0, 0.12)),
})


@settings(max_examples=60, deadline=None)
@given(fields=_spec_fields, axis=hs.sampled_from(pt.CONTINUOUS_AXES),
       value=hs.floats(0.5, 80.0))
def test_axis_helpers_equal_reference(fields, axis, value):
    assert pt.CONTINUOUS_AXES == jx.CONTINUOUS_AXES
    a, b = _spec("torch", **fields), _spec("jax", **fields)
    assert pt.axis_value(a, axis) == jx.axis_value(b, axis)
    assert dataclasses.asdict(pt.with_axis(a, axis, value)) == \
        dataclasses.asdict(jx.with_axis(b, axis, value))
    assert dataclasses.asdict(pt.strip_seed(a)) == \
        dataclasses.asdict(jx.strip_seed(b))
    with pytest.raises(ValueError):
        pt.axis_value(a, "days")
    with pytest.raises(ValueError):
        pt.with_axis(a, "egress", value)


# ------------------------------------------------- decide, synthetic model
AXES = {"base": "III", "days": 0.1, "n_files": 100,
        "cache_tb": [5.0, 20.0, 40.0, 80.0],
        "egress": ["internet", "direct"]}


@pytest.mark.parametrize("case", ["saturating", "unreachable"])
def test_decide_on_synthetic_model_equals_reference(case):
    jobs_fn = _sat_jobs if case == "saturating" else (
        lambda s: 100.0 if s.base != "I" else 5000.0)
    reports, logs = {}, {}
    for p in PACKAGES:
        logs[p] = []
        reports[p] = PACKAGES[p][1].decide(
            AXES, _make_eval(p, jobs_fn, _sat_cost, logs[p]), n_seeds=2,
            max_rounds=3, onprem=PACKAGES[p][1].OnPremDisk(15.0))
    assert logs["torch"] == logs["jax"]  # the same probes, in order
    a, b = (reports[p].to_json_dict() for p in ("torch", "jax"))
    assert _comparable(a) == _comparable(b)
    # the unreachable model never matches the baseline: no break-even
    assert (a["break_even"] is None) == (case == "unreachable")
    md = {p: reports[p].to_markdown().split("## Run stats")[0]
          for p in PACKAGES}
    assert md["torch"] == md["jax"]


# ---------------------------------------- decide on the port's plain path
SMALL_AXES = {"base": "III", "days": 0.1, "n_files": 1000,
              "cache_tb": [5.0, 20.0], "egress": ["internet", "direct"]}


def test_decide_on_plain_path_matches_jnp_program():
    """The whole workflow on simulated lanes: baseline, one refinement
    round, the displaced-disk bisection and the break-even ladder. Every
    decision is equal; every float is within ``RTOL``."""
    drv = pt_sweep.SweepDriver(backend="torch", tick=60.0,
                               tick_impl="torch", device="cpu")
    got = pt_decide.decide(SMALL_AXES, drv, n_seeds=2, max_rounds=1)
    ref_drv = jx_sweep.SweepDriver(backend="jax", tick=60.0,
                                   tick_impl="jnp")
    want = jx_decide.decide(SMALL_AXES, ref_drv, n_seeds=2, max_rounds=1)
    a, b = got.to_json_dict(), want.to_json_dict()
    assert a["stats"]["backend"] == "torch"
    assert a["stats"]["tick_impl"] == "torch"
    for k in ("sweep_calls", "configs_run", "lanes_simulated"):
        assert a["stats"][k] == b["stats"][k], k
    # the decisions themselves, exactly
    assert a["claim_holds"] == b["claim_holds"]
    assert a["chosen"]["label"] == b["chosen"]["label"]
    assert [p["label"] for p in a["frontier"]] == \
        [p["label"] for p in b["frontier"]]
    assert a["displaced_disk"]["min_cache_tb"] == \
        b["displaced_disk"]["min_cache_tb"]
    assert (a["break_even"] is None) == (b["break_even"] is None)
    if a["break_even"] is not None:
        assert a["break_even"]["bracket"] == b["break_even"]["bracket"]
    _assert_close_docs(_comparable(a), _comparable(b))


# ------------------------------------------------ SweepResult aggregation
def test_sweep_result_exports_equal_reference(tmp_path):
    rows = [(c, None, seed, 100.0 * c + seed, 3.0 * c - seed)
            for c in (5.0, 10.0) for seed in (0, 1, 2)]
    res = {p: PACKAGES[p][2].SweepResult(
        results=_results(p, rows), wall_s=2.0, lanes_simulated=6,
        cache_hits=1) for p in PACKAGES}
    for r in res.values():
        for x in r.results:
            x.metrics.update(job_waiting_h_mean=0.5, download_pb=0.1,
                             gcs_to_disk_pb=0.0, disk_to_gcs_pb=0.0,
                             gcs_used_pb=0.0)
    assert res["torch"].aggregate_seeds() == res["jax"].aggregate_seeds()
    assert res["torch"].ok and res["torch"].configs_per_sec == 3.0
    for p, r in res.items():
        r.to_csv(str(tmp_path / f"{p}.csv"))
        r.pareto_to_csv(str(tmp_path / f"{p}_pareto.csv"))
        r.to_json(str(tmp_path / f"{p}.json"))
    for name in ("{}.csv", "{}_pareto.csv", "{}.json"):
        a = (tmp_path / name.format("torch")).read_text()
        b = (tmp_path / name.format("jax")).read_text()
        assert a == b, name
    with open(tmp_path / "torch.csv") as f:
        assert sum(int(r["pareto"]) for r in csv.DictReader(f)) == \
            len(res["torch"].pareto_front())
    doc = json.loads((tmp_path / "torch.json").read_text())
    assert doc["lanes_simulated"] == 6 and doc["cache_hits"] == 1
