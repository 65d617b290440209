"""The port's process backend (``run_sweep(backend="process")``, the event
engine behind the job layer, the spawned pool and the fleet's
``"scenario"`` kind) bitwise against ``repro``'s, its cache keys, and
``specs_from_mapping``."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import scenarios as jx_scenarios
from repro.sim import cache as jx_cache
from repro.sim import sweep as jx_sweep
from repro_torch.core.scenarios import (
    ScenarioSpec,
    cache_key,
    engine_fingerprint,
    specs_from_mapping,
)
from repro_torch.obs.metrics import get_registry
from repro_torch.sim.cache import ResultCache
from repro_torch.sim.faults import FaultPlan
from repro_torch.sim.jobs import RetryPolicy
from repro_torch.sim.runners import LocalTransport
from repro_torch.sim.runners import worker
from repro_torch.sim.sweep import SweepDriver, run_scenario, run_sweep

SRC = str(Path(__file__).resolve().parents[1] / "src")

#: A grid the batched program refuses: curves, two horizons.
SPECS = [
    ScenarioSpec(base="I", days=0.2, n_files=800, curves=True),
    ScenarioSpec(base="II", days=0.2, n_files=800, cache_tb=5.0, seed=1),
    ScenarioSpec(base="III", days=0.4, n_files=800, cache_tb=5.0,
                 egress="direct", seed=2),
    ScenarioSpec(base="III", days=0.2, n_files=800, cache_tb=5.0,
                 workload="zipf-drift", job_rate_scale=1.5,
                 storage_price=0.02, seed=3),
]


def _jx(spec):
    return jx_scenarios.ScenarioSpec(**dataclasses.asdict(spec))


def _same(got, want):
    assert [r.spec.label for r in got] == [r.spec.label for r in want]
    for a, b in zip(got, want):
        assert a.metrics == b.metrics
        assert a.series == b.series
        assert a.monthly == b.monthly
        assert a.events == b.events
        assert (a.storage_usd, a.network_usd, a.ops_usd) == \
            (b.storage_usd, b.network_usd, b.ops_usd)


@pytest.fixture(scope="module")
def reference():
    return jx_sweep.run_sweep([_jx(s) for s in SPECS], backend="process",
                              workers=0).results


@pytest.mark.parametrize("workers", [0, 2])
def test_process_backend_bitwise_to_reference(reference, workers):
    reg = get_registry()
    before = reg.value("scenario.runs"), reg.value("engine.events")
    res = run_sweep(SPECS + SPECS[:1], backend="process", workers=workers)
    assert res.ok and len(res) == len(SPECS) + 1
    # the pool's workers hand back their registry deltas: the books are
    # a serial run's
    assert reg.value("scenario.runs") - before[0] == len(SPECS)
    assert reg.value("engine.events") - before[1] == \
        sum(r.events for r in reference)
    _same(res.results[:len(SPECS)], reference)
    assert res.results[-1] is res.results[0]  # duplicates share a result
    assert res.results[0].series  # curves=True recorded the Fig. 6/8 series
    assert all(r.events > 0 for r in res.results)


def test_run_scenario_bitwise_and_metrics(reference):
    reg = get_registry()
    before = reg.value("scenario.runs"), reg.value("engine.events")
    got = run_scenario(SPECS[2])
    _same([got], [reference[2]])
    assert reg.value("scenario.runs") - before[0] == 1
    assert reg.value("engine.events") - before[1] == got.events


def test_cache_key_equals_reference_and_engines_never_cross_serve(
        tmp_path, reference):
    for s in SPECS:
        assert cache_key(s, backend="process") == \
            jx_scenarios.cache_key(_jx(s), backend="process")
    assert engine_fingerprint("process", 60.0, None) == "process"
    spec, result = SPECS[1], run_scenario(SPECS[1])
    cache = ResultCache(tmp_path / "c")
    assert cache.put(spec, result, "process")
    for impl in ("torch", "cuda"):
        assert cache.get(spec, "torch", 10.0, impl) is None
    other = ResultCache(tmp_path / "t")
    other.put(spec, result, "torch", 10.0, "torch")
    assert other.get(spec, "process") is None
    served = cache.get(spec, "process")
    _same([served], [result])
    # one key, one entry format: repro's cache reads the port's entry
    ref = jx_cache.ResultCache(str(tmp_path / "c")).get(_jx(spec), "process")
    assert ref.metrics == result.metrics and ref.monthly == result.monthly
    # a pricing variant of the stored lane is re-billed, as a fresh run is
    variant = dataclasses.replace(spec, egress="interconnect",
                                  storage_price=0.02)
    _same([cache.get(variant, "process")], [run_scenario(variant)])


def test_process_sweep_through_cache_and_driver(tmp_path, reference):
    cold = run_sweep(SPECS, backend="process", workers=0, cache=tmp_path)
    assert cold.lanes_simulated == len(SPECS) and cold.cache_hits == 0
    _same(cold.results, reference)
    drv = SweepDriver(backend="process", workers=0, cache=tmp_path)
    assert drv.device is None and drv.tick_impl is None
    warm = drv.run(SPECS)
    assert warm.lanes_simulated == 0 and warm.cache_hits == len(SPECS)
    assert drv.configs_run == 0
    _same(warm.results, reference)


@pytest.mark.parametrize("knob", [dict(tick_impl="torch"),
                                  dict(device="cpu"),
                                  dict(record_series=6),
                                  dict(lane_chunk=2),
                                  dict(devices=["cpu"]),
                                  dict(shard=True)])
def test_process_backend_refuses_the_batched_knobs(knob):
    with pytest.raises(ValueError):
        run_sweep(SPECS[:1], backend="process", **knob)
    with pytest.raises(ValueError):
        SweepDriver(backend="process", **knob)
    with pytest.raises(ValueError, match="backend"):
        run_sweep(SPECS[:1], backend="jax")


def test_injected_crash_in_the_pool_is_recovered(reference):
    reg = get_registry()
    crashes = reg.value("jobs.crashes")
    plan = FaultPlan(seed=1, crash=1.0, only="spec0001")
    res = run_sweep(SPECS, backend="process", workers=2, faults=plan,
                    retry=RetryPolicy(max_attempts=2, base_delay_s=0.0))
    assert res.ok
    assert reg.value("jobs.crashes") - crashes >= 1
    _same(res.results, reference)


def test_fleet_scenario_kind_local_and_subprocess(reference):
    runner = worker.build_runner({"kind": "scenario"})
    _same([runner(SPECS[0])], [reference[0]])
    local = run_sweep(SPECS, backend="process", workers=2,
                      transport=LocalTransport)
    _same(local.results, reference)
    sub = run_sweep(SPECS, backend="process", workers=2,
                    transport="subprocess")
    assert sub.ok
    _same(sub.results, reference)


def test_process_workers_never_import_torch():
    """The event engine and its pool workers are host code: a worker that
    imports no torch holds no CUDA context on the card. A spawned worker
    also imports the module that started its pool, so the CLIs import
    torch only where their torch backend runs."""
    code = (
        "import sys\n"
        "import repro_torch.cli.decide, repro_torch.cli.run_sweep\n"
        "from repro_torch.core.scenarios import ScenarioSpec\n"
        "from repro_torch.sim.sweep import run_sweep\n"
        "from repro_torch.sim.runners import worker\n"
        "specs = [ScenarioSpec(days=0.05, n_files=200, seed=s)"
        " for s in range(2)]\n"
        "res = run_sweep(specs, backend='process', workers=2)\n"
        "assert res.ok and len(res) == 2\n"
        "worker.build_runner({'kind': 'scenario'})(specs[0])\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


# -- specs_from_mapping ---------------------------------------------------------

DOCS = [
    {"axes": {"cache_tb": [10.0, 20.0], "egress": ["internet", "direct"]},
     "days": 0.5, "n_files": 1000, "seed": 3},
    {"scenarios": [{"base": "I"}, {"base": "III", "days": 2.0,
                                   "curves": True}],
     "n_files": 500, "days": 1.0},
    {"axes": {"seed": [0, 1], "workload": ["steady", "diurnal"]},
     "base": "II"},
]


@pytest.mark.parametrize("doc", DOCS)
def test_specs_from_mapping_bitwise_to_reference(doc):
    got = specs_from_mapping(json.loads(json.dumps(doc)))
    want = jx_scenarios.specs_from_mapping(json.loads(json.dumps(doc)))
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    assert got and all(isinstance(s, ScenarioSpec) for s in got)


@pytest.mark.parametrize("doc,match", [
    ({"axes": {"cache_tb": [1.0]}, "bogus": 1}, "unknown top-level"),
    ({"days": 1.0}, "exactly one"),
    ({"axes": {"cache_tb": [1.0]}, "scenarios": [{}]}, "exactly one"),
    ({"scenarios": [{"nope": 1}]}, "unknown scenario fields"),
    ({"axes": {"nope": [1]}}, "unknown spec fields"),
])
def test_specs_from_mapping_errors(doc, match):
    with pytest.raises(ValueError, match=match):
        specs_from_mapping(doc)
    with pytest.raises(ValueError, match=match):
        jx_scenarios.specs_from_mapping(doc)
