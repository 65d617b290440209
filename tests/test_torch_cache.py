"""The port's result cache (``repro_torch.sim.cache``) against the JAX
package's (``repro.sim.cache``) on the CPU.

- key semantics: ``cache_key`` is the sha256 of ``repro``'s canonical
  document with the port's engine string (``torch:<tick>`` or
  ``torch:<tick>:cuda``), invariant under pricing-only fields and distinct
  for every dynamics field;
- bitwise round trips on the plain path, pricing variants re-billed from
  one stored lane, and a port entry that ``repro``'s own validator
  accepts;
- isolation: ``torch:*`` entries never serve ``jax:*``/``process``
  requests nor the reverse, and ``torch:<t>`` never serves
  ``torch:<t>:cuda`` nor the reverse, all in one directory;
- durability: the five corruption modes of ``tests/test_cache.py`` fall
  back to a recompute that repairs the entry;
- a warm ``SweepDriver`` rerun simulates no lane.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import repro.core.scenarios as jx
import repro.sim.cache as jx_cache
import repro.sim.sweep as jx_sweep
from repro_torch.core.scenarios import (
    RESULT_SCHEMA_VERSION,
    ScenarioSpec,
    cache_key,
    dynamics_key,
    engine_fingerprint,
    expand_grid,
    with_axis,
    with_seeds,
)
from repro_torch.sim.batched import run_sweep_torch
from repro_torch.sim.cache import (
    LocalDirBackend,
    ResultCache,
    _validate_entry,
    as_cache,
    entry_name,
)
from repro_torch.sim.sweep import ScenarioResult, SweepDriver, run_sweep
from repro_torch.version import __version__

#: Smallest spec that still exercises cache dynamics and billing.
TINY = dict(base="III", days=0.05, n_files=300, cache_tb=5.0)
TICK = 60.0

#: Two cache sizes x two egress options; seeds added by the tests.
QUICK_AXES = {"base": "III", "days": 0.1, "n_files": 1000,
              "cache_tb": [5.0, 20.0], "egress": ["internet", "direct"]}


@pytest.fixture(scope="module")
def tiny_result():
    """One freshly simulated (spec, result) pair on the plain path."""
    spec = ScenarioSpec(**TINY)
    res = run_sweep_torch([spec], tick=TICK, tick_impl="torch",
                          device="cpu")
    return spec, res.results[0]


def _fresh(spec):
    return run_sweep_torch([spec], tick=TICK, tick_impl="torch",
                           device="cpu").results[0]


def _entry_path(root, spec, tick_impl=None) -> str:
    return os.path.join(str(root), entry_name(
        cache_key(spec, "torch", TICK, tick_impl)))


def _same_result(a, b) -> None:
    """Bitwise equality of everything a sweep consumer can observe."""
    assert a.spec == b.spec
    assert a.metrics == b.metrics
    assert (a.storage_usd, a.network_usd, a.ops_usd) == \
        (b.storage_usd, b.network_usd, b.ops_usd)
    assert a.events == b.events
    assert a.series == b.series
    assert a.monthly == b.monthly


def _as_jx_spec(spec):
    return jx.ScenarioSpec(**dataclasses.asdict(spec))


# ------------------------------------------------------------ key semantics
@pytest.mark.parametrize("tick,impl,engine", [
    (None, None, "torch:10"), (60.0, None, "torch:60"),
    (60.0, "torch", "torch:60"), (60.0, "cuda", "torch:60:cuda"),
    (2.5, "cuda", "torch:2.5:cuda")])
def test_cache_key_is_the_reference_document_with_the_port_engine(
        tick, impl, engine):
    spec = ScenarioSpec(**TINY, egress="direct", storage_price=0.02, seed=3)
    assert engine_fingerprint("torch", tick, impl) == engine
    doc = {"schema": jx.RESULT_SCHEMA_VERSION, "engine": engine,
           "spec": dataclasses.asdict(jx.dynamics_key(_as_jx_spec(spec)))}
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    assert cache_key(spec, "torch", tick, impl) == \
        hashlib.sha256(blob.encode("utf-8")).hexdigest()
    assert RESULT_SCHEMA_VERSION == jx.RESULT_SCHEMA_VERSION


def test_engine_fingerprint_rejects_other_engines_and_auto():
    for backend in ("jax", "process", "cuda"):
        with pytest.raises(ValueError, match="backend"):
            engine_fingerprint(backend, 60.0)
    for impl in ("auto", "jnp", "pallas"):
        with pytest.raises(ValueError, match="resolve"):
            engine_fingerprint("torch", 60.0, impl)
    keys = {cache_key(ScenarioSpec(**TINY), "torch", t, i)
            for t in (10.0, 60.0) for i in ("torch", "cuda")}
    assert len(keys) == 4


def test_cache_key_invariant_under_pricing_fields():
    spec = ScenarioSpec(**TINY)
    for impl in ("torch", "cuda"):
        for field, value in [("egress", "direct"),
                             ("egress", "interconnect"),
                             ("storage_price", 0.020),
                             ("egress_price", 0.01)]:
            variant = ScenarioSpec(**{**TINY, field: value})
            assert cache_key(variant, "torch", TICK, impl) == \
                cache_key(spec, "torch", TICK, impl), field


def test_cache_key_distinct_for_every_dynamics_field():
    spec = ScenarioSpec(**TINY)
    base_key = cache_key(spec, "torch", TICK)
    for field, value in [("base", "I"), ("days", 0.1), ("n_files", 500),
                         ("seed", 1), ("cache_tb", 10.0),
                         ("gcs_limit_tb", 50.0), ("job_rate_scale", 2.0),
                         ("workload", "diurnal"), ("curves", True)]:
        variant = ScenarioSpec(**{**TINY, field: value})
        assert cache_key(variant, "torch", TICK) != base_key, field


# -------------------------------------------------------------- round trip
def test_roundtrip_is_bitwise_on_the_plain_path(tmp_path, tiny_result):
    spec, fresh = tiny_result
    cache = ResultCache(tmp_path)
    assert cache.put(spec, fresh, "torch", TICK, "torch")
    served = ResultCache(tmp_path).get(spec, "torch", TICK, "torch")
    assert served is not None
    _same_result(served, fresh)
    assert cache.stats.writes == 1


@pytest.mark.parametrize("field,value", [("egress", "direct"),
                                         ("storage_price", 0.031),
                                         ("egress_price", 0.07)])
def test_pricing_variant_served_from_shared_entry_is_bitwise(
        tmp_path, tiny_result, field, value):
    spec, fresh = tiny_result
    ResultCache(tmp_path).put(spec, fresh, "torch", TICK, "torch")
    variant = ScenarioSpec(**{**TINY, field: value})
    served = ResultCache(tmp_path).get(variant, "torch", TICK, "torch")
    assert served is not None
    _same_result(served, _fresh(variant))


def test_port_entry_passes_the_reference_validator(tmp_path, tiny_result):
    spec, fresh = tiny_result
    ResultCache(tmp_path).put(spec, fresh, "torch", TICK, "cuda")
    doc = json.loads(open(_entry_path(tmp_path, spec, "cuda")).read())
    assert jx_cache._validate_entry(doc) is doc
    assert _validate_entry(doc) is doc
    man = doc["manifest"]
    assert man["engine"] == "torch:60:cuda"
    assert (man["backend"], man["tick"], man["tick_impl"]) == \
        ("torch", TICK, "cuda")
    assert man["spec"] == dataclasses.asdict(dynamics_key(spec))
    assert man["torch"] == torch.__version__
    assert man["numpy"] == np.__version__
    assert man["package_version"] == __version__
    for field in ("python", "host", "created_unix", "wall_s"):
        assert field in man, field
    # the payload drops the pricing-dependent bill keys
    assert not any(k.startswith("month") for k in doc["payload"]["metrics"])


def test_synthetic_results_are_never_stored(tmp_path, tiny_result):
    spec, _ = tiny_result
    fake = ScenarioResult(spec=spec, metrics={"jobs_done": 1.0},
                          storage_usd=0.0, network_usd=0.0, ops_usd=0.0,
                          wall_s=0.0, events=0)
    cache = ResultCache(tmp_path)
    assert not cache.put(spec, fake, "torch", TICK)
    assert cache.store([(spec, fake)], "torch", TICK) == 0
    assert cache.get(spec, "torch", TICK) is None


# ---------------------------------------------------------------- isolation
def _jx_result(spec, fresh):
    """The port's result as a ``repro`` record, stored by ``repro``'s cache
    under its own engines: the same payload, another key."""
    return jx_sweep.ScenarioResult(
        spec=_as_jx_spec(spec), metrics=dict(fresh.metrics),
        storage_usd=fresh.storage_usd, network_usd=fresh.network_usd,
        ops_usd=fresh.ops_usd, wall_s=fresh.wall_s, events=fresh.events,
        monthly=dict(fresh.monthly))


def test_torch_and_reference_entries_never_serve_each_other(
        tmp_path, tiny_result):
    spec, fresh = tiny_result
    jspec = _as_jx_spec(spec)
    shared = str(tmp_path / "shared")
    port, ref = ResultCache(shared), jx_cache.ResultCache(shared)
    port.put(spec, fresh, "torch", TICK, "torch")
    # the reference's engines miss the port's entry ...
    assert ref.get(jspec, "jax", TICK, "jnp") is None
    assert ref.get(jspec, "jax", TICK, "pallas") is None
    assert ref.get(jspec, "process") is None
    # ... and the port misses theirs
    for backend, impl in (("jax", "jnp"), ("process", None)):
        ref.put(jspec, _jx_result(spec, fresh), backend, TICK, impl)
    other = str(tmp_path / "reference_only")
    ref_only = jx_cache.ResultCache(other)
    ref_only.put(jspec, _jx_result(spec, fresh), "jax", TICK, "jnp")
    ref_only.put(jspec, _jx_result(spec, fresh), "process")
    for impl in ("torch", "cuda"):
        assert ResultCache(other).get(spec, "torch", TICK, impl) is None
    # one directory holds all three, each under its own name
    assert len(list(LocalDirBackend(shared).names())) == 3
    _same_result(ResultCache(shared).get(spec, "torch", TICK, "torch"),
                 fresh)


def test_plain_and_kernel_entries_never_serve_each_other(tmp_path,
                                                         tiny_result):
    spec, fresh = tiny_result
    cache = ResultCache(tmp_path)
    cache.put(spec, fresh, "torch", TICK, "torch")
    assert cache.get(spec, "torch", TICK, "cuda") is None
    assert cache.get(spec, "torch", 10.0, "torch") is None
    other = str(tmp_path / "cuda_only")
    ResultCache(other).put(spec, fresh, "torch", TICK, "cuda")
    assert ResultCache(other).get(spec, "torch", TICK, "torch") is None
    assert ResultCache(other).get(spec, "torch", TICK) is None
    assert ResultCache(other).get(spec, "torch", TICK, "cuda") is not None


# ------------------------------------------------------------- durability
def _truncate(path):
    data = open(path, "rb").read()
    open(path, "wb").write(data[:len(data) // 2])


def _zero(path):
    open(path, "wb").close()


def _garbage(path):
    open(path, "wb").write(b"\x00\xffnot json at all {{{")


def _wrong_version(path):
    doc = json.load(open(path))
    doc["schema_version"] = RESULT_SCHEMA_VERSION + 999
    json.dump(doc, open(path, "w"))


def _mangled_payload(path):
    doc = json.load(open(path))
    doc["payload"]["monthly"]["egress_bytes"] = doc["payload"]["monthly"][
        "egress_bytes"] + [1.0]  # array lengths disagree
    json.dump(doc, open(path, "w"))


@pytest.mark.parametrize("mangle", [_truncate, _zero, _garbage,
                                    _wrong_version, _mangled_payload],
                         ids=["truncated", "zero-byte", "garbage",
                              "wrong-schema-version", "mangled-payload"])
def test_corrupted_entry_falls_back_to_recompute(tmp_path, tiny_result,
                                                 mangle):
    spec, fresh = tiny_result
    ResultCache(tmp_path).put(spec, fresh, "torch", TICK, "torch")
    path = _entry_path(tmp_path, spec)
    mangle(path)
    cache = ResultCache(tmp_path)
    assert cache.get(spec, "torch", TICK, "torch") is None
    assert cache.stats.corrupt == 1 and cache.stats.hits == 0
    assert not os.path.exists(path)  # bad entry dropped ...
    res = run_sweep([spec], tick=TICK, tick_impl="torch", device="cpu",
                    cache=cache)  # ... the recompute repairs it
    assert res.lanes_simulated == 1 and res.cache_hits == 0
    _same_result(res.results[0], fresh)
    assert os.path.exists(path)
    _same_result(cache.get(spec, "torch", TICK, "torch"), fresh)


# ----------------------------------------------- end-to-end warm accounting
def test_warm_driver_rerun_is_bitwise_and_simulates_nothing(tmp_path):
    specs = with_seeds(expand_grid(QUICK_AXES), 2)
    kw = dict(backend="torch", tick=TICK, tick_impl="torch", device="cpu",
              cache=str(tmp_path))
    cold_drv = SweepDriver(**kw)
    cold = cold_drv.run(specs)
    assert cold_drv.lanes_simulated == 4  # 2 cache sizes x 2 seeds
    assert cold.lanes_simulated == 4 and cold.cache_hits == 0
    assert cold_drv.sweep_calls == 1 and cold_drv.configs_run == 8
    warm_drv = SweepDriver(**kw)  # fresh driver: empty memo, disk only
    warm = warm_drv.run(specs)
    assert warm.lanes_simulated == 0
    assert warm.cache_hits == len(set(specs))
    assert warm_drv.configs_run == 0 and warm_drv.lanes_simulated == 0
    assert warm_drv.sweep_calls == 0
    for a, b in zip(cold.results, warm.results):
        _same_result(a, b)
    # a never-requested pricing variant rides a stored lane
    priced = with_axis(specs[0], "egress_price", 0.01)
    res = warm_drv.run([priced])
    assert res.cache_hits == 1 and warm_drv.lanes_simulated == 0
    # the kernels' engine shares nothing with the plain one: a cuda driver
    # keys other entries (its fetch misses, it never runs here)
    assert ResultCache(tmp_path).fetch(specs, "torch", TICK, "cuda") == {}


def test_driver_resolves_and_pins_tick_impl_and_rejects_later_knobs(
        tmp_path):
    drv = SweepDriver(tick=TICK, tick_impl="auto", device="cpu",
                      cache=tmp_path)
    assert drv.tick_impl == "torch" and drv.device.type == "cpu"
    assert isinstance(drv.cache, ResultCache)
    for knob in ("retry", "faults", "transport", "lane_chunk",
                 "record_series", "shard"):
        with pytest.raises(ValueError, match=knob):
            SweepDriver(device="cpu", **{knob: 1})
    with pytest.raises(TypeError):
        SweepDriver(device="cpu", workers=2)
    with pytest.raises(ValueError, match="backend"):
        SweepDriver(backend="jax", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        SweepDriver(tick_impl="cuda", device="cpu")


def test_as_cache_coercions(tmp_path):
    cache = as_cache(str(tmp_path))
    assert isinstance(cache, ResultCache)
    assert as_cache(cache) is cache
    assert as_cache(None) is None
    assert isinstance(as_cache(LocalDirBackend(str(tmp_path))), ResultCache)


def test_scenario_spec_is_frozen_and_hashable():
    """The memo, the cache's fetch and ``SweepResult`` key results by spec:
    the port's spec stays a frozen, hashable value like ``repro``'s."""
    a, b = ScenarioSpec(**TINY), ScenarioSpec(**TINY)
    assert a == b and hash(a) == hash(b) and len({a: 1, b: 2}) == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.cache_tb = 7.0
    assert [f.name for f in dataclasses.fields(ScenarioSpec)] == \
        [f.name for f in dataclasses.fields(jx.ScenarioSpec)]
