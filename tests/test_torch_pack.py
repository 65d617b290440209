"""The port's spec packing against the JAX package's, array by array.

``repro_torch.core.scenarios`` is a copy of ``repro.core.scenarios``'s spec
and packing code (the port imports nothing of ``repro``), so the two must
pack bit-identical grids from the same specs — same catalogue, same job
stream, same link tables — and reject the same bad specs.
"""

import dataclasses

import numpy as np
import pytest

import repro.core.scenarios as jx
import repro_torch.core.scenarios as pt

TINY = dict(days=0.25, n_files=1000)
QUICK = dict(days=0.1, n_files=1000)

_SCALARS = ("horizon", "tick", "n_months", "full_months",
            "max_jobs_per_tick", "site_names")


def _grids():
    """Spec grids of ``tests/test_batched.py`` plus workload lanes."""
    small = jx.expand_grid({
        "base": "III", "cache_tb": [10.0, 25.0, 60.0],
        "egress": ["internet", "direct"], "seed": 1, **TINY,
    }) + [
        jx.ScenarioSpec(base="I", seed=2, **TINY),
        jx.ScenarioSpec(base="II", seed=2, **TINY),
        jx.ScenarioSpec(base="III", cache_tb=15.0, gcs_limit_tb=5.0,
                        seed=3, **TINY),
        jx.ScenarioSpec(base="III", cache_tb=15.0, job_rate_scale=1.5,
                        seed=4, **TINY),
        jx.ScenarioSpec(base="III", cache_tb=15.0, storage_price=0.02,
                        seed=4, **TINY),
    ]
    pricing = jx.expand_grid({
        "base": "III", "cache_tb": [10.0, 20.0],
        "egress": ["internet", "direct", "interconnect"],
        "storage_price": [None, 0.02], **TINY,
    })
    workloads = [jx.ScenarioSpec(base="III", cache_tb=15.0, seed=0,
                                 workload=w, **TINY)
                 for w in ("steady", "diurnal:amplitude=0.8,period_h=3",
                           "zipf-drift:power_end=1.5,steps=4")]
    impl = jx.expand_grid({
        "base": "III", "cache_tb": [10.0, 25.0],
        "egress": ["internet", "direct"],
        "gcs_limit_tb": [None, 5.0], "seed": 1, **QUICK,
    })
    return {"small": (small, 10.0), "pricing": (pricing, 10.0),
            "workloads": (workloads, 10.0), "impl": (impl, 60.0)}


def _to_port(spec):
    return pt.ScenarioSpec(**dataclasses.asdict(spec))


def _assert_grids_equal(a, b):
    for name in _SCALARS:
        assert getattr(a, name) == getattr(b, name), name
    for name in pt._ARRAY_FIELDS:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert [dataclasses.asdict(s) for s in a.specs] == \
        [dataclasses.asdict(s) for s in b.specs]
    assert [dataclasses.asdict(c) for c in a.cost_models] == \
        [dataclasses.asdict(c) for c in b.cost_models]


@pytest.mark.parametrize("name", ["small", "pricing", "workloads", "impl"])
def test_pack_specs_bitwise_equal(name):
    specs, tick = _grids()[name]
    ref = jx.pack_specs(specs, tick=tick)
    got = pt.pack_specs([_to_port(s) for s in specs], tick=tick)
    _assert_grids_equal(ref, got)
    assert got.n_lanes == ref.n_lanes and got.n_specs == ref.n_specs


def test_packed_grid_from_arrays_carries_a_grid_across():
    specs, tick = _grids()["workloads"]
    ref = jx.pack_specs(specs, tick=tick)
    got = pt.packed_grid_from_arrays(ref)
    assert isinstance(got, pt.PackedGrid)
    _assert_grids_equal(ref, got)
    # the copy owns its arrays
    got.sizes[0, 0, 0] = -1.0
    assert ref.sizes[0, 0, 0] > 0.0


def test_labels_and_dynamics_keys_match():
    specs, _ = _grids()["pricing"]
    for s in specs:
        p = _to_port(s)
        assert p.label == s.label
        assert dataclasses.asdict(pt.dynamics_key(p)) == \
            dataclasses.asdict(jx.dynamics_key(s))
    assert pt.PRICING_FIELDS == jx.PRICING_FIELDS
    assert pt.EGRESS_OPTIONS == jx.EGRESS_OPTIONS
    for n in (0, 1, 3, 4, 5, 1000):
        assert pt._pow2_bucket(n) == jx._pow2_bucket(n)


def test_expand_grid_and_with_seeds_match():
    axes = {"base": "III", "cache_tb": [10.0, 20.0],
            "egress": ["internet", "direct"], **QUICK}
    a = jx.with_seeds(jx.expand_grid(axes), 3, first_seed=2)
    b = pt.with_seeds(pt.expand_grid(axes), 3, first_seed=2)
    assert [dataclasses.asdict(s) for s in a] == \
        [dataclasses.asdict(s) for s in b]


@pytest.mark.parametrize("bad", [
    {"base": "IV"},
    {"egress": "pigeon"},
    {"days": 0},
    {"days": -1.0},
    {"n_files": 0},
    {"job_rate_scale": 0},
    {"egress_price": -0.1},
    {"workload": "nope"},
    {"workload": "diurnal:amplitude=2"},
    {"workload": "zipf-drift:steps=1"},
    {"workload": "trace:/nonexistent/trace.csv"},
])
def test_scenario_spec_rejects_the_same_inputs(bad):
    with pytest.raises(ValueError) as ref_err:
        jx.ScenarioSpec(**bad)
    with pytest.raises(ValueError) as got_err:
        pt.ScenarioSpec(**bad)
    assert str(got_err.value) == str(ref_err.value)


def test_pack_specs_rejects_the_same_grids():
    bad_grids = [
        [pt.ScenarioSpec(days=0.25, n_files=100),
         pt.ScenarioSpec(days=0.5, n_files=100)],
        [pt.ScenarioSpec(days=0.25, n_files=100),
         pt.ScenarioSpec(days=0.25, n_files=200)],
        [pt.ScenarioSpec(days=0.25, n_files=100, curves=True)],
        [],
    ]
    for specs in bad_grids:
        with pytest.raises(ValueError):
            jx.pack_specs([jx.ScenarioSpec(**dataclasses.asdict(s))
                           for s in specs])
        with pytest.raises(ValueError):
            pt.pack_specs(specs)
    with pytest.raises(ValueError, match="tick"):
        pt.pack_specs([pt.ScenarioSpec(days=0.25, n_files=100)], tick=0.0)
