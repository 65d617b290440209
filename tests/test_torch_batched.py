"""End-to-end parity of the port's batched sweep with the JAX package's.

One grid packed by ``repro`` is carried across with
``packed_grid_from_arrays`` and run through both tick programs on the CPU:
``repro_torch`` ``simulate_packed(device="cpu", tick_impl="torch")``
against ``repro`` ``simulate_packed(tick_impl="jnp")``. The two programs
do the same operations in the same order, so integer-valued outputs must
be exact; reduction order (XLA's against PyTorch's) is the only allowed
source of difference in the float aggregates, held at rtol 1e-5. On the
216-config pricing grid the bar is the Table-2 5% per spec, as between
``repro``'s own implementations.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.scenarios as jx
from repro.sim.batched import simulate_packed as jx_simulate_packed
from repro.sim.sweep import run_sweep as jx_run_sweep
from repro_torch.core.scenarios import (
    ScenarioSpec,
    expand_grid,
    packed_grid_from_arrays,
    pack_specs,
    with_seeds,
)
from repro_torch.kernels.registry import resolve_tick_impl
from repro_torch.sim.batched import TickLoop, run_sweep_torch, simulate_packed
from repro_torch.sim.sweep import run_sweep

TOL = 0.05  # Table 2 validation tolerance (fractional)
TINY = dict(days=0.25, n_files=1000)
QUICK = dict(days=0.1, n_files=1000)

_EXACT = ("jobs_done_site", "wait_n", "cls_a_mo", "cls_b_mo")


def _close(a, b, tol=TOL, floor=1.0):
    return abs(a - b) <= tol * max(abs(a), abs(b), floor)


def _assert_lane_parity(ref, got, tol=TOL):
    """``tests/test_batched.py``'s per-lane Table-2 bar."""
    assert len(ref.results) == len(got.results)
    for a, b in zip(ref.results, got.results):
        assert b.spec.label == a.spec.label
        lbl = a.spec.label
        cost_tol = tol if a.spec.gcs_limit_tb is None or \
            a.spec.gcs_limit_tb == float("inf") else 2 * tol
        assert _close(a.jobs_done, b.jobs_done, tol), \
            f"{lbl}: jobs_done {a.jobs_done} vs {b.jobs_done}"
        assert _close(a.cost_usd, b.cost_usd, cost_tol), \
            f"{lbl}: cost {a.cost_usd} vs {b.cost_usd}"
        assert _close(a.metrics["download_pb"], b.metrics["download_pb"],
                      tol, floor=1e-6), f"{lbl}: download_pb"
        assert a.metrics["jobs_submitted"] == b.metrics["jobs_submitted"], \
            f"{lbl}: jobs_submitted"
        assert abs(a.metrics["job_waiting_h_mean"]
                   - b.metrics["job_waiting_h_mean"]) <= 0.05, \
            f"{lbl}: job_waiting_h_mean"


def test_tiny_grid_matches_jnp_program():
    """cfg I/II/III, limited and unlimited disk, a finite cold tier and a
    scaled job rate, 2161 ticks of 10 s."""
    specs = [
        jx.ScenarioSpec(base="III", cache_tb=10.0, seed=1, **TINY),
        jx.ScenarioSpec(base="I", seed=2, **TINY),
        jx.ScenarioSpec(base="II", seed=2, **TINY),
        jx.ScenarioSpec(base="III", cache_tb=15.0, gcs_limit_tb=5.0,
                        seed=3, **TINY),
        jx.ScenarioSpec(base="III", cache_tb=15.0, job_rate_scale=1.5,
                        seed=4, **TINY),
    ]
    grid = jx.pack_specs(specs, tick=10.0)
    ref = jx_simulate_packed(grid, tick_impl="jnp")
    got = simulate_packed(packed_grid_from_arrays(grid), tick_impl="torch",
                          device="cpu")
    _assert_exact_parity(ref, got)
    # the grid exercised the paths: jobs ran, files crossed every tier
    assert (got["jobs_done_site"] > 0).all()
    assert (got["diskgcs_b"].sum(1) > 0).sum() >= 3
    assert (got["gcsdisk_b"].sum(1) > 0).any()


def _assert_exact_parity(ref, got):
    """Integer-valued outputs exact, float aggregates at rtol 1e-5."""
    assert set(got) == set(ref)
    for key, want in ref.items():
        want = np.asarray(want)
        assert got[key].shape == want.shape, key
        if key in _EXACT:
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        else:
            assert got[key].dtype == want.dtype, key
            np.testing.assert_allclose(got[key], want, rtol=1e-5, err_msg=key)


def test_busy_migration_queue_matches_jnp_program():
    """Two disk->GCS slots per site, so migrations overflow into the link
    queue and later ones arrive while it is busy: both branches of the
    queue-rank glue (``rank - n_direct``, direct slots only while the
    queue is empty) run, against the jnp program's second cumsum."""
    specs = [
        jx.ScenarioSpec(base="III", cache_tb=10.0, seed=1, **TINY),
        jx.ScenarioSpec(base="III", cache_tb=15.0, gcs_limit_tb=5.0,
                        seed=3, **TINY),
    ]
    grid = jx.pack_specs(specs, tick=10.0)
    slots = np.array(grid.link_slots, copy=True)
    slots[:, 2::3] = 2.0  # link 3*site + 2: disk -> GCS
    grid = dataclasses.replace(grid, link_slots=slots)
    ref = jx_simulate_packed(grid, tick_impl="jnp")
    got = simulate_packed(packed_grid_from_arrays(grid), tick_impl="torch",
                          device="cpu")
    _assert_exact_parity(ref, got)
    assert (got["diskgcs_b"].sum(1) > 0).all()


@pytest.fixture(scope="module")
def pricing_grid():
    """The 216-config bench pricing grid (4 cache x 3 egress x 9 prices x
    2 seeds; 8 dynamics lanes after pricing dedup) at tick 60."""
    axes = {
        "base": "III",
        "cache_tb": [10.0, 20.0, 40.0, 80.0],
        "egress": ["internet", "direct", "interconnect"],
        "storage_price": [round(0.018 + 0.002 * i, 3) for i in range(9)],
        **QUICK,
    }
    specs = with_seeds(expand_grid(axes), 2)
    assert len(specs) == 216
    ref = jx_run_sweep(jx.with_seeds(jx.expand_grid(axes), 2),
                       backend="jax", tick=60.0, tick_impl="jnp")
    got = run_sweep_torch(specs, tick=60.0, tick_impl="torch", device="cpu")
    return specs, ref, got


def test_216_config_grid_within_table2_bar(pricing_grid):
    _, ref, got = pricing_grid
    _assert_lane_parity(ref, got)
    assert got.configs_per_sec is not None


def test_runs_are_deterministic(pricing_grid):
    specs, _, _ = pricing_grid
    grid = pack_specs(specs, tick=60.0)
    once = simulate_packed(grid, tick_impl="torch", device="cpu")
    again = simulate_packed(grid, tick_impl="torch", device="cpu")
    for key in once:
        np.testing.assert_array_equal(once[key], again[key], err_msg=key)


def test_front_door_forwards_and_rejects_later_knobs(pricing_grid,
                                                     tmp_path):
    specs, _, got = pricing_grid
    few = specs[:3]
    res = run_sweep(few, backend="torch", tick=60.0, device="cpu")
    for a, b in zip(res.results, got.results[:3]):
        assert a.metrics == b.metrics
        assert a.cost_usd == b.cost_usd
    assert res.lanes_simulated == 2  # seeds 0 and 1; two prices share 0
    # the result cache is the one knob of repro's run_sweep now served
    cached = run_sweep(few, tick=60.0, device="cpu", cache=tmp_path)
    assert cached.lanes_simulated == 2 and cached.cache_hits == 0
    for a, b in zip(cached.results, res.results):
        assert a.metrics == b.metrics
    with pytest.raises(ValueError, match="backend"):
        run_sweep(few, backend="jax", device="cpu")
    for knob in ("retry", "faults", "transport", "lane_chunk",
                 "record_series", "shard"):
        with pytest.raises(ValueError, match=knob):
            run_sweep(few, device="cpu", **{knob: 1})
    with pytest.raises(TypeError):
        run_sweep(few, device="cpu", workers=2)
    with pytest.raises(ValueError, match="tick_impl"):
        run_sweep(few, device="cpu", tick_impl="jnp")
    with pytest.raises(ValueError, match="CUDA device"):
        run_sweep([ScenarioSpec(**QUICK)], device="cpu", tick_impl="cuda")


def test_tick_keeps_every_state_tensor_at_its_address():
    """What CUDA graph capture needs of the tick: run in pieces on the CPU,
    it leaves every state tensor (the device tick counter included) at its
    address, the counter counts the ticks, and the run ends where one
    ``simulate_packed`` call does."""
    grid = pack_specs([
        ScenarioSpec(base="III", cache_tb=10.0, seed=1, **QUICK),
        ScenarioSpec(base="III", cache_tb=15.0, gcs_limit_tb=5.0, seed=3,
                     **QUICK),
    ], tick=10.0)
    cpu = torch.device("cpu")
    loop = TickLoop(grid, resolve_tick_impl("torch", cpu), cpu, graph=False)
    ptrs = {k: v.data_ptr() for k, v in loop.st.items()}
    for n in (1, 2, 100, grid.n_ticks - 103):
        loop.advance(n)
        assert {k: v.data_ptr() for k, v in loop.st.items()} == ptrs
        assert loop.st["tick"].tolist() == [loop.t]
    assert loop.t == grid.n_ticks
    # the ticks did the tick's work: jobs ran, files moved to the cold tier
    assert int(loop.st["ptr"].sum()) > 0
    assert bool((loop.st["gcs_state"] != 0).any())
    once = simulate_packed(grid, tick_impl="torch", device="cpu")
    for key, got in loop.result().items():
        np.testing.assert_array_equal(got, once[key], err_msg=key)
    with pytest.raises(ValueError, match="advance"):
        loop.advance(1)
    with pytest.raises(ValueError, match="cuda"):
        TickLoop(grid, resolve_tick_impl("torch", cpu), cpu, graph=True)
