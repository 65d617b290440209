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
from repro_torch.sim.jobs import RetryPolicy
from repro_torch.sim.sweep import run_sweep
from torch_threads import one_torch_thread  # noqa: F401

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
    # the result cache
    cached = run_sweep(few, tick=60.0, device="cpu", cache=tmp_path)
    assert cached.lanes_simulated == 2 and cached.cache_hits == 0
    for a, b in zip(cached.results, res.results):
        assert a.metrics == b.metrics
    with pytest.raises(ValueError, match="backend"):
        run_sweep(few, backend="jax", device="cpu")
    # the execution knobs of repro's run_sweep are served now: each one
    # forwards to the batched program and leaves the results as they were
    served = [dict(lane_chunk=1), dict(record_series=6),
              dict(retry=RetryPolicy()), dict(faults="seed=3"),
              dict(transport="local", workers=2, lane_chunk=1),
              dict(retry=RetryPolicy(), job_timeout=60.0),
              dict(devices=["cpu", "cpu"]), dict(shard=True),
              dict(shard=True, lane_chunk=1),
              dict(shard=True, retry=RetryPolicy())]
    for knobs in served:
        where = {} if "devices" in knobs else {"device": "cpu"}
        got_k = run_sweep(few, tick=60.0, **where, **knobs)
        assert got_k.ok and got_k.lanes_simulated == 2, knobs
        for a, b in zip(got_k.results, res.results):
            assert a.metrics == b.metrics, knobs
            assert a.cost_usd == b.cost_usd, knobs
            assert bool(a.series) == ("record_series" in knobs), knobs
    # shard is served too (the lane mesh of the CPU, bitwise above); with
    # devices= or on the process backend it raises, as in repro
    with pytest.raises(ValueError, match="devices="):
        run_sweep(few, devices=["cpu"], shard=True)
    with pytest.raises(ValueError, match="shard"):
        run_sweep(few, backend="process", shard=True)
    with pytest.raises(TypeError):
        run_sweep(few, device="cpu", bogus=2)
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


# ------------------------------------------------------- the traced tick
def _trace_grid():
    """Two lanes with a small disk cache: files wait for the disk window,
    links are busy, a few files migrate to the cold tier."""
    return pack_specs([
        ScenarioSpec(base="III", cache_tb=2.0, seed=1, **QUICK),
        ScenarioSpec(base="III", cache_tb=3.0, gcs_limit_tb=5.0, seed=3,
                     **QUICK),
    ], tick=10.0)


@pytest.fixture
def tracer():
    from repro_torch.obs.trace import get_tracer

    t = get_tracer()
    t.reset()
    t.enable()
    try:
        yield t
    finally:
        t.disable()
        t.reset()


def _tick_instants(tracer):
    return [e["args"] for e in tracer.events
            if e["name"] == "sweep.torch.tick"]


def test_traced_tick_results_bitwise_to_untraced(tracer):
    """The plain tick with the tracer on gives every output bitwise as with
    it off, and its loop records one ``sweep.torch.tick`` instant with
    every segment and count, on the host clock."""
    from repro_torch.kernels import trace_tick

    grid = _trace_grid()
    tracer.disable()
    off = simulate_packed(grid, tick_impl="torch", device="cpu")
    tracer.enable()
    on = simulate_packed(grid, tick_impl="torch", device="cpu")
    assert set(on) == set(off)
    for key, want in off.items():
        assert on[key].dtype == want.dtype
        np.testing.assert_array_equal(on[key], want, err_msg=key)
    (tick,) = _tick_instants(tracer)
    assert tick["clock"] == "perf_counter" and tick["lanes"] == 2
    assert tick["ticks"] == grid.n_ticks
    assert set(tick["segments"]) == set(trace_tick.SEGMENTS) - {"replay_gap"}
    assert set(tick["counts"]) == set(trace_tick.COUNTS) - {"ticks"}
    assert tick["lane_ticks"] == 2 * len(range(0, grid.n_ticks,
                                                trace_tick.COUNT_STRIDE))
    assert sorted(sum(trace_tick.LAYERS.values(), ())) == \
        sorted(trace_tick.SEGMENTS)


def test_untraced_loop_holds_no_trace_state_and_loads_no_trace_library():
    """With the tracer off a loop's state holds no trace tensor, its tick
    launches nothing of the trace library, and the library's module is
    never imported (a fresh process)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.core.scenarios import ScenarioSpec, pack_specs\n"
        "from repro_torch.kernels.registry import resolve_tick_impl\n"
        "from repro_torch.sim.batched import TickLoop\n"
        "grid = pack_specs([ScenarioSpec(base='III', days=0.01, "
        "n_files=300)], tick=60.0)\n"
        "cpu = torch.device('cpu')\n"
        "loop = TickLoop(grid, resolve_tick_impl('torch', cpu), cpu, "
        "graph=False)\n"
        "loop.advance(grid.n_ticks)\n"
        "loop.result()\n"
        "print(loop.trace, sorted(k for k in loop.st if 'trace' in k), "
        "any(m.startswith('repro_torch.kernels.trace_tick') "
        "for m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(src)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "[]", "False"]


def test_trace_counts_equal_the_series_capture_sums(tracer):
    """The counter's waiting files and active transfers, a lane, equal the
    series capture's sums over the same sampled ticks
    (``record_series=COUNT_STRIDE``: ``ser_queue`` and ``ser_link``), and
    it counts those ticks only."""
    from repro_torch.kernels.trace_tick import COUNT_STRIDE

    grid = _trace_grid()
    cpu = torch.device("cpu")
    loop = TickLoop(grid, resolve_tick_impl("torch", cpu), cpu, graph=False,
                    record=(COUNT_STRIDE,
                            (grid.n_ticks - 1) // COUNT_STRIDE + 1))
    loop.advance(grid.n_ticks)
    out = loop.result()
    counts = loop.st["trace_counts"].numpy()
    n_samples = (grid.n_ticks - 1) // COUNT_STRIDE + 1
    np.testing.assert_array_equal(counts[:, 5], n_samples)
    np.testing.assert_array_equal(
        counts[:, 3], out["ser_queue"].sum((1, 2)).astype(np.int64))
    np.testing.assert_array_equal(
        counts[:, 2], out["ser_link"].sum((1, 2, 3)).astype(np.int64))
    assert counts[:, 3].sum() > 0 and counts[:, 2].sum() > 0


def test_trace_gcs_candidates_equal_a_recount(tracer, monkeypatch):
    """The counter's GCS candidates and admitted migrations, a lane, equal
    a recount of the planes the tick hands the GCS admission
    (``want_mig``) and takes back from it, at the counted ticks."""
    from repro_torch.kernels.lane_tick import ref as lt_ref
    from repro_torch.kernels.tick_glue import ref as glue_ref
    from repro_torch.kernels.trace_tick import COUNT_STRIDE

    grid = _trace_grid()
    want_n = np.zeros(grid.n_lanes, np.int64)
    mig_n = np.zeros(grid.n_lanes, np.int64)
    counted = {}
    complete, gcs_admit = glue_ref.complete, lt_ref.gcs_admit

    def recount_complete(st, *args):
        want, occ3 = complete(st, *args)
        counted["now"] = int(st["tick"]) % COUNT_STRIDE == 0
        if counted["now"]:
            want_n[:] += want.sum((1, 2)).numpy()
        return want, occ3

    def recount_admit(*args):
        out = gcs_admit(*args)
        if counted["now"]:
            mig_n[:] += out[0].sum((1, 2)).numpy()
        return out

    monkeypatch.setattr(glue_ref, "complete", recount_complete)
    monkeypatch.setattr(lt_ref, "gcs_admit", recount_admit)
    cpu = torch.device("cpu")
    loop = TickLoop(grid, resolve_tick_impl("torch", cpu), cpu, graph=False)
    loop.advance(grid.n_ticks)
    counts = loop.st["trace_counts"].numpy()
    np.testing.assert_array_equal(counts[:, 0], want_n)
    np.testing.assert_array_equal(counts[:, 1], mig_n)
    assert want_n.sum() > 0


def test_trace_segments_sum_to_the_stamped_tick(tracer, monkeypatch):
    """On a clock that steps by known amounts: every segment is booked once
    a tick, non-negative, the segments of a tick sum to its stamped wall
    (first stamp to last), each maximum is the largest of its ticks, and
    ``replay_gap`` books the time between ticks, one fewer."""
    from repro_torch.kernels import trace_tick
    from repro_torch.kernels.trace_tick import ref as trace_ref

    rng = np.random.default_rng(0)
    stamps = []

    def clock():
        stamps.append((stamps[-1] if stamps else 10 ** 9)
                      + int(rng.integers(1, 1000)))
        return stamps[-1]

    monkeypatch.setattr(trace_ref, "clock_ns", clock)
    grid = _trace_grid()
    cpu = torch.device("cpu")
    loop = TickLoop(grid, resolve_tick_impl("torch", cpu), cpu, graph=False)
    loop.advance(grid.n_ticks)
    loop.result()
    (tick,) = _tick_instants(tracer)
    n_seg = len(trace_tick.SEGMENTS)
    per_tick = np.array(stamps).reshape(grid.n_ticks, n_seg)
    walls = per_tick[:, -1] - per_tick[:, 0]
    assert sum(s["sum_ns"] for s in tick["segments"].values()) == walls.sum()
    for i, name in enumerate(trace_tick.SEGMENTS[1:], start=1):
        d = per_tick[:, i] - per_tick[:, i - 1]
        assert tick["segments"][name] == {"sum_ns": int(d.sum()),
                                          "max_ns": int(d.max())}, name
        assert d.min() >= 0
    gaps = per_tick[1:, 0] - per_tick[:-1, -1]
    assert tick["replay_gap"] == {"sum_ns": int(gaps.sum()),
                                  "max_ns": int(gaps.max()),
                                  "n": grid.n_ticks - 1}
    assert tick["ticks"] == grid.n_ticks
