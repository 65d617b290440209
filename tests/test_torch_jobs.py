"""The port's execution layer on the CPU: its own copies of the fault plan
and the retrying job registry (``repro_torch.sim.faults``,
``repro_torch.sim.jobs``) against ``repro``'s, and the batched program in
lane chunks, over devices, and as retryable chunk jobs under injected
faults.

- ``unit_hash``, ``parse_faults``, ``FaultPlan.directive``/``corrupts``
  and ``RetryPolicy.delay_s`` equal to ``repro``'s for the same seeds, ids
  and attempts, so a fault schedule is the same in both packages;
- ``lane_chunk`` 1, 2 and 3 (a padded last chunk) and ``devices=["cpu",
  "cpu"]`` bitwise to the unchunked run;
- the four lane-chunk job cases of ``tests/test_jobs.py`` run on the port:
  a fault-injected sweep bitwise to the fault-free one, an abandoned
  chunk's partial result with its ``JobFailure``, a cache resume that
  recomputes only the missing lanes, corrupt cache reads recomputed;
- ``SweepDriver(retry=..., faults=...)`` losses reaching ``decide()``'s
  stats.
"""

import numpy as np
import pytest

import repro.sim.faults as jx_faults
import repro.sim.jobs as jx_jobs
import repro_torch.sim.faults as pt_faults
import repro_torch.sim.jobs as pt_jobs
from repro_torch.core.scenarios import (
    ScenarioSpec,
    expand_grid,
    pack_specs,
    with_seeds,
)
from repro_torch.obs.metrics import get_registry
from repro_torch.sim.batched import simulate_packed
from repro_torch.sim.decide import decide
from repro_torch.sim.faults import (
    FaultPlan,
    FaultyBackend,
    as_faults,
    parse_faults,
    unit_hash,
)
from repro_torch.sim.jobs import Job, JobRegistry, RetryPolicy, run_local_jobs
from repro_torch.sim.sweep import SweepDriver, run_sweep
from torch_threads import one_torch_thread  # noqa: F401

TICK = 60.0


def _metrics_of(res):
    """Comparable payload: the full metrics dict + bill per result."""
    return [(r.spec, r.metrics, r.storage_usd, r.network_usd, r.ops_usd)
            for r in res.results]


def _grid_specs(n_prices=1, n_egress=1, seeds=2):
    """``tests/test_jobs.py``'s lane-chunk grid: 4 GCS limits x seeds (x
    pricing variants sharing a lane)."""
    specs = expand_grid({
        "base": "III", "days": 0.1, "n_files": 1000,
        "gcs_limit_tb": [10.0, 20.0, 40.0, 80.0],
        "egress": ["internet", "direct", "interconnect"][:n_egress],
        "storage_price": [round(0.018 + 0.002 * i, 3)
                          for i in range(n_prices)],
    })
    return with_seeds(specs, seeds)


# ----------------------------------------------- the copies against repro
@pytest.mark.parametrize("text", ["", "a", "0:lanes00000:1", "7:spec0003:2",
                                  "11:corrupt:entry-abc", "seed=ü"])
def test_unit_hash_equals_reference(text):
    assert unit_hash(text) == jx_faults.unit_hash(text)


@pytest.mark.parametrize("spec", [
    "", "seed=7,crash=0.2,hang=0.1,transient=0.3,hang_s=0.05",
    "seed=11, crash=0.3 ,attempts=2,only=lanes", "corrupt=0.6,seed=2",
])
def test_parse_faults_and_directives_equal_reference(spec):
    got, want = parse_faults(spec), jx_faults.parse_faults(spec)
    for name in ("seed", "crash", "hang", "transient", "corrupt",
                 "attempts", "hang_s", "only"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.active == want.active
    for job in ("lanes00000", "lanes00002", "spec0001", "other"):
        for attempt in (1, 2, 3):
            labels = ("cfgIII,cache=20TB", job)
            assert got.directive(job, labels, attempt) == \
                want.directive(job, labels, attempt)
        assert got.corrupts(job, 1) == want.corrupts(job, 1)
        assert not got.corrupts(job, 2)


def test_fault_plan_validation_equals_reference():
    for bad in (dict(crash=1.5), dict(crash=0.6, hang=0.6),
                dict(attempts=0), dict(hang_s=-1.0)):
        with pytest.raises(ValueError):
            FaultPlan(**bad)
        with pytest.raises(ValueError):
            jx_faults.FaultPlan(**bad)
    with pytest.raises(ValueError, match="unknown fault field"):
        parse_faults("explode=1")
    assert as_faults(None) is None
    assert as_faults({"seed": 3, "crash": 0.5}) == FaultPlan(seed=3,
                                                             crash=0.5)
    with pytest.raises(TypeError):
        as_faults(3.0)


@pytest.mark.parametrize("kw", [{}, dict(seed=5, jitter=1.0),
                                dict(base_delay_s=0.3, multiplier=3.0,
                                     max_delay_s=2.0, seed=9)])
def test_backoff_sequences_equal_reference(kw):
    got, want = RetryPolicy(max_attempts=10, **kw), \
        jx_jobs.RetryPolicy(max_attempts=10, **kw)
    for job in ("lanes00000", "lanes00008", "spec0002"):
        seq = [got.delay_s(job, a) for a in range(1, 10)]
        assert seq == [want.delay_s(job, a) for a in range(1, 10)]
        assert seq == sorted(seq) and max(seq) <= got.max_delay_s


def test_local_jobs_retry_and_abandon_like_reference():
    """One executor loop, both packages: the same jobs under the same plan
    end in the same states after the same attempts."""
    plan = dict(seed=4, crash=0.3, transient=0.3, attempts=2)
    outcome = {}
    for name, jm, fm in (("torch", pt_jobs, pt_faults),
                         ("jax", jx_jobs, jx_faults)):
        jobs = [jm.Job(job_id=f"j{i}", payload=i) for i in range(12)]
        results, reg = jm.run_local_jobs(
            jobs, lambda job: job.payload * 2,
            policy=jm.RetryPolicy(max_attempts=2, base_delay_s=0.0),
            faults=fm.FaultPlan(**plan), sleep=lambda s: None)
        outcome[name] = (results, {j.job_id: (j.state, j.attempts,
                                              j.last_kind)
                                   for j in reg.jobs.values()})
    assert outcome["torch"] == outcome["jax"]
    assert any(s == "abandoned" for s, _, _ in outcome["torch"][1].values())


def test_registry_rejects_duplicates():
    reg = JobRegistry()
    reg.add(Job(job_id="a"))
    with pytest.raises(ValueError, match="duplicate"):
        reg.add(Job(job_id="a"))


# ------------------------------------------------ chunks and round-robin
@pytest.fixture(scope="module")
def five_lanes():
    grid = pack_specs([ScenarioSpec(base="III", cache_tb=2.0 + 4.0 * i,
                                    seed=i, days=0.05, n_files=500)
                       for i in range(5)], tick=TICK)
    assert grid.n_lanes == 5
    return grid, simulate_packed(grid, device="cpu")


@pytest.mark.parametrize("lane_chunk", [1, 2, 3])
def test_lane_chunks_bitwise_to_unchunked(five_lanes, lane_chunk):
    grid, whole = five_lanes
    chunked = simulate_packed(grid, device="cpu", lane_chunk=lane_chunk)
    assert set(chunked) == set(whole)
    for k, want in whole.items():
        assert chunked[k].dtype == want.dtype, k
        np.testing.assert_array_equal(chunked[k], want, err_msg=k)


def test_devices_round_robin_bitwise_to_unchunked(five_lanes):
    grid, whole = five_lanes
    for kw in (dict(), dict(lane_chunk=2)):
        rr = simulate_packed(grid, devices=["cpu", "cpu"], **kw)
        for k, want in whole.items():
            np.testing.assert_array_equal(rr[k], want, err_msg=k)
    with pytest.raises(ValueError, match="not both"):
        simulate_packed(grid, device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="non-empty"):
        simulate_packed(grid, devices=[])
    with pytest.raises(ValueError, match="lane_chunk"):
        simulate_packed(grid, device="cpu", lane_chunk=0)
    with pytest.raises(ValueError, match="devices="):
        simulate_packed(grid, devices=["cpu"], shard=True)
    # shard=True: the lane mesh (the CPU), with and without chunks
    for kw in (dict(), dict(lane_chunk=2)):
        sh = simulate_packed(grid, device="cpu", shard=True, **kw)
        for k, want in whole.items():
            np.testing.assert_array_equal(sh[k], want, err_msg=k)


def test_resilient_path_rejects_device_round_robin():
    with pytest.raises(ValueError, match="devices"):
        run_sweep(_grid_specs(), tick=TICK, lane_chunk=2,
                  devices=["cpu", "cpu"], retry=RetryPolicy())


# ------------------------------------------------ lane-chunk jobs, faults
def test_injected_sweep_bitwise_identical_216_configs():
    """The 216-config pricing grid under injected crashes, hangs and
    transient faults converges to the fault-free run's bits."""
    specs = _grid_specs(n_prices=9, n_egress=3, seeds=2)
    assert len(specs) == 216
    plain = run_sweep(specs, tick=TICK, device="cpu", lane_chunk=2)
    before = get_registry().value("jobs.retries")
    injected = run_sweep(
        specs, tick=TICK, device="cpu", lane_chunk=2, job_timeout=0.05,
        faults=FaultPlan(seed=11, crash=0.3, hang=0.3, transient=0.3,
                         hang_s=0.1, attempts=1),
        retry=RetryPolicy(max_attempts=3, base_delay_s=0.005,
                          max_delay_s=0.02))
    assert injected.ok and len(injected.results) == 216
    assert _metrics_of(injected) == _metrics_of(plain)
    assert get_registry().value("jobs.retries") > before  # faults fired
    whole = run_sweep(specs, tick=TICK, device="cpu")
    assert _metrics_of(whole) == _metrics_of(plain)


def test_abandoned_chunk_yields_partial_result():
    specs = _grid_specs()  # 8 specs, 8 lanes; chunk 2 -> 4 jobs
    res = run_sweep(
        specs, tick=TICK, device="cpu", lane_chunk=2,
        faults=FaultPlan(transient=1.0, attempts=99, only="lanes00002"),
        retry=RetryPolicy(max_attempts=2, base_delay_s=0.0))
    assert not res.ok
    assert len(res.results) == 6  # the abandoned chunk held 2 lanes
    assert res.lanes_simulated == 6
    (failure,) = res.failures
    assert (failure.job_id, failure.kind) == ("lanes00002", "transient")
    assert failure.attempts == 2
    assert failure.as_dict()["labels"] == [s.label for s in specs[2:4]]


def test_resume_recomputes_only_missing_lanes(tmp_path):
    """Chunks of 3 lanes straddle the seeds, so the journaled chunks' lanes
    have other job streams than the grid's first lanes: what each chunk
    journals is counted from its own lanes (``jobs_submitted``)."""
    specs = _grid_specs()
    cache_dir = str(tmp_path / "cache")
    # run 1: one chunk abandons; its completed peers journal into the cache
    run1 = run_sweep(
        specs, tick=TICK, device="cpu", lane_chunk=3, cache=cache_dir,
        faults=FaultPlan(transient=1.0, attempts=99, only="lanes00000"),
        retry=RetryPolicy(max_attempts=2, base_delay_s=0.0))
    assert not run1.ok and len(run1.results) == 5
    assert run1.lanes_simulated == 5
    # run 2, the resume: the same request without faults; only the missing
    # lanes simulate, everything else is served from the journal
    run2 = run_sweep(specs, tick=TICK, device="cpu", lane_chunk=3,
                     cache=cache_dir, retry=RetryPolicy())
    assert run2.ok and len(run2.results) == 8
    assert run2.cache_hits == 5 and run2.lanes_simulated == 3
    fresh = run_sweep(specs, tick=TICK, device="cpu")
    assert _metrics_of(run2) == _metrics_of(fresh)


def test_corrupt_cache_reads_detected_and_recomputed(tmp_path):
    specs = _grid_specs()
    cache_dir = str(tmp_path / "cache")
    warm = run_sweep(specs, tick=TICK, device="cpu", cache=cache_dir)
    assert warm.lanes_simulated == 8
    before = get_registry().value("faults.injected", kind="corrupt")
    res = run_sweep(specs, tick=TICK, device="cpu", cache=cache_dir,
                    faults=FaultPlan(seed=2, corrupt=0.6))
    assert res.ok and len(res.results) == 8
    assert get_registry().value("faults.injected", kind="corrupt") > before
    assert res.lanes_simulated > 0  # corrupted entries were re-simulated
    assert res.lanes_simulated + res.cache_hits >= 8
    assert _metrics_of(res) == _metrics_of(warm)


def test_faulty_backend_corrupts_only_first_read():
    class MemBackend:
        def __init__(self):
            self.blobs = {}

        def read(self, name):
            return self.blobs.get(name)

        def write(self, name, data):
            self.blobs[name] = data

        def delete(self, name):
            self.blobs.pop(name, None)

    fb = FaultyBackend(MemBackend(), FaultPlan(seed=0, corrupt=1.0))
    assert fb.read("missing") is None
    payload = b"0123456789abcdef"
    fb.write("entry", payload)
    assert fb.read("entry") != payload   # first read: garbled
    assert fb.read("entry") == payload   # refreshed reads are clean
    fb.delete("entry")
    assert fb.read("entry") is None


def test_run_local_jobs_abandons_errors_and_journals_successes():
    """``run_local_jobs`` as the job path drives it: results by job id, a
    generic error abandons at once (no retry), and ``on_done`` fires for
    each success only."""
    done = []

    def run_one(job):
        if job.payload == 1:
            raise RuntimeError("boom")
        return job.payload

    results, reg = run_local_jobs(
        [Job(job_id=f"j{i}", payload=i) for i in range(3)], run_one,
        on_done=lambda job, out: done.append(job.job_id))
    assert results == {"j0": 0, "j2": 2} and done == ["j0", "j2"]
    (failure,) = reg.failures()
    assert failure.kind == "error" and failure.attempts == 1


def test_driver_failures_reach_decide_stats():
    """A driver whose sweeps lose a chunk to exhausted retries: its
    ``failures`` fill, and ``decide()`` marks its report degraded and
    lists them."""
    axes = {"base": "III", "days": 0.05, "n_files": 500,
            "cache_tb": [5.0, 20.0], "egress": ["internet", "direct"]}
    drv = SweepDriver(tick=TICK, device="cpu", lane_chunk=1,
                      retry=RetryPolicy(max_attempts=2, base_delay_s=0.0),
                      faults=FaultPlan(transient=1.0, attempts=99,
                                       only="cache=20TB,egress=internet,"
                                            "seed=1"))
    report = decide(axes, drv, n_seeds=2, max_rounds=1,
                    breakeven_axis=None)
    assert drv.failures
    assert all(f.kind == "transient" and f.attempts == 2
               for f in drv.failures)
    doc = report.to_json_dict()
    assert doc["degraded"] is True
    assert [f["job_id"] for f in doc["stats"]["failures"]] == \
        [f.job_id for f in drv.failures]
