"""The port's worker fleet (``repro_torch.sim.runners``) on the CPU: its
frame protocol against ``repro``'s, the fleet dispatch of lane-chunk jobs
through the local and the subprocess transports bitwise to the plain run,
crash, hang and spawn-failure handling, and a worker process that imports
neither ``repro`` nor JAX.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sim.runners.transport import recv_frame as jx_recv_frame
from repro.sim.runners.transport import send_frame as jx_send_frame
from repro_torch.core.scenarios import expand_grid, pack_specs
from repro_torch.obs.metrics import get_registry
from repro_torch.sim.batched import _chunk_grid, _chunk_lanes
from repro_torch.sim.jobs import Job, RetryPolicy
from repro_torch.sim.runners import (
    LocalTransport,
    SubprocessTransport,
    resolve_transport,
    run_fleet_jobs,
)
from repro_torch.sim.runners import worker
from repro_torch.sim.runners.transport import recv_frame, send_frame
from repro_torch.sim.sweep import run_sweep
from torch_threads import one_torch_thread  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"
TICK = 60.0


def _specs(n_seeds=5):
    return expand_grid({"base": "III", "days": 0.02, "n_files": 300,
                        "cache_tb": 5.0, "seed": list(range(n_seeds))})


def _key(res):
    return [(r.spec, r.metrics, r.storage_usd, r.network_usd, r.ops_usd)
            for r in res.results]


@pytest.fixture(scope="module")
def plain():
    specs = _specs()
    return specs, run_sweep(specs, tick=TICK, device="cpu")


# -- frame protocol -----------------------------------------------------------

MESSAGES = [{"op": "init", "ctx": {"kind": "lanes", "device": "cpu"}},
            {"op": "job", "job_id": "lanes00002",
             "payload": {"chunk": {"sizes": np.arange(7.0)}, "n": 2},
             "directive": {"kind": "hang", "seconds": 0.5}},
            {"op": "stop"}]


@pytest.mark.parametrize("writer, reader", [
    (send_frame, jx_recv_frame), (jx_send_frame, recv_frame),
    (send_frame, recv_frame)], ids=["port-to-repro", "repro-to-port",
                                    "port"])
def test_frames_cross_between_packages(writer, reader):
    buf = io.BytesIO()
    for m in MESSAGES:
        writer(buf, m)
    raw = buf.getvalue()
    other = io.BytesIO()
    for m in MESSAGES:
        (jx_send_frame if writer is send_frame else send_frame)(other, m)
    assert raw == other.getvalue()  # byte for byte the same frames
    buf.seek(0)
    got = [reader(buf) for _ in MESSAGES]
    assert got[0] == MESSAGES[0] and got[2] == MESSAGES[2]
    np.testing.assert_array_equal(got[1]["payload"]["chunk"]["sizes"],
                                  MESSAGES[1]["payload"]["chunk"]["sizes"])
    with pytest.raises(EOFError):
        reader(buf)


def test_frame_eof_mid_frame():
    buf = io.BytesIO()
    send_frame(buf, {"op": "job", "payload": list(range(100))})
    with pytest.raises(EOFError):
        recv_frame(io.BytesIO(buf.getvalue()[:-5]))


def test_resolve_transport():
    assert resolve_transport(None) is SubprocessTransport
    assert resolve_transport("subprocess") is SubprocessTransport
    assert resolve_transport("local") is LocalTransport
    factory = lambda: LocalTransport()  # noqa: E731
    assert resolve_transport(factory) is factory
    with pytest.raises(ValueError, match="unknown transport"):
        resolve_transport("carrier-pigeon")


def test_worker_kinds():
    # scenario jobs run on the port's event engine (tests/test_torch_process.py
    # holds them bitwise to repro's)
    assert callable(worker.build_runner({"kind": "scenario"}))
    with pytest.raises(ValueError, match="unknown worker context kind"):
        worker.build_runner({"kind": "nope"})


# -- fleet dispatch, local transport ------------------------------------------

def test_fleet_local_bitwise(plain):
    specs, want = plain
    fleet = run_sweep(specs, tick=TICK, device="cpu", workers=2,
                      transport="local", lane_chunk=2)
    assert fleet.ok
    assert _key(fleet) == _key(want)


def test_fleet_crash_converges_bitwise(plain):
    specs, want = plain
    get_registry().reset()
    res = run_sweep(specs, tick=TICK, device="cpu", workers=2,
                    transport="local", lane_chunk=1,
                    faults="seed=7,crash=0.6")
    assert res.ok and _key(res) == _key(want)
    assert get_registry().value("jobs.crashes") >= 1


def test_fleet_hang_times_out_and_converges(plain):
    specs, want = plain
    get_registry().reset()
    # an inline hang sleeps before its chunk runs: the deadline is above
    # a chunk's own time and below the hang
    res = run_sweep(specs, tick=TICK, device="cpu", workers=2,
                    transport="local", lane_chunk=3,
                    faults="seed=5,hang=0.9,hang_s=1.5", job_timeout=1.0)
    assert res.ok and _key(res) == _key(want)
    assert get_registry().value("jobs.timeouts") >= 1


def test_fleet_exhausted_retries_partial_not_fatal(plain):
    specs, _ = plain
    res = run_sweep(specs, tick=TICK, device="cpu", workers=2,
                    transport="local", lane_chunk=2,
                    faults="seed=11,crash=1.0,attempts=99",
                    retry=RetryPolicy(max_attempts=2, base_delay_s=0.01))
    assert not res.ok and len(res.results) == 0
    assert all(f.kind == "crash" and f.attempts == 2 for f in res.failures)


def test_fleet_spawn_failure_abandons_instead_of_spinning():
    def broken_factory():
        raise OSError("no more processes")

    jobs = [Job(job_id=f"j{i}", payload=i) for i in range(3)]
    get_registry().reset()
    results, reg = run_fleet_jobs(jobs, workers=2, transport=broken_factory)
    assert results == {}
    failures = reg.failures()
    assert len(failures) == 3
    assert all("no fleet worker" in f.errors[-1] for f in failures)
    assert get_registry().value("workers.spawn_failures") >= 1


def test_fleet_workers_validation():
    with pytest.raises(ValueError, match="workers must be >= 1"):
        run_fleet_jobs([], workers=0, transport="local")


def test_cuda_context_without_cuda_answers_with_an_error():
    """A worker told to run on ``cuda`` where there is none fails the
    attempt with a non-retryable error; it does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    grid = pack_specs(_specs(2), tick=TICK)
    ctx = {"kind": "lanes", "tick_impl": "cuda", "device": "cuda",
           "record": None, "grid": _chunk_grid(grid, _chunk_lanes(grid, 0,
                                                                   0, 0))}
    payload = {"chunk": _chunk_lanes(grid, 0, 2, 2), "n": 2}
    frame = worker.attempt(worker.build_runner(ctx),
                           {"job_id": "lanes00000", "payload": payload},
                           snapshot=False)
    assert frame["ok"] is False and frame["kind"] == "error"
    assert "CUDA is not available" in frame["error"]
    results, reg = run_fleet_jobs(
        [Job(job_id="lanes00000", payload=payload)], workers=1,
        transport="local", ctx=ctx)
    assert results == {}
    (failure,) = reg.failures()
    assert failure.kind == "error" and failure.attempts == 1


# -- subprocess transport -----------------------------------------------------

def test_fleet_subprocess_bitwise_and_crash_converges(plain):
    """Two worker processes on ``device="cpu"``: the fleet's result is
    bitwise the plain run's, every chunk's result frame merged, and a run
    whose workers die mid-job (``os._exit``) converges to the same bits."""
    specs, want = plain
    get_registry().reset()
    fleet = run_sweep(specs, tick=TICK, device="cpu", workers=2,
                      transport="subprocess", lane_chunk=2)
    assert fleet.ok and _key(fleet) == _key(want)
    reg = get_registry()
    assert reg.value("dispatch.results") == 3  # 5 lanes in chunks of 2
    assert reg.value("workers.spawned") == 2
    # each worker's attempts arrived with its result frames, by process
    per_worker = {k: v for k, v in reg.snapshot()["counters"].items()
                  if k.startswith("worker.jobs{")}
    assert len(per_worker) == 2 and sum(per_worker.values()) == 3
    get_registry().reset()
    crashed = run_sweep(specs, tick=TICK, device="cpu", workers=2,
                        transport="subprocess", lane_chunk=2,
                        faults="seed=7,crash=0.5")
    assert crashed.ok and _key(crashed) == _key(want)
    assert reg.value("jobs.crashes") >= 1 and reg.value("workers.lost") >= 1


def test_worker_process_imports_neither_repro_nor_jax(tmp_path):
    """A worker process driven through the frame protocol: it answers the
    init and a lane-chunk job, and its import log (``-X importtime``) holds
    no module of ``repro`` and none of JAX."""
    grid = pack_specs(_specs(2), tick=TICK)
    ctx = {"kind": "lanes", "tick_impl": "torch", "device": "cpu",
           "record": None, "grid": _chunk_grid(grid, _chunk_lanes(grid, 0,
                                                                   0, 0))}
    env = dict(os.environ, PYTHONPATH=str(SRC), PYTHONPROFILEIMPORTTIME="1")
    log = tmp_path / "worker.err"  # a file: a full pipe would block it
    with open(log, "wb") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.sim.runners.worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=err_file, env=env)
    try:
        send_frame(proc.stdin, {"op": "init", "ctx": ctx})
        send_frame(proc.stdin, {"op": "job", "job_id": "lanes00000",
                                "payload": {"chunk": _chunk_lanes(grid, 0, 2,
                                                                  2),
                                            "n": 2},
                                "directive": None})
        send_frame(proc.stdin, {"op": "stop"})
        proc.stdin.close()
        ready = recv_frame(proc.stdout)
        result = recv_frame(proc.stdout)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 0
    assert ready["op"] == "ready"
    assert result["ok"] and result["job_id"] == "lanes00000"
    assert result["result"]["jobs_done_site"].shape == (2, 2)
    modules = {line.split("|")[-1].strip()
               for line in log.read_text().splitlines()
               if line.startswith("import time:") and "|" in line}
    assert "repro_torch.sim.batched" in modules
    tops = {m.split(".")[0] for m in modules}
    assert not tops & {"repro", "jax", "jaxlib"}, sorted(
        m for m in modules if m.split(".")[0] in ("repro", "jax", "jaxlib"))
