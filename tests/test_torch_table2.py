"""The port's plain path against the event engine at the Table-2 bar.

``repro``'s acceptance grid (``tests/test_batched.py``,
``test_jax_backend_matches_reference_64_config_grid``): 64 configurations
(Config III; cache 10/20/40/80 TB; internet/direct egress; two storage
prices; 4 seeds; 0.75 days; 1,000 files a site) run through ``repro``'s
process backend, the event-driven reference engine, and through the
port's batched program on its plain path
(``run_sweep_torch(tick_impl="torch", device="cpu")``, tick 10 s). Per
lane: jobs done and the cost within 5%, download volume within 5%, equal
jobs submitted, and the mean waiting time within 0.05 h.

The horizon is ``repro``'s: at 0.25 days the reference engine's own
seed-to-seed cost spread is about ±6%, so a 5% per-lane bar needs the
0.75 days that bring it to about ±2%.
"""

import dataclasses

import pytest
import torch

from repro.core.scenarios import expand_grid as jx_expand_grid
from repro.core.scenarios import with_seeds as jx_with_seeds
from repro.sim.sweep import run_sweep as jx_run_sweep
from repro_torch.core.scenarios import ScenarioSpec
from repro_torch.sim.batched import run_sweep_torch
from torch_threads import one_torch_thread  # noqa: F401

TOL = 0.05  # Table 2 validation tolerance (fractional)


def _close(a, b, tol=TOL, floor=1.0):
    return abs(a - b) <= tol * max(abs(a), abs(b), floor)


@pytest.mark.slow
def test_plain_path_matches_event_engine_64_config_grid():
    specs = jx_with_seeds(jx_expand_grid({
        "base": "III",
        "cache_tb": [10.0, 20.0, 40.0, 80.0],
        "egress": ["internet", "direct"],
        "storage_price": [None, 0.02],
        "days": 0.75, "n_files": 1000,
    }), 4)
    assert len(specs) == 64
    ref = jx_run_sweep(specs, workers=2)
    # one intra-op thread: the plain tick's small ops gain nothing from
    # more on the CPU, and under a parallel test run more threads only
    # contend with the other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = run_sweep_torch(
            [ScenarioSpec(**dataclasses.asdict(s)) for s in specs],
            tick=10.0, tick_impl="torch", device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert len(ref.results) == len(got.results) == 64
    for a, b in zip(ref.results, got.results):
        lbl = a.spec.label
        assert b.spec.label == lbl
        assert _close(a.jobs_done, b.jobs_done), \
            f"{lbl}: jobs_done {a.jobs_done} vs {b.jobs_done}"
        assert _close(a.cost_usd, b.cost_usd), \
            f"{lbl}: cost {a.cost_usd} vs {b.cost_usd}"
        assert _close(a.metrics["download_pb"], b.metrics["download_pb"],
                      floor=1e-6), f"{lbl}: download_pb"
        assert a.metrics["jobs_submitted"] == b.metrics["jobs_submitted"], \
            f"{lbl}: jobs_submitted"
        assert abs(a.metrics["job_waiting_h_mean"]
                   - b.metrics["job_waiting_h_mean"]) <= 0.05, \
            f"{lbl}: job_waiting_h_mean"
