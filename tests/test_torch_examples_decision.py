"""``examples/sweep_decision_torch.py`` against the JAX package's decision
on the CPU.

The port's example at a reduced scale (0.05 days, 1,000 files a site, 2
seeds, one refinement round) on the plain tick on the CPU (``--device cpu
--tick-impl torch``) against ``repro.sim.decide.decide`` on
``SweepDriver(backend="jax", tick=30.0)`` (the jnp program on the CPU)
over the example's axes: the same decisions (chosen point, frontier,
trimmed cache, break-even bracket, claim), the same work counted, every
float of the report within the rtol 1e-5 of ``tests/test_torch_batched.py``;
the example's printed decision line names the trimmed cache.
"""

import json
import math

from repro.sim.decide import OnPremDisk, decide
from repro.sim.sweep import SweepDriver
from torch_entry_points import load
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5  # tests/test_torch_batched.py's float bar against jnp
DAYS, FILES, SEEDS, ROUNDS = 0.05, 1000, 2, 1


def _comparable(doc):
    """A report's JSON without what differs by package or by run: the
    registry snapshot, the driver's wall time and its backend name."""
    doc = json.loads(json.dumps(doc))
    for k in ("metrics", "sweep_wall_s", "backend", "tick_impl"):
        doc["stats"].pop(k, None)
    return doc


def _assert_close(a, b, path=""):
    """Equal structure and non-float leaves; floats within ``RTOL``."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_close(u, v, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-9), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_sweep_decision_matches_repro_at_reduced_scale(capsys):
    ex = load("examples/sweep_decision_torch.py")
    got = ex.main(["--device", "cpu", "--tick-impl", "torch",
                   "--days", str(DAYS), "--files", str(FILES),
                   "--seeds", str(SEEDS), "--max-rounds", str(ROUNDS)])
    out = capsys.readouterr().out
    axes = {"base": "III", "days": DAYS, "n_files": FILES,
            "cache_tb": [5.0, 20.0, 100.0],
            "egress": ["internet", "direct", "interconnect"]}
    drv = SweepDriver(backend="jax", tick=30.0)
    ref = decide(axes, drv, n_seeds=SEEDS,
                 onprem=OnPremDisk(usd_per_tb_month=15.0), rel_tol=0.05,
                 max_rounds=ROUNDS)
    ref.stats.update(sweep_calls=drv.sweep_calls, configs_run=drv.configs_run,
                     lanes_simulated=drv.lanes_simulated,
                     sweep_wall_s=round(drv.wall_s, 2))
    a, b = got["report"], ref.to_json_dict()
    assert a["stats"]["backend"] == "torch"
    assert a["stats"]["tick_impl"] == "torch"
    assert a["claim_holds"] == b["claim_holds"]
    assert (a["chosen"] and a["chosen"]["label"]) == \
        (b["chosen"] and b["chosen"]["label"])
    assert [p["label"] for p in a["frontier"]] == \
        [p["label"] for p in b["frontier"]]
    assert a["displaced_disk"]["min_cache_tb"] == \
        b["displaced_disk"]["min_cache_tb"]
    assert (a["break_even"] and a["break_even"]["bracket"]) == \
        (b["break_even"] and b["break_even"]["bracket"])
    _assert_close(_comparable(a), _comparable(b))
    assert out.startswith(f"deciding over 18-config coarse grid ({DAYS:g} "
                          f"days, {FILES} files/site, {SEEDS} seeds) ...")
    assert "# Cloud-cache decision report" in out
    assert got["decision"] == out.strip().splitlines()[-1]
    d = a["displaced_disk"]
    if d["min_cache_tb"] is not None:
        assert got["decision"].startswith(
            f"decision: buy a {d['min_cache_tb']:g} TB/site hot cache")
