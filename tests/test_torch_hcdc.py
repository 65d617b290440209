"""The port's HCDC event engine (``repro_torch.core.hcdc.HCDCScenario``)
bitwise against ``repro``'s on the same configurations and seeds: metric
dicts, Fig. 6/8 series, waiting-time samples, bills, ``monthly_raw`` and
``events_executed`` compared with ``==``."""

import numpy as np
import pytest

from repro.core import hcdc as jx_hcdc
from repro.core import hotcold as jx_hotcold
from repro.sim import workload as jx_workload
from repro_torch.core import hcdc, hotcold
from repro_torch.sim import workload

TB = 1000.0**4

#: name -> (base, overrides): Table 5's three configurations at their
#: limits, then configuration III (and II) at a 5 TB disk, which the
#: 2,000-file catalogue fills, so deletions and migrations run.
CASES = {
    "I": ("I", {}),
    "II": ("II", {}),
    "III": ("III", {}),
    "II-small-disk": ("II", {"disk_tb": 5.0}),
    "III-small-disk": ("III", {"disk_tb": 5.0}),
    "tape-latency-sigma": ("III", {"disk_tb": 5.0,
                                   "tape_latency_sigma": 600.0}),
    "migration-threshold": ("III", {"disk_tb": 5.0, "min_popularity": 5}),
    "cold-deletion": ("III", {"disk_tb": 5.0, "gcs_limit": 40 * TB,
                              "cold_threshold": 0.9}),
    "diurnal": ("III", {"disk_tb": 5.0, "workload": "diurnal"}),
    "zipf-drift": ("III", {"disk_tb": 5.0, "workload": "zipf-drift"}),
    "curves": ("III", {"disk_tb": 5.0, "curves": True}),
}


def _config(pkg, base: str, days: float, n_files: int, seed: int,
            disk_tb=None, min_popularity=0, cold_threshold=None,
            workload_text=None, **overrides):
    hc, hotc, wl = pkg
    kw = dict(simulated_time=int(days * 86400), n_files_per_site=n_files,
              seed=seed, **overrides)
    if min_popularity:
        kw["migration_policy"] = hotc.MigrationPolicy(min_popularity)
    if cold_threshold is not None:
        kw["cold_deletion_policy"] = hotc.ColdDeletionPolicy(cold_threshold)
    if workload_text is not None:
        kw["workload"] = wl.parse_workload(workload_text)
    cfg = hc.make_config(base, **kw)
    if disk_tb is not None:
        for s in cfg.sites:
            s.disk_limit = disk_tb * TB
    return cfg


def _run(pkg, base, days, n_files, seed, **kw):
    kw["workload_text"] = kw.pop("workload", None)
    sc = pkg[0].HCDCScenario(_config(pkg, base, days, n_files, seed, **kw))
    metrics = sc.run()
    return sc, metrics


REF = (jx_hcdc, jx_hotcold, jx_workload)
PORT = (hcdc, hotcold, workload)


def _same_run(a, b):
    (sa, ma), (sb, mb) = a, b
    assert ma == mb
    assert sa.sim.events_executed == sb.sim.events_executed
    assert sa.gcs.monthly_raw == sb.gcs.monthly_raw
    assert sa.gcs.full_months_closed == sb.gcs.full_months_closed
    assert [(x.storage_usd, x.network_usd, x.ops_usd) for x in sa.gcs.bills] \
        == [(x.storage_usd, x.network_usd, x.ops_usd) for x in sb.gcs.bills]
    assert sa.gcs.volume_deltas == sb.gcs.volume_deltas
    assert sa.out.hist("job_waiting_h").samples == \
        sb.out.hist("job_waiting_h").samples
    assert set(sa.out.series) == set(sb.out.series)
    for name, ts in sa.out.series.items():
        ta, va = ts.to_arrays()
        tb, vb = sb.out.series[name].to_arrays()
        assert np.array_equal(ta, tb) and np.array_equal(va, vb)
    for x, y in zip(sa.sites, sb.sites):
        assert np.array_equal(x.disk_state, y.disk_state)
        assert np.array_equal(x.gcs_state, y.gcs_state)
        assert np.array_equal(x.gcs_recalls, y.gcs_recalls)
        assert x.deletable == y.deletable


@pytest.mark.parametrize("case", list(CASES))
def test_hcdc_scenario_bitwise_to_reference(case):
    base, kw = CASES[case]
    want = _run(REF, base, 0.5, 2000, 7, **kw)
    got = _run(PORT, base, 0.5, 2000, 7, **kw)
    _same_run(got, want)
    sc, m = got
    assert m["jobs_done"] > 0 and m["jobs_submitted"] >= m["jobs_done"]
    if kw.get("disk_tb"):
        assert sum(st.disk.used for st in sc.sites) > 0
        if base == "III" and not kw.get("min_popularity"):
            assert m["disk_to_gcs_pb"] > 0  # migrations ran
    if kw.get("curves"):
        assert {"gcs_used", "Site-1.disk_used",
                "Site-2.running_jobs"} <= set(sc.out.series)


def test_hcdc_bills_past_a_month_bitwise_to_reference():
    """One horizon past a 30-day month: a closed month and a partial one,
    each billed; a small catalogue and a 120 s generator keep it short."""
    kw = dict(disk_tb=2.0, gen_interval=120)
    want = _run(REF, "III", 31.0, 300, 3, **kw)
    got = _run(PORT, "III", 31.0, 300, 3, **kw)
    _same_run(got, want)
    sc, m = got
    assert sc.gcs.full_months_closed == 1 and len(sc.gcs.bills) == 2
    assert m["month1.storage_usd"] > 0 and m["month2.storage_usd"] > 0
    assert m["month1.network_usd"] > 0


def test_paper_tables_and_defaults_match_reference():
    assert hcdc.PAPER_TABLE6 == jx_hcdc.PAPER_TABLE6
    assert hcdc.PAPER_TABLE7 == jx_hcdc.PAPER_TABLE7
    assert hcdc.PAPER_TABLE8 == jx_hcdc.PAPER_TABLE8
    assert hotcold.MigrationPolicy(3).should_migrate(3)
    assert not hotcold.MigrationPolicy(3).should_migrate(2)
    pol = hotcold.ColdDeletionPolicy(0.5)
    assert pol.trim_target(10.0, 7.0) == \
        jx_hotcold.ColdDeletionPolicy(0.5).trim_target(10.0, 7.0) == 2.0
    assert hotcold.ColdDeletionPolicy().trim_target(10.0, 7.0) == 0.0
