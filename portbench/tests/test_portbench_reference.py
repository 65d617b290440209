"""The frozen reference against the port's plain path on a tiny grid (2
lanes, 2,000 files a site, 0.05 days), bitwise; the configuration files
against the port's configurations; the control's failure."""

import json
import math

import pytest
import torch

from helpers import BENCH
from portbench import compare
from portbench.grid import call_specs
from portbench.reference import billing, packer, tick

CONFIGS = ("hcdc-cfg3-1m", "hcdc-cfg2-1m")


def tiny(config):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg.update(files_per_site=2000, days=0.05)
    traffic = {"runner": "sweep", "cache_tb": [0.5, 2.0],
               "egress": ["internet", "direct"],
               "storage_price": [0.02, 0.03], "seeds_per_call": 1,
               "workload": {"name": "steady"}}
    return cfg, call_specs(traffic, 2 ** 31 + 11, 1)


def reference(cfg, specs, bf16=False):
    grid = packer.pack(cfg, specs, cfg["days"], cfg["tick_s"])
    assert grid.n_lanes == 2
    return billing.results(cfg, grid, tick.simulate(grid, "cpu", bf16=bf16))


def port(cfg, specs):
    from repro_torch.core.scenarios import ScenarioSpec
    from repro_torch.sim.sweep import run_sweep

    ps = [ScenarioSpec(base=cfg["base"], days=cfg["days"],
                       n_files=cfg["files_per_site"], seed=s["seed"],
                       cache_tb=s["cache_tb"], egress=s["egress"],
                       storage_price=s["storage_price"],
                       workload=packer.workload_string(s["workload"]))
          for s in specs]
    res = run_sweep(ps, backend="torch", tick_impl="torch", device="cpu",
                    cache=None)
    return [{"metrics": r.metrics, "storage_usd": r.storage_usd,
             "network_usd": r.network_usd, "ops_usd": r.ops_usd,
             "monthly": r.monthly} for r in res.results]


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_is_bitwise_the_plain_path(config):
    cfg, specs = tiny(config)
    want = port(cfg, specs)
    got = reference(cfg, specs)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        fg, fw = compare.flatten(g), compare.flatten(w)
        assert fg.keys() == fw.keys()
        assert all(fg[k] == fw[k] for k in fw), [
            (k, fg[k], fw[k]) for k in fw if fg[k] != fw[k]][:3]
    numbers, _ = compare.compare(got, want)
    assert numbers["gap"][0] == 0.0 and compare.is_correct(numbers)
    # the grid exercises the layers the cells name
    assert any(w["metrics"]["jobs_done"] > 0 for w in want)
    if config == "hcdc-cfg3-1m":
        assert any(w["metrics"]["disk_to_gcs_pb"] > 0 for w in want)
        assert any(w["network_usd"] > 0 for w in want)


@pytest.mark.parametrize("config", CONFIGS)
def test_configuration_file_states_the_engine_configuration(config):
    from repro_torch.core.hcdc import DAY, make_config
    from repro_torch.sim.cloud import PEERING_PRICES, GCSCostModel
    from repro_torch.sim.infrastructure import TB, GiB

    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    e = make_config(cfg["base"])
    assert cfg["source_days"] * DAY == e.simulated_time
    assert cfg["files_per_site"] == e.n_files_per_site
    assert cfg["gen_interval_s"] == e.gen_interval
    assert [(s["name"], s["tape_to_disk_b_s"], s["disk_tb"] * TB)
            for s in cfg["sites"]] == [
        (s.name, s.tape_to_disk_mb_s, s.disk_limit) for s in e.sites]
    gcs = cfg["gcs_limit_tb"]
    assert (gcs if gcs is None else gcs * TB) == e.gcs_limit
    links = cfg["links"]
    assert (links["gcs_to_disk_b_s"], links["disk_to_gcs_b_s"],
            links["max_active"], links["tape_latency_s"]) == (
        e.gcs_to_disk, e.disk_to_gcs, e.max_active, e.tape_latency)
    assert cfg["download_b_s"] == e.download
    size = cfg["file_size_gib"]
    assert (size["lam"], size["lo"], size["hi"]) == (
        e.size_lam, e.size_lo, e.size_hi)
    pop = cfg["popularity"]
    assert (pop["p"], pop["lo"], pop["hi"], pop["selection_power"]) == (
        e.popularity.p, e.popularity.lo, e.popularity.hi,
        e.popularity.selection_power)
    assert (cfg["jobs_per_tick"]["mu"], cfg["jobs_per_tick"]["sigma"]) == (
        e.jobs_mu, e.jobs_sigma)
    assert (cfg["job_duration_s"]["lam"], cfg["job_duration_s"]["lo"]) == (
        e.dur_lam, e.dur_lo)
    assert cfg["migrate_min_popularity"] == e.migration_policy.min_popularity
    prices, cm = cfg["prices"], GCSCostModel()
    assert prices["storage_per_gb_month"] == cm.storage_per_gb_month
    assert [(math.inf if b is None else b * 1024.0 ** 4, p)
            for b, p in prices["egress_tiers"]] == list(cm.egress_tiers)
    assert prices["peering_per_gib"] == PEERING_PRICES
    assert (prices["class_a_per_10k"], prices["class_b_per_10k"]) == (
        cm.class_a_per_10k, cm.class_b_per_10k)
    assert packer.GiB == GiB and packer.TB == TB


@pytest.mark.parametrize("config", CONFIGS)
def test_control_fails_the_comparison(config):
    cfg, specs = tiny(config)
    want = reference(cfg, specs)
    numbers, _ = compare.compare(reference(cfg, specs, bf16=True), want)
    assert not compare.is_correct(numbers)
    assert numbers["gap"][0] > 100 * numbers["gap"][1]


def test_blocked_scan_is_the_scan():
    g = torch.Generator().manual_seed(3)
    mask = torch.rand((3, 50_000), generator=g) < 1e-3
    assert torch.equal(tick.cumsum_last(mask, torch.int32),
                       torch.cumsum(mask, -1, dtype=torch.int32))
    sizes = (torch.rand((3, 50_000), generator=g) * 1e11).float()
    x = (sizes * mask).double()
    assert torch.equal(tick.cumsum_last(x), torch.cumsum(x, -1))


@pytest.mark.parametrize("workload", [
    {"name": "diurnal", "amplitude": 0.8, "period_h": 0.5},
    {"name": "campaign", "period_h": 0.4, "duty": 0.2, "peak": 4,
     "off": 0.25},
    {"name": "zipf-drift", "power_start": 3.5, "power_end": 1.5,
     "steps": 4}], ids=lambda w: w["name"])
def test_workload_shapes_pack_as_the_port_packs_them(workload):
    """The traffic files may name any of the sweep's workload shapes: the
    reference packs and simulates each as the port's plain path does."""
    cfg, specs = tiny("hcdc-cfg3-1m")
    specs = [dict(s, workload=workload) for s in specs]
    got, want = reference(cfg, specs), port(cfg, specs)
    for g, w in zip(got, want):
        assert compare.flatten(g) == compare.flatten(w)
