"""Worked §5.3 decision example on the PyTorch port: is commercial cloud
cache worth buying?

The port's counterpart of ``examples/sweep_decision.py``. Uses the
decision-support layer (``repro_torch.sim.decide``) end-to-end instead of
eyeballing a fixed grid: a disk-only baseline is compared against a coarse
cloud-cache grid that is adaptively refined around its cost/throughput
frontier (seed replicas give every number a ± CI), the cheapest matching
configuration's cache is trimmed to the smallest size that still holds the
baseline's throughput (the displaced on-prem disk is the paper's headline
quantity), and a bisection on the flat egress-price axis finds where the
cloud option breaks even with buying disk. The sweeps run on the batched
program on the CUDA device (``--tick-impl cuda``: the hand-written lane-tick
and glue kernels, the tick replayed from a CUDA graph; ``torch``: the plain
PyTorch tick); ``--device cpu`` runs the plain tick on the CPU.

    python examples/sweep_decision_torch.py [--tick-impl torch] [--device cpu]

The same workflow at CLI scale: ``python -m repro_torch.cli.decide``;
methodology: ``docs/decision.md``.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.registry import TICK_IMPL_CHOICES  # noqa: E402
from repro_torch.sim.decide import OnPremDisk, decide  # noqa: E402
from repro_torch.sim.sweep import SweepDriver  # noqa: E402

DAYS, FILES, SEEDS, MAX_ROUNDS = 0.25, 2000, 2, 3


def main(argv=None) -> dict:
    """Decide and print the report and the decision; return the report's
    JSON document and the decision line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=float, default=DAYS)
    ap.add_argument("--files", type=int, default=FILES)
    ap.add_argument("--seeds", type=int, default=SEEDS)
    ap.add_argument("--max-rounds", type=int, default=MAX_ROUNDS)
    ap.add_argument("--tick-impl", default="auto", choices=TICK_IMPL_CHOICES,
                    help="cuda (the kernels, on the card), torch (the plain "
                         "tick) or auto (cuda on the card, torch on the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain tick on the CPU)")
    args = ap.parse_args(argv)

    # Candidate grid: configuration III (100 TB cache + GCS cold tier in
    # the paper; cache size swept here) across the §5.3 egress pricing
    # alternatives. The coarse cache axis is deliberately sparse — the
    # refinement fills in the frontier region on its own.
    axes = {
        "base": "III", "days": args.days, "n_files": args.files,
        "cache_tb": [5.0, 20.0, 100.0],
        "egress": ["internet", "direct", "interconnect"],
    }
    driver = SweepDriver(backend="torch", tick=30.0, tick_impl=args.tick_impl,
                         device=args.device)
    onprem = OnPremDisk(usd_per_tb_month=15.0)

    print(f"deciding over {3 * 3 * args.seeds}-config coarse grid "
          f"({args.days:g} days, {args.files} files/site, {args.seeds} "
          f"seeds) ...")
    report = decide(axes, driver, n_seeds=args.seeds, onprem=onprem,
                    rel_tol=0.05, max_rounds=args.max_rounds)
    report.stats.update(
        sweep_calls=driver.sweep_calls,
        configs_run=driver.configs_run,
        lanes_simulated=driver.lanes_simulated,
        sweep_wall_s=round(driver.wall_s, 2),
    )
    print()
    print(report.to_markdown())

    d = report.displaced
    if d.min_cache_tb is not None:
        decision = (f"decision: buy a {d.min_cache_tb:g} TB/site hot cache "
                    f"with '{d.candidate.spec.egress}' egress — "
                    f"${d.cloud_budget_usd:,.2f} of cloud spend displaces "
                    f"{d.displaced_tb:,.1f} TB of on-prem disk at the "
                    "baseline's throughput (within CI).")
    else:
        decision = ("decision: stay on-prem at this scale; no cloud "
                    "candidate matches the baseline's throughput.")
    print(decision)
    return {"report": report.to_json_dict(), "decision": decision}


# The guard stays: the cross-backend path spawns worker processes that
# re-import this module, and an unguarded run would recurse into the pool
# bootstrap.
if __name__ == "__main__":
    main()
