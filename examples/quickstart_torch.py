"""Quickstart on the PyTorch port: the HCDC model in 60 seconds.

The port's counterpart of ``examples/quickstart.py``, on
``repro_torch``'s event engine (host only, no device):

1. Runs the paper's three configurations at reduced scale and prints the
   headline result (cloud cold-tier cache recovers the job throughput that
   a disk limit destroys).
2. Runs the §6 decision tool: given a disk budget, should you buy cloud
   cache, and what does it cost?

    python examples/quickstart_torch.py

It prints the JAX package's quickstart lines character for character.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.hcdc import HCDCScenario, make_config  # noqa: E402
from repro_torch.core.planner import recommend, sweep  # noqa: E402
from repro_torch.sim.engine import DAY  # noqa: E402

DAYS, FILES = 4, 40_000
SWEEP_DAYS, SWEEP_FILES = 2, 20_000


def _limit(tb: float) -> str:
    return "inf" if tb == float("inf") else f"{tb:.0f}TB"


def main(argv=None) -> dict:
    """Print the quickstart; return its numbers: each configuration's
    metrics, the headline shares, the sweep's points and the
    recommended disk limit."""
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)

    print("=== HCDC configurations (paper Table 5, reduced scale) ===")
    results = {}
    for name, desc in [("I", "unlimited disk, no cloud"),
                       ("II", "100 TB disk, no cloud"),
                       ("III", "100 TB disk + cloud cold tier")]:
        cfg = make_config(name, simulated_time=DAYS * DAY,
                          n_files_per_site=FILES, seed=0)
        m = HCDCScenario(cfg).run()
        results[name] = m
        cost = sum(v for k, v in m.items() if k.endswith("_usd"))
        print(f"cfg {name:3s} ({desc:32s}): jobs={m['jobs_done']:7.0f} "
              f"downloads={m['download_pb']:6.3f} PB  disk_used="
              f"{m['Site-1.disk_used_pb'] + m['Site-2.disk_used_pb']:6.3f} PB  "
              f"cloud_cost=${cost:,.0f}")

    jI, jII, jIII = (results[k]["jobs_done"] for k in ("I", "II", "III"))
    loss, recovered = 100 * (1 - jII / jI), 100 * jIII / jI
    print(f"\nheadline: disk limit costs {loss:.1f}% of job "
          f"throughput; adding the cloud cold tier recovers it to "
          f"{recovered:.1f}% of baseline.")

    print("\n=== decision tool (paper §6): disk-limit sweep ===")
    points = sweep([50.0, 100.0], days=SWEEP_DAYS, n_files=SWEEP_FILES, seed=1)
    for p in points:
        print(f"disk={_limit(p.disk_limit_tb):6s} jobs={p.jobs_done:7.0f} "
              f"disk_used={p.disk_used_pb:6.3f} PB "
              f"cloud=${p.cloud_cost_usd:,.0f}")
    rec = recommend(points, min_throughput_frac=0.95)
    print(f"recommended: disk={_limit(rec.disk_limit_tb)} (>=95% of baseline "
          f"throughput at minimal disk + cloud cost)")
    return {"configs": results, "disk_limit_loss_pct": loss,
            "recovered_pct": recovered,
            "sweep": [vars(p) for p in points],
            "recommended_disk_tb": rec.disk_limit_tb}


if __name__ == "__main__":
    main()
