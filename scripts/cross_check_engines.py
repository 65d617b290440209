#!/usr/bin/env python3
"""Hold the port's batched program against its event engine on a few specs.

    python3 scripts/cross_check_engines.py [--device cpu|cuda]
        [--tick-impl auto|torch|cuda] [--days 1] [--files 1000000]
        [--threads N]

Runs the specs below on ``backend="process"`` (the event-driven reference
engine, host code) and on the batched program (``run_sweep_torch``, tick
10 s) of ``repro_torch``, and prints per spec the jobs done and cloud
cost of both and their relative differences, measured as the ``decide
--cross-check`` command measures them (jobs against the event engine's,
cost against the larger of the event engine's and 20 USD), beside its
bars of 0.10 and 0.20. The specs are decision points of the 216-config
pricing grid's decision at the paper's catalogue: the disk-only baseline
(Config I) and Config III at 10 TB and 40 TB caches, seed 0 (pricing
fields do not change the dynamics). Exits 1 when a spec is beyond a bar.

On the CPU (``--device cpu``) the batched program runs its plain PyTorch
tick, at about a quarter of a second a tick for the three lanes of 1M
files: a 1-day run takes about an hour there. Wall times printed are the
host's.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

TOL_JOBS, TOL_COST = 0.10, 0.20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="the batched program's device (default: the card)")
    ap.add_argument("--tick-impl", default="auto")
    ap.add_argument("--days", type=float, default=1.0)
    ap.add_argument("--files", type=int, default=1_000_000)
    ap.add_argument("--threads", type=int, default=None,
                    help="torch CPU threads (default: torch's choice)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.scenarios import ScenarioSpec
    from repro_torch.sim.batched import run_sweep_torch
    from repro_torch.sim.sweep import run_sweep

    if args.threads:
        torch.set_num_threads(args.threads)
    d, n = args.days, args.files
    specs = [ScenarioSpec(base="I", days=d, n_files=n, gcs_limit_tb=0.0),
             ScenarioSpec(base="III", cache_tb=10.0, days=d, n_files=n),
             ScenarioSpec(base="III", cache_tb=40.0, days=d, n_files=n)]
    t0 = time.perf_counter()
    ref = run_sweep(specs, backend="process", workers=len(specs))
    print(f"event engine: {time.perf_counter() - t0:.2f} s wall (host)",
          flush=True)
    t0 = time.perf_counter()
    got = run_sweep_torch(specs, tick=10.0, tick_impl=args.tick_impl,
                          device=args.device)
    print(f"batched program ({args.device or 'cuda'}, {args.tick_impl}): "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    bad = 0
    for a, b in zip(got.results, ref.results):
        dj = abs(a.jobs_done - b.jobs_done) / max(b.jobs_done, 1.0)
        dc = abs(a.cost_usd - b.cost_usd) / max(b.cost_usd, 20.0)
        over = dj > TOL_JOBS or dc > TOL_COST
        bad += over
        print(f"{a.spec.label}: jobs {a.jobs_done:.0f} vs {b.jobs_done:.0f} "
              f"({dj:.4f}), cost {a.cost_usd:.2f} vs {b.cost_usd:.2f} USD "
              f"({dc:.4f}), {b.events} events"
              f"{'  BEYOND THE BAR' if over else ''}", flush=True)
    print(f"{len(specs) - bad} of {len(specs)} specs within jobs "
          f"{TOL_JOBS:.2f} / cost {TOL_COST:.2f}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
