#!/usr/bin/env python3
"""Time the port's sweep tick on one GPU: the main path's ``cuda`` tick,
replayed from its CUDA graph, of this checkout or of another.

    python3 scripts/bench_tick.py [--days 1] [--root DIR] [--warm N]

Runs ``chip_smoke.py``'s sweep grid (Config III, 216 specs, 8 dynamics
lanes, 2 sites x 1,000,000 files, tick 10 s, ``--days`` of horizon)
through ``run_sweep_torch`` with ``tick_impl="cuda"`` (ticks/s, packing
included), then ``chip_smoke.profile_phase`` on the replayed tick
(after ``--warm`` ticks, then 40 on the host clock and 40 profiled): wall
microseconds a tick unprofiled, device microseconds a tick and the idle
share (``torch.profiler``), the twelve largest device rows, and the
lane-tick and tick-glue kernels' microseconds a tick. ``--root`` times the
port of another checkout (for example a parent commit unpacked with ``git
archive`` under ``build/``) with this script's helpers; its kernels build
into its own ``build/``. Prints the card, the profile and one JSON line.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--days", type=float, default=1.0,
                    help="simulated horizon of the sweep (default 1)")
    ap.add_argument("--root", type=Path, default=None,
                    help="time the port of this checkout instead")
    ap.add_argument("--warm", type=int, default=20,
                    help="ticks before the profile's 80 (default 20)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_tick: CUDA is not available", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.core.scenarios import pack_specs
    from repro_torch.kernels import lane_tick
    from repro_torch.sim.batched import run_sweep_torch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    port = Path(lane_tick.__file__).resolve().parents[3]
    print(f"port: {port}")
    specs = cs.pricing_specs(args.days, 1_000_000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_sweep_torch(specs, tick=10.0, tick_impl="cuda", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grid = pack_specs(specs, tick=10.0)
    ticks_per_s = grid.n_ticks / wall
    print(f"sweep cuda (captured): {wall:.2f} s wall, {ticks_per_s:.1f} "
          f"ticks/s (packing included), {grid.n_ticks} ticks")
    prof = cs.profile_phase(torch, grid, graph=True, warm=args.warm)
    busy = prof["busy_us"]
    print(json.dumps({"port": str(port), "ticks_per_s": ticks_per_s,
                      "wall_us": prof["wall_us"], "busy_us": busy,
                      "idle_share": (None if busy is None
                                     else 1 - busy / prof["wall_us"]),
                      "topk_us": prof.get("topk_us"),
                      "glue_us": prof.get("glue_us"),
                      "wait_queue": prof.get("wait_queue")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
