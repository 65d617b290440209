#!/usr/bin/env python3
"""Time the port's sweep tick on one GPU: the main path's ``cuda`` tick,
replayed from its CUDA graph, of this checkout or of another.

    python3 scripts/bench_tick.py [--days 1] [--root DIR] [--warm N]
                                  [--dump FILE.npz]
    python3 scripts/bench_tick.py --compare A.npz B.npz

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

``--dump`` also runs the grid once more on a ``TickLoop`` replayed from
its graph and saves its outputs and the SHA-256 of each state tensor
after the last tick to an ``.npz`` file; ``--compare`` (no GPU needed)
prints, for two such files (say, a parent's and this checkout's), which
state tensors and outputs are bitwise equal and, for each output that is
not, its elements that differ and the largest relative difference.
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
    ap.add_argument("--dump", type=Path, default=None,
                    help="save the replayed run's outputs and final state")
    ap.add_argument("--compare", type=Path, nargs=2, default=None,
                    help="compare two --dump files and exit")
    args = ap.parse_args(argv)
    if args.compare is not None:
        return compare(*args.compare)

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
    if args.dump is not None:
        dump(torch, grid, args.dump)
    return 0


def dump(torch, grid, path: Path) -> None:
    """Run ``grid``'s every tick on a replayed ``TickLoop`` and save its
    outputs (``out.*``) and the SHA-256 of each tensor of its final state
    (``st.*``) to ``path``."""
    import hashlib

    import numpy as np

    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.sim.batched import TickLoop

    dev = torch.device("cuda")
    loop = TickLoop(grid, resolve_tick_impl("cuda", dev), dev, graph=True)
    loop.advance(grid.n_ticks)
    arrays = {f"out.{k}": v for k, v in loop.result().items()}
    arrays.update({f"st.{k}": np.array(hashlib.sha256(
        v.cpu().numpy().tobytes()).hexdigest()) for k, v in loop.st.items()})
    loop.close()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    print(f"dump: {len(arrays)} arrays to {path}")


def compare(a: Path, b: Path) -> int:
    """Print which arrays of two dumps are bitwise equal; 0 if all are."""
    import numpy as np

    x, y = np.load(a), np.load(b)
    keys = sorted(set(x.files) | set(y.files))
    unequal = 0
    for k in keys:
        if k not in x.files or k not in y.files:
            print(f"{k}: only in {a if k in x.files else b}")
            unequal += 1
            continue
        u, v = x[k], y[k]
        if u.dtype == v.dtype and np.array_equal(u, v):
            print(f"{k}: bitwise equal")
            continue
        unequal += 1
        if u.dtype.kind == "U":  # a state tensor's digest
            print(f"{k}: differs")
            continue
        diff = u != v
        rel = (np.abs(u.astype(np.float64) - v) / np.maximum(
            np.abs(u.astype(np.float64)), 1e-30))[diff]
        print(f"{k}: {int(diff.sum())} of {diff.size} elements differ, "
              f"largest relative difference {float(rel.max()):.3e}")
    print(json.dumps({"arrays": len(keys), "unequal": unequal}))
    return 0 if unequal == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
