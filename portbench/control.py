"""The comparison's control: the plain reference in bfloat16 precision put
in the program's place, read against the float32 reference on the lanes a
run checks, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

One JSON line a seed: the numbers compared (``portbench.compare``), each
with its limit, and whether the control passed (it must not). The
benchmark's own runs never run this; it sets the upper reading of each
limit (``PERF.md``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def control(run, seed: int) -> dict:
    """The control's readings on the :data:`REF_LANES` first lanes of
    call 1 of ``seed``."""
    from portbench import compare
    from portbench.grid import call_specs

    runner = run.runner
    specs = call_specs(run.traffic, seed, 1)
    keys = list(dict.fromkeys(runner.lane_key(s) for s in specs))
    keys = keys[:runner.REF_LANES]
    specs = [s for s in specs if runner.lane_key(s) in keys]
    t0 = time.perf_counter()
    want = runner.reference(run, specs)
    t1 = time.perf_counter()
    got = runner.reference(run, specs, bf16=True)
    numbers, worst = compare.compare(got, want)
    return {"seed": seed, "specs": len(specs), "reference_s": t1 - t0,
            "numbers": numbers, "passed": compare.is_correct(numbers),
            "worst": worst[:2]}


def make_run(workload: str, device: str = "cuda", root: Path = ROOT,
             bench: Path = None):
    from portbench import harness

    bench = bench or root / "portbench"
    man = harness.manifest(root)
    cell = harness.cell_of(man, workload)
    cfg = harness.config_of(man, cell["config"], root)
    traffic = harness.traffic_of(cell["traffic"], bench)
    run = harness.Run(cell, cfg, traffic, 0, 0.0, False, device, "torch")
    run.runner = harness.runner_of(traffic["runner"], bench)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    run = make_run(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control(run, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
