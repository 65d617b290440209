"""The benchmark's harness: one run of one cell.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` finds everything by name: the cell in ``BENCHMARK.json``,
its configuration in the file the manifest names, its traffic in
``portbench/traffic/<traffic>.json``, the runner that runs it in
``portbench/runners/<runner>.py`` (named by the traffic file) and each
metric's reader in ``portbench/metrics/<metric>.py``. A cell, a traffic
mix, a configuration or a metric is added as files and manifest entries,
with no edit to a file that is there.

A run: set-up (imports and the runner's warm call), a measured window of
``--seconds``, the check of what the window produced against the plain
reference, then one JSON line on standard output. With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy and window seconds and the trace's
breakdown. The numbers compared, each beside its limit, end standard
error and end the line (``compared``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

from portbench import compare

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent

#: Top-level module names that may not be loaded in a run's process: the
#: JAX stack and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def process_start_time() -> Optional[float]:
    """The ``time.time()`` at which this process started (Linux), or
    ``None``."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - uptime + start_ticks / hz
    except (OSError, ValueError, IndexError):
        return None


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell_of(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config_of(man: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_of(name: str, bench: Path = BENCH_DIR) -> Dict:
    return load_json(bench / "traffic" / f"{name}.json")


def runner_of(name: str, bench: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench / "runners" / f"{name}.py",
                       f"portbench_runner_{name}")


def reader_of(metric: str, bench: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench / "metrics" / f"{metric}.py",
                       f"portbench_metric_{metric.replace('.', '_')}")


def metrics_for(man: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` list only in its cells."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def loaded_forbidden() -> List[str]:
    """Modules of :data:`FORBIDDEN_MODULES` in ``sys.modules``, compared
    by their whole top-level name."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN_MODULES})


class Run:
    """What one run knows: its arguments, its cell, configuration and
    traffic, and what the runner measured and recorded (filled as the run
    goes)."""

    def __init__(self, cell: Dict, cfg: Dict, traffic: Dict, seed: int,
                 seconds: float, trace: bool, device: str, tick_impl: str):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.tick_impl = device, tick_impl
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.calls: List = []  # one record a window call (the runner's)
        self.peak_bytes: Optional[int] = None
        self.record: Dict = {}  # what the traced run recorded


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", tick_impl: str = "cuda",
             started: Optional[float] = None, root: Path = ROOT,
             bench: Path = BENCH_DIR, log=None) -> Dict:
    """One run of ``workload``; returns the result line (a dict)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    started = time.time() if started is None else started
    man = manifest(root)
    cell = cell_of(man, workload)
    cfg = config_of(man, cell["config"], root)
    traffic = traffic_of(cell["traffic"], bench)
    runner = runner_of(traffic["runner"], bench)
    run = Run(cell, cfg, traffic, seed, seconds, trace, device, tick_impl)
    runner.setup(run)
    run.setup_s = time.time() - started
    runner.window(run)
    device_info = runner.device_info(run)
    attempted, failed = runner.attempted(run)
    numbers, worst = runner.check(run)
    metrics = {}
    for m in metrics_for(man, workload, trace):
        value = reader_of(m["name"], bench).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # last, after the check and the readers: whatever the process loaded
    found = loaded_forbidden()
    if found:
        raise SystemExit(f"portbench: the run loaded {', '.join(found)}; "
                         f"nothing the benchmark runs may load "
                         f"{', '.join(FORBIDDEN_MODULES)}")
    correct = compare.is_correct(numbers)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if trace and run.record.get("breakdown"):
        line["breakdown"] = run.record["breakdown"]
    ends = [round(c["end_s"], 4) for c in run.calls if "end_s" in c]
    log(f"portbench: window {run.window_s!r} s, calls ending at {ends} s, "
        f"set-up {run.setup_s!r} s")
    for w in worst:
        log(f"portbench: widest gap {w}")
    for name, (v, lim) in numbers.items():
        log(f"portbench: {name} {v!r} limit {lim!r}")
    line["compared"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in numbers.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start_time() or time.time()

    import torch

    chips = cell_of(manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace), started=started)
    print(json.dumps(line), flush=True)
    return 0
