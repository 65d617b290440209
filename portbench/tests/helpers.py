"""A benchmark tree at a size the CPU holds: a copy of ``portbench/`` and
a manifest with one tiny cell (``tiny``: 2,000 files a site, 0.05 days,
2 cache sizes x 2 prices x 2 seeds), run on the CPU with the plain tick."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"


def tiny_tree(tmp: Path, config: str = "hcdc-cfg3-1m",
              traffic: str = "pricing216") -> Path:
    """A checkout-like root under ``tmp``: ``BENCHMARK.json`` with the cell
    ``tiny`` added, its configuration and traffic as new files. Returns
    the root."""
    root = tmp / "root"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg.update(name="tiny-cfg", files_per_site=2000, days=0.05)
    (root / "portbench" / "configs" / "tiny-cfg.json").write_text(
        json.dumps(cfg))
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    tr.update(cache_tb=[0.5, 2.0], storage_price=[0.02, 0.03])
    (root / "portbench" / "traffic" / "tiny.json").write_text(json.dumps(tr))
    man["configs"].append({"name": "tiny-cfg", "source": cfg["source"],
                           "file": "portbench/configs/tiny-cfg.json",
                           "reduced": ["days", "files_per_site"],
                           "why": "the CPU's size"})
    man["workloads"].append({"name": "tiny", "config": "tiny-cfg",
                             "traffic": "tiny", "chips": 1,
                             "why": "the CPU's size"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def run_tiny(root: Path, seed: int = 5, seconds: float = 0.1,
             trace: bool = False):
    from portbench import harness

    return harness.run_cell("tiny", seed, seconds, trace, device="cpu",
                            tick_impl="torch", root=root,
                            bench=root / "portbench", log=lambda *a: None)
