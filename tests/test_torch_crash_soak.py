"""``scripts/crash_soak_torch.py`` on the CPU at a tiny grid.

The soak runs as a user runs it (a subprocess, ``--keep`` so its scratch
directory stays in this test's temporary directory): the kill+resume
phase and the fault soak through ``python -m repro_torch.cli.run_sweep``,
on the plain tick (``--backend torch --device cpu``) and on the event
engine (``--backend process``). Asserted: the exit code, the last line's
numbers and the resumed run's JSON (every config, no failures), never
where the kill landed, which depends on this machine's speed.
"""

import json
import os
import subprocess
import sys

import pytest

from torch_entry_points import ROOT

GRID = ["--days", "0.25", "--files", "200", "--cache-tb", "5,20",
        "--seeds", "2", "--kill-after", "3"]
BACKENDS = {"torch": ["--backend", "torch", "--device", "cpu",
                      "--tick-impl", "torch"],
            "process": ["--backend", "process"]}


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_crash_soak_passes_on_the_cpu(tmp_path, backend):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("PYTHONPATH", None)  # the script finds the port itself
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "crash_soak_torch.py"),
         *GRID, *BACKENDS[backend], "--keep"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0 and got["resume_rc"] == 0 and got["fault_rc"] == 0
    assert got["resume_rows"] == got["expected_rows"] == 4
    assert got["fault_rows"] == 4
    assert got["scratch"].startswith(str(tmp_path))
    with open(got["resume_json"]) as f:
        doc = json.load(f)
    assert len(doc["rows"]) == 4 and not doc.get("failures")
    assert doc["cache_hits"] == got["cache_hits"]
    assert doc["cache_hits"] + doc["lanes_simulated"] >= 1
    labels = sorted(r["label"] for r in doc["rows"])
    assert labels == sorted(f"cfgIII,cache={c}TB,egress=internet,seed={s}"
                            for c in (5, 20) for s in (0, 1))
