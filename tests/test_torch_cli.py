"""The port's CLIs (``python -m repro_torch.cli.run_sweep`` and
``...decide``) through ``main(argv)``: both backends on tiny grids, the
exit codes (2 with one ERROR line on a bad argument, 1 when the
cross-check disagrees, 3 on a partial result), and the process backend's
CSV and JSON against ``repro``'s CLI on the same arguments."""

import csv
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.cli import decide as decide_cli
from repro_torch.cli import run_sweep as sweep_cli
from repro_torch.core.scenarios import specs_from_mapping
from repro_torch.sim.batched import run_sweep_torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

GRID = ["--cache-tb", "5,20", "--egress", "internet,direct", "--seeds", "2",
        "--days", "0.1", "--files", "600", "--quiet"]


def _reference_script(name: str):
    """``repro``'s ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}_cli", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _errors(capsys):
    """The ERROR lines the CLI logged to stderr (its logging format,
    ``HH:MM:SS ERROR [run-id] ...``)."""
    return [ln for ln in capsys.readouterr().err.splitlines()
            if " ERROR [" in ln]


def _rows(path, drop=("wall_s",)):
    with open(path, newline="") as f:
        return [{k: v for k, v in r.items() if k not in drop}
                for r in csv.DictReader(f)]


def test_run_sweep_process_csv_and_json_equal_reference_cli(tmp_path):
    ref = _reference_script("run_sweep")
    args = GRID + ["--backend", "process", "--workers", "0", "--curves",
                   "--aggregate"]
    got = [*args, str(tmp_path / "agg.csv"), "--out",
           str(tmp_path / "got.csv"), "--json", str(tmp_path / "got.json"),
           "--pareto", str(tmp_path / "front.csv")]
    want = [*args, str(tmp_path / "ragg.csv"), "--out",
            str(tmp_path / "want.csv"), "--json", str(tmp_path / "want.json")]
    assert sweep_cli.main(got) == 0
    assert ref.main(want) == 0
    rows = _rows(tmp_path / "got.csv")
    assert len(rows) == 8 and rows == _rows(tmp_path / "want.csv")
    assert _rows(tmp_path / "agg.csv") == _rows(tmp_path / "ragg.csv")
    a, b = (json.loads((tmp_path / f).read_text())
            for f in ("got.json", "want.json"))
    assert a["series"] == b["series"] and len(a["series"]) == 8
    assert a["pareto"] == b["pareto"]
    assert [r["label"] for r in _rows(tmp_path / "front.csv")] == a["pareto"]


def test_run_sweep_torch_cpu(tmp_path, capsys):
    out = tmp_path / "t.csv"
    assert sweep_cli.main(GRID + ["--device", "cpu", "--tick-impl", "torch",
                                  "--tick", "60", "--out", str(out)]) == 0
    assert "Pareto front" in capsys.readouterr().out
    specs = specs_from_mapping({"axes": {
        "base": "III", "days": 0.1, "n_files": 600, "seed": [0, 1],
        "curves": False, "cache_tb": [5.0, 20.0],
        "egress": ["internet", "direct"]}})
    want = run_sweep_torch(specs, tick=60.0, tick_impl="torch", device="cpu")
    rows = _rows(out)
    assert [r["label"] for r in rows] == [r.spec.label for r in want.results]
    assert [float(r["jobs_done"]) for r in rows] == \
        [r.jobs_done for r in want.results]
    assert [float(r["cost_usd"]) for r in rows] == \
        [r.cost_usd for r in want.results]


def test_run_sweep_spec_file_json_and_yaml(tmp_path, monkeypatch):
    doc = {"n_files": 400, "days": 0.05,
           "scenarios": [{"base": "I", "curves": True},
                         {"base": "III", "days": 0.1}]}
    path = tmp_path / "s.json"
    path.write_text(json.dumps(doc))
    out = tmp_path / "o.csv"
    assert sweep_cli.main(["--spec", str(path), "--backend", "process",
                           "--workers", "0", "--quiet", "--out",
                           str(out)]) == 0
    assert [r["days"] for r in _rows(out)] == ["0.05", "0.1"]
    yml = tmp_path / "s.yaml"
    yml.write_text("n_files: 400\ndays: 0.05\naxes:\n  seed: [0, 1]\n")
    assert sweep_cli.main(["--spec", str(yml), "--backend", "process",
                           "--workers", "0", "--quiet", "--out",
                           str(out)]) == 0
    assert len(_rows(out)) == 2
    monkeypatch.setitem(sys.modules, "yaml", None)  # PyYAML not installed
    with pytest.raises(ValueError, match="'yaml'"):
        from repro_torch.cli._common import load_spec_doc
        load_spec_doc(str(yml))
    assert sweep_cli.main(["--spec", str(yml), "--backend", "process"]) == 2


def test_run_sweep_trace_and_device_profile(tmp_path):
    from repro_torch.obs.trace import get_tracer

    prof, trace = tmp_path / "prof", tmp_path / "trace.json"
    try:
        assert sweep_cli.main(["--backend", "process", "--workers", "0",
                               "--days", "0.05", "--files", "200",
                               "--quiet", "--trace-out", str(trace),
                               "--device-profile", str(prof),
                               "--metrics-out",
                               str(tmp_path / "m.json")]) == 0
    finally:
        get_tracer().disable()
        get_tracer().reset()
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert "run_scenario" in names
    (profile,) = prof.glob("device_trace.*.json")
    assert json.loads(profile.read_text())["traceEvents"]
    metrics = json.loads((tmp_path / "m.json").read_text())
    assert metrics["counters"]["scenario.runs"] >= 1


@pytest.mark.parametrize("argv", [
    ["--egress", "pigeon"],
    ["--spec", "/nonexistent/sweep.json"],
    ["--spec", "BAD_JSON"],
    ["--workload", ","],
    ["--workload", "steady,diurnal:amplitude=0.5"],
    ["--record-series", "6"],
    ["--tick-impl", "torch"],
    ["--device", "cpu"],
    ["--lane-chunk", "2"],
    ["--shard"],
    ["--resume"],
    ["--retries", "0"],
    ["--faults", "crash=2"],
])
def test_run_sweep_bad_arguments_exit_2(argv, tmp_path, capsys):
    argv = [tmp_path / "bad.json" if a == "BAD_JSON" else a for a in argv]
    (tmp_path / "bad.json").write_text("{not json")
    assert sweep_cli.main(["--backend", "process", "--no-cache", "--days",
                           "0.05", "--files", "100", "--quiet",
                           *map(str, argv)]) == 2
    assert len(_errors(capsys)) == 1


def test_torch_backend_without_cuda_fails_loudly(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    assert sweep_cli.main(["--days", "0.05", "--files", "100"]) == 2
    assert decide_cli.main(["--days", "0.05", "--files", "100"]) == 2
    assert decide_cli.main(["--device", "cpu", "--tick-impl", "cuda"]) == 2
    msgs = _errors(capsys)
    assert len(msgs) == 3
    assert sum("CUDA is not available" in m for m in msgs) == 2
    assert "needs a CUDA device" in msgs[2]


def test_run_sweep_partial_result_exit_3(tmp_path):
    assert sweep_cli.main(["--backend", "process", "--workers", "0",
                           "--days", "0.05", "--files", "100", "--seeds",
                           "2", "--quiet", "--retries", "1", "--faults",
                           "seed=1,crash=1.0,only=seed=1",
                           "--out", str(tmp_path / "p.csv")]) == 3
    assert [r["seed"] for r in _rows(tmp_path / "p.csv")] == ["0"]


DECIDE = ["--days", "0.1", "--files", "1000", "--cache-tb", "5,20",
          "--egress", "internet", "--storage-price", "", "--max-rounds",
          "1", "--workers", "0", "--quiet"]


def test_decide_cross_check_exit_0_then_warm(tmp_path, capsys):
    cache = str(tmp_path / "cache")
    cold, warm = tmp_path / "cold.json", tmp_path / "warm.json"
    args = DECIDE + ["--device", "cpu", "--tick-impl", "torch",
                     "--cross-check", "--cache-dir", cache]
    assert decide_cli.main(args + ["--json", str(cold)]) == 0
    assert "claim" in capsys.readouterr().out.lower()
    assert decide_cli.main(args + ["--json", str(warm)]) == 0
    a, b = (json.loads(p.read_text()) for p in (cold, warm))
    assert a["stats"]["lanes_simulated"] > 0
    assert b["stats"]["lanes_simulated"] == 0
    assert b["stats"]["configs_run"] == 0
    assert {k: v for k, v in a.items() if k != "stats"} == \
        {k: v for k, v in b.items() if k != "stats"}
    # the other side of the cross-check: the event engine as the main
    # backend, its decision points re-run on the plain torch path
    assert decide_cli.main(DECIDE + ["--backend", "process", "--device",
                                     "cpu", "--tick-impl", "torch",
                                     "--cross-check", "--cache-dir",
                                     cache]) == 0


def test_decide_cross_check_disagreement_exit_1():
    # no two engines agree to zero tolerance
    assert decide_cli.main(DECIDE + ["--backend", "process", "--device",
                                     "cpu", "--cross-check",
                                     "--check-tol-jobs", "0",
                                     "--check-tol-cost", "0"]) == 1


@pytest.mark.parametrize("argv", [
    ["--cache-tb", ""],
    ["--backend", "process", "--tick-impl", "torch"],
    ["--backend", "process", "--device", "cpu"],
    ["--backend", "process", "--lane-chunk", "2"],
    ["--backend", "process", "--shard"],
    ["--backend", "process", "--resume"],
    ["--backend", "process", "--retries", "0"],
    ["--backend", "process", "--refine", "bogus"],
])
def test_decide_bad_arguments_exit_2(argv, capsys):
    assert decide_cli.main(["--days", "0.05", "--files", "100",
                            "--no-cache", "--workers", "0", "--quiet",
                            *argv]) == 2
    assert len(_errors(capsys)) == 1


def test_python_dash_m_run_sweep(tmp_path):
    out = tmp_path / "m.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.cli.run_sweep", "--backend",
         "process", "--days", "0.05", "--files", "200", "--workers", "2",
         "--seeds", "2", "--quiet", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Pareto front" in proc.stdout
    assert len(_rows(out)) == 2
