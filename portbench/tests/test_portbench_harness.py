"""The harness on the CPU at a tiny size: a cell, a configuration, a
traffic mix and a metric added as new files are found by name; the
result line's keys; nothing under ``portbench/`` imports JAX or the JAX
package; ``run.py`` without a card prints no result."""

import ast
import json
import subprocess
import sys

import pytest

from helpers import BENCH, REPO, run_tiny, tiny_tree
from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_tree(tmp_path_factory.mktemp("bench"))
    # a metric added as a new reader file and a manifest entry
    (root / "portbench" / "metrics" / "calls.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["end_to_end"].append({"name": "calls", "unit": "calls",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


@pytest.fixture(scope="module")
def line(root):
    return run_tiny(root, seed=2 ** 33 + 5)


def test_new_cell_config_traffic_and_metric_are_found(line):
    assert line["correct"] is True
    assert line["metrics"]["calls"]["value"] >= 1
    assert line["metrics"]["calls"]["unit"] == "calls"


def test_last_line_keys(line):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["attempted"] >= 8 and line["failed"] == 0
    assert set(line["metrics"]) == {"config_days_per_s", "setup_s",
                                    "calls"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, c in line["compared"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)


def test_traced_line_reports_per_layer_metrics(root):
    line = run_tiny(root, seed=17, trace=True)
    assert line["correct"] is True
    # the CPU has no device trace: only the front door's span is read
    assert set(line["metrics"]) == {"pack_ms"}
    assert list(line)[-1] == "compared"


def test_same_seed_same_calls():
    from portbench.grid import call_seeds, call_specs

    traffic = json.loads((BENCH / "traffic" / "pricing216.json")
                         .read_text())
    a = call_specs(traffic, 2 ** 40 + 3, 2)
    assert a == call_specs(traffic, 2 ** 40 + 3, 2)
    assert len(a) == 216
    seeds = {s for c in range(6) for s in call_seeds(2 ** 40 + 3, c, 2)}
    assert len(seeds) == 12


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for path in files:
        for name in imports_of(path):
            assert name.split(".", 1)[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in imports_of(path):
            assert name.split(".", 1)[0] not in FORBIDDEN | {
                "repro_torch"}, (path, name)


def test_forbidden_modules_are_matched_by_whole_top_level_name(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.sim", object())
    assert harness.loaded_forbidden() == ["repro.sim"]


def test_a_module_loaded_after_the_window_stops_the_line(tmp_path,
                                                         monkeypatch):
    """A metric reader (run after the window and the check) that imports a
    module named ``repro``: the run gives no line."""
    root = tiny_tree(tmp_path)
    fake = tmp_path / "fake"
    (fake / "repro").mkdir(parents=True)
    (fake / "repro" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(fake))
    (root / "portbench" / "metrics" / "leaky.py").write_text(
        "def read(run):\n    import repro  # noqa: F401\n    return 1.0\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["end_to_end"].append({"name": "leaky", "unit": "s",
                              "better": "lower", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    try:
        with pytest.raises(SystemExit, match="repro"):
            run_tiny(root, seed=3)
    finally:
        sys.modules.pop("repro", None)


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sweep-cfg3-pricing216", "--seed", "1", "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
