"""Isolation and no-fallback guards of the PyTorch port.

- ``src/repro_torch``, ``chip_smoke.py``, the port's examples
  (``examples/*_torch.py``) and its scripts (``scripts/*_torch.py`` and
  every other script under ``scripts/`` that imports ``repro_torch``)
  import neither ``jax`` nor any module of the JAX package ``repro``
  (``repro_torch`` is the port itself);
- ``chip_smoke.py`` fails loudly without a GPU, and when it stands alone in
  a directory without the port: nonzero exit, never the ``ok`` line;
- each entry point with a device (the serve, train and decision examples
  and the crash soak) fails loudly without a GPU unless given ``--device
  cpu``: nonzero exit and the reason on stderr.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


#: The port's entry points that run on a device, with the arguments that
#: keep a run small where it would start.
DEVICE_ENTRY_POINTS = {
    "examples/serve_small_torch.py": [],
    "examples/train_with_hcdc_pipeline_torch.py": ["--steps", "1"],
    "examples/sweep_decision_torch.py": [],
    "scripts/crash_soak_torch.py": ["--kill-after", "0"],
}


def _port_scripts():
    """The port's examples and scripts: every ``*_torch.py`` under
    ``examples/`` and ``scripts/``, and every other script that imports
    ``repro_torch``."""
    files = sorted((ROOT / "examples").glob("*_torch.py"))
    for path in sorted((ROOT / "scripts").glob("*.py")):
        if path.stem.endswith("_torch") or any(
                mod.split(".")[0] == "repro_torch"
                for mod in _imported_modules(path)):
            files.append(path)
    return files


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [SMOKE] + _port_scripts()
    assert len(files) > 10
    return files


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative imports stay inside the port
                continue
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ml_dtypes", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def _run_smoke(cwd: Path, script: Path, *args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if sys.platform.startswith("linux"):
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(script), *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_port_scripts_are_covered():
    names = {str(p.relative_to(ROOT)) for p in _port_scripts()}
    assert set(DEVICE_ENTRY_POINTS) <= names
    assert {"examples/quickstart_torch.py",
            "scripts/perf_iterations_torch.py",
            "scripts/make_experiments_tables_torch.py",
            "scripts/bench_tick.py", "scripts/cross_check_engines.py",
            "scripts/trace_wait_select.py"} <= names
    assert not names & {"scripts/crash_soak.py", "scripts/run_sweep.py",
                        "examples/quickstart.py"}


@pytest.mark.parametrize("entry", sorted(DEVICE_ENTRY_POINTS))
def test_entry_point_fails_without_a_gpu(entry):
    proc = _run_smoke(ROOT, ROOT / entry, *DEVICE_ENTRY_POINTS[entry])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "Traceback" in proc.stderr


def test_chip_smoke_fails_without_a_gpu():
    proc = _run_smoke(ROOT, SMOKE)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, lone)
    proc = _run_smoke(tmp_path, lone)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
