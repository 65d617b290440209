"""Isolation and no-fallback guards of the PyTorch port.

- ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor any
  module of the JAX package ``repro`` (``repro_torch`` is the port itself);
- ``chip_smoke.py`` fails loudly without a GPU, and when it stands alone in
  a directory without the port: nonzero exit, never the ``ok`` line.
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


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
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


def _run_smoke(cwd: Path, script: Path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if sys.platform.startswith("linux"):
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


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
