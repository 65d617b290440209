"""Load one of the port's entry-point files (``examples/*_torch.py``,
``scripts/*_torch.py``) as a module, as the tests call its ``main``."""

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(relpath: str):
    """The file ``ROOT / relpath`` as a module named after it."""
    path = ROOT / relpath
    spec = importlib.util.spec_from_file_location(
        f"entry_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
