"""Argument handling the two CLIs share."""

from __future__ import annotations

import json
from typing import Any


def load_spec_doc(path: str) -> Any:
    """Read a sweep document: JSON always, YAML (``.yaml``/``.yml``) only
    where PyYAML imports. Raises ``ValueError`` (exit 2 in the CLIs) on a
    malformed file or a YAML file without PyYAML, ``OSError`` on a missing
    one."""
    with open(path) as f:
        if not path.endswith((".yaml", ".yml")):
            try:
                return json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"invalid JSON in {path}: {e}") from None
        try:
            import yaml
        except ImportError:
            raise ValueError(
                f"{path} is YAML, and the module 'yaml' (PyYAML) is not "
                "installed here; write the spec as JSON") from None
        try:
            return yaml.safe_load(f)
        except yaml.YAMLError as e:
            raise ValueError(f"invalid YAML in {path}: {e}") from None


def prebuild_kernels(tick_impl: str, device: str) -> None:
    """Build the tick's two kernel libraries together (one ``nvcc`` each,
    started at once, ``kernels/_build.py``) when the run will launch them,
    rather than one after the other at their first launch. Raises
    ``ValueError`` for ``tick_impl="cuda"`` off the card."""
    from repro_torch.kernels.registry import resolve_tick_impl

    if resolve_tick_impl(tick_impl, device).use_kernel:
        from repro_torch.kernels import _build

        _build.build(["lane_tick", "tick_glue"])
