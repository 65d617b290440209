"""Kernel-selection registry: the ``tick_impl`` axis and the device rule.

One name selects how the batched tick program (``repro_torch.sim.batched``)
runs its three hot pieces and the glue between them:

- ``"torch"``: the plain PyTorch versions (``kernels/lane_tick/ref.py``,
  ``kernels/tick_glue/ref.py``) — the oracle, on any device;
- ``"cuda"``: the hand-written CUDA kernels (``kernels/lane_tick/csrc``,
  and the glue between them, ``kernels/tick_glue/csrc``);
  a CUDA device is required, and asking for them on the CPU raises;
- ``"auto"``: ``"cuda"`` on a CUDA device, ``"torch"`` on the CPU.

Devices follow one rule (:func:`resolve_device`): an entry point given no
device runs on ``cuda`` and raises when CUDA is absent; it runs on the CPU
only when the caller passes ``device="cpu"``. Nothing falls back quietly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import torch


@dataclass(frozen=True)
class TickImpl:
    """One resolved tick-engine implementation (``use_kernel``: run the
    hand-written CUDA kernels instead of the plain PyTorch versions)."""

    name: str
    use_kernel: bool


TICK_IMPLS = {
    "torch": TickImpl("torch", use_kernel=False),
    "cuda": TickImpl("cuda", use_kernel=True),
}

#: Valid ``tick_impl=`` values, the ``"auto"`` alias included.
TICK_IMPL_CHOICES: Tuple[str, ...] = ("auto",) + tuple(TICK_IMPLS)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when ``device`` is None,
    and a ``RuntimeError`` when CUDA is then (or explicitly asked for and)
    not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on a CUDA device by "
            "default; pass device='cpu' to run the plain PyTorch version "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s} (expected cuda or cpu)")
    return dev


def resolve_tick_impl(name: str = "auto",
                      device: Union[str, torch.device, None] = None) -> TickImpl:
    """Resolve a ``tick_impl`` name for ``device`` (see module notes).

    Unknown names raise ``ValueError``; ``"cuda"`` on a non-CUDA device
    raises ``ValueError`` too.
    """
    if isinstance(name, TickImpl):
        name = name.name
    if name not in TICK_IMPL_CHOICES:
        raise ValueError(f"unknown tick_impl {name!r} "
                         f"(expected one of {', '.join(TICK_IMPL_CHOICES)})")
    dev = resolve_device(device)
    if name == "auto":
        name = "cuda" if dev.type == "cuda" else "torch"
    if name == "cuda" and dev.type != "cuda":
        raise ValueError(f"tick_impl='cuda' needs a CUDA device, got {dev!s}")
    return TICK_IMPLS[name]
