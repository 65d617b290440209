"""Production mesh definition, the port's counterpart of
``repro.launch.mesh``: ``DeviceMesh``es over the current process group.

``repro``'s dry run asks XLA for 512 placeholder host devices;
the port's runs on ``torch.distributed``'s ``"fake"`` backend
(:func:`fake_world`), where one process plays rank 0 of a 256- or
512-rank group and every collective returns at once without moving data.
Tests and the card see real groups (``gloo`` on the CPU, ``nccl`` on the
card) through :func:`make_debug_mesh`.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Union

import torch
import torch.distributed as dist

from repro_torch.kernels.registry import resolve_device

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def _device_type(device: Union[str, torch.device, None]) -> str:
    return resolve_device(device).type


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device, None] = None):
    """16x16 = 256 ranks a pod ``("data", "model")``; 2 pods = 512 ranks
    ``("pod", "data", "model")``, over the current process group, whose
    world size must match (:func:`fake_world` for the dry run)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device: Union[str, torch.device, None] = None):
    """A ``data x model`` mesh over the current process group (tests, the
    card at world size 1)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(device), (data, model),
                            mesh_dim_names=("data", "model"))


@contextmanager
def fake_world(world_size: int, rank: int = 0):
    """Run as ``rank`` of a ``world_size``-rank ``"fake"`` process group
    (no other process, collectives move no data), destroyed on exit. Raises
    if a process group is already up or ``torch``'s fake backend cannot be
    imported."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # pragma: no cover - torch without its test tree
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg)") from e
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
