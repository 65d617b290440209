"""Activation-sharding context: anchors DTensor propagation inside models,
the port's counterpart of ``repro.parallel.ctx``.

Model code is mesh-agnostic; step builders install a context
(:func:`sharding_ctx`) and the model calls :func:`shard_batch` at layer
boundaries. With parameters as DTensors, DTensor's propagation picks each
op's output placement from its inputs' (XLA's SPMD partitioner in
``repro``); the anchor redistributes the layer's output back to batch
sharding, so a weight sharded on its contracting dim (FSDP) is gathered
for the layer instead of the activations being replicated across the data
axis.
"""

from __future__ import annotations

import math
import types
from contextlib import contextmanager
from typing import Tuple

import torch

from repro_torch.parallel.sharding import mesh_shape, placements

# process-wide, not thread-local: autograd runs a CUDA backward, and remat's
# recompute inside it, on a device thread of its own
_CTX = types.SimpleNamespace(mesh=None, options={})


def _axes(mesh) -> Tuple[str, ...]:
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


@contextmanager
def sharding_ctx(mesh, **options):
    """Install ``mesh`` and ``options`` (``moe_local_dispatch``,
    ``no_ep``) for the models' anchors and the MoE layer, restored on
    exit. With a mesh, a plain tensor meeting a DTensor in an op (the
    positions, RoPE's tables) is taken as replicated
    (``implicit_replication``)."""
    prev = _CTX.mesh
    prev_opt = _CTX.options
    _CTX.mesh = mesh
    _CTX.options = options
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
    finally:
        _CTX.mesh = prev
        _CTX.options = prev_opt


def current_mesh():
    return _CTX.mesh


def ctx_option(name: str, default=None):
    return _CTX.options.get(name, default)


def dp_shard_count() -> int:
    mesh = current_mesh()
    if mesh is None:
        return 1
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _axes(mesh))


def reduce_partial(x):
    """``x`` with any pending partial sum reduced (its shards kept): what
    an activation whose batch cannot be sharded leaves an anchor with, and
    what a row-parallel product is reduced to before its columns are
    split. A plain tensor passes through."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def shard_batch(x):
    """Redistribute dim 0 (batch/rows) of a DTensor activation to the dp
    axes, or to ``"data"`` alone when the product of the dp axes does not
    divide it; where neither divides, only a pending partial sum is
    reduced. A plain tensor, or no mesh, passes through."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor) or x.ndim < 1:
        return x
    axes = _axes(mesh)
    if not axes:
        return x
    shape = mesh_shape(mesh)
    n = math.prod(shape[a] for a in axes)
    if n <= 1 or x.shape[0] % n != 0:
        # try the in-pod data axis alone
        if ("data" in axes and x.shape[0] % shape["data"] == 0
                and shape["data"] > 1):
            spec = ("data",) + (None,) * (x.ndim - 1)
            return x.redistribute(x.device_mesh, placements(spec, mesh))
        return reduce_partial(x)
    spec = (axes,) + (None,) * (x.ndim - 1)
    return x.redistribute(x.device_mesh, placements(spec, mesh))


def gather_fsdp(tree):
    """``tree`` (a layer's parameters) with every DTensor leaf gathered
    over the data-parallel axes, its tensor-parallel sharding kept: FSDP's
    all-gather of a layer's weights before the layer runs (its backward
    reduce-scatters the gradients). With the activations batch-sharded
    (:func:`shard_batch`) each product then has one placement that moves
    nothing, the tensor-parallel one, which DTensor picks. Without a mesh,
    or on plain tensors, ``tree`` is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = current_mesh()
    if mesh is None:
        return tree
    names = list(mesh_shape(mesh))
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]

    def one(t):
        if not isinstance(t, DTensor):
            return t
        pl = [Replicate() if i in dp and isinstance(p, Shard) else p
              for i, p in enumerate(t.placements)]
        if pl == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, pl)

    if isinstance(tree, dict):
        return {k: gather_fsdp(v) if isinstance(v, (dict, list)) else one(v)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_fsdp(v) if isinstance(v, (dict, list)) else one(v)
                for v in tree]
    return one(tree)


class _GradPlaced(torch.autograd.Function):
    """Identity forward; backward: the gradient redistributed to the
    forward's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != list(ctx.placements):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_placed(x):
    """``x``, whose gradient is redistributed to ``x``'s own placements on
    the way back (a partial sum reduced there). The vocab-parallel
    embedding needs it: DTensor cannot carry a partial gradient back
    through its masked lookup. A plain tensor passes through."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or not torch.is_grad_enabled():
        return x
    return _GradPlaced.apply(x)
