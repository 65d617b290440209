"""The attention and scan kernels on DTensors, and their shape-only entries
for the dry run.

DTensor has no sharding rule for a hand-written kernel, so each entry
runs it on the local shards through ``torch.distributed.tensor.
experimental.local_map``, with every placement stated:

- attention, ``q [B, h, T, hd]`` and ``k/v [B, hkv, S, hd]``: on each
  mesh dim, batch sharded (``Shard(0)`` on all three), heads sharded
  (``Shard(1)`` on q; on k and v too, or, where the kv heads do not divide
  that dim, k and v replicated: then each kv head is repeated for its
  query heads first, as ``repro``'s ``_expand_kv`` does, and sharded like
  q), or all replicated. The output takes q's placements;
- the scan, ``u, dt [B, T, D]``: on each mesh dim, batch (``Shard(0)``)
  or ``d_inner`` (``Shard(2)``) sharded, or replicated, the two placed
  alike (where one is replicated on a mesh dim and the other sharded,
  both take the shard); A ``[D, N]``
  follows ``d_inner``, B and C ``[B, T, N]`` follow the batch (they are
  redistributed there first: a projection sharded on ``d_inner`` leaves
  them partial sums). y takes u's placements, the state ``[B, D, N]`` the
  matching ones.

Any other placement raises ``ValueError``.

The shape-only entries (``impl="shape"`` at the entry points) return
uninitialised outputs of the kernel's shapes, types and device and report
its per-rank cost to :data:`COST_HOOKS` (``roofline.op_cost.OpCost``
installs one while it counts): FLOPs as
``repro``'s reference counts them, matrix products only (attention ``4 x
B x h x T x S x hd`` over all pairs, twice that for the backward's four
products; the scan none), and bytes as inputs plus outputs. Their
backward is shape-only too, so the plain scan's loop over T never runs
under the dry run. They take fake or ``meta`` tensors only and raise on a
tensor that holds data.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

#: Callables ``(name, flops, nbytes)`` that a shape-only entry reports its
#: cost to; with none installed the cost goes nowhere.
COST_HOOKS: List[Callable[[str, float, float], None]] = []


def _report(name: str, flops: float, *tensors) -> None:
    nbytes = float(sum(math.prod(t.shape) * t.element_size()
                       for t in tensors if t is not None))
    for hook in COST_HOOKS:
        hook(name, flops, nbytes)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _is_fake(t) -> bool:
    """Whether ``t`` (a DTensor by its local shard) holds no data: a fake
    or ``meta`` tensor."""
    from torch._subclasses.fake_tensor import FakeTensor

    if _is_dtensor(t):
        t = t._local_tensor
    return isinstance(t, FakeTensor) or t.device.type == "meta"


def _require_fake(*tensors) -> None:
    for t in tensors:
        if t is not None and not _is_fake(t):
            raise ValueError("a shape-only kernel entry takes fake or meta "
                             "tensors only (the dry run's); got a tensor "
                             "that holds data")


# ------------------------------------------------------------ shape-only
class _ShapeOnly(torch.autograd.Function):
    """``forward(ctx, name, out_fn, fwd_flops, bwd_flops, *tensors)``:
    ``out_fn(*tensors)`` (uninitialised outputs), its cost recorded;
    backward: uninitialised gradients of the inputs' shapes, the
    backward's cost recorded."""

    @staticmethod
    def forward(ctx, name, out_fn, fwd_flops, bwd_flops, *tensors):
        outs = out_fn(*tensors)
        flat = outs if isinstance(outs, tuple) else (outs,)
        _report(name, fwd_flops, *tensors, *flat)
        ctx.name, ctx.bwd_flops = name, bwd_flops
        ctx.metas = [(t.shape, t.dtype, t.device) for t in tensors]
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        gin = [torch.empty(s, dtype=d, device=dev) if n else None
               for (s, d, dev), n in zip(ctx.metas, ctx.needs_input_grad[4:])]
        _report(ctx.name + ".backward", ctx.bwd_flops, *grads, *gin)
        return (None, None, None, None, *gin)


def attention_shape(q, k, v, *, causal: bool = True, window: int = 0):
    """Shape-only attention: ``[B, nh, T, hd]`` in q's type."""
    _require_fake(q, k, v)
    B, nh, T, hd = q.shape
    S = k.shape[2]
    flops = 4.0 * B * nh * T * S * hd
    return _ShapeOnly.apply("flash_attention", lambda q, k, v: torch.empty_like(q),
                            flops, 2 * flops, q, k, v)


def selective_scan_shape(u, dt, A, Bm, Cm, *, return_state: bool = False):
    """Shape-only selective scan: ``y [B, T, D]`` float32 (and ``h [B, D,
    N]`` float32)."""
    _require_fake(u, dt, A, Bm, Cm)
    B, T, D = u.shape
    N = A.shape[1]

    def out(u, *_):
        y = torch.empty((B, T, D), dtype=torch.float32, device=u.device)
        if not return_state:
            return y
        return y, torch.empty((B, D, N), dtype=torch.float32, device=u.device)

    return _ShapeOnly.apply("selective_scan", out, 0.0, 0.0, u, dt, A, Bm, Cm)


def mamba_scan_shape(dA, dBu, C, *, return_state: bool = False):
    """Shape-only ``mamba_scan``: ``y [B, T, D]`` (and ``h [B, D, N]``)."""
    _require_fake(dA, dBu, C)
    B, T, D, N = dA.shape

    def out(dA, *_):
        y = torch.empty((B, T, D), dtype=torch.float32, device=dA.device)
        if not return_state:
            return y
        return y, torch.empty((B, D, N), dtype=torch.float32, device=dA.device)

    return _ShapeOnly.apply("mamba_scan", out, 0.0, 0.0, dA, dBu, C)


# -------------------------------------------------------------- DTensor
def _shard_dims(placements) -> Tuple:
    """Per mesh dim: the tensor dim sharded there, None if replicated;
    raises on a partial sum."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for p in placements:
        if isinstance(p, Shard):
            out.append(p.dim)
        elif isinstance(p, Replicate):
            out.append(None)
        else:
            raise ValueError(f"placement {p}: the kernels take sharded or "
                             f"replicated inputs only")
    return tuple(out)


def _placements_of(dims):
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if d is None else Shard(d) for d in dims]


def _expand_heads(t, group: int):
    """``[B, hkv, S, hd]`` -> ``[B, hkv * group, S, hd]``, each kv head
    repeated for its query heads (``repro``'s ``_expand_kv``)."""
    B, h, S, hd = t.shape
    return t[:, :, None].expand(B, h, group, S, hd).reshape(B, h * group, S, hd)


def sharded_attention(fn: Callable, q, k, v):
    """``fn(q, k, v)`` (a local attention) on DTensors (module notes)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    if not (_is_dtensor(k) and _is_dtensor(v)):
        raise ValueError("attention: q is a DTensor, k and v must be too")
    qd, kd, vd = (_shard_dims(t.placements) for t in (q, k, v))
    if kd != vd:
        raise ValueError(f"attention: k {k.placements} and v {v.placements} "
                         f"must be placed alike")
    for m, (a, b) in enumerate(zip(qd, kd)):
        if a not in (None, 0, 1):
            raise ValueError(f"attention: q placement {q.placements[m]} on "
                             f"mesh dim {m}: only batch (Shard(0)) or heads "
                             f"(Shard(1)) may be sharded")
        if a != b and not (a == 1 and b is None):
            raise ValueError(f"attention: q {q.placements} and k/v "
                             f"{k.placements} disagree on mesh dim {m}")
    if qd != kd:
        # kv heads that do not divide the mesh dim the query heads are
        # sharded on: each query head gets its own copy of its kv head,
        # then every rank holds the kv heads of its query heads
        group = q.shape[1] // k.shape[1]
        k, v = (_expand_heads(t, group).redistribute(mesh, q.placements)
                for t in (k, v))
    # local_map reads a list as one tensor's placements, a tuple as one a
    # output
    qp = list(q.placements)
    return local_map(fn, out_placements=qp, in_placements=(qp, qp, qp),
                     device_mesh=mesh)(q, k, v)


def sharded_scan(fn: Callable, u, dt, A, Bm, Cm, return_state: bool):
    """``fn(u, dt, A, Bm, Cm)`` (a local selective scan) on DTensors
    (module notes)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    mesh = u.device_mesh
    # u and dt take the same shards: on each mesh dim the one that is
    # sharded there (a product may leave one of them replicated)
    ud = tuple(a if a is not None else b for a, b in
               zip(_shard_dims(u.placements), _shard_dims(dt.placements)))
    for m, a in enumerate(ud):
        if a not in (None, 0, 2):
            raise ValueError(f"scan: u {u.placements} / dt {dt.placements} "
                             f"on mesh dim {m}: only batch (Shard(0)) or "
                             f"d_inner (Shard(2)) may be sharded")
    u_pl = _placements_of(ud)
    u, dt = (t if list(t.placements) == u_pl else t.redistribute(mesh, u_pl)
             for t in (u, dt))
    a_pl = _placements_of(0 if a == 2 else None for a in ud)
    bc_pl = _placements_of(0 if a == 0 else None for a in ud)
    h_pl = _placements_of({0: 0, 2: 1}.get(a) for a in ud)

    def to(t, pl):
        if not isinstance(t, DTensor):
            raise ValueError("scan: u is a DTensor, A, B and C must be too")
        return t if list(t.placements) == pl else t.redistribute(mesh, pl)

    A, Bm, Cm = to(A, a_pl), to(Bm, bc_pl), to(Cm, bc_pl)
    up = list(u.placements)  # a list: one tensor's placements (local_map)
    out_pl = (up, h_pl) if return_state else up
    return local_map(fn, out_placements=out_pl,
                     in_placements=(up, up, a_pl, bc_pl, bc_pl),
                     device_mesh=mesh)(u, dt, A, Bm, Cm)
