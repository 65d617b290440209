"""Per-rank cost of a traced step: the port's counterpart of
``repro.roofline.hlo_cost`` (which parses XLA's HLO text, so it is not
copied).

:class:`OpCost` is a ``TorchDispatchMode``. Put it on top of a
``FakeTensorMode`` (nothing is allocated or computed) and run one step:
parameters and activations as DTensors over a (fake) ``DeviceMesh``, or
plain tensors without a mesh. The mode steps aside for every op on a
DTensor (it returns ``NotImplemented``), so it sees the ops DTensor runs
on each rank's local shards, the collectives of its redistributions
included: every number is one rank's. DTensor's own shape propagation
(an op re-run on fake tensors of the global shapes) is not counted.

:meth:`OpCost.result` returns ``repro``'s ``analyze_hlo`` keys:

- ``flops``: matrix products only, ``2 x M x N x K`` each (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``), as ``hlo_cost`` counts dots, plus what
  the kernels' shape-only entries report (``kernels.sharded.COST_HOOKS``,
  where the mode installs its hook while it counts: attention ``4 x B x h
  x T x S x hd`` forward, the scan 0);
- ``bytes_accessed``: each op's tensor inputs plus its outputs, views and
  allocations not counted. This is unfused: every elementwise op reads
  and writes its tensors, where XLA's fusions count a fused region's
  boundary once, so it is larger than ``hlo_cost``'s count, and no
  tolerance against it is claimed;
- ``collective_wire_bytes``, ``collective_per_kind``,
  ``collective_counts``: the functional collectives, each buffer weighted
  by ``roofline.analysis``'s ring factors for its group's size (the mesh
  dimension it runs over).

It also tracks one rank's live bytes: :meth:`OpCost.track` registers the
step's arguments, every op's outputs are tracked until their storage is
freed, and ``peak_bytes`` is the high-water mark.

One mode counts at a time: entering a second raises. While it counts it
shadows DTensor's shape propagation on the process's sharding propagator
(an instance attribute over ``_propagate_tensor_meta_non_cached``, a
private method of torch's), and puts back what was there when it exits.
The counts follow DTensor's strategy choices, which differ between torch
versions: compare records of one version only (``launch.dryrun`` writes
it into each).
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.roofline.analysis import collective_bytes

aten = torch.ops.aten

_MATMUL = {aten.mm.default, aten.addmm.default, aten.bmm.default,
           aten.baddbmm.default}

#: Ops that move no data of their own.
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.detach.default, aten.lift_fresh.default}

#: Functional collective -> (repro's kind, the buffer its wire bytes
#: scale: "in" or "out").
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "all_reduce": ("all-reduce", "in"),
    "all_reduce_coalesced": ("all-reduce", "in"),
    "all_to_all_single": ("all-to-all", "in"),
}

_ACTIVE: List["OpCost"] = []  # the mode that counts, at most one

_PROPAGATE = "_propagate_tensor_meta_non_cached"
_MISSING = object()


@contextmanager
def repeated(n: int):
    """Count what runs inside ``n`` times over in the active
    :class:`OpCost` (a loop whose body runs once in the trace: ``hlo_cost``
    multiplies a while body by its trip count the same way). Live bytes
    are not scaled."""
    for c in _ACTIVE:
        c.scale *= n
    try:
        yield
    finally:
        for c in _ACTIVE:
            c.scale /= n


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


class OpCost(TorchDispatchMode):
    """Count one rank's FLOPs, bytes, collectives and live bytes (module
    notes)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[Dict[str, Any]] = []
        self.kernels: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._shadow = 0
        self._prop = None
        self._saved = _MISSING
        self.scale = 1.0

    # -- live bytes
    def track(self, tree) -> int:
        """Track every tensor of ``tree`` (DTensors by their local shard)
        as live; returns the bytes newly tracked."""
        from torch.distributed.tensor import DTensor

        added = 0
        for t in tree_flatten(tree)[0]:
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                added += self._track_one(t)
        return added

    def _track_one(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- kernels
    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        """A shape-only entry's cost (``kernels.sharded.COST_HOOKS``)."""
        self.flops += flops * self.scale
        self.bytes += nbytes * self.scale
        self.kernels[name] = self.kernels.get(name, 0) + int(self.scale)

    # -- mode
    def __enter__(self):
        from torch.distributed.tensor import DTensor

        from repro_torch.kernels.sharded import COST_HOOKS

        if _ACTIVE:
            raise RuntimeError("OpCost does not nest: another one is "
                               "counting")
        prop = DTensor._op_dispatcher.sharding_propagator
        inner = getattr(prop, _PROPAGATE)

        def shadowed(op_schema):
            self._shadow += 1
            try:
                return inner(op_schema)
            finally:
                self._shadow -= 1

        self._saved = prop.__dict__.get(_PROPAGATE, _MISSING)
        setattr(prop, _PROPAGATE, shadowed)
        self._prop = prop
        _ACTIVE.append(self)
        COST_HOOKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels.sharded import COST_HOOKS

        COST_HOOKS.remove(self._kernel)
        _ACTIVE.remove(self)
        if self._saved is _MISSING:
            delattr(self._prop, _PROPAGATE)  # the class's method again
        else:
            setattr(self._prop, _PROPAGATE, self._saved)
        self._prop, self._saved = None, _MISSING
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        ns = func.namespace
        if ns == "_c10d_functional":
            self._collective(func, args, out)
        elif ns == "aten" and not func.is_view and func not in _FREE:
            ins = tree_flatten((args, kwargs))[0]
            outs = tree_flatten(out)[0]
            self.bytes += self.scale * (sum(map(_nbytes, ins))
                                        + sum(map(_nbytes, outs)))
            if func in _MATMUL:
                self.flops += self.scale * self._matmul_flops(func, args, out)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and not func.is_view:
                self._track_one(t)
        return out

    @staticmethod
    def _matmul_flops(func, args, out) -> float:
        a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) else args[0]
        return 2.0 * out.numel() * a.shape[-1]

    def _collective(self, func, args, out) -> None:
        name = func._schema.name.split("::")[-1]
        if name in ("wait_tensor",):
            return
        if name not in _COLLECTIVES:
            raise NotImplementedError(f"op_cost: no wire model for {func}")
        kind, which = _COLLECTIVES[name]
        group = args[-1]
        buf = tree_flatten(out if which == "out" else args[0])[0]
        self.collectives.append({
            "kind": kind, "group_size": _group_size(group),
            "bytes": self.scale * sum(map(_nbytes, buf)), "op": name,
            "times": self.scale})

    def result(self) -> Dict[str, Any]:
        """``analyze_hlo``'s keys for what was counted (module notes)."""
        coll = collective_bytes(self.collectives)
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes,
            "collective_wire_bytes": coll["total_wire_bytes"],
            "collective_per_kind": coll["per_kind"],
            "collective_counts": coll["count"],
            "kernels": dict(self.kernels),
            "peak_bytes": self.peak,
        }


def local_nbytes(tree) -> int:
    """Bytes of one rank's shards of every tensor of ``tree``."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t._local_tensor
        total += _nbytes(t)
    return total
