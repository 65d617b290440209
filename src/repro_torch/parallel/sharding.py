"""Sharding rules: parameter-tree paths -> partition specs on the production
mesh, the port's counterpart of ``repro.parallel.sharding``.

Mesh axes (see ``repro_torch.launch.mesh``): optional ``pod`` (cross-pod
data parallel), ``data`` (in-pod data parallel / FSDP / sequence),
``model`` (tensor/expert parallel).

Parallelism modes composed here, as in ``repro``:
- TP: heads / ffn / vocab / experts / d_inner -> "model".
- DP: batch -> ("pod", "data").
- FSDP (ZeRO-3): the non-TP weight axis additionally -> ("pod", "data")
  for large archs (plan.fsdp).
- ZeRO-1/2: optimizer state and gradients take the parameters' specs with
  the FSDP axis on, so state bytes scale 1/chips.
- SP: long-context decode shards global-layer KV caches over "data".
- EP: the MoE expert dim of the ``[E, C, d]`` dispatch buffer -> "model".

A spec is a :class:`PartitionSpec`, a tuple with one entry a tensor dim:
None (replicated), a mesh axis name, or a tuple of names (the dim split
over those axes in order, the first outermost). :func:`placements` turns
it into DTensor placements (``Shard``/``Replicate`` a mesh dim).
``repro``'s ``NamedSharding`` trees are these specs, or their placements
on a ``DeviceMesh``.

The rules read a mesh through :func:`mesh_shape` only: a
``torch.distributed`` ``DeviceMesh`` with named dims, or any object with
``shape`` (axis -> size), ``axis_names`` and ``size``, as ``repro``'s
rules read a duck-typed mesh. Paths are the port's per-layer ones
(``layers/<i>/attn/wq``): the rules count dims from the end, so a spec is
``repro``'s stacked one without its leading ``[L]`` entry.

The sweep's layout lives here too: :func:`lane_mesh` and
:data:`LANES_AXIS`, the one-axis ``"lanes"`` mesh over the local devices
that ``repro_torch.sim.batched`` deals contiguous blocks of scenario lanes
over (``run_sweep(..., shard=True)``).

:func:`plan_for` with no mesh keeps the single-card rules that training
on one card reads (no FSDP, one microbatch); with a mesh it is
``repro``'s.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, Optional, Sequence, Tuple, Union

import torch

if TYPE_CHECKING:  # models import the context, which imports this module
    from repro_torch.models.config import ModelConfig

DP_AXES = ("pod", "data")  # flattened data-parallel axes (pod may be absent)

#: Mesh axis name of the sweep's scenario-lane dimension
#: (``repro_torch.sim.batched``: one lane = one scenario; lanes never
#: interact).
LANES_AXIS = "lanes"

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry a tensor dim: None, an axis name or a tuple of names
    (``jax.sharding.PartitionSpec``'s meaning)."""

    def __new__(cls, *dims: Axis):
        return super().__new__(cls, dims)


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of ``mesh``: a named ``DeviceMesh`` or a
    duck-typed mesh with ``shape`` as a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


@dataclass(frozen=True)
class LaneMesh:
    """The sweep's one-axis ``"lanes"`` mesh: the devices lanes are dealt
    over, one contiguous block of lanes a device, in this order."""

    devices: Tuple[torch.device, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (LANES_AXIS,)

    @property
    def shape(self) -> Dict[str, int]:
        return {LANES_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def lane_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              device_type: str = "cuda") -> LaneMesh:
    """One-axis ``"lanes"`` mesh for the batched sweep.

    The sweep's lane dimension is embarrassingly parallel (lanes never
    interact), so its mesh is the degenerate one-axis case of the model
    meshes above, with no collective. ``n_devices`` takes the first N
    local devices of ``device_type`` (default: all visible CUDA devices;
    the CPU is one device); ``devices`` supplies an explicit list
    instead."""
    if devices is None:
        if device_type == "cuda":
            local = [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
        elif device_type == "cpu":
            local = [torch.device("cpu")]
        else:
            raise ValueError(f"lane_mesh: unsupported device type "
                             f"{device_type!r} (expected cuda or cpu)")
        if n_devices is not None:
            if n_devices > len(local):
                raise ValueError(
                    f"lane_mesh: {n_devices} devices requested but only "
                    f"{len(local)} local devices are visible")
            local = local[:n_devices]
        devices = local
    elif n_devices is not None and n_devices != len(devices):
        raise ValueError("pass n_devices or devices, not both")
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("lane_mesh needs at least one device")
    return LaneMesh(devices)


@dataclass(frozen=True)
class ParallelPlan:
    """Per-(arch x shape) distribution decisions (``repro``'s fields)."""

    fsdp: bool = False            # shard weights' non-TP axis over data
    microbatches: int = 1         # grad-accumulation steps in train_step
    seq_shard_cache: bool = False # long-context: shard KV cache seq over data
    shard_activation_seq: bool = False  # Megatron-SP style boundary sharding
    remat_policy: str = "nothing" # "nothing" | "dots" (perf knob)
    optimizer: str = "adamw"      # "adamw" | "adafactor"
    grad_accum_dtype: str = "f32" # "f32" | "bf16": the microbatch sum's type
    attn_chunk_threshold: int = 0 # >0: override chunked-attention threshold
    moe_local_dispatch: bool = False  # shard-local dispatch + explicit A2A
    no_ep: bool = False           # replicate experts (small-expert archs):
                                  # routing stays shard-local, zero A2A


def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_shape(mesh)
    return tuple(a for a in DP_AXES if a in names)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in dp_axes(mesh))


def tp_size(mesh) -> int:
    return int(mesh_shape(mesh)["model"])


def _fits(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


# --------------------------------------------------------------------- rules
# (path regex, per-dim logical axes). Dims counted from the END of the shape,
# so a leading stack dim never matters. Tokens: "tp" (model), "fsdp" (data
# axes when plan.fsdp), "ep"/"tp_ff" (experts or their ffn dim on model),
# None (replicated).
_PARAM_RULES = [
    (r"embed$", ("tp", "fsdp")),              # [V, d] vocab-parallel
    (r"lm_head$", ("fsdp", "tp")),            # [d, V]
    (r"frontend_proj$", (None, "tp")),
    (r"attn/wq$", ("fsdp", "tp", None)),      # [d, nh, hd]
    (r"attn/wk$", ("fsdp", "tp", None)),
    (r"attn/wv$", ("fsdp", "tp", None)),
    (r"attn/wo$", ("tp", None, "fsdp")),      # [nh, hd, d]
    (r"cross/wq$", ("fsdp", "tp", None)),
    (r"cross/wk$", ("fsdp", "tp", None)),
    (r"cross/wv$", ("fsdp", "tp", None)),
    (r"cross/wo$", ("tp", None, "fsdp")),
    (r"(attn|cross)/b[qkv]$", ("tp", None)),
    (r"mlp/w_gate$", ("fsdp", "tp")),         # [d, f]
    (r"mlp/w_up$", ("fsdp", "tp")),
    (r"mlp/w_down$", ("tp", "fsdp")),         # [f, d]
    (r"dense_mlp/w_gate$", ("fsdp", "tp")),
    (r"dense_mlp/w_up$", ("fsdp", "tp")),
    (r"dense_mlp/w_down$", ("tp", "fsdp")),
    (r"moe/router$", ("fsdp", None)),         # [d, E]
    (r"moe/w_gate$", ("ep", "fsdp", "tp_ff")),  # [E, d, f]
    (r"moe/w_up$", ("ep", "fsdp", "tp_ff")),
    (r"moe/w_down$", ("ep", "tp_ff", "fsdp")),  # [E, f, d]
    (r"ssm/in_proj$", ("fsdp", "tp")),        # [d, 2di]
    (r"ssm/conv_w$", (None, "tp")),           # [K, di]
    (r"ssm/conv_b$", ("tp",)),
    (r"ssm/x_proj$", ("tp", None)),           # [di, dtr+2n]
    (r"ssm/dt_proj_w$", (None, "tp")),        # [dtr, di]
    (r"ssm/dt_proj_b$", ("tp",)),
    (r"ssm/A_log$", ("tp", None)),            # [di, N]
    (r"ssm/D$", ("tp",)),
    (r"ssm/out_proj$", ("tp", "fsdp")),       # [di, d]
    (r"norm", (None,)),                        # any norm scale: replicated
]


def _resolve_axis(token: Optional[str], dim: int, mesh,
                  plan: ParallelPlan) -> Axis:
    if token is None:
        return None
    if token in ("tp", "ep", "tp_ff"):
        # EP shards experts on "model"; tp_ff is the fallback for the expert
        # ffn dims (unused when "ep" applies: only one of them gets "model").
        if plan.no_ep and token in ("ep", "tp_ff"):
            return None  # fully replicated experts (dispatch stays local)
        return "model" if _fits(dim, tp_size(mesh)) else None
    if token == "fsdp":
        if not plan.fsdp:
            return None
        return dp_axes(mesh) if _fits(dim, dp_size(mesh)) else None
    raise ValueError(token)


def spec_for_param(path_s: str, shape: Tuple[int, ...], mesh,
                   plan: ParallelPlan) -> PartitionSpec:
    for pat, tokens in _PARAM_RULES:
        if re.search(pat, path_s):
            ndims = len(shape)
            spec: list = [None] * ndims
            offset = ndims - len(tokens)  # leading stack dims replicated
            if offset < 0:
                return P()
            used: set = set()
            ep_applied = any(
                t == "ep" and _fits(shape[offset + i], tp_size(mesh))
                for i, t in enumerate(tokens))
            for i, tok in enumerate(tokens):
                if tok == "tp_ff" and ep_applied:
                    continue  # experts already consume the model axis
                if tok == "ep" and not ep_applied:
                    continue
                ax = _resolve_axis(tok, shape[offset + i], mesh, plan)
                if ax is None:
                    continue
                flat = ax if isinstance(ax, tuple) else (ax,)
                if any(a in used for a in flat):
                    continue  # an axis may shard only one dim
                used.update(flat)
                spec[offset + i] = ax
            return P(*spec)
    return P()


def tree_paths(tree, prefix: str = ""):
    """``(path, leaf)`` of every tensor leaf of a params/cache tree in
    order: dict keys and list indices joined by ``/``, as ``repro``'s
    ``_path_str``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def map_with_path(fn, tree, prefix: str = ""):
    """``tree`` with every leaf (anything with a ``shape``: a tensor, a
    ``launch.shapes.Spec``) replaced by ``fn(path, leaf)``; None kept."""
    if hasattr(tree, "shape"):
        return fn(prefix[:-1], tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        return tuple(map_with_path(fn, v, f"{prefix}{i}/")
                     for i, v in enumerate(tree))
    if tree is None:
        return None
    raise TypeError(f"{prefix[:-1] or 'tree'}: unexpected leaf {type(tree).__name__}")


def param_shardings(mesh, plan: ParallelPlan, params_shape) -> Any:
    """The spec of every leaf of ``params_shape`` (a tree of anything with
    ``.shape``: tensors, meta tensors)."""
    return map_with_path(
        lambda path, leaf: spec_for_param(path, tuple(leaf.shape), mesh, plan),
        params_shape)


# ----------------------------------------------------------------- activations
def batch_spec(mesh, batch_size: int) -> PartitionSpec:
    shape = mesh_shape(mesh)
    axes = list(dp_axes(mesh))
    # use the largest prefix of (pod, data) that divides the batch
    while axes and batch_size % math.prod(shape[a] for a in axes):
        axes.pop()
    return P(tuple(axes)) if axes else P()


def batch_shardings(mesh, batch_tree) -> Any:
    return map_with_path(lambda _, leaf: batch_spec(mesh, leaf.shape[0]),
                         batch_tree)


def cache_shardings(mesh, plan: ParallelPlan, cfg: ModelConfig,
                    cache_tree) -> Any:
    """KV/SSM cache specs for serving.

    kv k/v: [B, S, nkv, hd] — B over dp if divisible; else (long-context
    batch=1) S over "data" when plan.seq_shard_cache; nkv over "model" when
    divisible, else S over "model". ssm h: [B, di, N] — di over "model".
    conv: [B, K-1, di]. The port's cache paths are
    ``layers/<i>/kv/k`` and ``cross_kv/<i>/<0|1>``."""
    data = mesh_shape(mesh).get("data", 1)

    def one(ps: str, leaf):
        shape = tuple(leaf.shape)
        if re.search(r"kv/(k|v)$", ps) or re.search(r"cross_kv", ps):
            off = len(shape) - 4
            if off < 0:
                return P()
            b, s, nkv = shape[off], shape[off + 1], shape[off + 2]
            spec: list = [None] * len(shape)
            baxes = batch_spec(mesh, b)
            spec[off] = baxes[0] if len(baxes) else None
            if (spec[off] is None and plan.seq_shard_cache
                    and _fits(s, data)):
                spec[off + 1] = "data"  # SP: distributed flash-decode
            if _fits(nkv, tp_size(mesh)):
                spec[off + 2] = "model"
            elif _fits(s, tp_size(mesh)) and spec[off + 1] is None:
                # kv heads don't divide TP: shard the sequence over "model"
                spec[off + 1] = "model"
            return P(*spec)
        if re.search(r"ssm/h$", ps):
            off = len(shape) - 3
            spec = [None] * len(shape)
            baxes = batch_spec(mesh, shape[off])
            spec[off] = baxes[0] if len(baxes) else None
            if _fits(shape[off + 1], tp_size(mesh)):
                spec[off + 1] = "model"
            return P(*spec)
        if re.search(r"ssm/conv$", ps):
            off = len(shape) - 3
            spec = [None] * len(shape)
            baxes = batch_spec(mesh, shape[off])
            spec[off] = baxes[0] if len(baxes) else None
            if _fits(shape[off + 2], tp_size(mesh)):
                spec[off + 2] = "model"
            return P(*spec)
        return P()

    return map_with_path(one, cache_tree)


def placements(spec: Sequence[Axis], mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): for
    each mesh dim, ``Shard(d)`` where tensor dim d names it, else
    ``Replicate()``. A dim split over several axes is sharded over each in
    mesh order, which is ``repro``'s order for ``("pod", "data")``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is None:
                continue
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Sequence[Axis], mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``
    (every sharded dim divides, as the rules check)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out[d] //= sizes[a]
    return tuple(out)


def expert_sharder(mesh):
    """Placement of the MoE ``[E, C, d]`` dispatch buffer (EP): experts on
    "model" where they divide it."""

    def shard(buf):
        from torch.distributed.tensor import DTensor

        if not isinstance(buf, DTensor) or not _fits(buf.shape[0], tp_size(mesh)):
            return buf
        return buf.redistribute(mesh, placements(P("model", None, None), mesh))

    return shard


def activation_seq_sharder(mesh, plan: ParallelPlan):
    """Megatron-SP style: shard the sequence dim of layer-boundary
    activations over "model" (None unless the plan asks for it)."""

    if not plan.shard_activation_seq:
        return None

    def shard(x):  # x: [B, T, d]
        from torch.distributed.tensor import DTensor

        if (isinstance(x, DTensor) and x.ndim == 3
                and _fits(x.shape[1], tp_size(mesh))):
            baxes = batch_spec(mesh, x.shape[0])
            b0 = baxes[0] if len(baxes) else None
            return x.redistribute(mesh, placements(P(b0, "model", None), mesh))
        return x

    return shard


# --------------------------------------------------------------------- plans
def plan_for(cfg: ModelConfig, shape_name: Optional[str] = None,
             mesh=None) -> ParallelPlan:
    """Without a mesh: the single-card rules (Adafactor above 200 B
    parameters, microbatch gradients summed in bf16, one microbatch: the
    caller sizes the batch). With one: ``repro``'s defaults, shard-local
    MoE dispatch, expert replication for small-expert MoE (no_ep) and
    FSDP for large archs, with ``train_4k``'s microbatches sized from the
    data-parallel width."""
    params_b = cfg.param_count() * 2  # bf16 bytes
    if mesh is None:
        return ParallelPlan(
            microbatches=1,
            optimizer="adafactor" if params_b > 200e9 * 2 else "adamw",
            grad_accum_dtype="bf16")
    n_dev = mesh_size(mesh)
    big = params_b / n_dev > 2e9  # > ~2 GB/device of raw weights under TP-only
    # total expert weight bytes decide EP vs replication
    expert_b = (cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff * 2
                if cfg.family == "moe" else 0)
    is_decode = shape_name in ("decode_32k", "long_500k")
    no_ep = cfg.family == "moe" and expert_b < 30e9
    plan = ParallelPlan(
        # no_ep replicates expert weights -> FSDP-shard them for memory
        fsdp=big or params_b > 60e9 * 2 or no_ep,
        microbatches=1,
        optimizer="adafactor" if params_b > 200e9 * 2 else "adamw",
        grad_accum_dtype="bf16",
        # decode steps (<= a few tokens/shard) keep the global path
        moe_local_dispatch=cfg.family == "moe" and not is_decode,
        no_ep=no_ep,
    )
    if shape_name == "train_4k":
        gb = 256
        if cfg.family == "moe":
            micro = 4 if no_ep else 8
        else:
            # per-device microbatch of 1 row keeps activations small
            micro = max(1, gb // dp_size(mesh))
        plan = dataclasses.replace(plan, microbatches=micro)
    if shape_name == "long_500k":
        plan = dataclasses.replace(plan, seq_shard_cache=True)
    return plan


def _contiguous_strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def shard_tree(tree, mesh, specs):
    """``tree``'s tensors (each whole, the same on every rank, real or
    fake) as DTensors on ``mesh`` under ``specs`` (a tree of specs of the
    same layout): each rank keeps its own shard, cut locally, with no
    collective. Shards split over several mesh dims are cut in mesh
    order, as DTensor nests them."""
    from torch.distributed.tensor import DTensor, Shard

    def one(path, t):
        spec = specs
        for k in path.split("/") if path else ():
            spec = spec[k] if isinstance(spec, dict) else spec[int(k)]
        pl = placements(spec, mesh)
        local = t
        for m, p in enumerate(pl):
            if isinstance(p, Shard):
                local = local.chunk(mesh.size(m), p.dim)[mesh.get_local_rank(m)]
        # a copy of its own: a chunk of the whole tensor would keep the
        # whole storage alive
        local = local.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, mesh, pl,
                                  run_check=False, shape=t.shape,
                                  stride=_contiguous_strides(t.shape))

    return map_with_path(one, tree)
