"""Mixture-of-Experts layer with capacity-bucketed dispatch, the port's
counterpart of ``repro.models.moe``.

Router: float32 softmax, top-k, gates renormalised, and the Switch
load-balancing auxiliary loss (returned for training; serving drops it).
Dispatch groups the token assignments by expert through a stable sort and
writes them into a dense ``[E, C+1, d]`` buffer (capacity ``C``); an
assignment past an expert's capacity goes to the dead column ``C``. Each
live ``(expert, slot)`` receives exactly one token and is written, not
accumulated, so the buffer is the same on every run; the dead column is
zeroed after the write (``repro`` sums the dropped tokens into it and
zeroes it before the gather, so neither keeps them). The three expert
products run as batched matrix products over the experts, as ``repro``'s
einsums do outside any Pallas kernel.

arctic-480b also has a parallel dense residual MLP (``moe_dense_ff``),
added to the MoE output.

On a mesh (``parallel.ctx.sharding_ctx``, activations and weights as
DTensors), ``ctx_option("moe_local_dispatch")`` takes
:func:`_moe_local_dispatch`: the tokens reshaped to ``[S, T/S, d]`` with
S the data-parallel shard count, each shard's sort, ``searchsorted`` and
scatter run on its own rows (``local_map``: DTensor has no rule for
them), per-shard ``[S, E, C+1, d]`` buffers, and the transpose to ``[E,
S(C+1), d]`` with the experts on ``"model"`` (EP) or, with ``no_ep``,
everything left on the data shards. Its arithmetic is
:func:`local_dispatch` on plain tensors for a given S. The global path
takes the ``shard_experts`` hook (``parallel.sharding.expert_sharder``)
on its ``[E, C+1, d]`` buffers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import dense_init, init_mlp, swiglu

Params = Dict[str, torch.Tensor]


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": dense_init(generator, (d, e), in_axis_size=d,
                             dtype=torch.float32),
        "w_gate": dense_init(generator, (e, d, f), in_axis_size=d, dtype=cfg.dtype),
        "w_up": dense_init(generator, (e, d, f), in_axis_size=d, dtype=cfg.dtype),
        "w_down": dense_init(generator, (e, f, d), in_axis_size=f, dtype=cfg.dtype),
    }
    if cfg.moe_dense_ff:
        p["dense_mlp"] = init_mlp(generator, d, cfg.moe_dense_ff, cfg.dtype)
    return p


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits: [T, E] -> (gates [T, k] float32, idx [T, k] int64, aux_loss
    scalar). ``torch.topk`` takes the largest probabilities first, as
    ``jax.lax.top_k``."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    E = logits.shape[-1]
    me = probs.mean(0)  # mean router prob per expert
    ce = F.one_hot(idx, E).float().sum(1).mean(0) / k  # fraction of tokens per expert
    return gates, idx, E * (me * ce).sum()


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert has for ``n_tokens`` tokens: ``repro``'s formula in
    Python floats, dropless for small counts (decode)."""
    return max(int((n_tokens * cfg.top_k / cfg.n_experts) * cfg.capacity_factor) + 1,
               min(n_tokens, 16))


def moe_dispatch(x: torch.Tensor, idx: torch.Tensor, capacity: int,
                 n_experts: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [T, d]; idx: [T, k] -> buffer [E, C+1, d], (e_sel, p_sel) for
    combine.

    Position in expert: stable-sort the flattened assignments by expert
    id; position = rank - first rank of that expert (``searchsorted``
    left over the sorted ids). Assignments at position C or later land in
    the dead column C, which holds zeros afterwards."""
    T, k = idx.shape
    e_flat = idx.reshape(-1)
    sorted_e, order = torch.sort(e_flat, stable=True)
    start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(T * k, device=idx.device) - start
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted  # invert the permutation
    p_sel = pos.reshape(T, k).clamp_max(capacity)  # overflow -> dead column C
    buf = x.new_zeros((n_experts, capacity + 1, x.shape[-1]))
    buf[idx, p_sel] = x[:, None].expand(T, k, x.shape[-1])
    buf[:, capacity] = 0
    return buf, idx, p_sel


def moe_combine(expert_out: torch.Tensor, gates: torch.Tensor,
                e_sel: torch.Tensor, p_sel: torch.Tensor) -> torch.Tensor:
    """expert_out: [E, C+1, d]; gather back per (token, k) and sum weighted
    by the gates (cast to the activation type first, as ``repro``). What
    is gathered from the dead column is zeroed, so dropped assignments
    add nothing."""
    picked = expert_out[e_sel, p_sel]  # [T, k, d], a copy
    picked.masked_fill_((p_sel == expert_out.shape[1] - 1)[..., None], 0)
    return torch.einsum("tkd,tk->td", picked, gates.to(picked.dtype))


def _experts(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """The expert FFNs on ``[E, C, d]`` buffers, batched over the experts."""
    h = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    return torch.bmm(F.silu(h) * u, p["w_down"])


def local_capacity(cfg: ModelConfig, t_loc: int) -> int:
    """Slots an expert has on one data shard of ``t_loc`` tokens
    (``repro``'s ``_moe_local_dispatch``)."""
    return max(int((t_loc * cfg.top_k / cfg.n_experts) * cfg.capacity_factor) + 1,
               min(t_loc, 4))


def _dispatch_shards(x3, idx3, cap: int, n_experts: int):
    """:func:`moe_dispatch` on each shard of ``x3 [S, T_loc, d]`` /
    ``idx3 [S, T_loc, k]``: buffers ``[S, E, C+1, d]`` and the shards'
    ``(e_sel, p_sel)``."""
    parts = [moe_dispatch(x, i, cap, n_experts) for x, i in zip(x3, idx3)]
    return tuple(torch.stack(t) for t in zip(*parts))


def _combine_shards(eo3, gates3, e3, p3):
    """:func:`moe_combine` on each shard: ``[S, T_loc, d]``."""
    return torch.stack([moe_combine(*a) for a in zip(eo3, gates3, e3, p3)])


def local_dispatch(p: Params, cfg: ModelConfig, xt, gates, idx, S: int,
                   no_ep: bool = False, mesh=None):
    """The shard-local dispatch of ``xt [T, d]`` for ``S`` data shards:
    ``[T, d]``, or None where ``S <= 1`` or S does not divide T (the
    caller falls back to the global path). Plain tensors give its
    arithmetic; with ``mesh``, DTensors run it as ``repro``'s placements
    say (module notes)."""
    T, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    if S <= 1 or T % S != 0:
        return None
    t_loc = T // S
    cap = local_capacity(cfg, t_loc)
    C1 = cap + 1
    x3 = xt.reshape(S, t_loc, d)
    idx3 = idx.reshape(S, t_loc, k)
    gates3 = gates.reshape(S, t_loc, k)
    dispatch, combine = _dispatch_shards, _combine_shards
    if mesh is not None:
        dispatch, combine, place = _sharded_ops(mesh)
        x3, idx3, gates3 = (place(t, 0, None) for t in (x3, idx3, gates3))
    buf3, e3, p3 = dispatch(x3, idx3, cap, E)  # [S, E, C+1, d]
    if mesh is not None:
        buf3 = place(buf3, 0, None if no_ep else 1)
    buf = buf3.transpose(0, 1).reshape(E, S * C1, d)
    if mesh is not None:  # <- the all-to-all (EP); shard-local with no_ep
        buf = place(buf, 1, None) if no_ep else place(buf, None, 0)
    eo = _experts(p, buf)
    eo3 = eo.reshape(E, S, C1, d).transpose(0, 1)
    if mesh is not None:  # the way back
        eo3 = place(eo3, 0, None if no_ep else 1)
    out3 = combine(eo3, gates3, e3, p3)  # [S, T_loc, d]
    return out3.reshape(T, d)


def _sharded_ops(mesh):
    """Dispatch and combine through ``local_map`` on ``mesh``, and
    ``place(t, dp_dim, model_dim)``: ``t`` redistributed with tensor dim
    ``dp_dim`` over the data-parallel axes and ``model_dim`` over
    ``"model"`` (None: replicated)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.sharding import dp_axes, placements

    daxes = dp_axes(mesh)

    def spec(ndim, dp_dim, model_dim):
        s = [None] * ndim
        if dp_dim is not None:
            s[dp_dim] = daxes
        if model_dim is not None:
            s[model_dim] = "model"
        return placements(s, mesh)

    def place(t, dp_dim, model_dim):
        return t.redistribute(mesh, spec(t.ndim, dp_dim, model_dim))

    shard = list(spec(4, 0, None))  # a list: one tensor's (local_map)

    def dispatch(x3, idx3, cap, E):
        return local_map(lambda x, i: _dispatch_shards(x, i, cap, E),
                         out_placements=(shard, shard, shard),
                         in_placements=(shard, shard),
                         device_mesh=mesh)(x3, idx3)

    def combine(eo3, gates3, e3, p3):
        eo3 = place(eo3, 0, None)  # every expert's rows on each shard
        return local_map(_combine_shards, out_placements=shard,
                         in_placements=(shard,) * 4,
                         device_mesh=mesh)(eo3, gates3, e3, p3)

    return dispatch, combine, place


def _replicated_ops(xt, gates, idx):
    """The global path on DTensors: every token gathered to every rank and
    :func:`moe_dispatch` / :func:`moe_combine` run there through
    ``local_map`` (``repro``'s partitioner replicates the global scatter
    the same way). Returns (dispatch, combine, xt, gates, idx)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = xt.device_mesh
    rep = [Replicate()] * mesh.ndim  # a list: one tensor's (local_map)

    def full(t):
        return t.redistribute(mesh, rep)

    def dispatch(x, i, cap, E):
        return local_map(lambda x, i: moe_dispatch(x, i, cap, E),
                         out_placements=(rep, rep, rep),
                         in_placements=(rep, rep), device_mesh=mesh)(x, i)

    def combine(eo, g, e, ps):
        return local_map(moe_combine, out_placements=rep,
                         in_placements=(rep,) * 4,
                         device_mesh=mesh)(full(eo), g, e, ps)

    return dispatch, combine, full(xt), full(gates), full(idx)


def moe_layer(p: Params, cfg: ModelConfig, x: torch.Tensor,
              shard_experts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> (out [B, T, d], aux_loss). ``shard_experts``: an
    optional callable placing the global path's ``[E, C+1, d]`` buffers
    (EP)."""
    from repro_torch.parallel.ctx import ctx_option, current_mesh, dp_shard_count

    B, T, d = x.shape
    xt = x.reshape(B * T, d)
    gates, idx, aux = router_topk(xt.float() @ p["router"], cfg.top_k)
    out = None
    mesh = current_mesh()
    if ctx_option("moe_local_dispatch") and mesh is not None:
        out = local_dispatch(p, cfg, xt, gates, idx, dp_shard_count(),
                             no_ep=bool(ctx_option("no_ep")), mesh=mesh)
    if out is None:
        dispatch, combine = moe_dispatch, moe_combine
        if isinstance(xt, DTensor):
            dispatch, combine, xt, gates, idx = _replicated_ops(xt, gates, idx)
        buf, e_sel, p_sel = dispatch(xt, idx, expert_capacity(cfg, B * T),
                                     cfg.n_experts)
        if shard_experts is not None:
            buf = shard_experts(buf)
        eo = _experts(p, buf)
        if shard_experts is not None:
            eo = shard_experts(eo)
        out = combine(eo, gates, e_sel, p_sel)
    out = out.reshape(B, T, d)
    if cfg.moe_dense_ff:
        dm = p["dense_mlp"]
        out = out + swiglu(x, dm["w_gate"], dm["w_up"], dm["w_down"])
    return out, aux
