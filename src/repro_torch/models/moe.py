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
added to the MoE output. ``repro``'s mesh-only paths (``_moe_local_dispatch``
and the ``shard_experts`` hook) have no counterpart on one card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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


def moe_layer(p: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> (out [B, T, d], aux_loss)."""
    B, T, d = x.shape
    xt = x.reshape(B * T, d)
    gates, idx, aux = router_topk(xt.float() @ p["router"], cfg.top_k)
    buf, e_sel, p_sel = moe_dispatch(xt, idx, expert_capacity(cfg, B * T),
                                     cfg.n_experts)
    h = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    eo = torch.bmm(F.silu(h) * u, p["w_down"])
    out = moe_combine(eo, gates, e_sel, p_sel).reshape(B, T, d)
    if cfg.moe_dense_ff:
        dm = p["dense_mlp"]
        out = out + swiglu(x, dm["w_gate"], dm["w_up"], dm["w_down"])
    return out, aux
