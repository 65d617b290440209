"""Optimizers (functional, optax-style minimal) and gradient compression,
the port's counterpart of ``repro.train.optimizer``.

- ``adamw``: AdamW with float32 moments, one per parameter tensor (the
  update is elementwise, so the port's per-layer tensors give
  ``repro``'s stacked numbers).
- ``adafactor``: factored second moment (row/column statistics) for the
  archs whose float32 Adam state does not fit.
- ``compress_gradients``: int8 quantisation with error feedback.

All three compute in float32 and cast the new parameters back to each
parameter's type, as ``repro``'s do. Each takes and returns trees of the
port's layout (``"layers"`` a list of per-layer dictionaries) and returns
new tensors, never updating in place. Adafactor's statistics and clipping
and the compression's scale are taken over a whole leaf of ``repro``'s
stacked tree (all layers of one weight together), so those two run on
``models.convert.stack_layers``' stacked copies and keep Adafactor's
statistics in that layout; AdamW needs no copy. ``torch.round`` rounds
half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.convert import (
    _transpose_layers,
    stack_layers,
    tree_leaves,
    tree_map,
    unstack_layers,
)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # adafactor
    decay: float = 0.8
    clip_threshold: float = 1.0


def _pick(guide, out, i: int):
    """Item ``i`` of the tuples at ``guide``'s leaves in ``out`` (the
    result of a :func:`tree_map` whose function returned tuples)."""
    return tree_map(lambda _, o: o[i], guide, out)


def _index_lists(tree, i: int):
    """``tree`` (dictionaries of per-layer lists) at layer ``i``."""
    if isinstance(tree, list):
        return tree[i]
    return {k: _index_lists(v, i) for k, v in tree.items()}


def _replicated(t):
    """A DTensor gathered onto every rank (a small statistic); a plain
    tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw(cfg: OptConfig = OptConfig()) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()

        def upd(g, m, v, p):
            g = g.float()
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            mh = m / b1c
            vh = v / b2c
            delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
            return m, v, (p.float() - cfg.lr * delta).to(p.dtype)

        out = tree_map(upd, grads, state["m"], state["v"], params)
        return _pick(params, out, 2), {"m": _pick(params, out, 0),
                                       "v": _pick(params, out, 1),
                                       "step": step}

    return Optimizer(init, update)


def adafactor(cfg: OptConfig = OptConfig()) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018, simplified).
    Its statistics live in ``repro``'s stacked layout: a stacked ``[L,
    d]`` leaf factors over its layers, as ``repro``'s does."""

    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def init(params):
        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return {"stats": tree_map(one, stack_layers(params)),
                "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        beta = 1.0 - step.float() ** (-cfg.decay)

        def one(g, st, p):
            g = g.float()
            g2 = g * g + 1e-30
            if "vr" in st:
                vr = beta * st["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * st["vc"] + (1 - beta) * g2.mean(-2)
                denom = vr.mean(-1, keepdim=True).clamp_min(1e-30)
                prec = (vr[..., None] / denom[..., None]) * vc[..., None, :]
                upd = g * torch.rsqrt(prec + 1e-30)
                new_st = {"vr": vr, "vc": vc}
            else:
                v = beta * st["v"] + (1 - beta) * g2
                upd = g * torch.rsqrt(v + 1e-30)
                new_st = {"v": v}
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt((upd * upd).mean() + 1e-30)
            upd = upd / (rms / cfg.clip_threshold).clamp_min(1.0)
            newp = p.float() - cfg.lr * (upd + cfg.weight_decay * p.float())
            return new_st, newp.to(p.dtype)

        if isinstance(tree_leaves(params)[0], DTensor):
            new_p, new_s = _by_layer(grads, state["stats"], params, beta, one)
            return new_p, {"stats": new_s, "step": step}
        sp = stack_layers(params)
        out = tree_map(one, stack_layers(grads), state["stats"], sp)
        return (unstack_layers(_pick(sp, out, 1)),
                {"stats": _pick(sp, out, 0), "step": step})

    def _leaf(gs, st, ps, beta, stacked: bool):
        """:func:`update`'s step of one stacked leaf kept as its per-layer
        tensors ``gs``/``ps`` (one each outside ``"layers"``): the
        statistics of each layer's slice, the clipping RMS over all of
        them together."""
        upds, news = [], []
        for i, (g, p) in enumerate(zip(gs, ps)):
            old = {k: v[i] for k, v in st.items()} if stacked else st
            g = g.float()
            g2 = g * g + 1e-30
            if "vr" in old:
                vr = beta * old["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * old["vc"] + (1 - beta) * g2.mean(-2)
                denom = vr.mean(-1, keepdim=True).clamp_min(1e-30)
                prec = (vr[..., None] / denom[..., None]) * vc[..., None, :]
                upds.append(g * torch.rsqrt(prec + 1e-30))
                news.append({"vr": vr, "vc": vc})
            else:
                v = beta * old["v"] + (1 - beta) * g2
                upds.append(g * torch.rsqrt(v + 1e-30))
                news.append({"v": v})
        sq = sum((u * u).sum() for u in upds)
        rms = torch.sqrt(sq / sum(u.numel() for u in upds) + 1e-30)
        scale = (rms / cfg.clip_threshold).clamp_min(1.0)
        new_ps = [(p.float() - cfg.lr * (u / scale + cfg.weight_decay * p.float())
                   ).to(p.dtype) for u, p in zip(upds, ps)]
        if not stacked:
            return news[0], new_ps[0]
        return ({k: torch.stack([_replicated(n[k]) for n in news])
                 for k in news[0]}, new_ps)

    def _by_layer(grads, stats, params, beta, one):
        """The update on DTensors without stacking them (DTensor cannot
        stack sharded layers in place): each ``"layers"`` leaf's per-layer
        tensors through :func:`_leaf`, the statistics kept stacked and
        replicated, as ``train_step.shard_state`` places them. Returns
        (params, stats)."""
        new_p: dict = {}
        new_s: dict = {}
        for k, p in params.items():
            if k == "layers" and isinstance(p, list):
                new_s[k], per = _layer_leaves(
                    _transpose_layers(grads[k]), stats[k],
                    _transpose_layers(p), beta, one)
                new_p[k] = [_index_lists(per, i) for i in range(len(p))]
            elif isinstance(p, dict):
                new_p[k], new_s[k] = _by_layer(grads[k], stats[k], p, beta, one)
            else:
                new_s[k], new_p[k] = _leaf([grads[k]], stats[k], [p], beta,
                                           False)
        return new_p, new_s

    def _layer_leaves(g, st, p, beta, one):
        """:func:`_leaf` at each list of ``p`` (a dictionary of per-layer
        lists); returns (stacked stats, the same dictionary of new
        per-layer lists)."""
        if isinstance(p, list):
            if p[0].ndim >= 2:
                return _leaf(g, st, p, beta, True)
            # a 1-d weight factors over its layers: stacked (it is small)
            new_st, new_p = one(torch.stack([_replicated(t) for t in g]), st,
                                torch.stack([_replicated(t) for t in p]))
            return new_st, list(new_p.unbind(0))
        out = {k: _layer_leaves(g[k], st[k], p[k], beta, one) for k in p}
        return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}

    return Optimizer(init, update)


def make_optimizer(name: str, cfg: OptConfig = OptConfig()) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor}[name](cfg)


# -------------------------------------------------------- grad compression
def compress_gradients(grads, error_state):
    """int8 quantisation with error feedback, one scale a leaf of
    ``repro``'s stacked tree.

    Returns (quantised-dequantised grads, new error state), both in the
    port's layout; ``error_state`` None starts from zeros.
    """

    def one(g, e):
        g32 = g.float() + e
        scale = g32.abs().max().clamp_min(1e-12) / 127.0
        q = torch.round(g32 / scale).clamp(-127, 127).to(torch.int8)
        deq = q.float() * scale
        return deq.to(g.dtype), g32 - deq

    if error_state is None:
        error_state = tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)
    sg = stack_layers(grads)
    out = tree_map(one, sg, stack_layers(error_state))
    return unstack_layers(_pick(sg, out, 0)), unstack_layers(_pick(sg, out, 1))
