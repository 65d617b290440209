"""Shared NN building blocks (functional, dictionaries of tensors), the
port's counterpart of ``repro.models.modules``.

Each function computes what ``repro``'s of the same name computes, in the
same types: the norm in float32 with the ``1 + scale`` form, RoPE on
float32 angles (a bf16 input is promoted to float32 by the products with
``cos``/``sin``, as ``jnp`` promotes it, and cast back once), the
training loss in float32. The inits
draw from an explicit ``torch.Generator``, which lives on the device the
tensors are made on; they give other numbers than ``jax.random`` from the
same seed, so the tests carry ``repro``'s weights over
(``repro_torch.models.convert``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def init_rms_norm(d: int, device=None) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def dense_init(generator: torch.Generator, shape, in_axis_size: Optional[int] = None,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Normal weights of std ``1/sqrt(fan_in)``, drawn in float32 on the
    generator's device, scaled in place (one float32 copy of the tensor
    at a time: arctic's expert tensors are 17.8 GB in float32) and cast
    to ``dtype``."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(fan_in ** -0.5).to(dtype)


def rope_frequencies(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: [..., T] int."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # [hd/2]
    angles = positions[..., :, None, None].float() * freqs  # [..., T, 1, hd/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def init_mlp(generator: torch.Generator, d: int, d_ff: int, dtype) -> Params:
    return {
        "w_gate": dense_init(generator, (d, d_ff), dtype=dtype),
        "w_up": dense_init(generator, (d, d_ff), dtype=dtype),
        "w_down": dense_init(generator, (d_ff, d), in_axis_size=d_ff, dtype=dtype),
    }


def init_embedding(generator: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                       device=generator.device).to(dtype)


def full_last_dim(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its last dim (the vocabulary) gathered onto every
    rank, for the gold logit's gather and the greedy ``argmax``, which
    DTensor cannot take on a sharded dim; any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    last = {-1, x.ndim - 1}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in last else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: [B, T, V]; labels: [B, T]. The mean negative log-likelihood
    in float32, over the positions ``mask`` keeps (``repro``'s: the
    masked sum over ``max(sum(mask), 1)``) or over all of them."""
    logits = full_last_dim(logits.float())
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
