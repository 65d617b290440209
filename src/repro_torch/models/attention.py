"""GQA attention: prefill through the attention kernel, KV-cache decode in
plain PyTorch; the port's counterpart of ``repro.models.attention``.

Variants handled by flags: qk-norm (qwen3), sliding-window masks
(gemma3 5:1 local:global, hymba local+3-global), attention bias. Prefill
(:func:`attention_core`) hands the projected heads to
``repro_torch.kernels.flash_attention`` (the hand-written Hopper kernel on
the card, its plain version on the CPU or with ``impl="torch"``), which
masks by index and never builds the ``[T, S]`` scores: it takes the place
of both ``repro``'s masked full-score path and its chunked one, so their
thresholds have no counterpart here. The kernel has no logit softcap, so a
config that sets one raises in prefill. Decode
(:func:`decode_attention`) attends one query position against a length-S
cache, ring-buffered for local layers, as ``repro`` does.

Cross-attention (enc-dec) reads keys and values projected once from the
encoder's output (:func:`encode_cross_kv`, no RoPE): with T decoder
queries against S encoder keys and no mask, through the attention kernel
in prefill (:func:`cross_attention`), in plain PyTorch for decode's one
query (:func:`decode_cross_attention`). The encoder's self-attention is
:func:`attention` with ``causal=False``.

Layouts are ``repro``'s at every function: activations ``[B, T, heads,
hd]``, ``wq`` ``[d, nh, hd]``, ``wo`` ``[nh, hd, d]``, caches ``[B, S, nkv,
hd]``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import apply_rope, dense_init, init_rms_norm, rms_norm

Params = Dict[str, torch.Tensor]


def init_attention(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d, hd = cfg.d_model, cfg.hd
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    dev = generator.device
    p = {
        "wq": dense_init(generator, (d, nh, hd), in_axis_size=d, dtype=cfg.dtype),
        "wk": dense_init(generator, (d, nkv, hd), in_axis_size=d, dtype=cfg.dtype),
        "wv": dense_init(generator, (d, nkv, hd), in_axis_size=d, dtype=cfg.dtype),
        "wo": dense_init(generator, (nh, hd, d), in_axis_size=nh * hd, dtype=cfg.dtype),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros((nh, hd), dtype=cfg.dtype, device=dev)
        p["bk"] = torch.zeros((nkv, hd), dtype=cfg.dtype, device=dev)
        p["bv"] = torch.zeros((nkv, hd), dtype=cfg.dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, dev)
        p["k_norm"] = init_rms_norm(hd, dev)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("btd,dhk->bthk", x, w)`` as one matrix product."""
    d, h, k = w.shape
    y = x @ w.reshape(d, h * k)
    if isinstance(y, DTensor):
        y = _whole_heads(y, h)
    return y.unflatten(-1, (h, k))


def _whole_heads(y, h: int):
    """``y`` (a DTensor, heads x width in its last dim) with that dim
    gathered where its shards would cut a head (DTensor may shard a
    product's columns over a mesh dim that the heads do not divide)."""
    from torch.distributed.tensor import Replicate, Shard

    last = (-1, y.ndim - 1)
    sharded = [m for m, p in enumerate(y.placements)
               if isinstance(p, Shard) and p.dim in last]
    n = 1
    for m in sharded:
        n *= y.device_mesh.size(m)
    if h % n == 0:
        return y
    pl = [Replicate() if m in sharded else p for m, p in enumerate(y.placements)]
    return y.redistribute(y.device_mesh, pl)


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bthk,hkd->btd", out, wo)`` as one matrix product."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.reshape(h * k, d)


def attention_core(p: Params, cfg: ModelConfig, q, k, v,
                   window: Optional[int] = None,
                   impl: str = "auto", causal: bool = True) -> torch.Tensor:
    """Attention from projected q ([B, T, h, hd], positions 0..T-1) and
    k/v ([B, S, nkv, hd]); returns [B, T, d]. ``causal``: query t sees
    keys up to t (``window`` None or 0: every earlier key; else keys less
    than ``window`` positions back); else every key. The heads go to
    ``flash_attention`` as ``[B, h, T, hd]`` contiguous (``impl`` picks
    the kernel or its plain version, ``kernels.registry``)."""
    if cfg.attn_logit_softcap:
        raise NotImplementedError(
            "attn_logit_softcap: the attention kernel has no logit softcap")
    out = flash_attention(*(t.transpose(1, 2).contiguous() for t in (q, k, v)),
                          causal=causal, window=int(window or 0), impl=impl)
    return _out_proj(out.transpose(1, 2), p["wo"])


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, window: Optional[int] = None,
              impl: str = "auto", causal: bool = True) -> torch.Tensor:
    """Prefill attention. x: [B, T, d]; positions [B, T] = 0..T-1 (RoPE);
    window and causal: see :func:`attention_core`."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    return attention_core(p, cfg, q, k, v, window, impl, causal)


# ----------------------------------------------------------------- decode
def init_kv_cache(cfg: ModelConfig, batch: int, length: int,
                  device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _attend_one(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, valid: Optional[torch.Tensor] = None,
                softcap: Optional[float] = None) -> torch.Tensor:
    """One query position against S keys in float32: q [B, nh, hd], k/v
    [B, S, nkv, hd] read in place by each query head's group, ``valid``
    [S] the keys it may see (None: all). Returns [B, nh, hd] in q's
    type."""
    if isinstance(q, DTensor):
        return _attend_one_sharded(cfg, q, k, v, valid, softcap)
    B, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(B, nkv, nh // nkv, hd).float()
    scores = torch.einsum("bgrk,bsgk->bgrs", qg, k.float()) * cfg.hd ** -0.5
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if valid is not None:
        scores = scores.masked_fill(~valid, torch.finfo(torch.float32).min)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgk->bgrk", w, v.float())
    return out.reshape(B, nh, hd).to(q.dtype)


def _attend_one_sharded(cfg: ModelConfig, q, k, v, valid, softcap):
    """:func:`_attend_one` on DTensors, each rank on its own rows and
    heads (``local_map``: DTensor cannot split the query heads into kv
    groups when either is sharded). q's batch and heads keep their
    placements; k and v follow q's batch, their sequence gathered where
    it is sharded (the cache's sequence-parallel layout), their kv heads
    sharded like q's or replicated, when each rank reads its query heads'
    kv heads."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    group = q.shape[1] // k.shape[2]
    kv_pl, head_dim = [], None
    for m, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if isinstance(pq, Shard) and pq.dim == 1:  # query heads
            kv_pl.append(Shard(2) if isinstance(pk, Shard) and pk.dim == 2
                         else Replicate())
            if not isinstance(kv_pl[-1], Shard):
                head_dim = m
        elif isinstance(pq, Shard) and pq.dim == 0:  # batch
            kv_pl.append(Shard(0))
        else:
            kv_pl.append(Replicate())
    k, v = (t.redistribute(mesh, kv_pl) for t in (k, v))
    coord = mesh.get_local_rank(head_dim) if head_dim is not None else 0

    def local(ql, kl, vl):
        if head_dim is not None:  # this rank's query heads' kv heads
            nl = ql.shape[1]
            h0 = coord * nl
            if nl % group and group % nl:
                raise ValueError(f"decode attention: {nl} local query heads "
                                 f"do not map onto whole kv heads")
            a = h0 // group
            kl = kl[:, :, a:a + max(nl // group, 1)]
            vl = vl[:, :, a:a + max(nl // group, 1)]
        return _attend_one(cfg, ql, kl, vl, valid, softcap)

    qp = list(q.placements)  # a list: one tensor's (local_map)
    return local_map(local, out_placements=qp,
                     in_placements=(qp, kv_pl, kv_pl), device_mesh=mesh)(q, k, v)


def decode_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], t: int,
                     window: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x: [B, 1, d]; cache k/v: [B, S, nkv, hd]; t: current
    position. Ring-buffer addressing: slot = t mod S (exact for local
    layers with S == window; for global layers S >= max positions). The
    new key and value are written into the cache in place; the scores,
    softmax and sum over the values are float32, each query head reading
    its group's kv head in place (``repro``'s ``_expand_kv`` copies the
    cache once per query head instead)."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    pos = torch.full((B, 1), t, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, pos)
    slot = t % S
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    # Valid slots: written positions within the causal window.
    s_idx = torch.arange(S, device=x.device)
    # Position stored in slot s (ring): the latest p <= t with p mod S == s.
    stored_pos = t - torch.remainder(t - s_idx, S)
    valid = stored_pos >= 0
    if window:
        valid &= (t - stored_pos) < window
    out = _attend_one(cfg, q[:, 0], cache["k"], cache["v"], valid,
                      cfg.attn_logit_softcap)
    return _out_proj(out[:, None], p["wo"]), cache


# ------------------------------------------------------------ cross-attn
def init_cross_attention(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": dense_init(generator, (d, nh, hd), in_axis_size=d, dtype=cfg.dtype),
        "wk": dense_init(generator, (d, nkv, hd), in_axis_size=d, dtype=cfg.dtype),
        "wv": dense_init(generator, (d, nkv, hd), in_axis_size=d, dtype=cfg.dtype),
        "wo": dense_init(generator, (nh, hd, d), in_axis_size=nh * hd, dtype=cfg.dtype),
    }


def encode_cross_kv(p: Params, cfg: ModelConfig, enc_out: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys and values [B, S, nkv, hd] of the encoder's output [B, S, d]."""
    return _heads(enc_out, p["wk"]), _heads(enc_out, p["wv"])


def cross_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor],
                    impl: str = "auto") -> torch.Tensor:
    """x: [B, T, d] against the encoder's (k, v) [B, S, nkv, hd], every key
    seen (no mask, no RoPE), through the attention kernel (``impl``);
    returns [B, T, d]."""
    k, v = enc_kv
    return attention_core(p, cfg, _heads(x, p["wq"]), k, v, impl=impl,
                          causal=False)


def decode_cross_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                           enc_kv: Tuple[torch.Tensor, torch.Tensor]
                           ) -> torch.Tensor:
    """:func:`cross_attention` for decode's one query (x [B, 1, d]), in
    plain PyTorch like :func:`decode_attention`."""
    k, v = enc_kv
    out = _attend_one(cfg, _heads(x, p["wq"])[:, 0], k, v)
    return _out_proj(out[:, None], p["wo"])
