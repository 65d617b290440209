"""Decoder LMs (dense, MoE, SSM, hybrid, vision) and the enc-dec backbone
for training and serving, the port's counterpart of ``repro.models.model``.

Parameters are plain dictionaries of tensors in ``repro``'s layouts, with
one difference: ``params["layers"]`` (and ``params["encoder"]["layers"]``)
is a list of per-layer dictionaries (``repro`` stacks them on a leading
``[L]`` axis for its scans; ``repro_torch.models.convert`` splits them).
Every function walks the layers in a Python loop, and every arch keeps a
per-layer cache list: local-attention layers keep ring buffers of window
length, global layers full-length caches (``repro`` does this for
sliding-window archs and scans stacked caches for the others); an enc-dec
cache also holds one ``(k, v)`` of the encoder's output a layer
(``cross_kv``, filled by prefill).

Training (:func:`forward` -> ``(logits, aux)``, :func:`loss_fn`) and
prefill run every attention through the attention kernel (the decoder's
causal self-attention, the encoder's bidirectional one and
cross-attention, T decoder queries against S encoder keys) and each SSM
through the Mamba-scan kernel's fused entry, ``selective_scan``
(``impl``: ``"auto"``, ``"cuda"`` or ``"torch"``, as
``repro_torch.kernels.registry`` says); under autograd both kernels'
backward is their plain version's (``kernels.autograd``). Where
``cfg.remat`` is set, training recomputes each layer, decoder and
encoder, in the backward (``torch.utils.checkpoint``, ``repro``'s
``jax.checkpoint`` of its scan body), so each kernel runs twice a layer
a step. Decode runs in plain PyTorch, as ``repro``'s does. The MoE layer
is ``models.moe``; its load-balancing loss is summed over the layers
into ``forward``'s ``aux``. The vision stub's patch embeddings
(``batch["frontend"]``) are projected ahead of the text, and the loss
reads the text's tail of the logits; the audio stub's frames
(``batch["enc_input"]``) are projected into the encoder.

On a mesh (parameters and batch as DTensors under
``parallel.ctx.sharding_ctx``) the embedding's output and every layer's
output pass ``shard_batch``, ``repro``'s anchors, and each layer's
weights are gathered over the data axes first (``gather_fsdp``); on plain
tensors both pass them through.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.registry import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import (
    cross_entropy_loss,
    dense_init,
    init_embedding,
    init_mlp,
    init_rms_norm,
    rms_norm,
    swiglu,
)
from repro_torch.parallel.ctx import gather_fsdp, grad_placed, shard_batch

Params = Dict[str, Any]

#: Families ``ModelConfig.family`` may name.
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family no config defines."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} "
                         f"(expected one of {', '.join(FAMILIES)})")


# --------------------------------------------------------------------- init
def _init_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    p: Params = {"norm1": init_rms_norm(cfg.d_model, dev)}
    if cfg.has_attention:
        p["attn"] = attn_mod.init_attention(generator, cfg)
    if cfg.has_ssm:
        p["ssm"] = ssm_mod.init_ssm(generator, cfg)
    if cfg.family in ("dense", "hybrid", "vlm", "audio"):
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.dtype)
    elif cfg.family == "moe":
        p["moe"] = moe_mod.init_moe(generator, cfg)
    if cfg.family != "ssm":
        p["norm2"] = init_rms_norm(cfg.d_model, dev)
    if cfg.family == "hybrid":
        p["norm_attn_out"] = init_rms_norm(cfg.d_model, dev)
        p["norm_ssm_out"] = init_rms_norm(cfg.d_model, dev)
    if cfg.is_enc_dec:
        p["cross"] = attn_mod.init_cross_attention(generator, cfg)
        p["norm_cross"] = init_rms_norm(cfg.d_model, dev)
    return p


def _init_encoder_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    return {
        "norm1": init_rms_norm(cfg.d_model, dev),
        "attn": attn_mod.init_attention(generator, cfg),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.dtype),
        "norm2": init_rms_norm(cfg.d_model, dev),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Union[str, torch.device, None] = None) -> Params:
    """Random weights drawn from ``generator`` on ``device`` (``cuda``
    unless the caller asks for the CPU; the generator must live there;
    default: one seeded with 0)."""
    check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, weights on {dev}")
    p: Params = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "layers": [_init_layer(generator, cfg) for _ in range(cfg.n_layers)],
        "final_norm": init_rms_norm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                  in_axis_size=cfg.d_model, dtype=cfg.dtype)
    if cfg.is_enc_dec:
        p["encoder"] = {
            "layers": [_init_encoder_layer(generator, cfg)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": init_rms_norm(cfg.d_model, dev),
        }
    if cfg.frontend is not None:
        p["frontend_proj"] = dense_init(
            generator, (cfg.frontend_dim, cfg.d_model),
            in_axis_size=cfg.frontend_dim, dtype=cfg.dtype)
    return p


def layer_windows(cfg: ModelConfig) -> Tuple[int, ...]:
    """Per-layer attention window, 0 for a global layer (the attention
    kernel's convention; ``repro`` uses a large sentinel)."""
    return tuple(0 if cfg.is_global_layer(i) or cfg.sliding_window is None
                 else int(cfg.sliding_window) for i in range(cfg.n_layers))


# ------------------------------------------------------------------ forward
def _mix(cfg: ModelConfig, lp: Params, x, attn_out, ssm_out,
         cross: Optional[Callable] = None, shard_experts=None):
    """The block after its attention and SSM halves (``repro``'s
    ``_layer_apply`` from the mix on): the residual, then ``cross`` (the
    layer's cross-attention of its normed input, enc-dec only), then the
    MLP or the MoE layer. Returns (x, aux): the MoE layer's
    load-balancing loss, None for the other families. On a mesh each
    half's output is anchored to the batch sharding (``shard_batch``)
    before it joins the residual: a row-parallel product leaves a partial
    sum, which is reduced there rather than carried into the next
    product."""
    attn_out, ssm_out = shard_batch(attn_out), shard_batch(ssm_out)
    if cfg.family == "ssm":
        return x + ssm_out, None
    if cfg.family == "hybrid":
        x = x + 0.5 * (rms_norm(attn_out, lp["norm_attn_out"], cfg.norm_eps)
                       + rms_norm(ssm_out, lp["norm_ssm_out"], cfg.norm_eps))
    else:
        x = x + attn_out
    if cross is not None:
        x = x + shard_batch(cross(rms_norm(x, lp["norm_cross"], cfg.norm_eps)))
    h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
    if cfg.family == "moe":
        mo, aux = moe_mod.moe_layer(lp["moe"], cfg, h2,
                                    shard_experts=shard_experts)
        return x + shard_batch(mo), aux
    return (x + shard_batch(swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                                   lp["mlp"]["w_down"])), None)


def _remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` (one layer), recomputed in the backward instead of keeping
    its activations where ``cfg.remat`` is set and grad mode is on:
    ``torch.utils.checkpoint`` a layer at a time, ``repro``'s
    ``jax.checkpoint`` of its scan body."""
    if cfg.remat and torch.is_grad_enabled():
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return fn


def _prefill_cross(cfg: ModelConfig, lp: Params, ekv, impl: str):
    """The layer's cross-attention for prefill and ``forward`` (None
    without an encoder)."""
    if ekv is None:
        return None
    return functools.partial(attn_mod.cross_attention, lp["cross"], cfg,
                             enc_kv=ekv, impl=impl)


def _encoder_layer(cfg: ModelConfig, lp: Params, x, positions, impl: str):
    lp = gather_fsdp(lp)
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    x = x + shard_batch(attn_mod.attention(lp["attn"], cfg, h, positions,
                                           impl=impl, causal=False))
    h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + shard_batch(swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                                  lp["mlp"]["w_down"]))


def _encode(cfg: ModelConfig, params: Params, enc_in: torch.Tensor,
            impl: str = "auto") -> torch.Tensor:
    """Bidirectional encoder over [B, S, d] inputs: every layer's
    self-attention sees every position (``causal=False``)."""
    positions = torch.arange(enc_in.shape[1], device=enc_in.device).expand(
        enc_in.shape[:2])
    layer = _remat(cfg, functools.partial(_encoder_layer, cfg))
    x = enc_in
    for lp in params["encoder"]["layers"]:
        x = layer(lp, x, positions, impl)
    return rms_norm(x, gather_fsdp(params["encoder"]["final_norm"]), cfg.norm_eps)


def _encoder_output(cfg: ModelConfig, params: Params,
                    batch: Dict[str, torch.Tensor], impl: str):
    """The encoder's output over ``batch["enc_input"]`` (the audio stub's
    frames, projected to d_model) for an enc-dec config, else None."""
    if not cfg.is_enc_dec:
        return None
    if "enc_input" not in batch:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: the batch "
                         f"needs 'enc_input' (the encoder's frames, [B, S, "
                         f"{cfg.frontend_dim or cfg.d_model}])")
    enc_in = batch["enc_input"]
    if cfg.frontend == "audio":
        enc_in = shard_batch(enc_in.to(cfg.dtype)
                             @ gather_fsdp(params["frontend_proj"]))
    return _encode(cfg, params, enc_in, impl)


def _embed(table, tokens: torch.Tensor):
    """Rows of ``table`` at ``tokens``: an index on a plain tensor;
    ``F.embedding`` on a DTensor, which has a rule for it (the
    vocab-parallel lookup) and none for the index."""
    if isinstance(table, DTensor):
        return F.embedding(tokens.long(), table)
    return table[tokens.long()]


def embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """Token embedding, behind the vision stub's projected patch
    embeddings when the batch has ``"frontend"``. Returns (x [B, T, d],
    positions [B, T] over prefix and text)."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = _embed(gather_fsdp(params["embed"]), tokens).to(cfg.dtype)
    if cfg.frontend is not None and cfg.frontend != "audio" and "frontend" in batch:
        fe = batch["frontend"].to(cfg.dtype) @ gather_fsdp(params["frontend_proj"])
        x = torch.cat([fe, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    return grad_placed(shard_batch(x)), positions


def _logits(cfg: ModelConfig, params: Params, x):
    x = rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps)
    head = gather_fsdp(params["embed"] if cfg.tie_embeddings else params["lm_head"])
    head = head.T if cfg.tie_embeddings else head
    return x @ head.to(cfg.dtype)


def _layer(cfg: ModelConfig, lp: Params, window: int, x, positions,
           enc_out, impl: str, shard_experts=None):
    """One decoder layer (``repro``'s ``_layer_apply``, with the layer's
    cross keys and values projected from the encoder's output first, as
    ``repro``'s scan body does). Returns (x, aux or None)."""
    lp = gather_fsdp(lp)
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    a = (attn_mod.attention(lp["attn"], cfg, h, positions, window, impl=impl)
         if cfg.has_attention else None)
    s = ssm_mod.ssm_block(lp["ssm"], cfg, h, impl) if cfg.has_ssm else None
    ekv = (attn_mod.encode_cross_kv(lp["cross"], cfg, enc_out)
           if enc_out is not None else None)
    x, aux = _mix(cfg, lp, x, a, s, _prefill_cross(cfg, lp, ekv, impl),
                  shard_experts)
    return shard_batch(x), aux


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            impl: str = "auto", shard_experts=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits [B, T, V], aux)`` of the whole sequence (the vision
    prefix included), layer by layer, as ``repro``'s: ``aux`` is the MoE
    layers' load-balancing loss summed over the layers (float32, 0 for
    the other families). The training path, and the port's own reference
    for :func:`prefill` and :func:`decode_step`. ``shard_experts``: the
    MoE layer's EP hook (``parallel.sharding.expert_sharder``)."""
    x, positions = embed_inputs(cfg, params, batch)
    enc_out = _encoder_output(cfg, params, batch, impl)
    layer = _remat(cfg, functools.partial(_layer, cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, w in zip(params["layers"], layer_windows(cfg)):
        x, a = layer(lp, w, x, positions, enc_out, impl, shard_experts)
        if a is not None:
            aux = aux + a
    return _logits(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            impl: str = "auto", shard_experts=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``repro``'s training loss: the cross-entropy of the logits against
    ``batch["labels"]`` (over ``batch["mask"]`` where given; the vision
    prefix's logits cut off, the text's tail kept) plus
    ``cfg.router_aux_weight`` times the MoE aux loss. Returns
    ``(total, {"ce", "aux"})``."""
    logits, aux = forward(cfg, params, batch, impl, shard_experts)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # stub frontend prefix: text tail only
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    ce = cross_entropy_loss(logits, labels, batch.get("mask"))
    total = ce + cfg.router_aux_weight * aux
    return total, {"ce": ce, "aux": aux}


# ------------------------------------------------------------------ serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device, None] = None) -> Dict[str, Any]:
    """Per-layer caches (``{"layers": [entry, ...]}``) on ``device``
    (``cuda`` unless the caller asks for the CPU): ``kv`` of ``max_len``
    for a global layer and of ``min(window, max_len)`` for a local one
    (a ring buffer), ``ssm`` state and conv history; an enc-dec cache
    also ``"cross_kv"``, None until prefill."""
    check_family(cfg)
    dev = resolve_device(device)
    layers: List[Dict[str, Any]] = []
    for i in range(cfg.n_layers):
        entry: Dict[str, Any] = {}
        if cfg.has_attention:
            if cfg.is_global_layer(i) or cfg.sliding_window is None:
                s = max_len
            else:
                s = min(cfg.sliding_window, max_len)
            entry["kv"] = attn_mod.init_kv_cache(cfg, batch, s, device=dev)
        if cfg.has_ssm:
            entry["ssm"] = ssm_mod.init_ssm_cache(cfg, batch, device=dev)
        layers.append(entry)
    cache: Dict[str, Any] = {"layers": layers}
    if cfg.is_enc_dec:
        cache["cross_kv"] = None
    return cache


def _prefill_layer(cfg: ModelConfig, lp: Params, x, positions, window: int,
                   entry: Dict[str, Any], enc_out=None, impl: str = "auto"):
    """One FUSED layer of prefill: the block output and the cache entry in
    a single pass (q/k/v projected once, the SSM scan run once). The
    entry's k/v are written in place. Returns (x_out, new_cache_entry,
    the layer's cross (k, v) or None)."""
    lp = gather_fsdp(lp)
    T = x.shape[1]
    new_entry: Dict[str, Any] = {}
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    attn_out = ssm_out = ekv = None
    if cfg.has_attention:
        q, k, v = attn_mod._project_qkv(lp["attn"], cfg, h, positions)
        ck, cv = entry["kv"]["k"], entry["kv"]["v"]
        S = ck.shape[1]
        if S >= T:
            ck[:, :T], cv[:, :T] = k, v
        else:  # ring buffer shorter than prompt: keep the tail
            roll = (T - S) % S  # align ring slots with position mod S
            if isinstance(ck, DTensor):
                # slot (j + roll) mod S takes the tail's step j: the tail
                # rolled by `roll`, written as two slices (DTensor has no
                # rule for the index put)
                for c, t in ((ck, k[:, T - S:]), (cv, v[:, T - S:])):
                    c[:, :roll], c[:, roll:] = t[:, S - roll:], t[:, :S - roll]
            else:
                idx = (torch.arange(S, device=x.device) + roll) % S
                ck[:, idx], cv[:, idx] = k[:, T - S:], v[:, T - S:]
        new_entry["kv"] = entry["kv"]
        attn_out = attn_mod.attention_core(lp["attn"], cfg, q, k, v, window,
                                           impl=impl)
    if cfg.has_ssm:
        sp = lp["ssm"]
        u, z = (h @ sp["in_proj"]).chunk(2, dim=-1)
        u_act = F.silu(ssm_mod._causal_conv1d(u, sp["conv_w"], sp["conv_b"]))
        y, h_final = ssm_mod.gated_scan(u_act, z, sp, cfg, x.dtype, impl)
        new_entry["ssm"] = {"h": h_final,
                            "conv": u[:, -(cfg.ssm_conv - 1):, :].contiguous()}
        ssm_out = y @ sp["out_proj"]
    if enc_out is not None:
        ekv = attn_mod.encode_cross_kv(lp["cross"], cfg, enc_out)
    x, _ = _mix(cfg, lp, x, attn_out, ssm_out,
                _prefill_cross(cfg, lp, ekv, impl))
    return x, new_entry, ekv


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache: Dict[str, Any], impl: str = "auto"
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the full prompt (the vision prefix ahead of it, the encoder
    over ``batch["enc_input"]`` first), filling caches. Returns
    (last-token logits [B, V], cache)."""
    x, positions = embed_inputs(cfg, params, batch)
    enc_out = _encoder_output(cfg, params, batch, impl)
    new_list, cross = [], []
    for lp, w, entry in zip(params["layers"], layer_windows(cfg), cache["layers"]):
        x, new_entry, ekv = _prefill_layer(cfg, lp, x, positions, w, entry,
                                           enc_out, impl)
        x = shard_batch(x)
        new_list.append(new_entry)
        cross.append(ekv)
    new_cache: Dict[str, Any] = {"layers": new_list}
    if cfg.is_enc_dec:
        new_cache["cross_kv"] = cross
    return _logits(cfg, params, x[:, -1]), new_cache


def _decode_layer(cfg: ModelConfig, lp: Params, x, entry: Dict[str, Any],
                  t: int, window: int, cross_kv=None):
    """One layer of single-token decode: returns (x_out, new_entry)."""
    lp = gather_fsdp(lp)
    new_entry: Dict[str, Any] = {}
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    a_out = s_out = cross = None
    if cfg.has_attention:
        a_out, new_entry["kv"] = attn_mod.decode_attention(
            lp["attn"], cfg, h, entry["kv"], t, window=window)
    if cfg.has_ssm:
        s_out, new_entry["ssm"] = ssm_mod.ssm_decode_step(
            lp["ssm"], cfg, h, entry["ssm"])
    if cross_kv is not None:
        cross = functools.partial(attn_mod.decode_cross_attention,
                                  lp["cross"], cfg, enc_kv=cross_kv)
    return _mix(cfg, lp, x, a_out, s_out, cross)[0], new_entry


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, Any], t: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step (plain PyTorch, no kernel). tokens: [B, 1]; t:
    current position, the vision prefix included (an int; a 0-d tensor is
    read to the host). The cache's k/v are written in place."""
    check_family(cfg)
    t = int(t)
    x = shard_batch(_embed(gather_fsdp(params["embed"]), tokens).to(cfg.dtype))
    if cfg.is_enc_dec and cache["cross_kv"] is None:
        raise ValueError(f"{cfg.name}: decode needs the encoder's keys and "
                         f"values, which prefill puts in the cache")
    cross = cache.get("cross_kv") or [None] * cfg.n_layers
    new_list: List[Dict[str, Any]] = []
    for lp, w, entry, ckv in zip(params["layers"], layer_windows(cfg),
                                 cache["layers"], cross):
        x, new_entry = _decode_layer(cfg, lp, x, entry, t, w, ckv)
        new_list.append(new_entry)
    new_cache: Dict[str, Any] = {"layers": new_list}
    if cfg.is_enc_dec:
        new_cache["cross_kv"] = cache["cross_kv"]
    return _logits(cfg, params, x)[:, -1], new_cache
