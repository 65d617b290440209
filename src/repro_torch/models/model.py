"""Decoder LMs for serving (dense, SSM, hybrid), the port's counterpart of
``repro.models.model``.

Parameters are plain dictionaries of tensors in ``repro``'s layouts, with
one difference: ``params["layers"]`` is a list of per-layer dictionaries
(``repro`` stacks them on a leading ``[L]`` axis for its scans;
``repro_torch.models.convert`` splits them). Every function walks the
layers in a Python loop, and every arch keeps a per-layer cache list:
local-attention layers keep ring buffers of window length, global layers
full-length caches (``repro`` does this for sliding-window archs and
scans stacked caches for the others).

Prefill runs each layer's attention through the attention kernel and its
SSM through the Mamba-scan kernel's fused entry, ``selective_scan`` (``impl``: ``"auto"``, ``"cuda"`` or
``"torch"``, as ``repro_torch.kernels.registry`` says), decode in plain
PyTorch, as ``repro``'s does. Families ``moe``, ``vlm`` and ``audio`` and
enc-dec backbones are not ported: they raise ``NotImplementedError``.
Training (``loss_fn``) is not ported either.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.registry import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import (
    dense_init,
    init_embedding,
    init_mlp,
    init_rms_norm,
    rms_norm,
    swiglu,
)

Params = Dict[str, Any]

#: Families the port serves.
FAMILIES = ("dense", "ssm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not serve."""
    if cfg.family not in FAMILIES or cfg.is_enc_dec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (MoE, the "
            f"vision and audio front ends and enc-dec backbones are "
            f"ROADMAP.md queue 1 item 6b); the port serves "
            f"{', '.join(FAMILIES)}")


# --------------------------------------------------------------------- init
def _init_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    p: Params = {"norm1": init_rms_norm(cfg.d_model, dev)}
    if cfg.has_attention:
        p["attn"] = attn_mod.init_attention(generator, cfg)
    if cfg.has_ssm:
        p["ssm"] = ssm_mod.init_ssm(generator, cfg)
    if cfg.family in ("dense", "hybrid"):
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.dtype)
        p["norm2"] = init_rms_norm(cfg.d_model, dev)
    if cfg.family == "hybrid":
        p["norm_attn_out"] = init_rms_norm(cfg.d_model, dev)
        p["norm_ssm_out"] = init_rms_norm(cfg.d_model, dev)
    return p


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
    return p


def layer_windows(cfg: ModelConfig) -> Tuple[int, ...]:
    """Per-layer attention window, 0 for a global layer (the attention
    kernel's convention; ``repro`` uses a large sentinel)."""
    return tuple(0 if cfg.is_global_layer(i) or cfg.sliding_window is None
                 else int(cfg.sliding_window) for i in range(cfg.n_layers))


# ------------------------------------------------------------------ forward
def _mix(cfg: ModelConfig, lp: Params, x, attn_out, ssm_out):
    """The block after its attention and SSM halves (``repro``'s
    ``_layer_apply`` from the mix on)."""
    if cfg.family == "ssm":
        return x + ssm_out
    if cfg.family == "hybrid":
        x = x + 0.5 * (rms_norm(attn_out, lp["norm_attn_out"], cfg.norm_eps)
                       + rms_norm(ssm_out, lp["norm_ssm_out"], cfg.norm_eps))
    else:
        x = x + attn_out
    h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"], lp["mlp"]["w_down"])


def embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """Token embedding. Returns (x [B, T, d], positions [B, T])."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    return x, positions


def _logits(cfg: ModelConfig, params: Params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(cfg.dtype)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            impl: str = "auto") -> torch.Tensor:
    """Logits [B, T, V] of the whole sequence, layer by layer: the port's
    own reference for :func:`prefill` and :func:`decode_step`."""
    x, positions = embed_inputs(cfg, params, batch)
    for lp, w in zip(params["layers"], layer_windows(cfg)):
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        a = (attn_mod.attention(lp["attn"], cfg, h, positions, w, impl=impl)
             if cfg.has_attention else None)
        s = ssm_mod.ssm_block(lp["ssm"], cfg, h, impl) if cfg.has_ssm else None
        x = _mix(cfg, lp, x, a, s)
    return _logits(cfg, params, x)


# ------------------------------------------------------------------ serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device, None] = None) -> Dict[str, Any]:
    """Per-layer caches (``{"layers": [entry, ...]}``) on ``device``
    (``cuda`` unless the caller asks for the CPU): ``kv`` of ``max_len``
    for a global layer and of ``min(window, max_len)`` for a local one
    (a ring buffer), ``ssm`` state and conv history."""
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
    return {"layers": layers}


def _prefill_layer(cfg: ModelConfig, lp: Params, x, positions, window: int,
                   entry: Dict[str, Any], impl: str = "auto"):
    """One FUSED layer of prefill: the block output and the cache entry in
    a single pass (q/k/v projected once, the SSM scan run once). The
    entry's k/v are written in place. Returns (x_out, new_cache_entry)."""
    T = x.shape[1]
    new_entry: Dict[str, Any] = {}
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    attn_out = ssm_out = None
    if cfg.has_attention:
        q, k, v = attn_mod._project_qkv(lp["attn"], cfg, h, positions)
        ck, cv = entry["kv"]["k"], entry["kv"]["v"]
        S = ck.shape[1]
        if S >= T:
            ck[:, :T], cv[:, :T] = k, v
        else:  # ring buffer shorter than prompt: keep the tail
            roll = (T - S) % S  # align ring slots with position mod S
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
    return _mix(cfg, lp, x, attn_out, ssm_out), new_entry


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache: Dict[str, Any], impl: str = "auto"
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the full prompt, filling caches. Returns (last-token logits
    [B, V], cache)."""
    x, positions = embed_inputs(cfg, params, batch)
    new_list = []
    for lp, w, entry in zip(params["layers"], layer_windows(cfg), cache["layers"]):
        x, new_entry = _prefill_layer(cfg, lp, x, positions, w, entry, impl)
        new_list.append(new_entry)
    return _logits(cfg, params, x[:, -1]), {"layers": new_list}


def _decode_layer(cfg: ModelConfig, lp: Params, x, entry: Dict[str, Any],
                  t: int, window: int):
    """One layer of single-token decode: returns (x_out, new_entry)."""
    new_entry: Dict[str, Any] = {}
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    a_out = s_out = None
    if cfg.has_attention:
        a_out, new_entry["kv"] = attn_mod.decode_attention(
            lp["attn"], cfg, h, entry["kv"], t, window=window)
    if cfg.has_ssm:
        s_out, new_entry["ssm"] = ssm_mod.ssm_decode_step(
            lp["ssm"], cfg, h, entry["ssm"])
    return _mix(cfg, lp, x, a_out, s_out), new_entry


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, Any], t: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step (plain PyTorch, no kernel). tokens: [B, 1]; t:
    current position (an int; a 0-d tensor is read to the host). The
    cache's k/v are written in place."""
    check_family(cfg)
    t = int(t)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    new_list: List[Dict[str, Any]] = []
    for lp, w, entry in zip(params["layers"], layer_windows(cfg), cache["layers"]):
        x, new_entry = _decode_layer(cfg, lp, x, entry, t, w)
        new_list.append(new_entry)
    return _logits(cfg, params, x)[:, -1], {"layers": new_list}
