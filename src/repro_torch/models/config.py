"""Unified model configuration, the port's copy of ``repro.models.config``.

One frozen dataclass covers every family ``repro`` defines (dense, moe,
ssm, hybrid, vlm, audio), and the port serves them all
(``repro_torch.models.model``). ``dtype`` is a
``torch.dtype`` (``repro``'s is a ``jnp`` type); every other field and
helper is ``repro``'s, and ``tests/test_torch_models.py`` holds each
config's fields and ``param_count()`` equal to ``repro``'s.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    # -- attention variants ---------------------------------------------------
    qk_norm: bool = False            # qwen3
    attn_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # local-attention window (gemma3, hymba)
    global_every: Optional[int] = None    # every k-th layer global (gemma3: 6)
    global_layers: Tuple[int, ...] = ()   # explicit global layer ids (hymba)
    rope_theta: float = 10_000.0
    # -- MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_dense_ff: int = 0            # arctic: parallel dense-residual MLP width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # -- SSM (mamba-1) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: Optional[int] = None    # default: ceil(d_model / 16)
    # -- hybrid (hymba: parallel attn + ssm heads in each block) ----------------
    hybrid: bool = False
    # -- encoder-decoder (seamless backbone) -------------------------------------
    encoder_layers: int = 0          # > 0 => enc-dec
    # -- modality frontend stubs --------------------------------------------------
    frontend: Optional[str] = None   # "vision" | "audio"
    frontend_tokens: int = 0         # tokens contributed by the stub frontend
    frontend_dim: int = 0            # embedding dim delivered by the frontend
    # -- misc ---------------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = True

    # ----------------------------------------------------------------- helpers
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank if self.dt_rank is not None else -(-self.d_model // 16)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def is_global_layer(self, i: int) -> bool:
        """Static per-layer attention pattern (full vs sliding window)."""
        if self.sliding_window is None:
            return True
        if self.global_layers:
            return i in self.global_layers
        if self.global_every:
            # gemma3 pattern: 5 local then 1 global, repeating.
            return (i % self.global_every) == (self.global_every - 1)
        return False

    def layer_globals(self) -> Tuple[bool, ...]:
        return tuple(self.is_global_layer(i) for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers), for roofline math."""
        hd, d = self.hd, self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.has_attention:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            per_layer += q + kv + o
        if self.family == "moe":
            per_layer += self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            if self.moe_dense_ff:
                per_layer += 3 * d * self.moe_dense_ff
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff
        if self.has_ssm:
            di, n, dtr = self.d_inner, self.ssm_state, self.dtr
            per_layer += 2 * d * di          # in_proj (x, z)
            per_layer += di * self.ssm_conv  # conv
            per_layer += di * (dtr + 2 * n)  # x -> (dt, B, C)
            per_layer += dtr * di + di       # dt_proj
            per_layer += di * n + di         # A_log, D
            per_layer += di * d              # out_proj
        per_layer += 2 * d  # norms
        total = emb + self.n_layers * per_layer
        if self.is_enc_dec:
            # encoder layers: self-attn + mlp; decoder adds cross-attn.
            enc_layer = 4 * d * self.n_heads * hd + 3 * d * self.d_ff + 2 * d
            total += self.encoder_layers * enc_layer
            total += self.n_layers * (2 * d * self.n_kv_heads * hd + 2 * d * self.n_heads * hd)
        return int(total)

    def active_param_count(self) -> int:
        """Active (per-token) parameters — MoE counts top_k experts only."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * d * self.d_ff
        return int(self.param_count() - inactive)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
