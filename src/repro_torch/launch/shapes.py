"""Assigned input shapes and abstract input specs per (arch x shape), the
port's counterpart of ``repro.launch.shapes``.

Shapes (LM-family: seq_len x global_batch):
  train_4k     4,096 x 256   -> train_step
  prefill_32k  32,768 x 32   -> prefill_step
  decode_32k   32,768 x 128  -> serve_step (1 new token, seq_len KV cache)
  long_500k    524,288 x 1   -> serve_step; sub-quadratic archs only

``long_500k`` runs for ssm (falcon-mamba), hybrid (hymba) and
mostly-local gemma3; it is skipped for pure full-attention archs.
phi-3-vision's 4k train sequence = 256 stub patch tokens + 3,840 text
tokens; seamless train feeds seq_len stub audio frames to the encoder and
seq_len/4 text tokens to the decoder; seamless serve shapes decode against
a seq_len decoder cache with a fixed 4,096-frame encoder context.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

LONG_CONTEXT_OK = {"falcon_mamba_7b", "hymba_1_5b", "gemma3_27b"}

#: Encoder frames of an enc-dec serve shape.
ENC_FRAMES = 4096


class Spec(NamedTuple):
    """A stand-in for one input: its shape and type, nothing allocated
    (``jax.ShapeDtypeStruct``'s role)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def meta(self) -> torch.Tensor:
        """A ``meta`` tensor of this shape and type."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: long_500k skipped (quadratic)"
    return True, ""


def _sds(shape, dtype) -> Spec:
    return Spec(tuple(shape), dtype)


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Spec]:
    """:class:`Spec` stand-ins for every model input (no allocation)."""
    s = SHAPES[shape_name]
    seq, batch, kind = s["seq"], s["batch"], s["kind"]
    i32 = torch.int32

    if kind == "train":
        if cfg.frontend == "vision":
            text = seq - cfg.frontend_tokens
            return {
                "tokens": _sds((batch, text), i32),
                "labels": _sds((batch, text), i32),
                "frontend": _sds((batch, cfg.frontend_tokens, cfg.frontend_dim),
                                 cfg.dtype),
            }
        if cfg.is_enc_dec:
            return {
                "tokens": _sds((batch, seq // 4), i32),
                "labels": _sds((batch, seq // 4), i32),
                "enc_input": _sds((batch, seq, cfg.frontend_dim), torch.float32),
            }
        return {
            "tokens": _sds((batch, seq), i32),
            "labels": _sds((batch, seq), i32),
        }

    if kind == "prefill":
        out = {"tokens": _sds((batch, seq), i32)}
        if cfg.frontend == "vision":
            out["tokens"] = _sds((batch, seq - cfg.frontend_tokens), i32)
            out["frontend"] = _sds((batch, cfg.frontend_tokens, cfg.frontend_dim),
                                   cfg.dtype)
        if cfg.is_enc_dec:
            out["enc_input"] = _sds((batch, ENC_FRAMES, cfg.frontend_dim),
                                    torch.float32)
        return out

    # decode: one new token against a seq-length cache
    return {"tokens": _sds((batch, 1), i32)}


def decode_cache_len(shape_name: str) -> int:
    return SHAPES[shape_name]["seq"]
