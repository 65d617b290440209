"""Modality front-end stubs, the port's counterpart of
``repro.models.multimodal``.

``vlm`` (phi-3-vision) and ``audio`` (seamless-m4t) configs specify the
transformer backbone; the CLIP and speech front ends are stubs whose
precomputed patch or frame embeddings arrive in the batch (``"frontend"``
ahead of the text, ``"enc_input"`` for the encoder). These helpers draw
stand-ins of the right shapes and types from an explicit
``torch.Generator``, on its device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.config import ModelConfig


def _normal(cfg: ModelConfig, generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(cfg.dtype)


def synthetic_frontend(cfg: ModelConfig, generator: torch.Generator,
                       batch: int) -> torch.Tensor:
    """[B, frontend_tokens, frontend_dim] stand-in for CLIP patch embeddings."""
    if cfg.frontend != "vision":
        raise ValueError(f"{cfg.name}: no vision front end")
    return _normal(cfg, generator, (batch, cfg.frontend_tokens, cfg.frontend_dim))


def synthetic_frames(cfg: ModelConfig, generator: torch.Generator,
                     batch: int, n_frames: int) -> torch.Tensor:
    """[B, n_frames, frontend_dim] stand-in for speech-encoder frame features."""
    if cfg.frontend != "audio":
        raise ValueError(f"{cfg.name}: no audio front end")
    return _normal(cfg, generator, (batch, n_frames, cfg.frontend_dim))


def frontend_spec(cfg: ModelConfig, batch: int, n_tokens: int
                  ) -> Tuple[Tuple[int, int, int], torch.dtype]:
    """(shape, dtype) of a front end's embeddings: ``repro``'s
    ``ShapeDtypeStruct``."""
    return (batch, n_tokens, cfg.frontend_dim), cfg.dtype
