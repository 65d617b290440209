"""Model zoo for training and serving, the port's counterpart of
``repro.models``.

Families dense (command-r, qwen3, gemma3, mistral-large), MoE (olmoe,
arctic), SSM (falcon-mamba), hybrid attn+SSM (hymba), vision (phi-3-vision)
and the enc-dec audio backbone (seamless-m4t) built from one config.
Functional style: ``init_params(cfg, generator, device)`` -> dictionary of
tensors, ``forward(cfg, params, batch)`` -> ``(logits, aux)``,
``loss_fn(cfg, params, batch)`` -> ``(loss, {"ce", "aux"})``, plus
prefill/decode entry points with per-layer KV/SSM caches. Training's
forward and prefill run the port's attention and Mamba-scan kernels.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)

__all__ = [
    "ModelConfig",
    "init_params",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "init_cache",
]
