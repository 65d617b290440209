"""Serving substrate: KV/SSM caches, prefill/decode steps, batch engine."""

from repro_torch.serve.engine import make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step"]
