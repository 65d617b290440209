"""Serving steps + a minimal batched serving loop, the port's counterpart
of ``repro.serve.engine``.

``make_prefill_step`` / ``make_decode_step`` return the step functions:
prefill consumes the prompt and fills per-layer caches (ring buffers for
local-attention layers) through the attention and Mamba-scan kernels;
decode advances one token for the whole batch (greedy ``argmax``).
``ServeLoop`` is the batched request loop: greedy sampling in waves of
``batch_slots`` requests, as ``repro``'s. It runs eagerly on the device
that holds the parameters. It feeds tokens only, as ``repro``'s does: a
vision config is served on its text alone (no patch embeddings), and an
enc-dec config, whose prefill needs the encoder's ``enc_input``, is
refused there with a ``ValueError`` (``repro``'s raises ``KeyError``);
serve those through :func:`make_prefill_step` with the batch's
``"frontend"`` or ``"enc_input"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Params, decode_step, init_cache, prefill
from repro_torch.models.modules import full_last_dim
from repro_torch.parallel.ctx import sharding_ctx


def make_prefill_step(cfg: ModelConfig, impl: str = "auto", mesh=None,
                      **ctx_opts) -> Callable:
    """``prefill_step(params, batch, cache)``; with a ``mesh`` (DTensor
    parameters, batch and cache) under ``sharding_ctx(mesh, **ctx_opts)``
    (``moe_local_dispatch``, ``no_ep``)."""
    def prefill_step(params, batch, cache):
        with sharding_ctx(mesh, **ctx_opts):
            return prefill(cfg, params, batch, cache, impl=impl)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None, **ctx_opts) -> Callable:
    """``serve_step(params, tokens, cache, t)`` -> (next tokens, logits,
    cache); ``mesh`` and ``ctx_opts`` as :func:`make_prefill_step`'s."""
    def serve_step(params, tokens, cache, t):
        with sharding_ctx(mesh, **ctx_opts):
            logits, new_cache = decode_step(cfg, params, tokens, cache, t)
            next_tok = full_last_dim(logits).argmax(-1)[:, None]
        return next_tok, logits, new_cache

    return serve_step


@dataclass
class Request:
    rid: int
    prompt: torch.Tensor  # [T] int
    max_new: int = 16


class ServeLoop:
    """Small batching loop (slot-per-request, greedy)."""

    def __init__(self, cfg: ModelConfig, params: Params, batch_slots: int,
                 max_len: int, impl: str = "auto"):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.decode = make_decode_step(cfg)
        self.prefill = make_prefill_step(cfg, impl)

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve requests in waves of `slots` (simple admission policy):
        each wave's prompts left-padded with token 0 to its longest
        (the pad is attended, as in ``repro``), empty slots given a prompt
        of zeros, decoding from position T for the wave's largest
        ``max_new``."""
        results: Dict[int, List[int]] = {}
        queue = list(requests)
        while queue:
            wave = queue[: self.slots]
            queue = queue[len(wave):]
            prompts = [r.prompt.to(self.device, torch.long) for r in wave]
            T = max(p.shape[0] for p in prompts)
            toks = torch.stack([
                F.pad(p, (T - p.shape[0], 0)) for p in prompts
            ] + [torch.zeros((T,), dtype=torch.long, device=self.device)]
                * (self.slots - len(wave)))
            cache = init_cache(self.cfg, self.slots, self.max_len, self.device)
            logits, cache = self.prefill(self.params, {"tokens": toks}, cache)
            cur = logits.argmax(-1)[:, None]
            t = T
            max_new = max(r.max_new for r in wave)
            outs = [cur]
            for _ in range(max_new - 1):
                cur, _, cache = self.decode(self.params, cur, cache, t)
                outs.append(cur)
                t += 1
            gen = torch.cat(outs, dim=1).tolist()
            for i, r in enumerate(wave):
                results[r.rid] = gen[i][: r.max_new]
        return results
