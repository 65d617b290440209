"""Plain PyTorch attention forward (masked full-score softmax), on any
device.

The definition the kernels in ``csrc/`` are held to: the CPU tests hold
it against ``repro.kernels.flash_attention.ref:9`` ``attention_ref``, and
``chip_smoke.py`` holds each kernel against it on the card. Scores and
softmax are float32 whatever the input type; the result is cast back to
``q.dtype``.
"""

from __future__ import annotations

import torch

#: Score of a masked (query, key) pair: finite, so a row whose every key is
#: masked averages all keys uniformly, as the reference does.
MASKED = -1e30


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """``q [B, nh, T, hd]``, ``k/v [B, nkv, S, hd]`` with ``nh % nkv == 0``
    (GQA: query head ``h`` reads kv head ``h // (nh // nkv)``). Query ``t``
    may see key ``s`` when ``rel = t - s`` passes the masks: ``causal``
    keeps ``rel >= 0``, a ``window > 0`` keeps ``rel < window``. Returns
    ``[B, nh, T, hd]`` in ``q.dtype``."""
    B, nh, T, hd = q.shape
    nkv, S = k.shape[1], k.shape[2]
    if nkv != nh:
        rep = nh // nkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * (hd ** -0.5)
    rel = (torch.arange(T, device=q.device)[:, None]
           - torch.arange(S, device=q.device)[None, :])
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rel >= 0
    if window > 0:
        mask &= rel < window
    s = s.masked_fill(~mask, MASKED)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", p, v.float())
    return out.to(q.dtype)
