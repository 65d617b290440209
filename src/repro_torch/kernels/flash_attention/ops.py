"""Entry point of the attention forward: :func:`flash_attention`
(``repro.kernels.flash_attention.ops:21``).

``impl`` follows ``repro_torch.kernels.registry`` and takes the place of
``repro``'s ``use_pallas``/``interpret``: ``"torch"`` runs the plain
version (``ref.py``) on any device, ``"cuda"`` the hand-written kernel
(``csrc/flash_attention.cu``) and raises off a CUDA device, ``"auto"`` is
``"cuda"`` for CUDA tensors and ``"torch"`` for CPU ones. The function runs
where its tensors live. No padding: the kernel masks the ragged edges of T
and S itself. The kernel's wrapper checks device, dtype, shape and
contiguity, launches on the current stream without synchronising, raises
on a CUDA error and counts its launches (:func:`launch_counts`); it has no
fallback.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.registry import resolve_tick_impl

KERNELS = ("flash_attention",)

_P = ctypes.c_void_p
_I = ctypes.c_int

#: argtypes of the C entry points (see ``_build.KernelLib``).
_SIGNATURES = {
    "fa_max_head_dim": ([], _I),
    "fa_error_string": ([_I], ctypes.c_char_p),
    "fa_forward": ([_P] * 4 + [_I] * 8 + [ctypes.c_float, _I, _P], _I),
}

_LIB = _build.KernelLib("flash_attention", _SIGNATURES, "fa_error_string",
                        KERNELS)
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts


def _attention_kernel(q, k, v, causal: bool, window: int):
    """Launch ``csrc/flash_attention.cu`` on CUDA tensors (contract of
    ``ref.attention``)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the attention kernel needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k and v must be [B, heads, length, head_dim]")
    B, nh, T, hd = q.shape
    nkv, S = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: expected torch.float32 or torch.bfloat16, got "
                         f"{q.dtype}")
    chk = _build.check_tensor
    chk("q", q, q.dtype, (B, nh, T, hd), dev)
    chk("k", k, q.dtype, (B, nkv, S, hd), dev)
    chk("v", v, q.dtype, (B, nkv, S, hd), dev)
    if nkv < 1 or nh % nkv:
        raise ValueError(f"{nh} query heads are not a multiple of {nkv} kv "
                         f"heads")
    max_hd = _LIB.get().fa_max_head_dim()  # the accumulator patch's width
    if not 1 <= hd <= max_hd:
        raise ValueError(f"head_dim {hd} outside 1..{max_hd}")
    if S < 1:
        raise ValueError("no keys: S must be at least 1")
    out = torch.empty_like(q)
    if T == 0 or B == 0 or nh == 0:
        return out
    _LIB.launch("flash_attention", "fa_forward", dev,
                *(t.data_ptr() for t in (q, k, v, out)), B, nh, nkv, T, S,
                hd, int(bool(causal)), int(window), hd ** -0.5,
                int(q.dtype == torch.bfloat16))
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    impl: str = "auto"):
    """``q [B, nh, T, hd]``, ``k/v [B, nkv, S, hd]`` (float32 or bfloat16)
    -> ``[B, nh, T, hd]`` in ``q.dtype``; see ``ref.attention`` for the
    masks and the head mapping."""
    if resolve_tick_impl(impl, q.device).use_kernel:
        return _attention_kernel(q, k, v, causal, int(window))
    return ref.attention(q, k, v, causal=causal, window=window)
