"""Entry point of the Mamba-1 selective scan: :func:`mamba_scan`
(``repro.kernels.mamba_scan.ops:19``).

``impl`` follows ``repro_torch.kernels.registry`` and takes the place of
``repro``'s ``use_pallas``: ``"torch"`` runs the plain version
(``ref.py``) on any device, ``"cuda"`` the hand-written kernel
(``csrc/mamba_scan.cu``) and raises off a CUDA device, ``"auto"`` is
``"cuda"`` for CUDA tensors and ``"torch"`` for CPU ones. The function runs
where its tensors live; nothing is padded. The kernel's wrapper checks
device, dtype, shape and contiguity, launches on the current stream without
synchronising, raises on a CUDA error and counts its launches
(:func:`launch_counts`); it has no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import ref
from repro_torch.kernels.registry import resolve_tick_impl

KERNELS = ("mamba_scan",)

_P = ctypes.c_void_p
_I = ctypes.c_int

#: argtypes of the C entry points (see ``_build.KernelLib``).
_SIGNATURES = {
    "ms_max_state": ([], _I),
    "ms_error_string": ([_I], ctypes.c_char_p),
    "ms_scan": ([_P] * 4 + [_I] * 4 + [_P], _I),
}

_LIB = _build.KernelLib("mamba_scan", _SIGNATURES, "ms_error_string",
                        KERNELS)
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts


def _scan_kernel(dA, dBu, C):
    """Launch ``csrc/mamba_scan.cu`` on CUDA tensors (contract of
    ``ref.mamba_scan``)."""
    dev = dA.device
    if dev.type != "cuda":
        raise ValueError(f"the scan kernel needs CUDA tensors, got {dev}")
    if dA.dim() != 4:
        raise ValueError(f"dA: expected [B, T, D, N], got {tuple(dA.shape)}")
    B, T, D, N = dA.shape
    chk = _build.check_tensor
    chk("dA", dA, torch.float32, (B, T, D, N), dev)
    chk("dBu", dBu, torch.float32, (B, T, D, N), dev)
    chk("C", C, torch.float32, (B, T, N), dev)
    max_n = _LIB.get().ms_max_state()  # one warp's lanes per (b, d)
    if not 1 <= N <= max_n:
        raise ValueError(f"state width N = {N} outside 1..{max_n}")
    y = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    _LIB.launch("mamba_scan", "ms_scan", dev,
                *(t.data_ptr() for t in (dA, dBu, C, y)), B, T, D, N)
    return y


def mamba_scan(dA, dBu, C, *, impl: str = "auto"):
    """``dA, dBu [B, T, D, N] float32``, ``C [B, T, N] float32`` ->
    ``y [B, T, D] float32``; see ``ref.mamba_scan``."""
    if resolve_tick_impl(impl, dA.device).use_kernel:
        return _scan_kernel(dA, dBu, C)
    return ref.mamba_scan(dA, dBu, C)
