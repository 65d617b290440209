"""Entry points of the Mamba-1 selective scan: :func:`mamba_scan`
(``repro.kernels.mamba_scan.ops:19``) and :func:`selective_scan`, the same
recurrence from its own inputs, with dA and dBu formed in the kernel.

``impl`` follows ``repro_torch.kernels.registry`` and takes the place of
``repro``'s ``use_pallas``: ``"torch"`` runs the plain version
(``ref.py``) on any device, ``"cuda"`` the hand-written kernel
(``csrc/mamba_scan.cu``, one kernel with an entry for each) and raises off
a CUDA device, ``"auto"`` is ``"cuda"`` for CUDA tensors and ``"torch"``
for CPU ones. The functions run where their tensors live; nothing is
padded. The wrappers check device, dtype, shape and layout, size the
launch to the card (:func:`scan_geometry`), launch on the current stream
without synchronising, raise on a CUDA error and count their launches
(:func:`launch_counts`, one name an entry); they have no fallback. Under
autograd the fused entry's backward is the plain version's, recomputed
from its saved inputs (``kernels.autograd``); the contract entry, off the
training path, has none and refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build, sharded
from repro_torch.kernels.autograd import kernel_with_plain_backward
from repro_torch.kernels.mamba_scan import ref
from repro_torch.kernels.registry import resolve_tick_impl

KERNELS = ("mamba_scan", "selective_scan")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: argtypes of the C entry points (see ``_build.KernelLib``).
_SIGNATURES = {
    "ms_max_state": ([], _I),
    "ms_error_string": ([_I], ctypes.c_char_p),
    "ms_scan": ([_P] * 4 + [_I] * 6 + [_P, _P], _I),
    "ms_selective_scan": ([_P] * 6 + [_I] * 4 + [_LL] * 4 + [_I] * 3
                          + [_P, _P], _I),
}

_LIB = _build.KernelLib("mamba_scan", _SIGNATURES, "ms_error_string",
                        KERNELS)
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts

#: The kernel's constants (``csrc/mamba_scan.cu``): states a thread holds
#: (``kV``), ring stages (``kStages``), warps a block at most
#: (``kMaxWarps``), dynamic shared memory a block at most (``kMaxSmem``).
STATES_PER_THREAD, STAGES, MAX_WARPS, MAX_SMEM = 4, 4, 16, 232448
#: Time steps a ring stage at most: past it a stage's barrier is a small
#: share of its work.
MAX_STEPS = 32
#: Shared memory an SM (228 KB), of which each resident block reserves 1 KB.
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024


def group_log2(N: int) -> int:
    """log2 of the threads that share one ``(b, d)``: the least power of
    two that holds ``N`` states at ``STATES_PER_THREAD`` a thread."""
    g = 0
    while (STATES_PER_THREAD << g) < N:
        g += 1
    return g


def _round16(x: int) -> int:
    return (x + 15) & ~15


def step_bytes(fused: bool, tile: int, N: int, esz: int) -> int:
    """Shared memory of one time step of a block of ``tile`` pairs
    (``StepLayout``): contract dA, dBu and C rows, fused u, dt, B and C
    rows, each slot rounded to 16 bytes; ``esz`` is the fused inputs'
    element size."""
    if fused:
        rows = (tile * esz, tile * 4, N * esz, N * esz)
    else:
        rows = (tile * N * 4, tile * N * 4, 0, N * 4)
    return sum(map(_round16, rows))


def scan_geometry(B: int, D: int, N: int, sm_count: int, fused: bool,
                  esz: int = 4) -> Tuple[int, int]:
    """``(warps, steps)`` of a launch: the least warps a block (at most
    ``MAX_WARPS``) for which the ``B x ceil(D / tile)`` blocks fit on
    ``sm_count`` SMs at one each, so every state is resident at once and no
    SM holds more than one block's warps; then the most time steps a ring
    stage (at most ``MAX_STEPS``) for which ``STAGES`` stages fit in the
    shared memory that share of an SM leaves."""
    per_warp = 32 >> group_log2(N)  # (b, d) pairs a warp
    warps_b = -(-D // per_warp)
    warps = next((w for w in range(1, MAX_WARPS + 1)
                  if B * -(-warps_b // w) <= sm_count), MAX_WARPS)
    warps = max(1, min(warps, warps_b))
    blocks = B * -(-warps_b // warps)
    per_sm = -(-blocks // sm_count)
    budget = min(MAX_SMEM, SMEM_PER_SM // per_sm - SMEM_RESERVED)
    step = step_bytes(fused, warps * per_warp, N, esz)
    steps = max(1, min(MAX_STEPS, budget // (STAGES * step)))
    return warps, steps


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _state_out(B, T, D, N, return_state, dev):
    # the kernel writes the final state only where it is asked for; with
    # no step there is none to write, and the state stays h_{-1} = 0
    return (None if not return_state else
            torch.empty((B, D, N), dtype=torch.float32, device=dev) if T else
            torch.zeros((B, D, N), dtype=torch.float32, device=dev))


def _check_state_width(N: int) -> None:
    max_n = _LIB.get().ms_max_state()
    if not 1 <= N <= max_n:
        raise ValueError(f"state width N = {N} outside 1..{max_n}")


def _scan_kernel(dA, dBu, C, return_state: bool):
    """Launch ``ms_scan`` on CUDA tensors (contract of
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
    _check_state_width(N)
    warps, steps = scan_geometry(B, D, N, _sm_count(dev.index), False)
    y = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    h = _state_out(B, T, D, N, return_state, dev)
    _LIB.launch("mamba_scan", "ms_scan", dev,
                *(t.data_ptr() for t in (dA, dBu, C, y)), B, T, D, N,
                warps, steps, None if h is None else h.data_ptr())
    return (y, h) if return_state else y


def _check_rows(name: str, t, dtype, shape, device) -> None:
    """``t`` of ``dtype`` and ``shape`` on ``device`` with unit stride
    along its last axis (a column slice of a wider tensor is taken as it
    is)."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.stride(2) != 1 and t.shape[2] > 1:
        raise ValueError(f"{name}: expected unit stride along N")
    _build.refuse_grad(name, t)


def _selective_kernel(u, dt, A, Bm, Cm, return_state: bool):
    """Launch ``ms_selective_scan`` on CUDA tensors (contract of
    ``ref.selective_scan``)."""
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"the scan kernel needs CUDA tensors, got {dev}")
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError(f"u, A: expected [B, T, D] and [D, N], got "
                         f"{tuple(u.shape)} and {tuple(A.shape)}")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"u: expected float32 or bfloat16, got {u.dtype}")
    B, T, D = u.shape
    N = A.shape[1]
    chk = _build.check_tensor
    chk("u", u, u.dtype, (B, T, D), dev)
    chk("dt", dt, torch.float32, (B, T, D), dev)
    chk("A", A, torch.float32, (D, N), dev)
    _check_rows("Bm", Bm, u.dtype, (B, T, N), dev)
    _check_rows("Cm", Cm, u.dtype, (B, T, N), dev)
    _check_state_width(N)
    esz = u.element_size()
    warps, steps = scan_geometry(B, D, N, _sm_count(dev.index), True, esz)
    y = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    h = _state_out(B, T, D, N, return_state, dev)
    _LIB.launch("selective_scan", "ms_selective_scan", dev,
                *(t.data_ptr() for t in (u, dt, A, Bm, Cm, y)), B, T, D, N,
                Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
                int(u.dtype == torch.bfloat16), warps, steps,
                None if h is None else h.data_ptr())
    return (y, h) if return_state else y


def mamba_scan(dA, dBu, C, *, return_state: bool = False,
               impl: str = "auto"):
    """``dA, dBu [B, T, D, N] float32``, ``C [B, T, N] float32`` ->
    ``y [B, T, D] float32``, or ``(y, h_T [B, D, N])`` with
    ``return_state``; see ``ref.mamba_scan``. ``impl="shape"``: the dry
    run's shape-only entry (``kernels.sharded``)."""
    if impl == "shape":
        return sharded.mamba_scan_shape(dA, dBu, C, return_state=return_state)
    if resolve_tick_impl(impl, dA.device).use_kernel:
        return _scan_kernel(dA, dBu, C, return_state)
    return ref.mamba_scan(dA, dBu, C, return_state=return_state)


def _selective_route(u, dt, A, Bm, Cm, return_state: bool, launch=None):
    """``launch`` (default: the fused kernel) on the scan's inputs; under
    autograd its outputs' backward is the plain version's, recomputed
    (``kernels.autograd``), with gradients to u, dt, A, Bm and Cm (those
    of the strided Bm and Cm come back contiguous)."""
    launch = launch or _selective_kernel
    return kernel_with_plain_backward(
        lambda *a: launch(*a, return_state),
        lambda *a: ref.selective_scan(*a, return_state=return_state),
        u, dt, A, Bm, Cm)


def selective_scan(u, dt, A, Bm, Cm, *, return_state: bool = False,
                   impl: str = "auto"):
    """``u [B, T, D]`` (float32 or bfloat16), ``dt [B, T, D] float32``
    (after the softplus), ``A [D, N] float32`` (``-exp(A_log)``), ``Bm,
    Cm [B, T, N]`` of ``u``'s type (column slices taken as they are) ->
    ``y [B, T, D] float32``, or ``(y, h_T [B, D, N])`` with
    ``return_state``; see ``ref.selective_scan``. Differentiable on both
    routes: the kernel route's backward is the plain version's. DTensor
    inputs run each rank's shards (``kernels.sharded``); ``impl="shape"``
    is the dry run's shape-only entry (fake tensors only)."""
    if impl == "shape":
        def run(*a):
            return sharded.selective_scan_shape(*a, return_state=return_state)
    elif resolve_tick_impl(impl, u.device).use_kernel:
        def run(*a):
            return _selective_route(*a, return_state)
    else:
        def run(*a):
            return ref.selective_scan(*a, return_state=return_state)
    if isinstance(u, DTensor):
        return sharded.sharded_scan(run, u, dt, A, Bm, Cm, return_state)
    return run(u, dt, A, Bm, Cm)
