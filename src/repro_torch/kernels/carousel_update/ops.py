"""Entry points of the carousel tick: :func:`carousel_tick` and the tick
engine :func:`simulate_ticks` (``repro.kernels.carousel_update.ops:38``,
``:50``).

``tick_impl`` follows ``repro_torch.kernels.registry``: ``"torch"`` runs
the plain version (``ref.py``) on any device, ``"cuda"`` the hand-written
kernel (``csrc/carousel_update.cu``) and raises off a CUDA device, and
``"auto"`` is ``"cuda"`` for CUDA tensors and ``"torch"`` for CPU ones. The
kernel's wrapper checks device, dtype, shape and contiguity, launches on
the current stream without synchronising, raises on a CUDA error and
counts its launches (:func:`launch_counts`); it has no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.carousel_update import ref
from repro_torch.kernels.registry import resolve_device, resolve_tick_impl

KERNELS = ("carousel_tick",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: argtypes of the C entry points (see ``_build.KernelLib``).
_SIGNATURES = {
    "cu_max_links": ([], _I),
    "cu_error_string": ([_I], ctypes.c_char_p),
    "cu_carousel_tick": ([_P] * 6 + [ctypes.c_float, _LL, _I] + [_P] * 5,
                         _I),
}

_LIB = _build.KernelLib("carousel_update", _SIGNATURES, "cu_error_string",
                        KERNELS)
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts


def _tick_kernel(link_id, active, done, total, bw, mode, dt):
    """Launch ``csrc/carousel_update.cu`` on CUDA tensors (contract of
    ``ref.carousel_tick``; ``dt`` a number of seconds). ``M`` may not exceed
    the links one block's shared memory holds (``cu_max_links()``,
    58,112)."""
    dev = link_id.device
    if dev.type != "cuda":
        raise ValueError(f"the carousel kernel needs CUDA tensors, got {dev}")
    N, M = link_id.shape[0], bw.shape[0]
    chk = _build.check_tensor
    chk("link_id", link_id, torch.int32, (N,), dev)
    chk("active", active, torch.bool, (N,), dev)
    chk("done", done, torch.float32, (N,), dev)
    chk("total", total, torch.float32, (N,), dev)
    chk("bw", bw, torch.float32, (M,), dev)
    chk("mode", mode, torch.int32, (M,), dev)
    lib = _LIB.get()
    if not 1 <= M <= lib.cu_max_links():
        raise ValueError(f"carousel kernel: {M} links, expected 1 to "
                         f"{lib.cu_max_links()} (one block's shared memory)")
    counts_i = torch.empty((M,), dtype=torch.int32, device=dev)
    new_done = torch.empty((N,), dtype=torch.float32, device=dev)
    completed = torch.empty((N,), dtype=torch.bool, device=dev)
    counts = torch.empty((M,), dtype=torch.float32, device=dev)
    _LIB.launch("carousel_tick", "cu_carousel_tick", dev,
                *(t.data_ptr() for t in (link_id, active, done, total, bw,
                                         mode)),
                float(dt), N, M,
                *(t.data_ptr() for t in (counts_i, new_done, completed,
                                         counts)))
    return new_done, completed, counts


def carousel_tick(link_id, active, done, total, bw, mode, dt: float,
                  tick_impl: str = "auto"):
    """One transfer-manager tick of ``dt`` seconds where the tensors live;
    see ``ref.carousel_tick`` for the contract. Returns ``(new_done,
    completed, counts)``."""
    impl = resolve_tick_impl(tick_impl, link_id.device)
    fn = _tick_kernel if impl.use_kernel else ref.carousel_tick
    return fn(link_id, active, done, total, bw, mode, dt)


def simulate_ticks(link_id, active, done, total, bw, mode, dt: float,
                   n_ticks: int, *, tick_impl: str = "auto", device=None):
    """Run ``n_ticks`` of the tick engine: each tick advances the active
    transfers, and those that complete leave the active set.

    Runs on ``device`` (default ``cuda``; the CPU only when asked for), the
    inputs moved there. Returns ``(active [N] bool, done [N] float32,
    completions [n_ticks] int32)``, as ``repro``'s ``simulate_ticks``. The
    loop is in Python and makes no host sync. Unlike ``repro``, which
    always steps its jnp reference, each tick runs the implementation that
    ``tick_impl`` selects, so on the card the loop runs the kernel; both
    compute the same function, bitwise.
    """
    dev = resolve_device(device)
    impl = resolve_tick_impl(tick_impl, dev)
    link_id, active, done, total, bw, mode = (
        t.to(dev) for t in (link_id, active, done, total, bw, mode))
    per_tick = []
    for _ in range(n_ticks):
        done, completed, _ = carousel_tick(link_id, active, done, total, bw,
                                           mode, dt, tick_impl=impl.name)
        active = active & ~completed
        per_tick.append(completed.sum(dtype=torch.int32))
    completions = (torch.stack(per_tick) if per_tick
                   else torch.zeros(0, dtype=torch.int32, device=dev))
    return active, done, completions
