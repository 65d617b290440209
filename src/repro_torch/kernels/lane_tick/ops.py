"""Wrappers of the lane-tick CUDA kernels (``csrc/lane_tick.cu``).

Each wrapper takes the same arguments as its plain version in ``ref.py``.
A tensor on the CPU goes to that plain version; a CUDA tensor goes to the
kernel, or the wrapper raises: there is no fallback. On the card a wrapper
checks device, dtype, shape and contiguity, allocates outputs and scratch
with ``torch.empty``, launches on ``torch.cuda.current_stream()`` without
synchronising, raises if the C entry point reports a CUDA error, and adds
one to its launch count (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lane_tick import ref

KERNELS = ("transfer_tick", "gcs_admit", "window_admit")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: argtypes of the C entry points (see ``_build.KernelLib``).
_SIGNATURES = {
    "lt_transfer_tiles": ([_LL], _I),
    "lt_gcs_scratch_bytes": ([_I, _LL], _LL),
    "lt_error_string": ([_I], ctypes.c_char_p),
    "lt_transfer_tick": ([_P] * 9 + [_I, _I, _LL, _I] + [_P] * 12, _I),
    "lt_gcs_admit": ([_P] * 6 + [_I, _LL, _LL, _I, _I] + [_P] * 6, _I),
    "lt_window_admit": ([_P] * 4 + [_LL, _I, _I] + [_P] * 3, _I),
}

_LIB = _build.KernelLib("lane_tick", _SIGNATURES, "lt_error_string",
                        KERNELS)
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts
_check = _build.check_tensor



def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def transfer_tick(link_id, active, done, total, sizes, bw, mode, dt, month,
                  n_months: int):
    """See ``ref.transfer_tick``."""
    if link_id.device.type == "cpu":
        return ref.transfer_tick(link_id, active, done, total, sizes, bw,
                                 mode, dt, month, n_months)
    dev = link_id.device
    L, S, F = link_id.shape
    plane = (L, S, F)
    _check("link_id", link_id, torch.int32, plane, dev)
    _check("active", active, torch.bool, plane, dev)
    for name, t in (("done", done), ("total", total), ("sizes", sizes)):
        _check(name, t, torch.float32, plane, dev)
    _check("bw", bw, torch.float32, (L, 3 * S), dev)
    _check("mode", mode, torch.int32, (L, 3 * S), dev)
    _check("dt", dt, torch.float32, (), dev)
    _check("month", month, torch.int32, (), dev)
    lib = _LIB.get()
    n_tiles = lib.lt_transfer_tiles(F)
    f32 = dict(dtype=torch.float32, device=dev)
    counts = torch.empty((L * S * 3,), dtype=torch.int32, device=dev)
    part_bytes = torch.empty((L * S, n_tiles, 3), **f32)
    part_cnt = torch.empty((L * S, n_tiles, 2), dtype=torch.int32, device=dev)
    new_done = torch.empty(plane, **f32)
    comp = torch.empty(plane, dtype=torch.bool, device=dev)
    tape, recall, mig = (torch.empty((L, S), **f32) for _ in range(3))
    egress, cls_a, cls_b = (torch.empty((L, n_months), **f32)
                            for _ in range(3))
    _LIB.launch("transfer_tick", "lt_transfer_tick", dev,
                *map(_ptr, (link_id, active, done, total, sizes, bw, mode, dt,
                            month)),
                L, S, F, n_months,
                *map(_ptr, (counts, part_bytes, part_cnt, new_done, comp,
                            tape, recall, mig, egress, cls_a, cls_b)))
    return new_done, comp, tape, recall, mig, egress, cls_a, cls_b


def gcs_admit(want, sizes, used, limit, dt, month, n_months: int,
              n_passes: int = ref.GCS_ADMIT_PASSES):
    """See ``ref.gcs_admit``."""
    if want.device.type == "cpu":
        return ref.gcs_admit(want, sizes, used, limit, dt, month, n_months,
                             n_passes)
    if n_passes < 1:
        raise ValueError(f"n_passes must be >= 1, got {n_passes!r}")
    dev = want.device
    L, S, F = want.shape
    _check("want", want, torch.bool, (L, S, F), dev)
    _check("sizes", sizes, torch.float32, (L, S, F), dev)
    _check("used", used, torch.float32, (L,), dev)
    _check("limit", limit, torch.float32, (L,), dev)
    _check("dt", dt, torch.float32, (), dev)
    _check("month", month, torch.int32, (), dev)
    N = S * F
    if N >= 2 ** 31:
        raise ValueError(f"gcs_admit: S*F = {N} elements a lane; the kernel "
                         f"indexes a lane with int32")
    # tile counts, the candidate list (indices, sizes, flags) sized for N
    # candidates a lane, per-chunk bytes: one buffer, carved by the library
    scratch = torch.empty((_LIB.get().lt_gcs_scratch_bytes(L, N),),
                          dtype=torch.uint8, device=dev)
    adm = torch.empty((L, S, F), dtype=torch.bool, device=dev)
    rank = torch.empty((L, S, F), dtype=torch.int32, device=dev)
    used_out = torch.empty((L,), dtype=torch.float32, device=dev)
    gbsec = torch.empty((L, n_months), dtype=torch.float32, device=dev)
    _LIB.launch("gcs_admit", "lt_gcs_admit", dev,
                *map(_ptr, (want, sizes, used, limit, dt, month)),
                L, N, F, n_months, n_passes,
                *map(_ptr, (scratch, adm, rank, used_out, gbsec)))
    return adm, used_out, gbsec, rank


def window_admit(live, size, disk_used, disk_limit, fifo: bool):
    """See ``ref.window_admit``."""
    if live.device.type == "cpu":
        return ref.window_admit(live, size, disk_used, disk_limit, fifo)
    dev = live.device
    L, S, C = live.shape
    _check("live", live, torch.bool, (L, S, C), dev)
    _check("size", size, torch.float32, (L, S, C), dev)
    _check("disk_used", disk_used, torch.float32, (L, S), dev)
    _check("disk_limit", disk_limit, torch.float32, (L, S), dev)
    adm = torch.empty((L, S, C), dtype=torch.bool, device=dev)
    extra = torch.empty((L, S), dtype=torch.float32, device=dev)
    _LIB.launch("window_admit", "lt_window_admit", dev,
                *map(_ptr, (live, size, disk_used, disk_limit)),
                L * S, C, int(bool(fifo)), _ptr(adm), _ptr(extra))
    return adm, extra
