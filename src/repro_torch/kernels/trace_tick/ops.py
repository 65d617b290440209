"""Wrappers of the tick-tracing CUDA kernels (``csrc/trace_tick.cu``).

Each wrapper takes the same arguments as its plain version in ``ref.py``.
State on the CPU goes to that plain version, which reads the host clock;
CUDA state goes to the kernel, which reads the card's ``%globaltimer``.
On the card a wrapper checks device, dtype, shape and contiguity of what
its kernel touches, launches on ``torch.cuda.current_stream()`` without
synchronising or allocating, raises if the C entry point reports a CUDA
error, and adds one to its launch count (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tick_glue import ops as glue_ops
from repro_torch.kernels.trace_tick import ref
from repro_torch.kernels.trace_tick.ref import (  # noqa: F401
    COUNT_STRIDE,
    COUNTS,
    LAYERS,
    ROW,
    SEGMENTS,
    state,
)

KERNELS = ("trace_stamp", "trace_count")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: argtypes of the C entry points (see ``_build.KernelLib``).
_SIGNATURES = {
    "trk_error_string": ([_I], ctypes.c_char_p),
    "trk_stamp": ([_P, _I, _P], _I),
    "trk_count": ([_P, _LL, _P, _P, _I, _I, _LL, _I] + [_P] * 7, _I),
}

_LIB = _build.KernelLib("trace_tick", _SIGNATURES, "trk_error_string",
                        KERNELS)
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts
add_launch_counts = _LIB.add_launch_counts
_check = _build.check_tensor

#: Blocks an SM the counter's grid is sized for.
COUNT_BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def count_blocks(n: int, L: int, sm_count: int) -> int:
    """Blocks a lane of the counter on a card of ``sm_count`` SMs:
    :data:`COUNT_BLOCKS_PER_SM` an SM over the ``L`` lanes, at least one,
    at most one for each 4,096 of the lane's ``n`` flags (a block's
    16-byte loads of one step)."""
    return max(1, min(-(-n // 4096), COUNT_BLOCKS_PER_SM * sm_count
                      // max(L, 1)))


def clock_name(device) -> str:
    """The clock the stamps of a loop on ``device`` read."""
    return "perf_counter" if torch.device(device).type == "cpu" \
        else "globaltimer"


def stamp(acc: torch.Tensor, row: int) -> None:
    """See ``ref.stamp``."""
    if acc.device.type == "cpu":
        return ref.stamp(acc, row)
    _check("acc", acc, torch.int64, (ref.acc_size(),), acc.device)
    if not 0 <= row < len(SEGMENTS):
        raise ValueError(f"stamp: no segment {row!r}")
    _LIB.launch("trace_stamp", "trk_stamp", acc.device, acc.data_ptr(), row)


def count(counts, tick, want, mig, occ3, lq_next, lq_serve, wq_wait,
          work) -> None:
    """See ``ref.count``. On the card the admitted migrations are the
    tick-glue ``work`` buffer's counts (``tick_glue.ops.migration_counts``)
    and ``mig`` is not read."""
    if counts.device.type == "cpu":
        return ref.count(counts, tick, want, mig, occ3, lq_next, lq_serve,
                         wq_wait)
    dev = counts.device
    L, S, F = plane = tuple(want.shape)
    for name, t, dtype, shape in (
            ("counts", counts, torch.int64, (L, len(COUNTS))),
            ("tick", tick, torch.int64, (1,)),
            ("want", want, torch.bool, plane),
            ("wq_wait", wq_wait, torch.bool, plane),
            ("occ3", occ3, torch.float32, (L, S, 3)),
            ("lq_next", lq_next, torch.int32, (L, 3 * S)),
            ("lq_serve", lq_serve, torch.int32, (L, 3 * S))):
        _check(name, t, dtype, shape, dev)
    n_direct, n_queued = glue_ops.migration_counts(work, L, S)
    blocks = count_blocks(S * F, L, _sm_count(dev.index))
    _LIB.launch("trace_count", "trk_count", dev, tick.data_ptr(),
                COUNT_STRIDE, want.data_ptr(), wq_wait.data_ptr(), L, S, F,
                blocks, occ3.data_ptr(), lq_next.data_ptr(),
                lq_serve.data_ptr(), n_direct.data_ptr(), n_queued.data_ptr(),
                counts.data_ptr())


def restart(st: Dict[str, torch.Tensor]) -> None:
    """Zero the stamps (not the counts): the next stamp books nothing, and
    the segments cover the ticks from here on."""
    st["trace_acc"].zero_()


def summary(st: Dict[str, torch.Tensor], device) -> Dict:
    """The stamps and counts of a loop's state on the host (one read of
    each): per segment its sum and maximum in ns, ``replay_gap`` with its
    count, the ticks stamped, the clock, and the counts summed over the
    lanes with the lane-ticks counted."""
    acc = st["trace_acc"].cpu().tolist()
    rows = {name: acc[1 + 3 * i:4 + 3 * i] for i, name in enumerate(SEGMENTS)}
    counts = st["trace_counts"].sum(0).cpu().tolist()
    gap = rows.pop("replay_gap")
    return {
        "clock": clock_name(device),
        "ticks": rows["counters"][2],
        "segments": {name: {"sum_ns": s, "max_ns": m}
                     for name, (s, m, _) in rows.items()},
        "replay_gap": {"sum_ns": gap[0], "max_ns": gap[1], "n": gap[2]},
        "counts": dict(zip(COUNTS[:-1], counts[:-1])),
        "lane_ticks": counts[-1],
        "count_stride": COUNT_STRIDE,
    }
