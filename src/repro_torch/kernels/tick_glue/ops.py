"""Wrappers of the tick-glue CUDA kernels (``csrc/tick_glue.cu``).

Each wrapper takes the same arguments as its plain version in ``ref.py``
(the tick state ``st``, the grid's constants ``c`` and the tick's values)
and updates ``st`` in place as it does. State on the CPU goes to that
plain version; CUDA state goes to the kernel, or the wrapper raises: there
is no fallback. On the card a wrapper checks device, dtype, shape and
contiguity of every tensor its kernel touches, allocates outputs with
``torch.empty``, launches on ``torch.cuda.current_stream()`` without
synchronising, raises if the C entry point reports a CUDA error, and adds
one to its launch count (:func:`launch_counts`).

On the card ``work`` is the tick's int32 counter buffer: :func:`begin`
allocates it and its kernel zeroes it; the later steps of the same tick
count into it. The per-block partials of :func:`complete` and
:func:`wait_select` go to scratch buffers the wrapper allocates. The grid
of :func:`link_admit`, :func:`migrate` and :func:`wait_select` is sized
to the card's SMs (:func:`flag_blocks`, :func:`flag_ranges`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tick_glue import ref

KERNELS = ("glue_begin", "glue_complete", "glue_link_admit", "glue_migrate",
           "glue_wait_select")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: argtypes of the C entry points (see ``_build.KernelLib``).
_SIGNATURES = {
    "tg_work_ints": ([_I, _I], _LL),
    "tg_complete_scratch": ([_I, _I, _LL], _LL),
    "tg_wait_scratch": ([_I, _I, _LL, _I, _I], _LL),
    "tg_error_string": ([_I], ctypes.c_char_p),
    "tg_begin": ([_P] * 4 + [_I, _I, _LL] + [_P] * 3, _I),
    "tg_complete": ([_P] * 10 + [_I, _I, _LL] + [_P] * 16, _I),
    "tg_link_admit": ([_P] * 5 + [_I, _I, _LL, _I] + [_P] * 4, _I),
    "tg_migrate": ([_P] * 7 + [_I, _I, _LL, _I] + [_P] * 12, _I),
    "tg_wait_select": ([_P] * 2 + [_I, _I, _LL, _I, _I] + [_P] * 5, _I),
}

#: The largest ``W`` of :func:`wait_select` (the window kernel's limit).
MAX_WAIT = 32

#: Flags a block of the flag streams (``tg_link_admit``, ``tg_migrate``,
#: ``tg_wait_select``) takes a step (256 threads x 4 loads x 16 flags,
#: ``kFlagRun``): a row's runs.
FLAG_RUN = 16384

#: Resident blocks an SM that their grid is sized for
#: (``kFlagBlocksPerSm``, the kernels' launch bounds).
FLAG_BLOCKS_PER_SM = 4


def flag_blocks(F: int, R: int, sm_count: int) -> int:
    """Blocks a row of the flag streams on a card of ``sm_count`` SMs:
    ``FLAG_BLOCKS_PER_SM`` an SM over the ``R`` rows, at least one, at
    most the row's runs of ``FLAG_RUN`` flags."""
    runs = -(-F // FLAG_RUN)
    return max(1, min(runs, sm_count * FLAG_BLOCKS_PER_SM // max(R, 1)))


def flag_ranges(F: int, blocks: int, b: int) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` element ranges of a row that block ``b`` of its
    ``blocks`` takes: runs ``b``, ``b + blocks``, ... (the kernels'
    ``for_each_flag``)."""
    return [(lo, min(lo + FLAG_RUN, F))
            for lo in range(b * FLAG_RUN, F, blocks * FLAG_RUN)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count

_LIB = _build.KernelLib("tick_glue", _SIGNATURES, "tg_error_string",
                        KERNELS)
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts
add_launch_counts = _LIB.add_launch_counts
_check = _build.check_tensor


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _on_cpu(st) -> bool:
    return st["tr_slot"].device.type == "cpu"


def _dims(st):
    return tuple(st["tr_slot"].shape)


def _check_all(dev, specs) -> None:
    """``_check`` each ``(name, tensor, dtype, shape)`` of ``specs``."""
    for name, t, dtype, shape in specs:
        _check(name, t, dtype, shape, dev)


def _check_work(work, dev, L: int, S: int) -> None:
    if not isinstance(work, torch.Tensor):
        raise TypeError(f"work: expected the counter buffer of this tick's "
                        f"begin, got {type(work).__name__}")
    _check("work", work, torch.int32, (_LIB.get().tg_work_ints(L, S),), dev)


def begin(st, now, dt):
    """See ``ref.begin``; ``work`` is the tick's zeroed counter buffer."""
    if _on_cpu(st):
        return ref.begin(st, now, dt)
    dev = st["tr_slot"].device
    L, S, F = plane = _dims(st)
    _check_all(dev, (("tr_slot", st["tr_slot"], torch.bool, plane),
                     ("tr_start", st["tr_start"], torch.float32, plane),
                     ("now", now, torch.float32, ()),
                     ("dt", dt, torch.float32, ())))
    active = torch.empty(plane, dtype=torch.bool, device=dev)
    work = torch.empty((_LIB.get().tg_work_ints(L, S),), dtype=torch.int32,
                       device=dev)
    _LIB.launch("glue_begin", "tg_begin", dev,
                *map(_ptr, (st["tr_slot"], st["tr_start"], now, dt)),
                L, S, F, _ptr(active), _ptr(work))
    return active, work


def complete(st, c, now, new_done, comp, work):
    """See ``ref.complete``. The kernel takes the dropped and the deleted
    copies' bytes off ``disk_used`` itself, each row's sum in
    ``ref.row_sum``'s order (per-block partials in a scratch buffer)."""
    if _on_cpu(st):
        return ref.complete(st, c, now, new_done, comp, work)
    dev = st["tr_slot"].device
    L, S, F = plane = _dims(st)
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    links = (L, 3 * S)
    _check_all(dev, (
        ("now", now, f32, ()), ("new_done", new_done, f32, plane),
        ("comp", comp, b8, plane), ("sizes", c["sizes"], f32, plane),
        ("limited", c["limited"], b8, (L, S, 1)),
        ("gcs_enabled", c["gcs_enabled"], b8, (L, 1, 1)),
        ("pop_ok", c["pop_ok"], b8, plane), ("slots", c["slots"], f32, links),
        ("lq_next", st["lq_next"], i32, links),
        ("tr_link", st["tr_link"], i32, plane),
        ("disk_state", st["disk_state"], i32, plane),
        ("gcs_state", st["gcs_state"], i32, plane),
        ("tr_slot", st["tr_slot"], b8, plane),
        ("tr_done", st["tr_done"], f32, plane),
        ("tr_total", st["tr_total"], f32, plane),
        ("tr_start", st["tr_start"], f32, plane),
        ("pend_cnt", st["pend_cnt"], i32, plane),
        ("pend_tail", st["pend_tail"], f32, plane),
        ("fin_max", st["fin_max"], f32, plane),
        ("lq_serve", st["lq_serve"], i32, links),
        ("disk_used", st["disk_used"], f32, (L, S))))
    _check_work(work, dev, L, S)
    want = torch.empty(plane, dtype=b8, device=dev)
    occ3 = torch.empty((L, S, 3), dtype=f32, device=dev)
    partials = torch.empty((_LIB.get().tg_complete_scratch(L, S, F),),
                           dtype=f32, device=dev)
    _LIB.launch("glue_complete", "tg_complete", dev,
                *map(_ptr, (now, new_done, comp, c["sizes"], c["limited"],
                            c["gcs_enabled"], c["pop_ok"], c["slots"],
                            st["lq_next"], st["tr_link"])),
                L, S, F,
                *map(_ptr, (st["disk_state"], st["gcs_state"], st["tr_slot"],
                            st["tr_done"], st["tr_total"], st["tr_start"],
                            st["pend_cnt"], st["pend_tail"], st["fin_max"],
                            st["lq_serve"], st["disk_used"], want, occ3,
                            partials, work)))
    return want, occ3


def link_admit(st, c, now, work) -> None:
    """See ``ref.link_admit`` (``work`` is not read)."""
    if _on_cpu(st):
        return ref.link_admit(st, c, now, work)
    dev = st["tr_slot"].device
    L, S, F = plane = _dims(st)
    links = (L, 3 * S)
    _check_all(dev, (
        ("now", now, torch.float32, ()),
        ("tr_link", st["tr_link"], torch.int32, plane),
        ("lq_ticket", st["lq_ticket"], torch.int32, plane),
        ("lq_serve", st["lq_serve"], torch.int32, links),
        ("latency", c["latency"], torch.float32, links),
        ("tr_slot", st["tr_slot"], torch.bool, plane),
        ("tr_start", st["tr_start"], torch.float32, plane),
        ("lq_queued", st["lq_queued"], torch.bool, plane)))
    _LIB.launch("glue_link_admit", "tg_link_admit", dev,
                *map(_ptr, (now, st["tr_link"], st["lq_ticket"],
                            st["lq_serve"], c["latency"])),
                L, S, F, flag_blocks(F, L * S, _sm_count(dev.index)),
                *map(_ptr, (st["tr_slot"], st["tr_start"], st["lq_queued"])))


def migrate(st, c, now, mig, rank, occ3, work) -> None:
    """See ``ref.migrate``."""
    if _on_cpu(st):
        return ref.migrate(st, c, now, mig, rank, occ3, work)
    dev = st["tr_slot"].device
    L, S, F = plane = _dims(st)
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    links = (L, 3 * S)
    _check_all(dev, (
        ("now", now, f32, ()), ("mig", mig, b8, plane),
        ("rank", rank, i32, plane), ("sizes", c["sizes"], f32, plane),
        ("slots", c["slots"], f32, links),
        ("mig_link", c["mig_link"], i32, (1, S, 1)),
        ("lq_serve", st["lq_serve"], i32, links),
        ("gcs_state", st["gcs_state"], i32, plane),
        ("tr_slot", st["tr_slot"], b8, plane),
        ("tr_link", st["tr_link"], i32, plane),
        ("tr_total", st["tr_total"], f32, plane),
        ("tr_done", st["tr_done"], f32, plane),
        ("tr_start", st["tr_start"], f32, plane),
        ("lq_ticket", st["lq_ticket"], i32, plane),
        ("lq_queued", st["lq_queued"], b8, plane),
        ("lq_next", st["lq_next"], i32, links),
        ("occ3", occ3, f32, (L, S, 3))))
    _check_work(work, dev, L, S)
    _LIB.launch("glue_migrate", "tg_migrate", dev,
                *map(_ptr, (now, mig, rank, c["sizes"], c["slots"],
                            c["mig_link"], st["lq_serve"])),
                L, S, F, flag_blocks(F, L * S, _sm_count(dev.index)),
                *map(_ptr, (st["gcs_state"], st["tr_slot"], st["tr_link"],
                            st["tr_total"], st["tr_done"], st["tr_start"],
                            st["lq_ticket"], st["lq_queued"], st["lq_next"],
                            occ3, work)))


def migration_counts(work: torch.Tensor, L: int, S: int):
    """The migrations :func:`migrate`'s kernel admitted this tick, a row:
    ``(n_direct, n_queued)``, ``[L * S]`` int32 views of ``work`` (the
    buffer holds the occupancy ``[L * S, 3]``, then these two, then the
    launches' tickets)."""
    R = L * S
    return work[3 * R:4 * R], work[4 * R:5 * R]


def wait_select(st, W: int, work):
    """See ``ref.wait_select`` (1 <= ``W`` <= :data:`MAX_WAIT`, ``W`` <=
    F); on the card ``work`` is the tick's counter buffer, and each
    block's lowest keys go to a scratch buffer of :func:`flag_blocks`
    lists a row."""
    if _on_cpu(st):
        return ref.wait_select(st, W, work)
    dev = st["tr_slot"].device
    L, S, F = plane = _dims(st)
    if not 1 <= W <= min(MAX_WAIT, F):
        raise ValueError(f"wait_select: W={W} outside 1..{min(MAX_WAIT, F)}")
    _check_all(dev, (("wq_wait", st["wq_wait"], torch.bool, plane),
                     ("wq_ticket", st["wq_ticket"], torch.int32, plane)))
    _check_work(work, dev, L, S)
    blocks = flag_blocks(F, L * S, _sm_count(dev.index))
    keys = torch.empty((_LIB.get().tg_wait_scratch(L, S, F, W, blocks),),
                       dtype=torch.int64, device=dev)
    lowest = torch.empty((L, S, W), dtype=torch.int32, device=dev)
    idx = torch.empty((L, S, W), dtype=torch.int64, device=dev)
    _LIB.launch("glue_wait_select", "tg_wait_select", dev,
                _ptr(st["wq_wait"]), _ptr(st["wq_ticket"]), L, S, F, W,
                blocks, *map(_ptr, (keys, lowest, idx, work)))
    return lowest, idx
