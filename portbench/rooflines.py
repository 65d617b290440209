"""The bytes a tick of the sweep needs, counted from the state it reads
and writes, and the card's peaks they are held to.

Counted at one tick from what :func:`portbench.reference.tick.tick`
keeps in its probe (the state before each phase and the values passed
between phases), so the count is a function of the state alone and reads
the same whichever implementation produced that state. Each input byte
counts once read and each output byte once written; a plane read only
where a mask holds counts the 32-byte sectors the mask touches.

- :func:`phase_bytes`: each phase of the tick alone, as a kernel of that
  phase must move its inputs and outputs (the lane-tick phases
  ``transfer``, ``gcs``, ``window``; the glue phases ``begin``,
  ``complete``, ``link_admit``, ``migrate``, ``wait_select``);
- :func:`tick_bytes`: the whole tick, each plane read once (densely only
  where the tick must look at every file: the slot, disk-state, queue
  and wait flags) and written where it changed, whatever phases or
  kernels carry it out.

Every count is bound by bytes: the tick's operations are a few compares
and adds a byte moved, far under the card's float32 peak.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

#: H100 SXM data sheet (700 W): device-memory bandwidth, and the float32
#: peak outside the tensor cores.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

LANE_TICK_PHASES = ("transfer", "gcs", "window")
GLUE_PHASES = ("begin", "complete", "link_admit", "migrate", "wait_select")


def sector_bytes(mask: torch.Tensor, itemsize: int) -> int:
    """Bytes of the 32-byte sectors that a read of ``itemsize``-byte
    elements of a contiguous tensor at ``mask`` touches."""
    per = 32 // itemsize
    flat = mask.reshape(-1)
    pad = (-flat.numel()) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return 32 * int(flat.view(-1, per).any(-1).sum())


def phase_bytes(p: Dict, n_months: int) -> Dict[str, int]:
    """Bytes each phase of the probed tick needs (see module notes)."""
    def sec(mask, itemsize):
        return sector_bytes(mask, itemsize)

    active, comp = p["t_active"], p["comp"]
    L, S, _ = active.shape
    n = active.numel()
    R = L * S
    out = {}
    # transfer: the active flag, done and total in and new_done and the
    # completion out for every file; the link id of active transfers and
    # the size of completions; the per-link and per-lane vectors
    out["transfer"] = (n * (1 + 4 + 4) + n * (4 + 1) + sec(active, 4)
                       + sec(comp, 4) + L * 3 * S * 8 + 3 * R * 4
                       + 3 * L * n_months * 4)
    # gcs: the candidate flag in and the admission and its rank out for
    # every file, the size of candidates; per-lane scalars, the month row
    want = p["want_mig"]
    out["gcs"] = (n * (1 + 1 + 4) + sec(want, 4) + L * 4 * 3
                  + L * n_months * 4)
    # window: both candidate windows' masks in and out, the size of live
    # slots and heads, the ids of started slots and valid heads; the disk
    # occupancy and limit per row
    K, W = p["K"], p["W"]
    live_w = p["valid_w"] & ~p["stale"]
    out["window"] = (R * (2 * K + 4 * W) + sec(p["absent"], 4)
                     + sec(live_w, 4) + sec(p["started"], 8)
                     + sec(p["valid_w"], 8) + R * 12)
    # begin: the slot flag and the active flag out for every file, the
    # start time where a slot is held
    slot0 = p["begin.tr_slot"]
    out["begin"] = 2 * n + sec(slot0, 4)
    # complete: as chip_smoke.glue_bytes counts it
    s = p["complete"]
    lt = torch.remainder(s["tr_link"], 3)
    inb, cm = comp & (lt != 2), comp & (lt == 2)
    no_cons = (s["pend_cnt"] == 0) & (s["fin_max"] <= p["now"])
    d1 = torch.where(inb, 2, s["disk_state"])
    drop = cm & no_cons & (d1 == 2)
    d2 = torch.where(drop, 0, d1)
    cand = no_cons & (d2 == 2) & p["limited"]
    post_ds = p["complete.post_disk_state"]
    dele = cand & (post_ds == 0)
    changed = post_ds != s["disk_state"]
    out["complete"] = (
        23 * n + sec(s["tr_slot"] | comp, 4) + sec(comp, 1)
        + 2 * sec(comp, 4) + sec(cand, 4) + sec(cm, 4) + sec(cand, 1)
        + sec(drop | dele, 4) + sec(changed, 4) + 3 * sec(inb, 4)
        + sec(inb & (s["pend_cnt"] > 0), 4) + 5 * 4 * 3 * R + 8 * R)
    q0, q1 = p["link_admit.lq_queued"], p["migrate.lq_queued"]
    adm = q0 & ~q1
    out["link_admit"] = (n + 2 * sec(q0, 4) + 2 * sec(adm, 1)
                         + sec(adm, 4) + 2 * 4 * 3 * R)
    m = p["mig"]
    queued = m & p["wait.lq_queued"] & ~q1
    direct = m & ~queued
    out["migrate"] = (n + 6 * sec(m, 4) + sec(direct, 1) + sec(direct, 4)
                      + sec(queued, 4) + sec(queued, 1) + 5 * 4 * 3 * R)
    wq = p["wait.wq_wait"]
    out["wait_select"] = n + sec(wq, 4) + R * W * (4 + 8)
    return out


#: The state planes of a tick and their element sizes.
PLANE_ITEMSIZE = {
    "disk_state": 4, "gcs_state": 4, "tr_slot": 1, "tr_link": 4,
    "tr_done": 4, "tr_total": 4, "tr_start": 4, "lq_ticket": 4,
    "lq_queued": 1, "wq_wait": 1, "wq_ticket": 4, "pend_cnt": 4,
    "pend_tail": 4, "fin_max": 4,
}


def tick_bytes(p: Dict, pre: Dict, post: Dict) -> int:
    """Bytes the whole probed tick needs: ``pre`` and ``post`` are the
    state's ``[L, S, F]`` planes and ``[L, S, J]`` job planes before and
    after it (see module notes)."""
    def sec(mask, itemsize):
        return sector_bytes(mask, itemsize)

    slot = pre["tr_slot"]
    n = slot.numel()
    present = pre["disk_state"] == 2
    # dense: the slot, disk-state, link-queue and wait flags
    need = n * (1 + 4 + 1 + 1)
    # sparse reads: what a held slot, a file on disk, a queued transfer
    # and a waiting file lead to
    active = p["t_active"]
    need += sec(slot, 4) + 3 * sec(active, 4)  # start; link, done, total
    need += 2 * sec(present | p["comp"], 4)  # consumers: count, finish
    need += sec(p["comp"] | p["want_mig"], 4)  # sizes
    need += sec(p["want_mig"], 4) + sec(p["want_mig"], 4)  # gcs, pop
    need += sec(pre["lq_queued"], 4) + sec(pre["wq_wait"], 4)  # tickets
    # the job planes: submit tick and ready time dense, the file id where
    # a job is pending
    pending = pre["job_ready"] == float("inf")
    need += pre["job_ready"].numel() * (4 + 4) + sec(pending, 4)
    # writes: every plane where it changed
    for name, size in PLANE_ITEMSIZE.items():
        a, b = pre[name], post[name]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        need += sec(a != b, size)
    a, b = pre["job_ready"].view(torch.int32), post["job_ready"].view(
        torch.int32)
    need += sec(a != b, 4)
    return int(need)


def share(n_bytes: float, seconds: float) -> float:
    """The least time for ``n_bytes`` at the memory rate, as a percentage
    of ``seconds``."""
    return 100.0 * n_bytes / MEM_BYTES_PER_S / seconds


def library_share(run, lib: str, phases) -> Optional[float]:
    """The share of its roofline that kernel library ``lib`` reaches on
    ``phases``: their bytes (:func:`phase_bytes`) over the library's
    device time in the same ticks, summed over the traced run's sampled
    ticks; ``None`` where the library ran nothing there."""
    ticks = run.record.get("ticks")
    counts = run.record.get("tick_bytes")
    if not ticks or not counts:
        return None
    pairs = [(sum(c[p] for p in phases), ticks[c["tick"]].get(lib, 0))
             for c in counts if c["tick"] in ticks]
    ns = sum(t for _, t in pairs)
    if ns <= 0:
        return None
    return share(sum(b for b, _ in pairs), ns / 1e9)
