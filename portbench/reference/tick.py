"""The plain tick program of the batched sweep, frozen for the benchmark.

A lane is one simulated deployment; every lane of a packed grid steps a
shared clock of fixed ticks. Per tick, in this order: transfer advance and
completion billing, completions and pending-job resolution, link-slot FIFO
admission, hot-tier deletions, shared-GCS admission of the hot->cold
migrations and their submission, job submissions, the waiting queue's
FIFO admission into the disk window, pending jobs that can start, and the
GB-second integration of the cold tier.

Plain PyTorch only, in the operation order of the sweep's plain path, so
that a lane computed here is bitwise what a plain run of the same grid
gives. It imports nothing of the system under test. On a CUDA device the
tick is captured once as a CUDA graph after a few eager ticks and
replayed (the same kernels as eager ticks); on the CPU it runs eagerly.

``bf16=True`` is the benchmark's control: every float plane of the state
and the float per-file constants are kept in bfloat16 precision (rounded
after every tick), the step a faster variant would be tempted to take.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

ABSENT, IN_FLIGHT, PRESENT = 0, 1, 2
BIG_TICKET = 2 ** 30
GCS_ADMIT_PASSES = 3
WAIT_ADMITS_PER_TICK = 4
GRAPH_WARMUP_TICKS = 3
_INF = float("inf")


# -- pieces of the tick --------------------------------------------------

def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a pairwise tree in index order, the row
    zero-padded to a power of two."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


#: Width of the blocks of a long scan (:func:`cumsum_last`).
SCAN_BLOCK = 1024


def cumsum_last(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``torch.cumsum(x, -1, dtype=dtype)`` as a scan of blocks of
    :data:`SCAN_BLOCK` elements plus each block's exclusive offset: a
    scan over a few long rows then runs over many short ones. Integer
    scans are exact either way; a float scan gives the same value wherever
    its partial sums are exact (float64 sums of a sparse set of float32
    sizes, as the GCS admission takes them), and otherwise differs from a
    sequential scan by float64 rounding alone."""
    if dtype is not None:
        x = x.to(dtype)
    n = x.shape[-1]
    if n <= 4 * SCAN_BLOCK:
        return torch.cumsum(x, dim=-1, dtype=x.dtype)
    pad = (-n) % SCAN_BLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], -1, SCAN_BLOCK)
    inner = torch.cumsum(blocks, dim=-1, dtype=x.dtype)
    tot = inner[..., -1]
    off = torch.cumsum(tot, dim=-1, dtype=x.dtype) - tot
    out = (inner + off[..., None]).reshape(*x.shape[:-1], n + pad)
    return out[..., :n]


def month_onehot(month, n_months: int):
    return (torch.arange(n_months, device=month.device)
            == month).to(torch.float32)


def by_type(x3, is_t):
    return torch.where(is_t[0], x3[..., 0:1],
                       torch.where(is_t[1], x3[..., 1:2], x3[..., 2:3]))


def transfer_tick(link_id, active, done, total, sizes, bw, mode, dt, month,
                  n_months: int):
    L, S, F = link_id.shape
    ltype = torch.remainder(link_id, 3)
    is_t = [ltype == k for k in range(3)]
    act_f = active.to(torch.float32)
    counts = torch.stack([(active & m).sum(-1) for m in is_t],
                         dim=-1).to(torch.float32)
    bw_i = by_type(bw.view(L, S, 3), is_t)
    cnt_i = by_type(counts, is_t)
    mode_i = by_type(mode.view(L, S, 3), is_t)
    shared = bw_i / torch.clamp_min(cnt_i, 1.0)
    rate = torch.where(mode_i > 0, bw_i, shared)
    new_done = torch.minimum(total, done + act_f * rate * dt)
    comp = (new_done >= total) & active
    comp_recall = comp & is_t[1]
    comp_mig = comp & is_t[2]
    tape = (sizes * (comp & is_t[0])).sum(-1)
    recall = (sizes * comp_recall).sum(-1)
    mig = (sizes * comp_mig).sum(-1)
    onehot = month_onehot(month, n_months)
    egress = onehot * recall.sum(-1)[:, None]
    cls_a = onehot * comp_mig.sum((1, 2)).to(torch.float32)[:, None]
    cls_b = onehot * comp_recall.sum((1, 2)).to(torch.float32)[:, None]
    return new_done, comp, tape, recall, mig, egress, cls_a, cls_b


def admission_rank(admitted):
    csum = cumsum_last(admitted, torch.int32)
    return torch.where(admitted, csum - 1, -1)


def gcs_admit(want, sizes, used, limit, dt, month, n_months: int,
              n_passes: int = GCS_ADMIT_PASSES):
    """Shared-capacity admission: ``n_passes`` passes of one float64
    prefix per lane over the site-major candidates, gated on the
    pass-start occupancy; the GB-seconds of the final occupancy and each
    admission's rank within its site."""
    L = want.shape[0]
    want_flat = want.reshape(L, -1)
    sizes_flat = sizes.reshape(L, -1)
    limit64 = limit.double()[:, None]
    admitted = torch.zeros_like(want_flat)
    for _ in range(n_passes):
        rem = want_flat & ~admitted
        gate = used.double()[:, None] + cumsum_last(
            (sizes_flat * rem).double())
        new = rem & (gate <= limit64)
        site_bytes = (sizes * new.view_as(sizes)).double().sum(-1)
        used = (used.double() + site_bytes.sum(-1)).float()
        admitted = admitted | new
    gbsec = month_onehot(month, n_months) * (used / 1e9 * dt)[:, None]
    admitted = admitted.view(want.shape)
    return admitted, used, gbsec, admission_rank(admitted)


def window_admit(live, size, disk_used, disk_limit, fifo: bool):
    C = live.shape[-1]
    extra = torch.zeros_like(disk_used)
    if C == 0:
        return torch.zeros_like(live), extra
    blocked = torch.zeros_like(live[..., 0])
    cols = []
    for k in range(C):
        size_k = size[..., k]
        fit = disk_used + extra + size_k <= disk_limit
        live_k = live[..., k]
        if fifo:
            adm = live_k & fit & ~blocked
            blocked = blocked | (live_k & ~fit)
        else:
            adm = live_k & fit
        cols.append(adm)
        extra = extra + torch.where(adm, size_k, 0.0)
    return torch.stack(cols, dim=-1), extra


def windows_admit(absent, size_k, fid_k, valid_w, present_w, size_w, idx_w,
                  disk_used, disk_limit):
    started, extra = window_admit(absent, size_k, disk_used, disk_limit,
                                  False)
    used = disk_used + extra
    started_fid = torch.where(started, fid_k, -1)
    jumped = (idx_w[..., :, None] == started_fid[..., None, :]).any(-1)
    stale = valid_w & (present_w | jumped)
    admitted, extra_w = window_admit(valid_w & ~stale, size_w, used,
                                     disk_limit, True)
    return started, admitted, stale, used + extra_w


def glue_begin(st, now, dt):
    t_active = st["tr_slot"] & (st["tr_start"] <= now - dt + 0.5)
    ltype = torch.remainder(st["tr_link"], 3)
    return t_active, [ltype == k for k in range(3)]


def glue_complete(st, c, now, new_done, comp, is_t):
    sizes = c["sizes"]
    L, S, _ = sizes.shape
    gcs_en = c["gcs_enabled"]
    no_cons = (st["pend_cnt"] == 0) & (st["fin_max"] <= now)
    comp_mig = comp & is_t[2]
    inbound = comp & (is_t[0] | is_t[1])
    st["disk_state"].masked_fill_(inbound, PRESENT)
    st["gcs_state"].masked_fill_(comp_mig, PRESENT)
    drop_hot = comp_mig & no_cons & (st["disk_state"] == PRESENT)
    st["disk_used"].sub_(row_sum(torch.where(drop_hot, sizes, 0.0)))
    st["disk_state"].masked_fill_(drop_hot, ABSENT)
    st["tr_slot"].logical_and_(~comp)
    torch.where(comp, c["zero"], new_done, out=st["tr_done"])
    st["tr_total"].masked_fill_(comp, _INF)
    st["tr_start"].masked_fill_(comp, _INF)
    resolve = inbound & (st["pend_cnt"] > 0)
    torch.where(resolve,
                torch.maximum(st["fin_max"], now + st["pend_tail"]),
                st["fin_max"], out=st["fin_max"])
    st["pend_cnt"].masked_fill_(inbound, 0)
    st["pend_tail"].masked_fill_(inbound, 0.0)
    occ = torch.stack([(st["tr_slot"] & m).sum(-1) for m in is_t],
                      dim=-1).to(torch.float32).view(L, 3 * S)
    free = torch.clamp_min(c["slots"] - occ, 0.0)
    n_q = (st["lq_next"] - st["lq_serve"]).to(torch.float32)
    admit = torch.minimum(free, n_q).to(torch.int32)
    st["lq_serve"].add_(admit)
    occ3 = (occ + admit.to(torch.float32)).view(L, S, 3)
    cand = no_cons & (st["disk_state"] == PRESENT) & c["limited"]
    gs = st["gcs_state"]
    pop_ok = c["pop_ok"]
    migratable = gcs_en & (gs == ABSENT) & pop_ok
    delete = cand & (~gcs_en | (gs == PRESENT)
                     | ((gs == ABSENT) & ~pop_ok))
    want_mig = cand & migratable
    st["disk_used"].sub_(row_sum(torch.where(delete, sizes, 0.0)))
    st["disk_state"].masked_fill_(delete, ABSENT)
    return want_mig, occ3


def glue_link_admit(st, c, now, is_t):
    L, S, _ = st["tr_link"].shape
    adm_row = st["lq_queued"] & (
        st["lq_ticket"] < by_type(st["lq_serve"].view(L, S, 3), is_t))
    st["tr_slot"].logical_or_(adm_row)
    torch.where(adm_row, now + by_type(c["latency"].view(L, S, 3), is_t),
                st["tr_start"], out=st["tr_start"])
    st["lq_queued"].logical_and_(~adm_row)


def glue_migrate(st, c, now, mig, rank, occ3):
    sizes = c["sizes"]
    L, S, _ = sizes.shape
    lqn3 = st["lq_next"].view(L, S, 3)
    lqs3 = st["lq_serve"].view(L, S, 3)
    slots3 = c["slots"].view(L, S, 3)
    st["gcs_state"].masked_fill_(mig, IN_FLIGHT)
    q_empty = (lqn3[..., 2] == lqs3[..., 2])[..., None]
    free_m = torch.clamp_min(slots3[..., 2] - occ3[..., 2], 0.0)[..., None]
    direct = mig & q_empty & (rank < free_m)
    queued = mig & ~direct
    n_direct = direct.sum(-1, keepdim=True, dtype=torch.int32)
    qrank = rank - n_direct
    st["tr_slot"].logical_or_(direct)
    torch.where(mig, c["mig_link"], st["tr_link"], out=st["tr_link"])
    torch.where(mig, sizes, st["tr_total"], out=st["tr_total"])
    st["tr_done"].masked_fill_(mig, 0.0)
    torch.where(direct, now, st["tr_start"], out=st["tr_start"])
    torch.where(queued, lqn3[..., 2:3] + qrank, st["lq_ticket"],
                out=st["lq_ticket"])
    st["lq_queued"].logical_or_(queued)
    lqn3[..., 2] += queued.sum(-1, dtype=torch.int32)
    occ3[..., 2] += n_direct[..., 0].to(torch.float32)


def wait_select(st, W: int):
    F = st["wq_wait"].shape[-1]
    index = torch.arange(F, dtype=torch.int64, device=st["wq_wait"].device)
    tickets = torch.where(st["wq_wait"], st["wq_ticket"].to(torch.int64),
                          BIG_TICKET)
    key = torch.topk(tickets * F + index, W, dim=-1, largest=False,
                     sorted=True).values
    return (key // F).to(torch.int32), key % F


def _scatter_bool(plane, rows, src, reduce: str) -> None:
    plane.view(torch.uint8).scatter_reduce_(
        1, rows, src.to(torch.uint8), reduce, include_self=True)


#: The state's per-file and per-job planes (what a probe keeps of the
#: whole state, before and after its tick).
PLANES = ("disk_state", "gcs_state", "tr_slot", "tr_link", "tr_done",
          "tr_total", "tr_start", "lq_ticket", "lq_queued", "wq_wait",
          "wq_ticket", "pend_cnt", "pend_tail", "fin_max", "job_ready")


def _planes(st):
    return {k: st[k].clone() for k in PLANES}


def tick(st: Dict[str, torch.Tensor], c: Dict[str, torch.Tensor], S: int,
         K: int, n_months: int, probe: Optional[dict] = None) -> None:
    """One tick, in place on ``st``. With ``probe`` (a dict), the state
    before each phase and the values passed between phases are kept in
    it (what the benchmark's byte counts read)."""
    W = WAIT_ADMITS_PER_TICK
    sizes = c["sizes"]
    L, _, F = sizes.shape
    J = c["job_fid"].shape[-1]
    gcs_en = c["gcs_enabled"]
    t = st["tick"]
    now = c["times"].index_select(0, t).view(())
    dt = c["dts"].index_select(0, t).view(())
    month = c["month_idx"].index_select(0, t).view(())
    jobs_now = c["jobs_per_tick"].index_select(1, t).view(L, S)

    if probe is not None:
        probe.update(now=now.clone(), limited=c["limited"], K=K,
                     W=WAIT_ADMITS_PER_TICK, pre=_planes(st))
        probe["begin.tr_slot"] = probe["pre"]["tr_slot"]
    t_active, is_t = glue_begin(st, now, dt)
    if probe is not None:
        probe["t_active"] = t_active.clone()
    (new_done, comp, tape_add, recall_add, mig_add, egress_add,
     cls_a_add, cls_b_add) = transfer_tick(
        st["tr_link"], t_active, st["tr_done"], st["tr_total"], sizes,
        c["bw"], c["mode"], dt, month, n_months)
    st["tape_b"].add_(tape_add)
    st["gcsdisk_b"].add_(recall_add)
    st["diskgcs_b"].add_(mig_add)
    st["egress_mo"].add_(egress_add)
    st["cls_a_mo"].add_(cls_a_add)
    st["cls_b_mo"].add_(cls_b_add)
    if probe is not None:
        probe["comp"] = comp.clone()
        probe["complete"] = {k: st[k].clone() for k in (
            "tr_link", "pend_cnt", "fin_max", "disk_state", "tr_slot")}
    want_mig, occ3 = glue_complete(st, c, now, new_done, comp, is_t)
    if probe is not None:
        probe["want_mig"] = want_mig.clone()
        probe["complete.post_disk_state"] = st["disk_state"].clone()
        probe["link_admit.lq_queued"] = st["lq_queued"].clone()
    glue_link_admit(st, c, now, is_t)
    if probe is not None:
        probe["migrate.lq_queued"] = st["lq_queued"].clone()
    mig, gcs_used, gbsec_add, rank = gcs_admit(
        want_mig, sizes, st["gcs_used"], c["gcs_limit"], dt, month,
        n_months, GCS_ADMIT_PASSES)
    st["gcs_used"].copy_(gcs_used)
    if probe is not None:
        probe["mig"] = mig.clone()
    glue_migrate(st, c, now, mig, rank, occ3)
    lqn3 = st["lq_next"].view(L, S, 3)
    lqs3 = st["lq_serve"].view(L, S, 3)
    slots3 = c["slots"].view(L, S, 3)
    lat3 = c["latency"].view(L, S, 3)
    plans = []

    def plan_links(fids, fire):
        from_gcs = gcs_en & (
            torch.gather(st["gcs_state"], -1, fids) == PRESENT)
        link_local = from_gcs.to(torch.int32)
        direct = torch.zeros_like(fire)
        queued = torch.zeros_like(fire)
        tstart = torch.full(fire.shape, _INF, dtype=torch.float32,
                            device=fire.device)
        lq_val = torch.zeros(fire.shape, dtype=torch.int32,
                             device=fire.device)
        for loc in (0, 1):
            mask = fire & (link_local == loc)
            q_empty = (lqn3[..., loc] == lqs3[..., loc])[..., None]
            free_m = torch.clamp_min(
                slots3[..., loc] - occ3[..., loc], 0.0)[..., None]
            rk = torch.cumsum(mask.to(torch.float32), dim=-1) - 1.0
            d = mask & q_empty & (rk < free_m)
            qd = mask & ~d
            qrk = torch.cumsum(qd, dim=-1, dtype=torch.int32) - 1
            direct = direct | d
            queued = queued | qd
            tstart = torch.where(d, now + lat3[..., loc:loc + 1], tstart)
            lq_val = torch.where(qd, lqn3[..., loc:loc + 1] + qrk, lq_val)
            lqn3[..., loc] += qd.sum(-1, dtype=torch.int32)
            occ3[..., loc] += d.sum(-1).to(torch.float32)
        return dict(rows=c["row_base"] + fids, fire=fire,
                    m_vec=c["site3"] + link_local, direct=direct,
                    queued=queued, tstart=tstart, lq_val=lq_val)

    ks = c["ks"]
    jpos = st["ptr"][..., None] + ks
    jid = torch.clamp_max(jpos, J - 1)
    valid = (jpos < J) & (
        torch.gather(c["job_submit_tick"], -1, jid) == t)
    fids = torch.gather(c["job_fid64"], -1, jid)
    same = ((fids[..., None, :] == fids[..., :, None])
            & valid[..., None, :] & c["earlier"])
    first = valid & ~same.any(-1)
    ds_k = torch.gather(st["disk_state"], -1, fids)
    absent = first & (ds_k == ABSENT)
    if probe is not None:
        probe["wait.lq_queued"] = st["lq_queued"].clone()
        probe["wait.wq_wait"] = st["wq_wait"].clone()
    lowest, idx = wait_select(st, W)
    started, admitted, stale, disk_used = windows_admit(
        absent, torch.gather(sizes, -1, fids), fids,
        lowest < BIG_TICKET,
        torch.gather(st["disk_state"], -1, idx) != ABSENT,
        torch.gather(sizes, -1, idx), idx, st["disk_used"],
        c["disk_limit"])
    if probe is not None:
        probe.update(absent=absent.clone(), started=started.clone(),
                     valid_w=(lowest < BIG_TICKET).clone(),
                     stale=stale.clone(), admitted=admitted.clone())
    st["disk_used"].copy_(disk_used)

    if K > 0:
        ww = torch.gather(st["wq_wait"], -1, fids)
        tailw = torch.gather(c["job_tail"], -1, jid)
        to_wait = absent & ~started & ~ww
        wrank = torch.cumsum(to_wait, dim=-1, dtype=torch.int32) - 1
        plan = plan_links(fids, started)
        plan["to_wait"] = to_wait
        plan["wq_val"] = torch.where(
            to_wait, st["wq_next"][..., None] + wrank, 0)
        st["wq_next"].add_(to_wait.sum(-1, dtype=torch.int32))
        plan["stale"] = torch.zeros_like(started)
        ready_now = valid & (ds_k == PRESENT)
        plan["pend_add"] = valid & ~ready_now
        plan["fin_val"] = torch.where(ready_now, now + tailw, -_INF)
        plan["tail"] = tailw
        plans.append(plan)
    st["ptr"].add_(jobs_now)

    plan = plan_links(idx, admitted)
    plan["stale"] = stale
    plans.append(plan)

    pending = (c["job_submit_tick"] <= t) & (st["job_ready"] >= _INF)
    on_disk = torch.gather(st["disk_state"], -1, c["job_fid64"]) == PRESENT
    torch.where(pending & on_disk, now, st["job_ready"],
                out=st["job_ready"])

    def cat(key):
        return torch.cat([p[key].reshape(L, -1) for p in plans], dim=1)

    rows = cat("rows")
    fire = cat("fire")
    stale = cat("stale")
    m_vec = cat("m_vec")
    direct = cat("direct")
    queued = cat("queued")
    tstart = cat("tstart")
    lq_val = cat("lq_val")

    def flat(name):
        return st[name].view(L, -1)

    size_c = torch.gather(sizes.view(L, -1), 1, rows)
    cur_link = torch.gather(flat("tr_link"), 1, rows)
    cur_lqt = torch.gather(flat("lq_ticket"), 1, rows)
    cur_wqt = None
    if K > 0:
        rows1 = plans[0]["rows"].reshape(L, -1)
        cur_wqt = torch.gather(flat("wq_ticket"), 1, rows1)
    flat("disk_state").scatter_add_(1, rows, fire.to(torch.int32))
    _scatter_bool(flat("wq_wait"), rows, ~(fire | stale), "amin")
    flat("tr_link").scatter_add_(
        1, rows, torch.where(fire, m_vec - cur_link, 0))
    flat("tr_total").scatter_reduce_(
        1, rows, torch.where(fire, size_c, _INF), "amin", include_self=True)
    _scatter_bool(flat("tr_slot"), rows, direct, "amax")
    flat("tr_start").scatter_reduce_(1, rows, tstart, "amin",
                                     include_self=True)
    flat("lq_ticket").scatter_add_(
        1, rows, torch.where(queued, lq_val - cur_lqt, 0))
    _scatter_bool(flat("lq_queued"), rows, queued, "amax")

    if K > 0:
        g1 = plans[0]
        to_wait = g1["to_wait"].reshape(L, -1)
        wq_val = g1["wq_val"].reshape(L, -1)
        pend_add = g1["pend_add"].reshape(L, -1)
        _scatter_bool(flat("wq_wait"), rows1, to_wait, "amax")
        flat("wq_ticket").scatter_add_(
            1, rows1, torch.where(to_wait, wq_val - cur_wqt, 0))
        flat("pend_cnt").scatter_add_(1, rows1, pend_add.to(torch.int32))
        flat("pend_tail").scatter_reduce_(
            1, rows1,
            torch.where(pend_add, g1["tail"].reshape(L, -1), 0.0),
            "amax", include_self=True)
        flat("fin_max").scatter_reduce_(
            1, rows1, g1["fin_val"].reshape(L, -1), "amax",
            include_self=True)

    st["gbsec_mo"].add_(gbsec_add)
    t.add_(1)
    if probe is not None:
        probe["post"] = _planes(st)


# -- state, loop and read-out -------------------------------------------

#: Float state tensors that the control keeps in bfloat16 precision.
FLOAT_STATE = ("disk_used", "gcs_used", "tr_done", "tr_total", "tr_start",
               "pend_tail", "fin_max", "job_ready", "tape_b", "gcsdisk_b",
               "diskgcs_b", "egress_mo", "cls_a_mo", "cls_b_mo", "gbsec_mo")
#: Float per-file constants that the control keeps in bfloat16 precision.
FLOAT_CONSTANTS = ("sizes", "job_tail", "job_submit_time")


def build(grid, device: torch.device, bf16: bool = False):
    """Device constants and the initial state of a packed grid (a
    :class:`portbench.reference.packer.Grid`)."""
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    L, S, F = grid.sizes.shape
    J = grid.job_fid.shape[-1]
    K = grid.max_jobs_per_tick
    n_months = grid.n_months
    c = {
        "disk_limit": dev(grid.disk_limit),
        "gcs_enabled": dev(grid.gcs_enabled)[:, None, None],
        "gcs_limit": dev(grid.gcs_limit),
        "bw": dev(grid.link_bw),
        "slots": dev(grid.link_slots),
        "latency": dev(grid.link_latency),
        "mode": dev(grid.link_mode),
        "sizes": dev(grid.sizes),
        "job_fid": dev(grid.job_fid),
        "job_submit_tick": dev(grid.job_submit_tick),
        "job_submit_time": dev(grid.job_submit_time),
        "job_tail": dev(grid.job_tail),
        "times": dev(grid.times),
        "dts": dev(grid.dts),
        "month_idx": dev(grid.month_idx),
        "jobs_per_tick": dev(grid.jobs_per_tick),
        "zero": torch.zeros((), dtype=torch.float32, device=device),
    }
    if bf16:
        for k in FLOAT_CONSTANTS:
            c[k] = c[k].to(torch.bfloat16).to(torch.float32)
    site = torch.arange(S, device=device).view(1, S, 1)
    ks = torch.arange(K, device=device)
    c.update(
        job_fid64=c["job_fid"].to(torch.int64),
        limited=torch.isfinite(c["disk_limit"])[..., None],
        pop_ok=dev(grid.pop) >= dev(grid.min_migrate_pop)[:, None, None],
        mig_link=(3 * site + 2).to(torch.int32),
        site3=(3 * site).to(torch.int32),
        row_base=site * F,
        ks=ks,
        earlier=ks.view(1, K) < ks.view(K, 1),
    )

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    f32, i32 = torch.float32, torch.int32
    plane = (L, S, F)
    st = dict(
        disk_state=zeros(plane, i32), gcs_state=zeros(plane, i32),
        disk_used=zeros((L, S), f32), gcs_used=zeros((L,), f32),
        tr_slot=zeros(plane, torch.bool), tr_link=zeros(plane, i32),
        tr_done=zeros(plane, f32), tr_total=full(plane, _INF),
        tr_start=full(plane, _INF), lq_ticket=zeros(plane, i32),
        lq_queued=zeros(plane, torch.bool), lq_serve=zeros((L, 3 * S), i32),
        lq_next=zeros((L, 3 * S), i32), wq_wait=zeros(plane, torch.bool),
        wq_ticket=zeros(plane, i32), wq_next=zeros((L, S), i32),
        pend_cnt=zeros(plane, i32), pend_tail=zeros(plane, f32),
        fin_max=zeros(plane, f32), job_ready=full((L, S, J), _INF),
        ptr=zeros((L, S), i32), tape_b=zeros((L, S), f32),
        gcsdisk_b=zeros((L, S), f32), diskgcs_b=zeros((L, S), f32),
        egress_mo=zeros((L, n_months), f32),
        cls_a_mo=zeros((L, n_months), f32),
        cls_b_mo=zeros((L, n_months), f32),
        gbsec_mo=zeros((L, n_months), f32),
        tick=zeros((1,), torch.int64),
    )
    return c, st


def _round_bf16(st) -> None:
    for k in FLOAT_STATE:
        st[k].copy_(st[k].to(torch.bfloat16))


class Loop:
    """The tick program of one grid on one device, advanced tick by tick:
    eager on the CPU, replayed from a CUDA graph of one tick on a CUDA
    device (after :data:`GRAPH_WARMUP_TICKS` eager ticks on a side
    stream)."""

    def __init__(self, grid, device, bf16: bool = False):
        self.grid = grid
        self.device = torch.device(device)
        self.bf16 = bf16
        self.S = grid.sizes.shape[1]
        self.K = grid.max_jobs_per_tick
        self.c, self.st = build(grid, self.device, bf16)
        self.t = 0
        self._graph = None

    def _tick(self, probe=None):
        tick(self.st, self.c, self.S, self.K, self.grid.n_months, probe)
        if self.bf16:
            _round_bf16(self.st)

    def step(self, probe: dict) -> None:
        """One eager tick that fills ``probe`` (see :func:`tick`)."""
        self._tick(probe)
        self.t += 1

    def advance(self, n: int) -> None:
        if self.device.type != "cuda":
            for _ in range(n):
                self._tick()
            self.t += n
            return
        warm = min(n, max(0, GRAPH_WARMUP_TICKS - self.t))
        if warm:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(warm):
                    self._tick()
            torch.cuda.current_stream(self.device).wait_stream(side)
        rest = n - warm
        if rest and self._graph is None:
            torch.cuda.synchronize(self.device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._tick()
            self._graph = graph
        for _ in range(rest):
            self._graph.replay()
        self.t += n

    def result(self) -> Dict[str, np.ndarray]:
        """The per-lane aggregates of the ticks run so far (numpy)."""
        st, c = self.st, self.c
        L = c["sizes"].shape[0]
        horizon = torch.tensor(float(self.grid.horizon), dtype=torch.float32,
                               device=self.device)
        ready = st["job_ready"] < _INF
        done = ready & (st["job_ready"] + c["job_tail"] <= horizon)
        wait_h = (st["job_ready"] - c["job_submit_time"]) / 3600.0
        out = {
            "jobs_done_site": done.sum(-1, dtype=torch.int32),
            "download_b": row_sum(torch.where(
                ready, torch.gather(c["sizes"], -1, c["job_fid64"]), 0.0)),
            "wait_h_sum": row_sum(torch.where(ready, wait_h,
                                              0.0).view(L, -1)),
            "wait_n": ready.sum((1, 2), dtype=torch.int32),
        }
        for k in ("disk_used", "gcs_used", "tape_b", "gcsdisk_b",
                  "diskgcs_b", "egress_mo", "cls_a_mo", "cls_b_mo",
                  "gbsec_mo"):
            out[k] = st[k]
        return {k: v.cpu().numpy() for k, v in out.items()}

    def close(self) -> None:
        if self._graph is not None:
            self._graph.reset()
            self._graph = None
        self.st = self.c = None


def simulate(grid, device, bf16: bool = False) -> Dict[str, np.ndarray]:
    """Every tick of ``grid``; the per-lane aggregates."""
    loop = Loop(grid, device, bf16)
    try:
        loop.advance(grid.n_ticks)
        return loop.result()
    finally:
        loop.close()
