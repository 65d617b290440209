"""Lane-per-scenario batched sweep program, in PyTorch.

The port of ``repro.sim.batched``: a packed spec grid
(``repro_torch.core.scenarios.pack_specs``) runs as one fixed-tick program
in which lane ``l`` is one dynamics lane of the grid and every lane steps
a shared clock. Lanes are an explicit leading tensor axis (``[L, S, F]``
planes, ``[L, S]`` per-site and ``[L]`` per-lane vectors) instead of
``vmap``, and a loop over ticks (graph replays on the ``cuda`` path)
takes the place of ``scan``.

The tick body's three dense pieces — the transfer advance with its
completion billing, the shared-GCS admission passes with the GB-second
integration, the candidate-window recurrences — go through
``repro_torch.kernels.lane_tick``: the hand-written CUDA kernels for
``tick_impl="cuda"``, the plain PyTorch versions (``ref.py``) for
``tick_impl="torch"``. So does the glue between them, the state updates
of the completions, the link-slot admission and the hot-tier deletions
and migrations (``repro_torch.kernels.tick_glue``: one kernel a step, one
pass over the planes each). The candidate-window bookkeeping after them
is shared.

Per-tick phase order mirrors the reference generator: transfer advance +
completions -> link-slot FIFO admission -> hot-tier deletions & hot->cold
migrations -> job submissions -> pending-job resolution -> waiting-queue
(disk window) FIFO admission -> storage integration. See the JAX package's
module for the fidelity contract against the event engine (Table-2 5%).

Device rule: :func:`simulate_packed` and :func:`run_sweep_torch` run on
``cuda`` unless the caller passes ``device="cpu"``; without CUDA and
without that argument they raise. The tick loop makes no host sync: the
tick index is a device counter, the clock values are read at it on the
device, and no decision reads a device value on the host. On the ``cuda``
path the tick is captured once as a CUDA graph and replayed
(:class:`TickLoop`); the plain path stays eager.

Around the tick program, as in the JAX package:

- per-tick series capture (``record_series=``): ring buffers written at
  the end of every tick, at the sample slot taken from the device tick
  counter (a trash slot on the ticks between samples), converted by
  :func:`series_from_capture`;
- lane chunks (``lane_chunk=``): fixed-size chunks of the grid's lanes,
  the last one padded by repeating its last lane, each on a
  :class:`TickLoop` of its own that is closed before the next chunk on its
  device (one graph pool a device at a time), dealt round-robin over
  ``devices=``;
- the lane mesh (``shard=True``): the round-robin path over the devices
  of ``parallel.sharding.lane_mesh`` (every visible device of the type),
  each chunk cut into one contiguous block of lanes a device, the blocks
  run together and concatenated in lane order;
- the resilient job path (``retry=``/``faults=``/``transport=``): the
  chunks as retryable jobs (``repro_torch.sim.jobs``), in-process or on a
  worker fleet (``repro_torch.sim.runners``), each completed chunk
  journaled as it lands.

Every float reduction of a lane runs in an order that does not depend on
the number of lanes in the program (the kernels' grids tile each row or
lane by fixed sizes; the plain path's per-lane sums run over at least two
rows, or over fixed trees, ``tick_glue.ref.row_sum``), so a lane's results
are bitwise equal whether it runs alone, in a chunk or in the whole grid.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.scenarios import PackedGrid, ScenarioSpec, pack_specs
from repro_torch.kernels.lane_tick import ops, ref
from repro_torch.kernels.tick_glue import ops as glue_ops
from repro_torch.kernels.tick_glue import ref as glue_ref
from repro_torch.kernels.tick_glue.ref import (
    ABSENT,
    BIG_TICKET,
    PRESENT,
    row_sum,
)
from repro_torch.kernels.registry import (
    TickImpl,
    resolve_device,
    resolve_tick_impl,
)
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.parallel.sharding import lane_mesh
from repro_torch.sim.cloud import bills_from_monthly_totals
from repro_torch.sim.output import TimeSeries
from repro_torch.sim.sweep import ScenarioResult, SweepResult

#: Disk-window (waiting queue) admissions attempted per site per tick
#: (arrivals are ~0.64 jobs/tick/site, Table 3; a burst drains over the
#: next few ticks).
WAIT_ADMITS_PER_TICK = 4

#: Refinement passes of the shared-GCS admission gate.
GCS_ADMIT_PASSES = ref.GCS_ADMIT_PASSES

_INF = float("inf")

#: Per-site link-type order of the captured link-activity series (the
#: ``3 * site + type`` link-id layout).
LINK_TYPES = ("tape_to_disk", "gcs_to_disk", "disk_to_gcs")


def _normalize_record(record_series, n_ticks: int):
    """Normalize a ``record_series=`` argument to ``(stride, n_samples)``
    (or ``None`` when capture is off). ``True`` samples every tick; an
    int samples every that-many ticks (tick 0 always sampled)."""
    if record_series is None or record_series is False:
        return None
    stride = 1 if record_series is True else int(record_series)
    if stride < 1:
        raise ValueError(f"record_series must be >= 1, got {record_series!r}")
    return stride, (n_ticks - 1) // stride + 1


#: Words of 8 flags summed into one int64 before its byte lanes are
#: split: each lane then holds at most 255.
_COUNT_RUN = 255


def _count_true(mask: torch.Tensor) -> torch.Tensor:
    """The number of true elements along the last axis (int64), exact at
    any shape. A row whose flags are whole 8-byte words is read as int64
    words and summed in runs of :data:`_COUNT_RUN` words, so that no byte
    lane of a run's sum carries into the next, then the runs' byte lanes
    are added: the plane is read once and never widened (``mask.sum(-1)``
    copies it to int64 first). Other rows take the plain sum."""
    F = mask.shape[-1]
    if (F == 0 or F % 8 or mask.storage_offset() % 8
            or not mask.is_contiguous()):
        return mask.sum(-1)
    words = mask.view(torch.int64)
    head = words.shape[-1] - words.shape[-1] % _COUNT_RUN
    runs = [words[..., :head].unflatten(-1, (-1, _COUNT_RUN)).sum(-1)]
    if head < words.shape[-1]:
        runs.append(words[..., head:].sum(-1, keepdim=True))
    return torch.cat(runs, -1).view(torch.uint8).sum(-1)


def _scatter_bool(plane: torch.Tensor, rows: torch.Tensor, src: torch.Tensor,
                  reduce: str) -> None:
    """Duplicate-safe in-place min/max scatter into a bool ``[L, N]`` plane
    (through its ``uint8`` view; JAX's ``.at[].min/max`` semantics)."""
    plane.view(torch.uint8).scatter_reduce_(
        1, rows, src.to(torch.uint8), reduce, include_self=True)


def _lane_step_fns(S: int, K: int, n_months: int, impl: TickImpl,
                   record=None):
    """The tick body and the post-loop reduction (closures over the static
    dimensions, the resolved tick implementation and the series-capture
    configuration).

    The tick reads its index from the state's device counter
    (``st["tick"]``, stepped at its end) and its clock values with
    ``index_select`` on it, and updates every state tensor in place
    (``masked_fill_``, ``add_``, ``copy_``, ``torch.where(..., out=)`` and
    the duplicate-safe scatters at the end), so each keeps its address from
    tick to tick: what a CUDA graph of the tick needs. Every value the end
    scatters combine with (``cur_link``, ``cur_lqt``, ``cur_wqt``) is
    gathered before the first of them, and every read sees what the JAX
    package's functional tick body would bind at that point.

    ``record`` (``(stride, n_samples)`` or ``None``) turns on per-tick
    series capture: the state's ``ser_*`` buffers (``[L, n_samples + 1,
    ...]``) take the tick's end-of-tick observables — disk and GCS
    occupancy, waiting files, running jobs, active transfers per link
    type — at slot ``t // stride`` when ``t`` is a sample tick and in the
    last, trash, slot otherwise (``index_copy_`` at the slot that the
    table ``c["ser_slot"]`` holds for ``st["tick"]``, read on the
    device). The counts are integer sums, cast to float32 at the write. The link counts are the tick's own occupancy
    counters (``occ3``), which every slot taken or freed during the tick
    has updated: the active transfers per link type at its end. With
    ``record=None`` the tick is exactly the tick without capture.
    """
    lt = ops if impl.use_kernel else ref
    glue = glue_ops if impl.use_kernel else glue_ref
    W = WAIT_ADMITS_PER_TICK

    def tick_fn(st: Dict[str, torch.Tensor], c: Dict[str, torch.Tensor]):
        sizes = c["sizes"]
        L, _, F = sizes.shape
        J = c["job_fid"].shape[-1]
        gcs_en = c["gcs_enabled"]
        t = st["tick"]
        now = c["times"].index_select(0, t).view(())
        dt = c["dts"].index_select(0, t).view(())
        month = c["month_idx"].index_select(0, t).view(())
        jobs_now = c["jobs_per_tick"].index_select(1, t).view(L, S)

        # -- advance transfers one tick + completion billing; the glue
        # around it (tick_glue) updates the state planes in place
        t_active, work = glue.begin(st, now, dt)
        (new_done, comp, tape_add, recall_add, mig_add, egress_add,
         cls_a_add, cls_b_add) = lt.transfer_tick(
            st["tr_link"], t_active, st["tr_done"], st["tr_total"], sizes,
            c["bw"], c["mode"], dt, month, n_months)
        st["tape_b"].add_(tape_add)
        st["gcsdisk_b"].add_(recall_add)
        st["diskgcs_b"].add_(mig_add)
        st["egress_mo"].add_(egress_add)
        st["cls_a_mo"].add_(cls_a_add)
        st["cls_b_mo"].add_(cls_b_add)
        # completions, pending-job resolution, the link-slot prologue and
        # the hot-tier deletions; then the link-slot FIFO admission
        want_mig, occ3 = glue.complete(st, c, now, new_done, comp, work)
        glue.link_admit(st, c, now, work)
        # -- hot->cold migrations: the shared-GCS admission, then each
        # admitted file onto its site's disk->gcs link
        mig, gcs_used, gbsec_add, rank = lt.gcs_admit(
            want_mig, sizes, st["gcs_used"], c["gcs_limit"], dt, month,
            n_months, GCS_ADMIT_PASSES)
        st["gcs_used"].copy_(gcs_used)
        glue.migrate(st, c, now, mig, rank, occ3, work)
        # working [L, S, 3] counters: occ3 (from the glue) and lqn3, a view
        # of lq_next; both are updated in place below
        lqn3 = st["lq_next"].view(L, S, 3)
        lqs3 = st["lq_serve"].view(L, S, 3)
        slots3 = c["slots"].view(L, S, 3)
        lat3 = c["latency"].view(L, S, 3)

        # -- candidate windows: this tick's job arrivals (K per site) and
        # the waiting-queue heads (W per site) as prefix recurrences over
        # [L, S, C], both in one call; their state changes land below as
        # one duplicate-safe scatter per plane.
        plans = []

        def plan_links(fids, fire):
            """Assign link slots / FIFO queue tickets to fired candidates
            (``fids``/``fire`` are [L, S, C]); updates the [L, S, 3]
            counters ``occ3``/``lqn3`` in place."""
            from_gcs = gcs_en & (
                torch.gather(st["gcs_state"], -1, fids) == PRESENT)
            link_local = from_gcs.to(torch.int32)
            direct = torch.zeros_like(fire)
            queued = torch.zeros_like(fire)
            tstart = torch.full(fire.shape, _INF, dtype=torch.float32,
                                device=fire.device)
            lq_val = torch.zeros(fire.shape, dtype=torch.int32,
                                 device=fire.device)
            for loc in (0, 1):  # tape->disk, gcs->disk
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

        # group 1, job submissions: only the first arrival of a file
        # starts its transfer; later same-tick jobs attach
        ks = c["ks"]
        jpos = st["ptr"][..., None] + ks  # [L, S, K] int64
        jid = torch.clamp_max(jpos, J - 1)
        valid = (jpos < J) & (
            torch.gather(c["job_submit_tick"], -1, jid) == t)
        fids = torch.gather(c["job_fid64"], -1, jid)
        # same[l, s, k, j]: an earlier valid slot j < k has the same file
        same = ((fids[..., None, :] == fids[..., :, None])
                & valid[..., None, :] & c["earlier"])
        first = valid & ~same.any(-1)
        ds_k = torch.gather(st["disk_state"], -1, fids)
        absent = first & (ds_k == ABSENT)
        # group 2, waiting-queue admission: strict FIFO on the disk window
        # (the head blocks until its file fits, §5.2). The W lowest
        # (ticket, index) pairs, the fill past the waiting files in index
        # order as jax.lax.top_k gives it (tick_glue); the previous tick's
        # window scatters are the last writes of wq_wait and wq_ticket.
        lowest, idx = glue.wait_select(st, W, work)
        started, admitted, stale, disk_used = lt.windows_admit(
            absent, torch.gather(sizes, -1, fids), fids,
            lowest < BIG_TICKET,
            torch.gather(st["disk_state"], -1, idx) != ABSENT,
            torch.gather(sizes, -1, idx), idx, st["disk_used"],
            c["disk_limit"])
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
            # incremental consumer deltas: jobs whose file is on disk are
            # ready now (finish now + tail); the rest join the pending pool
            ready_now = valid & (ds_k == PRESENT)
            plan["pend_add"] = valid & ~ready_now
            plan["fin_val"] = torch.where(ready_now, now + tailw, -_INF)
            plan["tail"] = tailw
            plans.append(plan)
        st["ptr"].add_(jobs_now)

        plan = plan_links(idx, admitted)
        plan["stale"] = stale
        plans.append(plan)

        # -- pending jobs whose input is on disk enter queued -> running
        pending = (c["job_submit_tick"] <= t) & (st["job_ready"] >= _INF)
        on_disk = torch.gather(st["disk_state"], -1, c["job_fid64"]) == PRESENT
        torch.where(pending & on_disk, now, st["job_ready"],
                    out=st["job_ready"])

        # -- apply the planned windows: one scatter per state plane
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
        # started/stale entries leave the wait queue (new waiters join in
        # the K-window block below: min before max)
        _scatter_bool(flat("wq_wait"), rows, ~(fire | stale), "amin")
        flat("tr_link").scatter_add_(
            1, rows, torch.where(fire, m_vec - cur_link, 0))
        flat("tr_total").scatter_reduce_(
            1, rows, torch.where(fire, size_c, _INF), "amin",
            include_self=True)
        _scatter_bool(flat("tr_slot"), rows, direct, "amax")
        flat("tr_start").scatter_reduce_(1, rows, tstart, "amin",
                                         include_self=True)
        flat("lq_ticket").scatter_add_(
            1, rows, torch.where(queued, lq_val - cur_lqt, 0))
        _scatter_bool(flat("lq_queued"), rows, queued, "amax")

        if K > 0:  # K-window-only scatters (wait-queue joins + consumers)
            g1 = plans[0]
            to_wait = g1["to_wait"].reshape(L, -1)
            wq_val = g1["wq_val"].reshape(L, -1)
            pend_add = g1["pend_add"].reshape(L, -1)
            _scatter_bool(flat("wq_wait"), rows1, to_wait, "amax")
            flat("wq_ticket").scatter_add_(
                1, rows1, torch.where(to_wait, wq_val - cur_wqt, 0))
            # consumer counters, visible from the next tick on
            flat("pend_cnt").scatter_add_(1, rows1, pend_add.to(torch.int32))
            flat("pend_tail").scatter_reduce_(
                1, rows1,
                torch.where(pend_add, g1["tail"].reshape(L, -1), 0.0),
                "amax", include_self=True)
            flat("fin_max").scatter_reduce_(
                1, rows1, g1["fin_val"].reshape(L, -1), "amax",
                include_self=True)

        # -- stored cloud volume (GB-seconds) per month, from gcs_admit
        st["gbsec_mo"].add_(gbsec_add)

        # -- opt-in series capture (end-of-tick observables)
        if record is not None:
            slot = c["ser_slot"].index_select(0, t)
            ready = st["job_ready"]
            running = (ready < _INF) & (ready + c["job_tail"] > now)
            for name, value in (
                    ("ser_disk", st["disk_used"]),
                    ("ser_gcs", st["gcs_used"]),
                    ("ser_queue", _count_true(st["wq_wait"])),
                    ("ser_run", _count_true(running)),
                    ("ser_link", occ3)):
                st[name].index_copy_(
                    1, slot, value.to(torch.float32).unsqueeze(1))
        t.add_(1)

    def post_fn(st, c, horizon) -> Dict[str, torch.Tensor]:
        L = c["sizes"].shape[0]
        ready = st["job_ready"] < _INF
        done = ready & (st["job_ready"] + c["job_tail"] <= horizon)
        job_sizes = torch.gather(c["sizes"], -1, c["job_fid64"])
        wait_h = (st["job_ready"] - c["job_submit_time"]) / 3600.0
        series = {}
        if record is not None:  # drop the trash slot
            series = {k: st[k][:, :record[1]] for k in _SERIES_KEYS}
        # the float sums in fixed trees: the same bits whatever the number
        # of lanes (torch.sum's order follows its output's size)
        return {
            **series,
            "jobs_done_site": done.sum(-1, dtype=torch.int32),
            "download_b": row_sum(torch.where(ready, job_sizes, 0.0)),
            "wait_h_sum": row_sum(torch.where(ready, wait_h, 0.0).view(L, -1)),
            "wait_n": ready.sum((1, 2), dtype=torch.int32),
            "disk_used": st["disk_used"],
            "gcs_used": st["gcs_used"],
            "tape_b": st["tape_b"],
            "gcsdisk_b": st["gcsdisk_b"],
            "diskgcs_b": st["diskgcs_b"],
            "egress_mo": st["egress_mo"],
            "cls_a_mo": st["cls_a_mo"],
            "cls_b_mo": st["cls_b_mo"],
            "gbsec_mo": st["gbsec_mo"],
        }

    return tick_fn, post_fn


#: The series buffers of a capture, in the JAX package's key order.
_SERIES_KEYS = ("ser_disk", "ser_gcs", "ser_queue", "ser_run", "ser_link")


def _build_lane_sim(grid: PackedGrid, device: torch.device, record=None):
    """Device constants and initial state of a packed grid (with the
    series buffers of ``record``, ``(stride, n_samples)``, when given)."""
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    L = grid.n_lanes
    S = len(grid.site_names)
    F = grid.sizes.shape[-1]
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
        # the clock, read at the device tick counter st["tick"]
        "times": dev(grid.times),
        "dts": dev(grid.dts),
        "month_idx": dev(grid.month_idx),
        "jobs_per_tick": dev(grid.jobs_per_tick),
        "zero": torch.zeros((), dtype=torch.float32, device=device),
    }
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
    state = dict(
        disk_state=zeros(plane, i32),
        gcs_state=zeros(plane, i32),
        disk_used=zeros((L, S), f32),
        gcs_used=zeros((L,), f32),
        tr_slot=zeros(plane, torch.bool),
        tr_link=zeros(plane, i32),
        tr_done=zeros(plane, f32),
        tr_total=full(plane, _INF),
        tr_start=full(plane, _INF),
        lq_ticket=zeros(plane, i32),
        lq_queued=zeros(plane, torch.bool),
        lq_serve=zeros((L, 3 * S), i32),
        lq_next=zeros((L, 3 * S), i32),
        wq_wait=zeros(plane, torch.bool),
        wq_ticket=zeros(plane, i32),
        wq_next=zeros((L, S), i32),
        pend_cnt=zeros(plane, i32),
        pend_tail=zeros(plane, f32),
        fin_max=zeros(plane, f32),
        job_ready=full((L, S, J), _INF),
        ptr=zeros((L, S), i32),
        tape_b=zeros((L, S), f32),
        gcsdisk_b=zeros((L, S), f32),
        diskgcs_b=zeros((L, S), f32),
        egress_mo=zeros((L, n_months), f32),
        cls_a_mo=zeros((L, n_months), f32),
        cls_b_mo=zeros((L, n_months), f32),
        gbsec_mo=zeros((L, n_months), f32),
        tick=zeros((1,), torch.int64),
    )
    if record is not None:
        stride, n_samples = record
        # a tick's series slot: t // stride on a sample tick, else the
        # trash slot after the samples
        t = torch.arange(grid.n_ticks, device=device)
        c["ser_slot"] = torch.where(t % stride == 0, t // stride, n_samples)
        n = n_samples + 1
        state.update(
            ser_disk=zeros((L, n, S), f32),
            ser_gcs=zeros((L, n), f32),
            ser_queue=zeros((L, n, S), f32),
            ser_run=zeros((L, n, S), f32),
            ser_link=zeros((L, n, S, 3), f32),
        )
    return c, state


#: The kernel libraries the ``cuda`` tick launches, whose launch counts a
#: replay adds to.
_TICK_LIBS = (ops, glue_ops)

#: Eager ticks before the ``cuda`` tick is captured: real ticks of the run
#: that load the kernel library and warm the allocator's blocks and the
#: ``cumsum`` workspaces, on a side stream as CUDA graph capture
#: asks.
GRAPH_WARMUP_TICKS = 3


class TickLoop:
    """The tick program of one packed grid on one device, advanced tick by
    tick (:meth:`advance`) and read out once (:meth:`result`).

    With ``graph=True`` (the ``cuda`` kernels on a CUDA device) the first
    :data:`GRAPH_WARMUP_TICKS` ticks run eagerly on a side stream, the next
    tick is captured once as a CUDA graph (capture runs nothing), and that
    tick and every later one is a replay of it: the tick takes its index
    from the device counter it steps, and updates its state in place, so a
    replay does what a fresh launch of the tick would. A failed capture or
    replay raises; nothing falls back to eager ticks. The kernel wrappers
    count launches in Python, so each replay adds the captured tick's
    launches to ``launch_counts()`` of both libraries it launches
    (``lane_tick`` and ``tick_glue``). ``capture_s`` is the capture's
    host time, ``pool_bytes`` the device memory the graph's private pool
    reserved (both 0 until the capture). ``record`` (``(stride,
    n_samples)``, :func:`_normalize_record`) adds the series buffers to
    the state and their writes to the tick. On a CUDA device the loop runs
    with that device current, so loops of several cards can take turns.
    """

    def __init__(self, grid: PackedGrid, impl: TickImpl, device: torch.device,
                 graph: bool, record=None):
        if graph and not (impl.use_kernel and device.type == "cuda"):
            raise ValueError("a captured tick needs tick_impl='cuda'")
        self.n_ticks = grid.n_ticks
        self.device, self.use_graph = device, graph
        self.tick_fn, self.post_fn = _lane_step_fns(
            len(grid.site_names), grid.max_jobs_per_tick, grid.n_months, impl,
            record)
        self.c, self.st = _build_lane_sim(grid, device, record)
        self.horizon = torch.tensor(float(grid.horizon), dtype=torch.float32,
                                    device=device)
        self.t = 0
        self._graph = None
        self._per_tick: List[Dict[str, int]] = []
        self.capture_s = 0.0
        self.pool_bytes = 0

    def _current(self):
        """This loop's device made current (a no-op on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def advance(self, n: int) -> None:
        """Run the next ``n`` ticks (no host sync)."""
        if not 0 <= n <= self.n_ticks - self.t:
            raise ValueError(f"advance({n}) at tick {self.t} of "
                             f"{self.n_ticks}")
        with self._current():
            self._advance(n)
        self.t += n

    def _advance(self, n: int) -> None:
        if not self.use_graph:
            for _ in range(n):
                self.tick_fn(self.st, self.c)
            return
        warm = min(n, max(0, GRAPH_WARMUP_TICKS - self.t))
        if warm:
            self._warm_up(warm)
        replays = n - warm
        if replays:
            if self._graph is None:
                self._capture()
            for _ in range(replays):
                self._graph.replay()
            for lib, per_tick in zip(_TICK_LIBS, self._per_tick):
                lib.add_launch_counts(per_tick, replays)

    def _warm_up(self, n: int) -> None:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(n):
                self.tick_fn(self.st, self.c)
        cur.wait_stream(side)

    def _capture(self) -> None:
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = [lib.launch_counts() for lib in _TICK_LIBS]
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.tick_fn(self.st, self.c)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._per_tick = [{k: v - was[k]
                           for k, v in lib.launch_counts().items()}
                          for lib, was in zip(_TICK_LIBS, before)]
        for lib, per_tick in zip(_TICK_LIBS, self._per_tick):
            lib.add_launch_counts(per_tick, -1)  # capture launched nothing
        self._graph = graph

    def result(self) -> Dict[str, np.ndarray]:
        """The raw per-lane aggregates of the ticks run so far (numpy)."""
        with self._current():
            out = self.post_fn(self.st, self.c, self.horizon)
            return {k: v.cpu().numpy() for k, v in out.items()}

    def close(self) -> None:
        """Release the captured graph, and with it its private memory pool,
        and the grid's state, so a sweep that runs one loop after another
        (a decision round each) holds one pool at a time. The loop cannot
        advance or be read after it."""
        if self._graph is not None:
            self._graph.reset()
            self._graph = None
        self.st = self.c = None


def _resolve_devices(device, devices) -> List[torch.device]:
    """The devices a run deals its lane chunks to: ``devices`` when given
    (each by the device rule, all of one type, a CUDA device without an
    index taken as the current one), else ``[device]``."""
    if devices is None:
        devs = [resolve_device(device)]
    else:
        if device is not None:
            raise ValueError("pass device= or devices=, not both")
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices must be a non-empty sequence")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"devices must all be CUDA devices or all the "
                             f"CPU, got {[str(d) for d in devs]}")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def _check_shard(shard: bool, devices) -> None:
    if shard and devices is not None:
        raise ValueError("shard=True builds a lane mesh over the local "
                         "devices; devices= applies to the round-robin "
                         "path only")


#: Per-lane fields of ``PackedGrid``: what a lane chunk slices.
_LANE_FIELDS = ("disk_limit", "gcs_enabled", "gcs_limit", "min_migrate_pop",
                "link_bw", "link_slots", "link_latency", "link_mode",
                "sizes", "pop", "job_fid", "job_submit_tick",
                "job_submit_time", "job_tail", "jobs_per_tick", "n_jobs",
                "rate_mult")


def _chunk_lanes(grid: PackedGrid, start: int, stop: int,
                 C: int) -> Dict[str, np.ndarray]:
    """The per-lane fields of lanes ``start:stop``, padded to ``C`` lanes
    by repeating the last one (lanes never interact; the padding's results
    are dropped)."""
    idx = np.minimum(np.arange(start, start + C), stop - 1)
    return {name: np.asarray(getattr(grid, name))[idx]
            for name in _LANE_FIELDS}


def _chunk_grid(grid: PackedGrid, lanes: Dict[str, np.ndarray]) -> PackedGrid:
    """``grid`` holding only the lanes ``lanes`` (:func:`_chunk_lanes`), and
    no specs: what a :class:`TickLoop` of one chunk runs."""
    return dataclasses.replace(grid, specs=[], cost_models=[],
                               lane_of=np.zeros((0,), np.int32), **lanes)


#: Ticks a loop advances before the next device's loop takes its turn,
#: when one round of chunks runs on several devices.
_DEVICE_TURN_TICKS = 64


def _run_chunks(grid: PackedGrid, impl: TickImpl, devs: List[torch.device],
                graph: bool, record, C: int):
    """Run ``grid`` in chunks of ``C`` lanes dealt round-robin over
    ``devs``. A round takes the next chunks while their devices are
    distinct; its loops advance in turns of :data:`_DEVICE_TURN_TICKS`
    ticks, so every device has its chunk in flight before any result is
    read, and they are closed before the next round: one loop, and one
    graph pool, per device at a time. Returns the raw aggregates and the
    chunks' summed capture seconds and largest graph pool."""
    L, T = grid.n_lanes, grid.n_ticks
    chunks = [(start, min(start + C, L)) for start in range(0, L, C)]
    tracer = get_tracer()
    outs: List[Dict[str, np.ndarray]] = []
    capture_s, pool_bytes = 0.0, 0
    ci = 0
    while ci < len(chunks):
        batch = []
        while ci < len(chunks) and devs[ci % len(devs)] not in {
                d for _, _, d in batch}:
            batch.append((ci, chunks[ci], devs[ci % len(devs)]))
            ci += 1
        loops: List[TickLoop] = []
        with tracer.span("simulate_packed.chunk", chunk=batch[0][0],
                         chunks=len(batch), lanes=C * len(batch),
                         tick_impl=impl.name,
                         devices=[str(d) for _, _, d in batch]):
            try:
                for _, (start, stop), dev in batch:
                    loops.append(TickLoop(
                        _chunk_grid(grid, _chunk_lanes(grid, start, stop, C)),
                        impl, dev, graph, record))
                _advance_together(loops, T)
                for (_, (start, stop), _), loop in zip(batch, loops):
                    out = loop.result()
                    outs.append({k: v[:stop - start] for k, v in out.items()})
                    capture_s += loop.capture_s
                    pool_bytes = max(pool_bytes, loop.pool_bytes)
            finally:
                for loop in loops:
                    loop.close()
    out = {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}
    return out, capture_s, pool_bytes


def _advance_together(loops: List["TickLoop"], T: int) -> None:
    """Advance every loop ``T`` ticks, in turns of
    :data:`_DEVICE_TURN_TICKS` when there are several, so each device has
    work in flight while the others take theirs."""
    turn = T if len(loops) == 1 else _DEVICE_TURN_TICKS
    for t0 in range(0, T, turn):
        for loop in loops:
            loop.advance(min(turn, T - t0))


def simulate_packed(grid: PackedGrid, tick_impl: str = "auto",
                    device=None, lane_chunk: Optional[int] = None,
                    devices: Optional[Sequence] = None,
                    record_series=None, shard: bool = False, *,
                    _eager: bool = False) -> Dict[str, np.ndarray]:
    """Run a packed grid; returns the raw per-lane aggregate dict (numpy
    arrays, lane-leading), with the keys of ``repro``'s ``simulate_packed``.

    ``tick_impl``: ``"torch"`` | ``"cuda"`` | ``"auto"``
    (``repro_torch.kernels.registry``). ``device``: where the whole grid
    lives and runs — ``cuda`` when None (raising if CUDA is absent), the
    CPU only when asked for. The ``cuda`` tick replays a CUDA graph
    (:class:`TickLoop`); the plain ``torch`` tick runs eagerly, as the
    oracle. ``_eager`` runs the ``cuda`` tick eagerly too, for the
    comparison of the two.

    ``lane_chunk`` bounds device memory: lanes run in fixed-size chunks
    (the last one padded by repeating its final lane; the padding's
    results are dropped), each on its own :class:`TickLoop`, closed before
    the next chunk on its device. ``devices`` (instead of ``device``; the
    default is ``[device]``) receives the chunks round-robin, one chunk
    per device when ``lane_chunk`` is None. A lane's results are bitwise
    those of the unchunked run.

    ``record_series`` (``True`` = sample every tick, an int = sample
    stride in ticks, default off) adds the end-of-tick series buffers to
    the result — ``ser_disk``/``ser_queue``/``ser_run`` ``[L, T_sample,
    S]``, ``ser_gcs`` ``[L, T_sample]``, ``ser_link`` ``[L, T_sample,
    S, 3]``; convert with :func:`series_from_capture`. Capture off runs
    the tick without capture, so those results stay bitwise the same.

    ``shard=True`` runs the lanes over the ``"lanes"`` mesh of the local
    devices of ``device``'s type (``parallel.sharding.lane_mesh``: every
    visible CUDA device, or the CPU): one contiguous block of lanes a
    device, padded by repeating the last lane, run together and
    concatenated in lane order, bitwise the unsharded result
    (:func:`_lane_mesh_run`). ``lane_chunk`` still bounds memory, each
    chunk sharded; ``devices=`` is the round-robin path's knob and raises
    together with ``shard``.
    """
    _check_shard(shard, devices)
    record = _normalize_record(record_series, grid.n_ticks)
    devs = _resolve_devices(device, devices)
    impl = resolve_tick_impl(tick_impl, devs[0])
    graph = impl.use_kernel and not _eager
    if shard:
        devs, lane_chunk = _lane_mesh_run(devs[0], lane_chunk)
    return _simulate(grid, impl, devs, graph=graph, record=record,
                     lane_chunk=lane_chunk)[0]


def _lane_mesh_run(device: torch.device, lane_chunk: Optional[int]):
    """``shard=True`` as the round-robin path runs it: the devices of the
    lane mesh of ``device``'s type (``parallel.sharding.lane_mesh``) and
    each chunk of ``lane_chunk`` lanes cut into one block a device. With
    no ``lane_chunk`` :func:`_simulate` gives each device one contiguous
    block of the lanes, the last padded by repeating its final lane; the
    blocks run together and are concatenated in lane order."""
    devs = list(lane_mesh(device_type=device.type).devices)
    return devs, lane_chunk and -(-lane_chunk // len(devs))


def _simulate(grid: PackedGrid, impl: TickImpl, devs: List[torch.device],
              graph: bool, record, lane_chunk: Optional[int]):
    """The plain and the chunked run: raw aggregates, capture seconds,
    graph pool bytes and the number of chunks."""
    if lane_chunk is not None and lane_chunk <= 0:
        raise ValueError(f"lane_chunk must be > 0, got {lane_chunk!r}")
    L = grid.n_lanes
    if lane_chunk is None and len(devs) > 1:
        lane_chunk = -(-L // len(devs))  # one chunk per device
    if lane_chunk is None or lane_chunk >= L:
        out, loop = _run_loop(grid, impl, devs[0], graph, record)
        return out, loop.capture_s, loop.pool_bytes, 1
    C = int(lane_chunk)
    return (*_run_chunks(grid, impl, devs, graph, record, C), -(-L // C))


def _run_loop(grid: PackedGrid, impl: TickImpl, device: torch.device,
              graph: bool, record=None):
    """Run every tick of ``grid``; returns the raw aggregates and the
    closed :class:`TickLoop` (its ``capture_s`` and ``pool_bytes`` stay
    readable)."""
    loop = TickLoop(grid, impl, device, graph=graph, record=record)
    try:
        loop.advance(grid.n_ticks)
        return loop.result(), loop
    finally:
        loop.close()


def _lane_result(grid: PackedGrid, out: dict, si: int,
                 wall_s: float, lane_base: int = 0) -> ScenarioResult:
    """Fold one spec's dynamics-lane aggregates into a ``ScenarioResult``
    with the metric keys of the event engine. Several specs may share one
    lane (pricing-only variants); each is billed with its own cost model.

    ``lane_base`` shifts the lane index when ``out`` holds only a chunk of
    the grid's lanes (the resilient path journals each chunk's results as
    it lands, before the full arrays exist).
    """
    spec = grid.specs[si]
    li = int(grid.lane_of[si]) - lane_base
    names = grid.site_names
    jobs_done_site = out["jobs_done_site"][li]
    m = {
        "jobs_done": float(jobs_done_site.sum()),
        "jobs_submitted": float(grid.n_jobs[li + lane_base].sum()),
        "download_pb": float(out["download_b"][li].sum()) / 1e15,
        "gcs_to_disk_pb": float(out["gcsdisk_b"][li].sum()) / 1e15,
        "disk_to_gcs_pb": float(out["diskgcs_b"][li].sum()) / 1e15,
        "gcs_used_pb": float(out["gcs_used"][li]) / 1e15,
        "job_waiting_h_mean": (float(out["wait_h_sum"][li])
                               / max(float(out["wait_n"][li]), 1.0)),
    }
    for s, name in enumerate(names):
        m[f"{name}.tape_to_disk_pb"] = float(out["tape_b"][li, s]) / 1e15
        m[f"{name}.jobs_done"] = float(jobs_done_site[s])
        m[f"{name}.disk_used_pb"] = float(out["disk_used"][li, s]) / 1e15
    bills = bills_from_monthly_totals(
        grid.cost_models[si], out["gbsec_mo"][li], out["egress_mo"][li],
        out["cls_a_mo"][li], out["cls_b_mo"][li], grid.full_months)
    for i, bill in enumerate(bills):
        m[f"month{i+1}.storage_usd"] = bill.storage_usd
        m[f"month{i+1}.network_usd"] = bill.network_usd
    monthly = {
        "gb_seconds": [float(x) for x in out["gbsec_mo"][li]],
        "egress_bytes": [float(x) for x in out["egress_mo"][li]],
        "class_a": [float(x) for x in out["cls_a_mo"][li]],
        "class_b": [float(x) for x in out["cls_b_mo"][li]],
        "full_months": int(grid.full_months),
    }
    return ScenarioResult(
        spec=spec,
        metrics=m,
        storage_usd=sum(b.storage_usd for b in bills),
        network_usd=sum(b.network_usd for b in bills),
        ops_usd=sum(b.ops_usd for b in bills),
        wall_s=wall_s,
        events=grid.n_ticks,
        monthly=monthly,
    )



def series_from_capture(grid: PackedGrid, out: Dict[str, np.ndarray],
                        si: int, record_series) -> Dict[str, TimeSeries]:
    """Convert one spec's series buffers to ``TimeSeries``.

    ``out`` must come from a ``simulate_packed(..., record_series=...)``
    call with the *same* ``record_series`` value. Names match the event
    engine's ``OutputCollector`` where both record the observable —
    ``"{site}.disk_used"``, ``"gcs_used"``, ``"{site}.running_jobs"`` —
    plus the batched program's own: ``"{site}.wait_queue"`` (distinct
    files with waiting jobs) and
    ``"{site}.link_active.{tape_to_disk,gcs_to_disk,disk_to_gcs}"``
    (transfer slots active on each link type).
    """
    record = _normalize_record(record_series, grid.n_ticks)
    if record is None:
        raise ValueError(
            "series_from_capture requires the record_series value the "
            f"grid was simulated with, got {record_series!r}")
    if "ser_disk" not in out:
        raise KeyError(
            "no series buffers in this result — was simulate_packed "
            "called with record_series on?")
    stride, _ = record
    li = int(grid.lane_of[si])
    times = [float(t) for t in np.asarray(grid.times)[::stride]]
    series: Dict[str, TimeSeries] = {}

    def add(name: str, values: np.ndarray) -> None:
        series[name] = TimeSeries(name, times=list(times),
                                  values=[float(v) for v in values])

    add("gcs_used", out["ser_gcs"][li])
    for s, name in enumerate(grid.site_names):
        add(f"{name}.disk_used", out["ser_disk"][li, :, s])
        add(f"{name}.running_jobs", out["ser_run"][li, :, s])
        add(f"{name}.wait_queue", out["ser_queue"][li, :, s])
        for k, link in enumerate(LINK_TYPES):
            add(f"{name}.link_active.{link}", out["ser_link"][li, :, s, k])
    return series


#: Default lane-chunk size of the resilient job path when the caller did
#: not pick one: small enough that an abandoned job loses little work,
#: large enough that per-chunk dispatch overhead stays trivial.
_RESILIENT_LANE_CHUNK = 8

#: Default lane-chunk size on the worker fleet: each chunk pays a frame
#: round trip, so fleet chunks are bigger than the in-process default.
_FLEET_LANE_CHUNK = 64


def lane_chunk_runner(ctx: Dict, loops: Optional[list] = None) -> Callable:
    """Build the worker-side runner of lane-chunk job payloads.

    ``ctx`` is the init context ``_simulate_packed_jobs`` builds: the
    *concrete* tick implementation and device (resolved in the dispatcher,
    so a worker never picks its own), the normalized series-capture
    configuration, and ``grid``, the packed grid without its lanes (the
    shared tick arrays, shipped once, never per job). Each payload is
    ``{"chunk": {per-lane field: array}, "n": valid_lanes}``, already
    padded to the chunk size by the dispatcher; the runner runs it on a
    :class:`TickLoop` of its own, closed when the attempt ends, raised or
    not, and drops the padding, so its results are bitwise those of the
    serial run; with ``ctx["shard"]`` each payload runs over the lane mesh
    of the runner's local devices. A ``cuda`` context where CUDA is missing raises in the
    attempt (the device rule): nothing runs on the CPU instead. ``loops``,
    when given, collects each finished attempt's closed loop (its capture
    seconds and graph pool bytes).
    """
    tick_impl, device, record = ctx["tick_impl"], ctx["device"], ctx["record"]
    template = ctx["grid"]

    def run(payload):
        dev = resolve_device(device)
        impl = resolve_tick_impl(tick_impl, dev)
        grid = _chunk_grid(template, payload["chunk"])
        if ctx.get("shard"):
            devs, _ = _lane_mesh_run(dev, None)
            out = _simulate(grid, impl, devs, impl.use_kernel, record, None)[0]
            return {k: v[:payload["n"]] for k, v in out.items()}
        out, loop = _run_loop(grid, impl, dev, graph=impl.use_kernel,
                              record=record)
        if loops is not None:
            loops.append(loop)
        return {k: v[:payload["n"]] for k, v in out.items()}

    return run


def _simulate_packed_jobs(grid: PackedGrid, *, impl: TickImpl,
                          device: torch.device, lane_chunk: Optional[int],
                          record, faults, retry, job_timeout,
                          journal: Optional[Callable],
                          workers: Optional[int] = None, transport=None,
                          shard: bool = False):
    """Run a packed grid as retryable lane-chunk jobs.

    Each job runs one fixed-size slice of the grid's lanes through
    :func:`lane_chunk_runner`, so a converged fault-injected run is
    bitwise the fault-free one (lanes never interact). Completed chunks
    are journaled through ``journal`` as they land (checkpointed resume);
    abandoned chunks leave their lanes out of the stitched output and are
    reported by the returned registry.

    ``shard`` runs each chunk over the lane mesh of the local devices of
    the process that runs it (:func:`_lane_mesh_run`).

    ``transport`` engages the worker fleet (``repro_torch.sim.runners``):
    up to ``workers`` persistent workers, each given the init context
    once and fed per-chunk lane slices. On the ``cuda`` path the kernel
    libraries are built here first, so workers on one machine load them
    and do not each run ``nvcc``.

    Returns ``(out, registry, missing_lanes, loops)`` where ``out`` has
    the ``simulate_packed`` shape (zero-filled for missing lanes — callers
    skip those via ``missing_lanes``) and ``loops`` holds the closed loops
    of the chunks run in this process.
    """
    from repro_torch.sim import jobs as joblib

    if lane_chunk is not None and lane_chunk <= 0:
        raise ValueError(f"lane_chunk must be > 0, got {lane_chunk!r}")
    L = grid.n_lanes
    if lane_chunk is not None:
        C = int(lane_chunk)
    else:
        C = min(L, _FLEET_LANE_CHUNK if transport is not None
                else _RESILIENT_LANE_CHUNK)
    spec_of_chunk: Dict[tuple, list] = {}
    jobs_list = []
    for start in range(0, L, C):
        stop = min(start + C, L)
        sis = [si for si in range(grid.n_specs)
               if start <= int(grid.lane_of[si]) < stop]
        labels = tuple(grid.specs[si].label for si in sis)
        jobs_list.append(joblib.Job(job_id=f"lanes{start:05d}",
                                    payload=(start, stop), labels=labels,
                                    timeout_s=job_timeout))
        spec_of_chunk[(start, stop)] = sis

    def payload_of(job):
        start, stop = job.payload
        return {"chunk": _chunk_lanes(grid, start, stop, C),
                "n": stop - start}

    on_done = None
    if journal is not None:
        def on_done(job, out_chunk):
            start, stop = job.payload
            journal([(grid.specs[si],
                      _lane_result(grid, out_chunk, si, 0.0,
                                   lane_base=start))
                     for si in spec_of_chunk[(start, stop)]])

    ctx = {"kind": "lanes", "tick_impl": impl.name, "device": str(device),
           "record": record, "shard": shard,
           "grid": _chunk_grid(grid, _chunk_lanes(grid, 0, 0, 0))}
    policy = retry if retry is not None else joblib.RetryPolicy()
    tracer = get_tracer()
    loops: List[TickLoop] = []
    if transport is not None:
        from repro_torch.kernels import _build
        from repro_torch.sim.runners import run_fleet_jobs

        if impl.use_kernel:
            _build.build(["lane_tick", "tick_glue"])
        with tracer.span("simulate_packed.fleet", lanes=L, chunk=C,
                         workers=workers or 1, tick_impl=impl.name):
            chunk_results, registry = run_fleet_jobs(
                jobs_list, workers=workers or 1, transport=transport,
                ctx=ctx, prepare=payload_of, policy=policy, faults=faults,
                on_done=on_done)
    else:
        runner = lane_chunk_runner(ctx, loops)

        def run_one(job):
            start, stop = job.payload
            with tracer.span("simulate_packed.chunk", chunk=job.job_id,
                             lanes=stop - start, tick_impl=impl.name):
                return runner(payload_of(job))

        chunk_results, registry = joblib.run_local_jobs(
            jobs_list, run_one, policy=policy, faults=faults,
            on_done=on_done)

    out: Dict[str, np.ndarray] = {}
    done_lanes: set = set()
    for job in registry.jobs.values():
        if job.state != joblib.DONE:
            continue
        start, stop = job.payload
        o = chunk_results[job.job_id]
        if not out:
            out = {k: np.zeros((L,) + v.shape[1:], dtype=v.dtype)
                   for k, v in o.items()}
        for k, v in o.items():
            out[k][start:stop] = v
        done_lanes.update(range(start, stop))
    return out, registry, set(range(L)) - done_lanes, loops


def run_sweep_torch(specs: Sequence[ScenarioSpec], tick: float = 10.0,
                    tick_impl: str = "auto", device=None,
                    progress: Optional[Callable] = None,
                    lane_chunk: Optional[int] = None,
                    devices: Optional[Sequence] = None,
                    record_series=None, retry=None, faults=None,
                    job_timeout: Optional[float] = None,
                    journal: Optional[Callable] = None,
                    workers: Optional[int] = None, transport=None,
                    shard: bool = False) -> SweepResult:
    """Run a spec grid as one batched program on ``device`` (``cuda`` when
    None). Returns a ``SweepResult`` whose per-config ``wall_s`` is the
    batch wall time split evenly, whose ``events`` are ticks and whose
    ``lanes_simulated`` counts the distinct dynamics lanes simulated.
    Specs that differ only in pricing share one simulated lane and are
    billed separately. ``tick`` is the clock step in seconds, ``tick_impl``
    the kernel implementation — independent axes. ``progress(done, total,
    result)`` is called after each result.

    ``lane_chunk``/``devices``: see :func:`simulate_packed` — chunked
    execution in bounded device memory, dealt round-robin over devices.
    ``record_series`` turns on per-tick series capture (``True`` or a
    sample stride in ticks); each result then carries the summary digests
    of :func:`series_from_capture` in ``.series``.

    ``retry``/``faults``/``job_timeout``/``journal`` engage the
    fault-tolerant lane-chunk job path (``_simulate_packed_jobs``): lanes
    run as retryable chunk jobs, completions checkpoint through
    ``journal``, and chunks that exhaust their retries drop their specs
    from the (partial) result, reported in ``SweepResult.failures``. The
    plain path is untouched when none of ``retry``/``faults``/``transport``
    is given. ``transport``/``workers`` drain the chunk jobs through the
    worker fleet (``repro_torch.sim.runners``). Round-robin over
    ``devices`` is not combined with the job path. ``shard=True`` runs
    the lanes over the lane mesh of the local devices
    (:func:`simulate_packed`), each chunk job sharded on the job path.

    Telemetry: spans ``pack_specs`` and ``simulate_packed``, then one
    ``sweep.torch`` instant event with the call's specs, lanes, ticks,
    chunks and seconds (``pack_s``, ``capture_s`` and ``pool_bytes`` of
    the graph captures in this process — summed and the largest — and
    ``sweep_s`` for the whole call); the registry counts
    ``sweep.torch.runs`` and ``sweep.torch.lanes`` and observes
    ``sweep.torch.pack_s`` and ``sweep.torch.wall_s``."""
    from repro_torch.sim.faults import as_faults

    _check_shard(shard, devices)
    faults = as_faults(faults)
    resilient = (retry is not None or faults is not None
                 or transport is not None)
    if resilient and devices is not None:
        raise ValueError("devices round-robin is not supported on the "
                         "resilient job path (retry/faults/transport)")
    devs = _resolve_devices(device, devices)
    impl = resolve_tick_impl(tick_impl, devs[0])
    tracer = get_tracer()
    t0 = time.perf_counter()
    with tracer.span("pack_specs", n_specs=len(specs)):
        grid = pack_specs(specs, tick=tick)
    pack_s = time.perf_counter() - t0
    record = _normalize_record(record_series, grid.n_ticks)
    registry = None
    missing: set = set()
    capture_s, pool_bytes, n_chunks = 0.0, 0, 1
    with tracer.span("simulate_packed", lanes=grid.n_lanes,
                     ticks=grid.n_ticks, tick_impl=impl.name):
        if resilient:
            out, registry, missing, loops = _simulate_packed_jobs(
                grid, impl=impl, device=devs[0], lane_chunk=lane_chunk,
                record=record, faults=faults, retry=retry,
                job_timeout=job_timeout, journal=journal, workers=workers,
                transport=transport, shard=shard)
            n_chunks = len(registry.jobs)
            capture_s = sum(loop.capture_s for loop in loops)
            pool_bytes = max((loop.pool_bytes for loop in loops), default=0)
        else:
            if shard:
                devs, lane_chunk = _lane_mesh_run(devs[0], lane_chunk)
            out, capture_s, pool_bytes, n_chunks = _simulate(
                grid, impl, devs, graph=impl.use_kernel, record=record,
                lane_chunk=lane_chunk)
    wall = time.perf_counter() - t0
    lanes = grid.n_lanes - len(missing)
    reg = get_registry()
    reg.inc("sweep.torch.runs", help="Batched torch sweep invocations")
    reg.inc("sweep.torch.lanes", lanes,
            help="Dynamics lanes simulated by the batched torch program")
    reg.observe("sweep.torch.pack_s", pack_s,
                help="Spec packing wall time per sweep (s)")
    reg.observe("sweep.torch.wall_s", wall,
                help="Batched torch sweep wall time, packing included (s)")
    tracer.instant("sweep.torch", specs=grid.n_specs, lanes=grid.n_lanes,
                   ticks=grid.n_ticks, tick_impl=impl.name, chunks=n_chunks,
                   pack_s=pack_s, capture_s=capture_s, pool_bytes=pool_bytes,
                   sweep_s=wall)
    ok_sis = [si for si in range(grid.n_specs)
              if int(grid.lane_of[si]) not in missing]
    results: List[ScenarioResult] = []
    for si in ok_sis:
        r = _lane_result(grid, out, si, wall / max(len(ok_sis), 1))
        if record is not None:
            r.series = {name: ts.summary() for name, ts in
                        series_from_capture(grid, out, si,
                                            record_series).items()}
        results.append(r)
        if progress is not None:
            progress(len(results), len(ok_sis), r)
    return SweepResult(results=results, wall_s=wall, lanes_simulated=lanes,
                       failures=registry.failures() if registry else [])
