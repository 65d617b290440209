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
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.scenarios import PackedGrid, ScenarioSpec, pack_specs
from repro_torch.kernels.lane_tick import ops, ref
from repro_torch.kernels.tick_glue import ops as glue_ops
from repro_torch.kernels.tick_glue import ref as glue_ref
from repro_torch.kernels.tick_glue.ref import ABSENT, BIG_TICKET, PRESENT
from repro_torch.kernels.registry import (
    TickImpl,
    resolve_device,
    resolve_tick_impl,
)
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.sim.cloud import bills_from_monthly_totals
from repro_torch.sim.sweep import ScenarioResult, SweepResult

#: Disk-window (waiting queue) admissions attempted per site per tick
#: (arrivals are ~0.64 jobs/tick/site, Table 3; a burst drains over the
#: next few ticks).
WAIT_ADMITS_PER_TICK = 4

#: Refinement passes of the shared-GCS admission gate.
GCS_ADMIT_PASSES = ref.GCS_ADMIT_PASSES

_INF = float("inf")


def _scatter_bool(plane: torch.Tensor, rows: torch.Tensor, src: torch.Tensor,
                  reduce: str) -> None:
    """Duplicate-safe in-place min/max scatter into a bool ``[L, N]`` plane
    (through its ``uint8`` view; JAX's ``.at[].min/max`` semantics)."""
    plane.view(torch.uint8).scatter_reduce_(
        1, rows, src.to(torch.uint8), reduce, include_self=True)


def _lane_step_fns(S: int, K: int, n_months: int, impl: TickImpl):
    """The tick body and the post-loop reduction (closures over the static
    dimensions and the resolved tick implementation).

    The tick reads its index from the state's device counter
    (``st["tick"]``, stepped at its end) and its clock values with
    ``index_select`` on it, and updates every state tensor in place
    (``masked_fill_``, ``add_``, ``copy_``, ``torch.where(..., out=)`` and
    the duplicate-safe scatters at the end), so each keeps its address from
    tick to tick: what a CUDA graph of the tick needs. Every value the end
    scatters combine with (``cur_link``, ``cur_lqt``, ``cur_wqt``) is
    gathered before the first of them, and every read sees what the JAX
    package's functional tick body would bind at that point.
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
        t.add_(1)

    def post_fn(st, c, horizon) -> Dict[str, torch.Tensor]:
        ready = st["job_ready"] < _INF
        done = ready & (st["job_ready"] + c["job_tail"] <= horizon)
        job_sizes = torch.gather(c["sizes"], -1, c["job_fid64"])
        wait_h = (st["job_ready"] - c["job_submit_time"]) / 3600.0
        return {
            "jobs_done_site": done.sum(-1, dtype=torch.int32),
            "download_b": (job_sizes * ready).sum(-1),
            "wait_h_sum": torch.where(ready, wait_h, 0.0).sum((1, 2)),
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


def _build_lane_sim(grid: PackedGrid, device: torch.device):
    """Device constants and initial state of a packed grid."""
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
    reserved (both 0 until the capture).
    """

    def __init__(self, grid: PackedGrid, impl: TickImpl, device: torch.device,
                 graph: bool):
        if graph and not (impl.use_kernel and device.type == "cuda"):
            raise ValueError("a captured tick needs tick_impl='cuda'")
        self.n_ticks = grid.n_ticks
        self.device, self.use_graph = device, graph
        self.tick_fn, self.post_fn = _lane_step_fns(
            len(grid.site_names), grid.max_jobs_per_tick, grid.n_months, impl)
        self.c, self.st = _build_lane_sim(grid, device)
        self.horizon = torch.tensor(float(grid.horizon), dtype=torch.float32,
                                    device=device)
        self.t = 0
        self._graph = None
        self._per_tick: List[Dict[str, int]] = []
        self.capture_s = 0.0
        self.pool_bytes = 0

    def advance(self, n: int) -> None:
        """Run the next ``n`` ticks (no host sync)."""
        if not 0 <= n <= self.n_ticks - self.t:
            raise ValueError(f"advance({n}) at tick {self.t} of "
                             f"{self.n_ticks}")
        if not self.use_graph:
            for _ in range(n):
                self.tick_fn(self.st, self.c)
            self.t += n
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
        self.t += n

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


def simulate_packed(grid: PackedGrid, tick_impl: str = "auto",
                    device=None, *, _eager: bool = False
                    ) -> Dict[str, np.ndarray]:
    """Run a packed grid; returns the raw per-lane aggregate dict (numpy
    arrays, lane-leading), with the keys of ``repro``'s ``simulate_packed``.

    ``tick_impl``: ``"torch"`` | ``"cuda"`` | ``"auto"``
    (``repro_torch.kernels.registry``). ``device``: where the whole grid
    lives and runs — ``cuda`` when None (raising if CUDA is absent), the
    CPU only when asked for. The ``cuda`` tick replays a CUDA graph
    (:class:`TickLoop`); the plain ``torch`` tick runs eagerly, as the
    oracle. ``_eager`` runs the ``cuda`` tick eagerly too, for the
    comparison of the two.
    """
    dev = resolve_device(device)
    impl = resolve_tick_impl(tick_impl, dev)
    return _run_loop(grid, impl, dev, graph=impl.use_kernel and not _eager)[0]


def _run_loop(grid: PackedGrid, impl: TickImpl, device: torch.device,
              graph: bool):
    """Run every tick of ``grid``; returns the raw aggregates and the
    closed :class:`TickLoop` (its ``capture_s`` and ``pool_bytes`` stay
    readable)."""
    loop = TickLoop(grid, impl, device, graph=graph)
    try:
        loop.advance(grid.n_ticks)
        return loop.result(), loop
    finally:
        loop.close()


def _lane_result(grid: PackedGrid, out: dict, si: int,
                 wall_s: float) -> ScenarioResult:
    """Fold one spec's dynamics-lane aggregates into a ``ScenarioResult``
    with the metric keys of the event engine. Several specs may share one
    lane (pricing-only variants); each is billed with its own cost model.
    """
    spec = grid.specs[si]
    li = int(grid.lane_of[si])
    names = grid.site_names
    jobs_done_site = out["jobs_done_site"][li]
    m = {
        "jobs_done": float(jobs_done_site.sum()),
        "jobs_submitted": float(grid.n_jobs[li].sum()),
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


def run_sweep_torch(specs: Sequence[ScenarioSpec], tick: float = 10.0,
                    tick_impl: str = "auto", device=None) -> SweepResult:
    """Run a spec grid as one batched program on ``device`` (``cuda`` when
    None). Returns a ``SweepResult`` whose per-config ``wall_s`` is the
    batch wall time split evenly, whose ``events`` are ticks and whose
    ``lanes_simulated`` counts the distinct dynamics lanes packed. Specs
    that differ only in pricing share one simulated lane and are billed
    separately. ``tick`` is the clock step in seconds, ``tick_impl`` the
    kernel implementation — independent axes.

    Telemetry: spans ``pack_specs`` and ``simulate_packed``, then one
    ``sweep.torch`` instant event with the call's specs, lanes, ticks and
    seconds (``pack_s``, ``capture_s`` and ``pool_bytes`` of the graph
    capture, ``sweep_s`` for the whole call); the registry counts
    ``sweep.torch.runs`` and ``sweep.torch.lanes`` and observes
    ``sweep.torch.pack_s`` and ``sweep.torch.wall_s``."""
    dev = resolve_device(device)
    impl = resolve_tick_impl(tick_impl, dev)
    tracer = get_tracer()
    t0 = time.perf_counter()
    with tracer.span("pack_specs", n_specs=len(specs)):
        grid = pack_specs(specs, tick=tick)
    pack_s = time.perf_counter() - t0
    with tracer.span("simulate_packed", lanes=grid.n_lanes,
                     ticks=grid.n_ticks, tick_impl=impl.name):
        out, loop = _run_loop(grid, impl, dev, graph=impl.use_kernel)
    wall = time.perf_counter() - t0
    reg = get_registry()
    reg.inc("sweep.torch.runs", help="Batched torch sweep invocations")
    reg.inc("sweep.torch.lanes", grid.n_lanes,
            help="Dynamics lanes simulated by the batched torch program")
    reg.observe("sweep.torch.pack_s", pack_s,
                help="Spec packing wall time per sweep (s)")
    reg.observe("sweep.torch.wall_s", wall,
                help="Batched torch sweep wall time, packing included (s)")
    tracer.instant("sweep.torch", specs=grid.n_specs, lanes=grid.n_lanes,
                   ticks=grid.n_ticks, tick_impl=impl.name, pack_s=pack_s,
                   capture_s=loop.capture_s, pool_bytes=loop.pool_bytes,
                   sweep_s=wall)
    results: List[ScenarioResult] = [
        _lane_result(grid, out, si, wall / grid.n_specs)
        for si in range(grid.n_specs)]
    return SweepResult(results=results, wall_s=wall,
                       lanes_simulated=grid.n_lanes)
