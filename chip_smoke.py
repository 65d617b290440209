#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--days D]

Phases, in order; any failure exits nonzero without the final ``ok`` line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from the sources in this checkout (``nvcc`` into
   ``build/repro_torch/``), print the build seconds and each kernel's
   registers and spill bytes from ``ptxas``;
3. kernel phase: each hand-written kernel against its plain PyTorch version
   on the card, at the main path's shapes (8 lanes x 2 sites x 1,000,000
   files, the grid's K window, W = 4), with a finite-limit GCS admission
   case whose every admission difference must be a tie within a few ulps
   of the limit and whose migration rank must be bitwise the plain one,
   and a dense unlimited case; prints the differences, the kernel's and
   the plain version's milliseconds (CUDA events, after warm-up), the
   kernel's device time (``torch.profiler``) and the bound: the bytes the
   function needs at these inputs (dense planes once, sparse reads by the
   32-byte sectors they touch) over the memory rate (for ``gcs_admit``
   also the bound of the function without its rank plane);
4. small reference: a 1,000-file grid on the CPU's plain path against the
   card's kernel path, at the Table-2 5% bar;
5. sweep phase: the 216-config pricing grid (Config III; cache 10/20/40/80
   TB; 3 egress options; 9 storage prices; 2 seeds; 8 dynamics lanes) at
   the paper's full catalogue of 1,000,000 files per site through
   ``run_sweep_torch`` once with ``tick_impl="cuda"`` and once with
   ``"torch"`` on the card; per-spec agreement at the Table-2 5% bar, equal
   jobs submitted, and every kernel launched on the ``cuda`` run;
6. profile: 40 ticks of the ``cuda`` path on the host clock, 40 more under
   ``torch.profiler`` — wall and device time per tick, the device's idle
   share, the top kernels, ``torch.cumsum``'s calls and device time per
   tick, and the GCS candidates and admissions per lane per tick of the
   profiled ticks (counted after them) and of 40 ticks half-way through
   the horizon;
7. carousel phase: ``carousel_tick`` over 1,000,000 transfers (one site's
   catalogue, every file in flight) on 6 links (Config III's 2 sites x 3
   link types) and on 512, half shared and half per-transfer, dt = 10 s,
   then ``simulate_ticks`` for 1,000 ticks on 6 links through the kernel
   and through the plain version: ``new_done``/``completed`` bitwise,
   counts exact, the engine's final state bitwise and its completions
   equal; ticks/s of both;
8. attention phase: ``flash_attention`` at qwen3_4b widths (nh 32, nkv 8,
   hd 128, T = S = 4096, bf16, causal), gemma3_27b's local layers (nh 32,
   nkv 16, published head_dim 128, T = S = 4096, bf16, causal, window
   1024), the same at hd 168 (the width ``repro``'s gemma3_27b config
   derives as 5376/32 — not the published head_dim — kept as a width that
   is not a power of two) in bf16 and in float32 (T = S = 2048), and
   hymba_1_5b in float32 (nh 25, nkv 5, hd 64, T = S = 2048, causal,
   window 1024); the bf16 cases through the tensor-core kernel
   (``wgmma`` route), the float32 ones through the SIMT kernel (``simt``),
   each case checked to launch its route's kernel exactly once; each
   against the plain version at atol 4e-3 / rtol 8e-3
   in bf16 (one bf16 ulp, and at most 1% of the elements unequal) or
   2e-5 in float32, with PyTorch's
   ``scaled_dot_product_attention`` timed beside it as the yardstick
   (never on the port's path), its elements outside the same bar and
   each side's elements not equal to the plain version counted;
9. Mamba phase: ``mamba_scan`` at falcon_mamba_7b widths (B 1, T 2048,
   d_inner 8192, state 16; dA and dBu 1.07 GB each) against the plain
   version at 1e-4 atol/rtol;
10. the ``kernels`` JSON line: one entry per kernel and case (``case``
    names it), each with its launches on its own path (counts reset just
    before the path runs, read just after each case); attention entries
    also name their route (``variant``: ``wgmma`` or ``simt``) and that
    kernel's source; then the ``ok`` line.

Phases 3, 7, 8 and 9 print the kernel's and the plain version's
milliseconds (CUDA events after warm-up) and the bound: the larger of the
bytes the function needs over the memory rate and its operations over the
card's peak for their type (float32 outside the tensor cores, bf16 on
them), from the data sheet of an H100 SXM.

The horizon is cut from the paper's 90 days to ``--days`` (default 1 day,
8,641 ticks of 10 s) to fit the run's time limit; the catalogue is not cut.
Imports nothing of JAX and nothing of the JAX package. Exits nonzero when
CUDA is not available or when ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM data sheet: device-memory bandwidth, float32 peak outside the
#: tensor cores and dense bf16 tensor-core peak, the rates the bounds are
#: computed against.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

TOL = 0.05  # Table 2 validation tolerance (fractional)
_LANE_TICK = "src/repro_torch/kernels/lane_tick/csrc/lane_tick.cu"
KERNEL_SOURCE = {
    "transfer_tick": _LANE_TICK,
    "gcs_admit": _LANE_TICK,
    "window_admit": _LANE_TICK,
    "carousel_tick":
        "src/repro_torch/kernels/carousel_update/csrc/carousel_update.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "mamba_scan": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
}
#: The attention kernel each route launches (``flash_attention.ops._route``:
#: bfloat16 at hd a multiple of 8 -> ``wgmma``, else ``simt``).
ATTENTION_SOURCE = {
    "wgmma": "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_wgmma.cu",
    "simt": KERNEL_SOURCE["flash_attention"],
}
REPLACES = {
    "transfer_tick": "src/repro/kernels/lane_tick/lane_tick.py:81",
    "gcs_admit": "src/repro/kernels/lane_tick/lane_tick.py:194",
    "window_admit": "src/repro/kernels/lane_tick/lane_tick.py:292",
    "carousel_tick":
        "src/repro/kernels/carousel_update/carousel_update.py:42",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:28",
    "mamba_scan": "src/repro/kernels/mamba_scan/mamba_scan.py:29",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(torch, fn, n: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call over ``n`` calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_us(torch, fn, n: int = 20) -> float:
    """Device time per call of ``fn`` in microseconds: the device-side
    events ``torch.profiler`` records over ``n`` calls (after one warm-up
    call), summed and divided by ``n``. Unlike :func:`time_ms` it leaves
    out the host's gaps between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    """Least time for the work: bytes over the memory rate against
    operations over the peak for their type (float32 outside the tensor
    cores unless ``ops_per_s`` says otherwise); returns (ms, bound_by)."""
    t_bytes = n_bytes / MEM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def n_outside(got, want, atol: float, rtol: float) -> int:
    """Elements of ``got`` farther from ``want`` than ``atol + rtol *
    |want|`` (both compared in float32)."""
    want = want.float()
    return int(((got.float() - want).abs() > atol + rtol * want.abs()).sum())


def sector_bytes(torch, mask, itemsize: int) -> int:
    """Bytes of the 32-byte sectors that a read of ``itemsize``-byte
    elements of a contiguous tensor at ``mask`` touches: what a sparse read
    costs in device memory."""
    per = 32 // itemsize
    flat = mask.reshape(-1)
    pad = (-flat.numel()) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return 32 * int(flat.view(-1, per).any(-1).sum())


def gcs_tie_check(torch, want, sizes, used, limit, got, plain, n_passes,
                  ulps: int = 16):
    """Hold the kernel's GCS admission to the plain version's up to ties.

    Replays the plain passes and keeps, per candidate, the least distance
    of its gate value ``used + cumsum`` to the limit over the passes that
    still held it. A candidate the two admit differently must lie within
    ``ulps`` float32 ulps of a finite limit there: the kernel sums in
    another order than ``torch.cumsum``, and nothing else may differ.
    Returns the count of tied candidates and their bytes per lane."""
    L = want.shape[0]
    w, sz = want.reshape(L, -1), sizes.reshape(L, -1)
    dist = torch.full_like(sz, float("inf"))
    adm = torch.zeros_like(w)
    u = used
    for _ in range(n_passes):
        rem = w & ~adm
        gate = u[:, None] + torch.cumsum(sz * rem, dim=1)
        dist = torch.where(rem, torch.minimum(
            dist, (gate - limit[:, None]).abs()), dist)
        new = rem & (gate <= limit[:, None])
        u = u + (sz * new).sum(1)
        adm = adm | new
    check(torch.equal(adm, plain.reshape(L, -1)),
          "gcs_admit: the replay of the plain passes disagrees with ref")
    diff = got.reshape(L, -1) != adm
    tol = torch.where(torch.isfinite(limit),
                      ulps * torch.finfo(torch.float32).eps * limit.abs(),
                      torch.zeros_like(limit))
    bad = int((diff & ~(dist <= tol[:, None])).sum())
    check(bad == 0, f"gcs_admit: {bad} admission differences farther than "
                    f"{ulps} ulps from the limit")
    return int(diff.sum()), (sz * diff).sum(1)


def pricing_specs(days: float, n_files: int):
    from repro_torch.core.scenarios import expand_grid, with_seeds

    specs = with_seeds(expand_grid({
        "base": "III",
        "cache_tb": [10.0, 20.0, 40.0, 80.0],
        "egress": ["internet", "direct", "interconnect"],
        "storage_price": [round(0.018 + 0.002 * i, 3) for i in range(9)],
        "days": days, "n_files": n_files,
    }), 2)
    check(len(specs) == 216, f"pricing grid has {len(specs)} specs")
    return specs


def lane_parity(ref, got) -> int:
    """``tests/test_batched.py``'s per-spec Table-2 bar; returns the count
    of specs checked."""
    def close(a, b, tol=TOL, floor=1.0):
        return abs(a - b) <= tol * max(abs(a), abs(b), floor)

    check(len(ref.results) == len(got.results), "result counts differ")
    for a, b in zip(ref.results, got.results):
        lbl = a.spec.label
        check(a.spec == b.spec, f"spec order differs at {lbl}")
        for r in (a, b):
            vals = [r.cost_usd, *r.metrics.values()]
            check(all(v == v and abs(v) != float("inf") for v in vals),
                  f"{lbl}: non-finite metric")
        check(close(a.jobs_done, b.jobs_done),
              f"{lbl}: jobs_done {a.jobs_done} vs {b.jobs_done}")
        check(close(a.cost_usd, b.cost_usd),
              f"{lbl}: cost {a.cost_usd} vs {b.cost_usd}")
        check(close(a.metrics["download_pb"], b.metrics["download_pb"],
                    floor=1e-6), f"{lbl}: download_pb")
        check(a.metrics["jobs_submitted"] == b.metrics["jobs_submitted"],
              f"{lbl}: jobs_submitted")
        check(abs(a.metrics["job_waiting_h_mean"]
                  - b.metrics["job_waiting_h_mean"]) <= 0.05,
              f"{lbl}: job_waiting_h_mean")
    return len(ref.results)


def kernel_phase(torch, grid, L_sweep: int) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels.lane_tick import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20210507)
    L, S, F = L_sweep, len(grid.site_names), grid.sizes.shape[-1]
    K = grid.max_jobs_per_tick
    n_months = grid.n_months
    sizes = torch.as_tensor(grid.sizes[:L], device=dev)
    check(tuple(sizes.shape) == (L, S, F), f"sizes shape {sizes.shape}")
    dt = torch.tensor(10.0, dtype=torch.float32, device=dev)
    month = torch.tensor(0, dtype=torch.int32, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    results = {}

    # -- transfer_tick: ~1 in 3000 files in flight (the link slots' scale),
    # half of them within one step of completion; random link modes.
    site = torch.arange(S, device=dev).view(1, S, 1)
    ltype = torch.randint(0, 3, (L, S, F), generator=gen, device=dev)
    link_id = (3 * site + ltype).to(torch.int32)
    active = rand(L, S, F) < 3e-4
    total = sizes.clone()
    done = total * (1.0 - 0.01 * rand(L, S, F))
    bw = torch.as_tensor(grid.link_bw[:L], device=dev)
    mode = torch.randint(0, 2, (L, 3 * S), generator=gen, device=dev,
                         dtype=torch.int32)
    args = (link_id, active, done, total, sizes, bw, mode, dt, month,
            n_months)
    got = ops.transfer_tick(*args)
    want = ref.transfer_tick(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]), "transfer_tick: new_done not bitwise")
    check(torch.equal(got[1], want[1]), "transfer_tick: completion mask")
    rel = 0.0
    for g, w in zip(got[2:], want[2:]):
        err = (g - w).abs() / w.abs().clamp_min(1.0)
        rel = max(rel, float(err.max()))
    check(rel <= 1e-6, f"transfer_tick: billing rel err {rel}")
    n_comp = int(got[1].sum())
    check(n_comp > 0, "transfer_tick: no completion exercised")
    n = L * S * F
    n_act = int(active.sum())
    # needed: active, done and total in and new_done and the completion
    # flag out for every file; the link id only of active transfers, the
    # size only of completions; the per-link and per-lane vectors
    need = (n * (1 + 4 + 4) + n * (4 + 1) + sector_bytes(torch, active, 4)
            + sector_bytes(torch, got[1], 4) + L * 3 * S * 8
            + 3 * L * S * 4 + 3 * L * n_months * 4)
    nb, kind = bound_ms(need, 2 * n + 4 * n_act + n_comp)
    results["transfer_tick"] = dict(
        max_abs_err=float((got[0] - want[0]).abs().max()),
        ms=time_ms(torch, lambda: ops.transfer_tick(*args)),
        device_us=device_us(torch, lambda: ops.transfer_tick(*args)),
        plain_ms=time_ms(torch, lambda: ref.transfer_tick(*args)),
        bound_ms=nb, bound_by=kind, library_ms=None)
    log(f"kernel transfer_tick: new_done/comp bitwise, billing max rel err "
        f"{rel:.3g}, {n_act} active, {n_comp} completions, bound counts "
        f"{need / 1e6:.2f} MB")
    del link_id, active, total, done, got, want

    # -- gcs_admit: sparse candidates as in the tick (files whose last
    # consumer just finished), half the lanes under a finite limit that
    # cuts through the candidates; plus a dense unlimited case.
    want_m = rand(L, S, F) < 2e-5
    used = 1e12 * rand(L)
    wanted = (sizes * want_m).sum((1, 2))
    finite = torch.arange(L, device=dev) % 2 == 0
    limit = torch.where(finite, used + 0.5 * wanted,
                        torch.tensor(float("inf"), device=dev))
    gargs = (want_m, sizes, used, limit, dt, month, n_months)
    got = ops.gcs_admit(*gargs)
    plain = ref.gcs_admit(*gargs)
    torch.cuda.synchronize()
    ties, tie_bytes = gcs_tie_check(torch, want_m, sizes, used, limit,
                                    got[0], plain[0], ref.GCS_ADMIT_PASSES)
    # the migration rank: bitwise the plain rank of the kernel's own mask,
    # and so the plain version's wherever the masks agree (no tie)
    check(torch.equal(got[3], ref.admission_rank(got[0])),
          "gcs_admit: rank differs from the per-site rank of its mask")
    check(ties > 0 or torch.equal(got[3], plain[3]),
          "gcs_admit: rank differs from the plain version's")
    check(torch.equal(got[0][~finite], want_m[~finite]),
          "gcs_admit: unlimited lanes must admit every candidate")
    check(bool((got[0] != want_m)[finite].any()),
          "gcs_admit: the finite limit did not bind")
    # every lane: rtol 1e-6, widened on a lane with ties by the tied bytes
    u_err = (got[1] - plain[1]).abs()
    check(bool((u_err <= 1e-6 * plain[1].abs() + tie_bytes).all()),
          f"gcs_admit: used' differs by {u_err.tolist()}")
    g_tol = 1e-6 * plain[2].abs() + (tie_bytes / 1e9 * dt)[:, None]
    check(bool(((got[2] - plain[2]).abs() <= g_tol).all()),
          "gcs_admit: gbsec differs")
    dense = rand(L, S, F) < 0.3
    inf_limit = torch.full((L,), float("inf"), device=dev)
    dg = ops.gcs_admit(dense, sizes, used, inf_limit, dt, month, n_months)
    dp = ref.gcs_admit(dense, sizes, used, inf_limit, dt, month, n_months)
    torch.cuda.synchronize()
    check(torch.equal(dg[0], dp[0]), "gcs_admit: dense unlimited mask")
    check(torch.equal(dg[3], dp[3]), "gcs_admit: dense unlimited rank")
    torch.testing.assert_close(dg[1], dp[1], rtol=1e-6, atol=0.0)
    dense_ms = time_ms(torch, lambda: ops.gcs_admit(
        dense, sizes, used, inf_limit, dt, month, n_months), n=5)
    n_cand = int(want_m.sum())
    # needed: the candidate flag in and the admission out for every file,
    # the size only of candidates; per-lane scalars and the month row; the
    # migration rank out for every file (int32) since the kernel returns it
    need = (n * (1 + 1) + sector_bytes(torch, want_m, 4) + L * 4 * 3
            + L * n_months * 4)
    n_ops = 3 * n_cand * ref.GCS_ADMIT_PASSES
    nb_old, _ = bound_ms(need, n_ops)
    nb, kind = bound_ms(need + 4 * n, n_ops)
    results["gcs_admit"] = dict(
        max_abs_err=float(u_err.max()),
        ms=time_ms(torch, lambda: ops.gcs_admit(*gargs)),
        device_us=device_us(torch, lambda: ops.gcs_admit(*gargs)),
        plain_ms=time_ms(torch, lambda: ref.gcs_admit(*gargs)),
        bound_ms=nb, bound_by=kind, bound_ms_without_rank=nb_old,
        library_ms=None)
    log(f"kernel gcs_admit: {n_cand} candidates, {ties} boundary ties "
        f"(each within 16 ulps of the limit), rank bitwise, used'/gbsec on "
        f"every lane, dense unlimited case ({int(dense.sum())} candidates) "
        f"exact in {dense_ms:.4f} ms, bound counts {(need + 4 * n) / 1e6:.2f}"
        f" MB ({need / 1e6:.2f} MB without the rank plane: bound "
        f"{nb_old:.4f} ms)")
    del want_m, dense, got, plain, dg, dp

    # -- window_admit: the K job window (fifo=False) and the W = 4 wait
    # queue (fifo=True) against disk headroom.
    win_err = 0.0
    win_ms = []
    for C, fifo in ((K, False), (4, True)):
        live = rand(L, S, C) < 0.7
        size = sizes[:, :, :C].contiguous()
        limit_d = torch.full((L, S), 1e13, device=dev)
        used_d = limit_d - size.sum(-1) * rand(L, S)
        wargs = (live, size, used_d, limit_d, fifo)
        got = ops.window_admit(*wargs)
        plain = ref.window_admit(*wargs)
        torch.cuda.synchronize()
        check(torch.equal(got[0], plain[0]), f"window_admit C={C}: mask")
        check(torch.equal(got[1], plain[1]), f"window_admit C={C}: extra")
        win_err = max(win_err, float((got[1] - plain[1]).abs().max()))
        win_ms.append((time_ms(torch, lambda: ops.window_admit(*wargs)),
                       time_ms(torch, lambda: ref.window_admit(*wargs)),
                       # live in and admission out per candidate, the size
                       # only of live ones; used, limit and extra per row
                       L * S * C * (1 + 1) + sector_bytes(torch, live, 4)
                       + L * S * (4 + 4 + 4),
                       device_us(torch, lambda: ops.window_admit(*wargs))))
    nbytes = sum(w[2] for w in win_ms)
    nb, kind = bound_ms(nbytes / 2, 0.0)
    results["window_admit"] = dict(
        max_abs_err=win_err,
        ms=sum(w[0] for w in win_ms) / 2,
        device_us=sum(w[3] for w in win_ms) / 2,
        plain_ms=sum(w[1] for w in win_ms) / 2,
        bound_ms=nb, bound_by=kind, library_ms=None)
    log(f"kernel window_admit: K={K} and W=4 windows bitwise")
    for name, r in results.items():
        log(f"  {name}: ms {r['ms']:.4f} device_us {r['device_us']:.1f} "
            f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    return results


def profile_phase(torch, grid, warm: int = 20, n: int = 40) -> dict:
    """Where a tick's time goes on the ``cuda`` path: after ``warm`` ticks,
    ``n`` ticks of the grid's loop timed on the host clock, then the next
    ``n`` under ``torch.profiler`` for device time by kernel; the idle
    share is the device's unused part of the unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.lane_tick import ops
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.sim.batched import _build_lane_sim, _lane_step_fns

    dev = torch.device("cuda")
    tick_fn, _ = _lane_step_fns(len(grid.site_names), grid.max_jobs_per_tick,
                                grid.n_months, resolve_tick_impl("cuda", dev))
    c, st = _build_lane_sim(grid, dev)
    times = torch.as_tensor(grid.times, device=dev)
    dts = torch.as_tensor(grid.dts, device=dev)
    month_idx = torch.as_tensor(grid.month_idx, device=dev)
    jobs = torch.as_tensor(grid.jobs_per_tick, device=dev)

    def run(t0, t1):
        for t in range(t0, t1):
            tick_fn(st, times[t], dts[t], month_idx[t], t, jobs[:, t], c)

    run(0, warm)
    torch.cuda.synchronize()
    # the same number of ticks once without the profiler: its own host
    # cost would inflate the wall time and so the idle share
    t0 = time.perf_counter()
    run(warm, warm + n)
    torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    # the profiled ticks keep each GCS admission's candidate plane and
    # mask (references only: no device work added), counted afterwards
    seen = []
    gcs_admit = ops.gcs_admit

    def keeping(want, *args, **kw):
        out = gcs_admit(want, *args, **kw)
        seen.append((want, out[0]))
        return out

    def run_keeping(t0, t1):
        ops.gcs_admit = keeping
        try:
            run(t0, t1)
        finally:
            ops.gcs_admit = gcs_admit
        torch.cuda.synchronize()

    def counts(n_ticks):
        """Mean and max GCS candidates and admissions per lane per tick
        over the kept ticks (then dropped)."""
        check(len(seen) == n_ticks, f"profile: {len(seen)} GCS admissions "
                                    f"in {n_ticks} ticks")
        cand = torch.stack([w.sum((1, 2)) for w, _ in seen]).float()
        adm = torch.stack([a.sum((1, 2)) for _, a in seen]).float()
        seen.clear()
        return (f"mean {float(cand.mean()):.2f} max {int(cand.max())}; "
                f"admissions: mean {float(adm.mean()):.2f} max "
                f"{int(adm.max())}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_keeping(warm + n, warm + 2 * n)
        prof_wall_us = 1e6 * (time.perf_counter() - t0)
    profiled = counts(n)
    # device-side events only (the operators that launched them carry the
    # same time again)
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    ours_us = sum(r[1] for r in rows
                  if any(k in r[0] for k in ("tt_", "ga_", "wa_kernel")))
    log(f"profile ({n} ticks after {warm + n}): wall {wall_us / n:.1f} "
        f"us/tick unprofiled ({prof_wall_us / n:.1f} profiled), device busy "
        f"{busy_us / n:.1f} us/tick (idle share "
        f"{1 - busy_us / wall_us:.3f}), lane-tick kernels "
        f"{ours_us / n:.1f} us/tick, {len(rows)} device kernels by name")
    for key, us, count in rows[:12]:
        log(f"  {us / n:9.1f} us/tick {count // n:4d}/tick  {key[:90]}")
    # torch.cumsum by its operator: calls and the device time under them
    cumsum = [e for e in prof.key_averages() if e.key == "aten::cumsum"]
    cs_calls = sum(e.count for e in cumsum)
    cs_us = sum(e.device_time_total for e in cumsum)
    log(f"  torch.cumsum: {cs_calls / n:.1f} calls/tick, {cs_us / n:.1f} "
        f"us/tick of device time")
    log(f"  GCS candidates per lane per tick, ticks {warm + n}-"
        f"{warm + 2 * n} (the profiled ones, counted after them): "
        f"{profiled}")
    # the same counts half-way through the horizon, where jobs have
    # finished and files lose their last consumer
    mid = max(warm + 2 * n, grid.n_ticks // 2)
    if mid + n <= grid.n_ticks:
        run(warm + 2 * n, mid)
        run_keeping(mid, mid + n)
        log(f"  GCS candidates per lane per tick, ticks {mid}-{mid + n}: "
            f"{counts(n)}")


def carousel_phase(torch, n: int = 1_000_000, n_ticks: int = 1000):
    """The carousel tick engine's path: ``carousel_tick`` over ``n``
    transfers, every file of one site's catalogue in flight, on 6 links
    (Config III's 2 sites x 3 link types) and on 512 (the Pallas design's
    ceiling), half of them shared and half per-transfer, dt = 10 s; then
    ``simulate_ticks`` for ``n_ticks`` ticks on 6 links through the kernel.
    Bars: ``new_done``/``completed`` bitwise and counts exact against the
    plain version; the tick engine's final state bitwise and its per-tick
    completions equal to the plain engine's. Returns one (case, launches,
    result) per link count; the 6-link case's launches include the
    engine's ticks."""
    from repro_torch.kernels.carousel_update import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4101)

    def inputs(m):
        link_id = torch.randint(0, m, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        total = 1e6 + 1e9 * torch.rand(n, generator=gen, device=dev)
        done = total * torch.rand(n, generator=gen, device=dev)
        mode = (torch.arange(m, device=dev) % 2).to(torch.int32)
        # a transfer's own rate, 10 kB/s to 1 MB/s (log-uniform), so that
        # completions spread over the ticks; a shared link carries as much
        # per transfer while it is full
        bw = 10.0 ** (4.0 + 2.0 * torch.rand(m, generator=gen, device=dev))
        bw = torch.where(mode == 0, bw * (n / m), bw)
        return link_id, active, done, total, bw, mode

    cases = {m: inputs(m) for m in (6, 512)}
    dt = 10.0
    ops.reset_launch_counts()
    got, launches = {}, {}
    for m, a in cases.items():
        before = ops.launch_counts()["carousel_tick"]
        got[m] = ops.carousel_tick(*a, dt)
        launches[m] = ops.launch_counts()["carousel_tick"] - before
    before = ops.launch_counts()["carousel_tick"]
    t0 = time.perf_counter()
    sim_k = ops.simulate_ticks(*cases[6], dt, n_ticks, tick_impl="cuda",
                               device=dev)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    n_sim = ops.launch_counts()["carousel_tick"] - before
    check(n_sim == n_ticks and set(launches.values()) == {1},
          f"carousel_tick: {launches} launches per case and {n_sim} in "
          f"{n_ticks} ticks")
    launches[6] += n_sim

    t0 = time.perf_counter()
    sim_p = ops.simulate_ticks(*cases[6], dt, n_ticks, tick_impl="torch",
                               device=dev)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    check(torch.equal(sim_k[0], sim_p[0]), "simulate_ticks: active differs")
    check(torch.equal(sim_k[1], sim_p[1]), "simulate_ticks: done differs")
    check(torch.equal(sim_k[2], sim_p[2]),
          "simulate_ticks: completions differ")
    n_done = int(sim_k[2].sum())
    check(0 < n_done < n, f"simulate_ticks: {n_done} completions")
    log(f"carousel simulate_ticks: {n_ticks} ticks of {n} transfers on 6 "
        f"links, final state bitwise, {n_done} completions equal per tick; "
        f"kernel {n_ticks / wall_k:.1f} ticks/s, plain "
        f"{n_ticks / wall_p:.1f} ticks/s")

    per_case = []
    for m, args in cases.items():
        label = f"N=1M M={m}" + (f" + simulate_ticks {n_ticks} ticks"
                                 if m == 6 else "")
        want = ref.carousel_tick(*args, dt)
        torch.cuda.synchronize()
        for g, w, name in zip(got[m], want, ("new_done", "completed",
                                             "counts")):
            check(torch.equal(g, w), f"carousel_tick M={m}: {name} not "
                                     f"bitwise")
        n_comp = int(got[m][1].sum())
        check(0 < n_comp < n, f"carousel_tick M={m}: {n_comp} completions")
        # needed: link id, active, done and total in, new_done and the
        # completion flag out (18 B a transfer); bw, mode and counts per link
        nb, kind = bound_ms(18 * n + 12 * m, 5 * n)
        r = dict(max_abs_err=float((got[m][0] - want[0]).abs().max()),
                 ms=time_ms(torch, lambda: ops.carousel_tick(
                     *args, dt, tick_impl="cuda")),
                 plain_ms=time_ms(torch, lambda: ref.carousel_tick(*args,
                                                                   dt)),
                 bound_ms=nb, bound_by=kind, library_ms=None)
        per_case.append((label, launches[m], r))
        dev_us = device_us(torch, lambda: ops.carousel_tick(
            *args, dt, tick_impl="cuda"))
        log(f"carousel_tick M={m}: new_done/completed bitwise, counts exact, "
            f"{n_comp} completions; ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} bound_ms {nb:.4f} ({kind}); device time "
            f"{dev_us:.1f} us per call (profiler: memset and both kernels)")
    return per_case


#: Attention cases: (label, B, nh, nkv, hd, T = S, dtype, causal, window).
#: Published widths, and hd 168: what ``repro``'s gemma3_27b config derives
#: (5376/32; the published head_dim is 128), kept as a width that is not a
#: power of two, with two query heads per kv head.
ATTENTION_CASES = (
    ("qwen3_4b", 1, 32, 8, 128, 4096, "bfloat16", True, 0),
    ("gemma3_27b local", 1, 32, 16, 128, 4096, "bfloat16", True, 1024),
    ("hd168 bf16", 1, 32, 16, 168, 4096, "bfloat16", True, 1024),
    ("hd168 f32", 1, 32, 16, 168, 2048, "float32", True, 1024),
    ("hymba_1_5b f32", 1, 25, 5, 64, 2048, "float32", True, 1024),
)

#: (atol, rtol) against the plain version. Both sides compute in float32
#: and round the output once, so in bfloat16 they may differ by one ulp
#: (at most 2**-7 of the value), and only where the float32 value sits
#: next to a rounding boundary: at most ``BF16_UNEQUAL_SHARE`` of the
#: elements may differ at all. SDPA, which rounds its probabilities to
#: bfloat16, stays within the ulp but differs on about 40% of them.
ATTENTION_BARS = {"bfloat16": (4e-3, 8e-3), "float32": (2e-5, 2e-5)}
BF16_UNEQUAL_SHARE = 0.01


def unmasked_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep: each costs 4*hd flops."""
    total = 0
    for t in range(T):
        lo = max(0, t - window + 1) if window > 0 else 0
        hi = min(S - 1, t) if causal else S - 1
        total += max(0, hi - lo + 1)
    return total


def attention_phase(torch):
    """The attention path: ``flash_attention`` once per case of
    ``ATTENTION_CASES`` through the kernel, then each result against the
    plain version on the same inputs at ``ATTENTION_BARS``, and the times
    of the kernel, the plain version and PyTorch's
    ``scaled_dot_product_attention`` (the yardstick; the port never calls
    it). Returns one (case, launches, result) per case."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    # the plain version's products in full float32, as the kernel's
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2604)
    inputs = []
    for label, B, nh, nkv, hd, T, dt_name, causal, window in ATTENTION_CASES:
        dtype = getattr(torch, dt_name)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((B, nh, T, hd), (B, nkv, T, hd),
                                 (B, nkv, T, hd)))
        inputs.append((q, k, v, dict(causal=causal, window=window)))
    ops.reset_launch_counts()
    outs, launches, routes = [], [], []
    for q, k, v, kw in inputs:
        route = ops._route(q.dtype, q.shape[-1])
        before = ops.launch_counts()
        outs.append(ops.flash_attention(q, k, v, **kw))
        after = ops.launch_counts()
        launches.append(after["flash_attention"] - before["flash_attention"])
        key = f"flash_attention_{route}"
        check(after[key] - before[key] == 1,
              f"flash_attention: the {route} kernel launched "
              f"{after[key] - before[key]} times for one call")
        routes.append(route)
    torch.cuda.synchronize()
    check(launches == [1] * len(inputs),
          f"flash_attention: {launches} launches per case")

    per_case = []
    for case, (q, k, v, kw), out, n_launch, route in zip(
            ATTENTION_CASES, inputs, outs, launches, routes):
        label, B, nh, nkv, hd, T, dt_name, causal, window = case
        want = ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check(out.dtype == q.dtype and out.shape == q.shape,
              f"attention {label}: output {out.dtype} {tuple(out.shape)}")
        atol, rtol = ATTENTION_BARS[dt_name]
        err = (out.float() - want.float()).abs()
        bad = n_outside(out, want, atol, rtol)
        check(bad == 0, f"attention {label}: {bad} elements outside atol "
                        f"{atol} rtol {rtol}, max abs err {float(err.max())}")
        rel = (torch.arange(T, device=dev)[:, None]
               - torch.arange(T, device=dev)[None, :])
        mask = rel >= 0 if causal else torch.ones_like(rel, dtype=bool)
        if window > 0:
            mask &= rel < window
        gqa = {"enable_gqa": True} if nkv != nh else {}
        if causal and window == 0:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, **gqa)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, **gqa)
        lib_out = lib()
        lib_err = float((lib_out.float() - want.float()).abs().max())
        lib_bad = n_outside(lib_out, want, atol, rtol)
        # elements not equal to the plain version at all: the kernel differs
        # only where its float32 value sits next to an output rounding
        # boundary, SDPA also where its low-precision products move it
        ne, lib_ne = int((out != want).sum()), int((lib_out != want).sum())
        del lib_out
        check(dt_name != "bfloat16" or ne <= BF16_UNEQUAL_SHARE * out.numel(),
              f"attention {label}: {ne} of {out.numel()} elements differ "
              f"from the plain version")
        pairs = B * nh * unmasked_pairs(T, T, causal, window)
        n_bytes = out.element_size() * (2 * q.numel() + 2 * k.numel())
        rate = BF16_OPS_PER_S if dt_name == "bfloat16" else F32_OPS_PER_S
        nb, kind = bound_ms(n_bytes, 4 * hd * pairs, rate)
        r = dict(max_abs_err=float(err.max()),
                 ms=time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                            n=10),
                 plain_ms=time_ms(torch, lambda: ref.attention(q, k, v, **kw),
                                  n=5),
                 bound_ms=nb, bound_by=kind,
                 library_ms=time_ms(torch, lib, n=10),
                 variant=route, source=ATTENTION_SOURCE[route])
        per_case.append((f"{label} (nh {nh} nkv {nkv} hd {hd} T=S {T} "
                         f"{dt_name} window {window})", n_launch, r))
        log(f"attention {label} (B={B} nh={nh} nkv={nkv} hd={hd} T=S={T} "
            f"{dt_name} causal={causal} window={window}, {route} kernel): "
            f"max abs err "
            f"{r['max_abs_err']:.3g} (bar atol {atol} rtol {rtol}; SDPA's "
            f"{lib_err:.3g}, {lib_bad} of {out.numel()} elements outside "
            f"the bar); elements not equal to the plain version: kernel "
            f"{ne}, SDPA {lib_ne}; ms "
            f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']:.4f} bound_ms {nb:.4f} ({kind}, "
            f"{4 * hd * pairs / 1e9:.2f} GFLOP)")
        del want
    return per_case


def mamba_phase(torch, B: int = 1, T: int = 2048, D: int = 8192,
                N: int = 16):
    """The selective-scan path at falcon_mamba_7b's widths (d_inner 8192,
    state 16; T = 2048): ``mamba_scan`` once through the kernel, held
    against the plain version at 1e-4 atol/rtol. Returns one (case,
    launches, result)."""
    from repro_torch.kernels.mamba_scan import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7007)
    dA = torch.rand((B, T, D, N), generator=gen, device=dev).neg_().exp_()
    dBu = torch.randn((B, T, D, N), generator=gen, device=dev).mul_(0.1)
    C = torch.randn((B, T, N), generator=gen, device=dev)
    ops.reset_launch_counts()
    y = ops.mamba_scan(dA, dBu, C)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["mamba_scan"]
    check(launches == 1, f"mamba_scan: {launches} launches on its path")
    want = ref.mamba_scan(dA, dBu, C)
    torch.cuda.synchronize()
    check(tuple(y.shape) == (B, T, D) and bool(torch.isfinite(y).all()),
          "mamba_scan: output shape or finiteness")
    err = (y - want).abs()
    bad = int((err > 1e-4 + 1e-4 * want.abs()).sum())
    check(bad == 0, f"mamba_scan: {bad} elements outside 1e-4 atol/rtol, "
                    f"max abs err {float(err.max())}")
    # dA and dBu read once, C read once, y written once; 4 flops per state
    # and step (multiply, add, multiply by C, sum)
    n_bytes = 4 * (2 * dA.numel() + C.numel() + y.numel())
    nb, kind = bound_ms(n_bytes, 4 * dA.numel())
    r = dict(max_abs_err=float(err.max()),
             ms=time_ms(torch, lambda: ops.mamba_scan(dA, dBu, C), n=10),
             plain_ms=time_ms(torch, lambda: ref.mamba_scan(dA, dBu, C),
                              n=2, warm=1),
             bound_ms=nb, bound_by=kind, library_ms=None)
    log(f"mamba_scan (B={B} T={T} D={D} N={N}, dA/dBu "
        f"{dA.numel() * 4 / 1e9:.2f} GB each): max abs err "
        f"{r['max_abs_err']:.3g} (bar 1e-4); ms {r['ms']:.4f} plain_ms "
        f"{r['plain_ms']:.4f} bound_ms {nb:.4f} ({kind}, "
        f"{n_bytes / 1e9:.3f} GB)")
    return [(f"falcon_mamba_7b (B {B} T {T} D {D} N {N})", launches, r)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--days", type=float, default=1.0,
                    help="simulated horizon of the sweep phase (default 1)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available: this run needs a GPU")
    try:
        from repro_torch.core.scenarios import pack_specs
        from repro_torch.kernels import _build
        from repro_torch.kernels.lane_tick import ops
        from repro_torch.sim.batched import run_sweep_torch
    except ImportError as e:
        raise SmokeFailure(f"the port is not importable beside this script "
                           f"({e})") from None

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for lib in secs:
        for kname, u in _build.ptxas_usage(lib).items():
            log(f"  ptxas {lib}/{kname}: {u.get('registers')} registers, "
                f"spill {u.get('spill_stores')}/{u.get('spill_loads')} B "
                f"stores/loads")
        for w in _build.ptxas_warnings(lib):
            log(f"  ptxas {lib}: {w}")

    days, n_files = args.days, 1_000_000
    specs = pricing_specs(days, n_files)
    t0 = time.perf_counter()
    grid = pack_specs(specs, tick=10.0)
    log(f"pack: {time.perf_counter() - t0:.1f} s; {grid.n_specs} specs, "
        f"{grid.n_lanes} lanes, {len(grid.site_names)} sites x {n_files} "
        f"files, K={grid.max_jobs_per_tick}, T={grid.n_ticks} ticks")
    kern = kernel_phase(torch, grid, grid.n_lanes)

    # -- small reference: CPU plain path against the card's kernels
    small = pricing_specs(0.1, 1000)
    cpu = run_sweep_torch(small, tick=60.0, tick_impl="torch", device="cpu")
    gpu = run_sweep_torch(small, tick=60.0, tick_impl="cuda", device="cuda")
    log(f"small reference: {lane_parity(cpu, gpu)} specs within the "
        f"Table-2 bar (CPU plain vs card kernels)")

    # -- sweep phase (the main path)
    log(f"sweep: horizon cut from the paper's 90 days to {days:g} days "
        f"({grid.n_ticks} ticks of 10 s); catalogue {n_files} files/site")
    runs = {}
    counts = None
    for impl in ("cuda", "torch"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_sweep_torch(specs, tick=10.0, tick_impl=impl,
                              device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if impl == "cuda":
            counts = ops.launch_counts()
        runs[impl] = res
        log(f"sweep {impl}: {wall:.2f} s wall, {grid.n_ticks / wall:.1f} "
            f"ticks/s, {len(res) / wall:.2f} configs/s, launches "
            f"{ops.launch_counts()}")
    for name in ops.KERNELS:
        check(counts[name] > 0, f"{name} was not launched on the main path")
    n_ok = lane_parity(runs["torch"], runs["cuda"])
    log(f"sweep parity: {n_ok} specs within the Table-2 bar, jobs "
        f"submitted equal")
    profile_phase(torch, grid)

    # one entry per kernel and case: the lane-tick kernels at the sweep's
    # shapes with their launches on the sweep, then the three further
    # kernel paths, each driven with its count reset just before and read
    # just after each case
    shapes = (f"sweep shapes (L {grid.n_lanes}, S {len(grid.site_names)}, "
              f"F {n_files})")
    cases = [(name, shapes + (", mean of the K and W=4 windows"
                              if name == "window_admit" else ""),
              counts[name], kern[name]) for name in ops.KERNELS]
    for name, phase in (("carousel_tick", carousel_phase),
                        ("flash_attention", attention_phase),
                        ("mamba_scan", mamba_phase)):
        cases += [(name, *c) for c in phase(torch)]

    kernels = [dict(name=name, case=case, route="cuda",
                    source=r.get("source", KERNEL_SOURCE[name]),
                    replaces=REPLACES[name], launches=n,
                    **{k: r[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")},
                    **{k: r[k] for k in (
                        "variant", "device_us", "bound_ms_without_rank")
                       if k in r})
               for name, case, n, r in cases]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} ({k['case']}) was not "
                                 f"launched on its path")
    check({k["name"] for k in kernels} == set(KERNEL_SOURCE),
          "the kernels line misses a kernel")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
