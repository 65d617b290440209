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
   files; both candidate windows of a tick, the grid's K and W = 4, in
   one launch, some heads stale because a K slot started their file,
   also timed replayed from a CUDA graph of 20 calls), with a
   finite-limit GCS admission
   case whose every admission difference must be a tie within 16 ulps
   of the limit and whose migration rank must be bitwise the plain one,
   a dense unlimited case, and the dense candidates (share 0.3) under
   finite limits, held to the same tie bar; prints the differences, the
   kernel's and the plain version's milliseconds (CUDA events, after
   warm-up), the kernel's device time (``torch.profiler``) and the bound:
   the bytes the function needs at these inputs (dense planes once,
   sparse reads by the 32-byte sectors they touch) over the memory rate
   (for ``gcs_admit`` also the bound of the function without its rank
   plane);
   then the tick-glue kernels (``kernels.tick_glue``: ``glue_begin``,
   ``glue_complete``, ``glue_link_admit``, ``glue_migrate``,
   ``glue_wait_select``): the sweep
   grid's ``cuda`` tick with them, captured and replayed, against the
   same tick with the plain glue (eager, the same lane-tick kernels),
   every state tensor bitwise after 600 ticks and after 200 more (at
   most half the horizon, and the rest of it); on the fused loop's state
   at tick 600 and on a dense synthetic state (about
   0.3 of the planes completing, queued, migrating and waiting) each glue
   kernel against its plain version, every state tensor and output
   (``disk_used``, the wait-queue heads) bitwise after each step, with
   its milliseconds (CUDA events around each call,
   its state restored before it), device microseconds (profiler), the
   plain version's milliseconds and the bound of the bytes it needs;
   ``torch.topk`` of the wait tickets timed beside ``glue_wait_select``
   (its library call), and a copy of ``glue_complete``'s bytes (what the
   card streams at that size) beside ``glue_complete``;
4. small reference: a 1,000-file grid on the CPU's plain path against the
   card's kernel path, at the Table-2 5% bar;
5. sweep phase: the 216-config pricing grid (Config III; cache 10/20/40/80
   TB; 3 egress options; 9 storage prices; 2 seeds; 8 dynamics lanes) at
   the paper's full catalogue of 1,000,000 files per site through
   ``run_sweep_torch`` once with ``tick_impl="cuda"`` (the tick replayed
   from a CUDA graph) and once with ``"torch"`` on the card; per-spec
   agreement at the Table-2 5% bar, equal jobs submitted, and each kernel
   (the three lane-tick and the five glue kernels) launched once a tick
   on the ``cuda`` run, replays counted; then
   ``simulate_packed`` on the packed grid with the ``cuda`` tick eager
   and replayed, every output bitwise equal;
6. profile, for the eager and the replayed ``cuda`` tick
   (``sim.batched.TickLoop``): 40 ticks on the host clock, 40 more under
   ``torch.profiler`` — wall and device time per tick, the device's idle
   share, the top kernels, the lane-tick and each glue kernel's device
   time per tick, ``torch.cumsum``'s calls and device time per tick,
   ``torch.topk``'s kernels (none: the run fails on any) and PyTorch's
   reductions per tick; for
   the replayed tick the capture's host time and the graph
   pool's bytes; for the eager one the GCS candidates and admissions per
   lane per tick of the profiled ticks (counted after them) and of 40
   ticks half-way through the horizon;
7. decide phase, the §5.3 decision workflow through the port's front door
   (``sim.decide.decide`` on ``sim.sweep.SweepDriver(backend="torch",
   tick=10.0, tick_impl="cuda", device="cuda", cache=<dir>)``, the cache
   in a fresh directory under ``build/``): the pricing grid's axes (2
   seeds) at the sweep's horizon and catalogue, ``max_rounds=2``, cold
   (each lane-tick and glue kernel launched, counts reset just before;
   device memory back within half a graph pool of where it was, so each
   sweep call's pool is released), then warm with a fresh driver on the
   same cache (0 lanes simulated, the report equal outside its stats);
   then a small grid (2 caches x 2 egress x 2 prices x 2 seeds, 20,000
   files, 0.25 days, tick 60 s) on the kernels and on the plain
   ``torch`` path with one cache directory (their keys differ): equal
   decisions (the chosen
   point, the frontier's labels, the trimmed cache TB, the break-even
   bracket, the claim) and every point's jobs and cost, and the displaced
   TB, within the Table-2 bar (both reports printed where not); prints
   ``claim_holds``, ``refine.lane_fraction`` and
   ``displaced_disk.displaced_tb``, per sweep call the specs, lanes, pack
   s, ``TickLoop.capture_s``, graph pool bytes, sweep s and ticks/s (the
   ``sweep.torch`` trace events), and the phase's wall s;
8. carousel phase: ``carousel_tick`` over 1,000,000 transfers (one site's
   catalogue, every file in flight) on 6 links (Config III's 2 sites x 3
   link types) and on 512, half shared and half per-transfer, dt = 10 s,
   then ``simulate_ticks`` for 1,000 ticks on 6 links through the tick
   engine (one count, then one kernel launch a tick on carried link
   counts, replayed from CUDA graphs) and through the plain loop:
   ``new_done``/``completed`` bitwise, counts exact, the engine's final
   state bitwise and its completions equal; ticks/s of both, the engine's
   with its capture and without, its launches a tick (replays counted),
   and over 128 steady ticks its wall and device microseconds a tick
   (``torch.profiler``), idle share and bound;
9. attention phase: ``flash_attention`` at qwen3_4b widths (nh 32, nkv 8,
   hd 128, T = S = 4096, bf16, causal), gemma3_27b's local layers (nh 32,
   nkv 16, published head_dim 128, T = S = 4096, bf16, causal, window
   1024), the same at hd 168 (the width ``repro``'s gemma3_27b config
   derives as 5376/32 — not the published head_dim — kept as a width that
   is not a power of two) in bf16 and in float32 (T = S = 2048), and
   hymba_1_5b in float32 (nh 25, nkv 5, hd 64, T = S = 2048, causal,
   window 1024), and bf16 at hd 100 (nh 32, nkv 16, T = S = 2048,
   causal, window 1024), a width that is not a multiple of 8; the bf16
   cases at a multiple of 8 through the ``wgmma`` tensor-core kernel, hd
   100 through the SIMT one, the float32 ones through the ``tf32x3`` one
   (each product in three TF32 terms of split operands), each case
   checked to launch its route's kernel exactly once; each against the
   plain version at atol 4e-3 / rtol 8e-3 in bf16 (one bf16 ulp, and at
   most 1% of the elements unequal) or 2e-5 in float32, with PyTorch's
   ``scaled_dot_product_attention`` timed beside it as the yardstick
   (never on the port's path), its elements outside the same bar and
   each side's elements not equal to the plain version counted; each
   case's device time from 10 calls replayed in one CUDA graph
   (``graph_ms``), and from ``torch.profiler`` (``device_us``; ``None``,
   "not measured", where its reading is more than 5% off the graph's, as
   when it records too few kernels or none); a float32 case's bound is
   12*hd flops per unmasked pair at dense TF32's 495 TFLOP/s (the split
   design's own least time), printed beside the SIMT ceiling, 4*hd flops
   at 67 TFLOP/s (``bound_ms_simt``);
10. Mamba phase: ``mamba_scan`` at falcon_mamba_7b widths (B 1, T 2048,
    d_inner 8192, state 16; dA and dBu 1.07 GB each) against the plain
    version at 1e-4 atol/rtol;
11. the ``kernels`` JSON line: one entry per kernel and case (``case``
    names it), each with its launches on its own path (counts reset just
    before the path runs, read just after each case; the lane-tick and
    glue entries also with ``launches_decide``, their launches in the
    cold decide run); the glue kernels,
    which replace no Pallas kernel, name the lines of ``repro``'s tick
    that XLA fuses as what they replace; attention entries
    also name their route (``variant``: ``wgmma``, ``simt`` or
    ``tf32x3``, each at least once) and that kernel's source; then the
    ``ok`` line.

Phases 3, 8, 9 and 10 print the kernel's and the plain version's
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
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM data sheet: device-memory bandwidth, float32 peak outside the
#: tensor cores and dense bf16 and TF32 tensor-core peaks, the rates the
#: bounds are computed against.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12

TOL = 0.05  # Table 2 validation tolerance (fractional)
_LANE_TICK = "src/repro_torch/kernels/lane_tick/csrc/lane_tick.cu"
_CAROUSEL = "src/repro_torch/kernels/carousel_update/csrc/carousel_update.cu"
_TICK_GLUE = "src/repro_torch/kernels/tick_glue/csrc/tick_glue.cu"
KERNEL_SOURCE = {
    "transfer_tick": _LANE_TICK,
    "gcs_admit": _LANE_TICK,
    "window_admit": _LANE_TICK,
    "glue_begin": _TICK_GLUE,
    "glue_complete": _TICK_GLUE,
    "glue_link_admit": _TICK_GLUE,
    "glue_migrate": _TICK_GLUE,
    "glue_wait_select": _TICK_GLUE,
    "carousel_tick": _CAROUSEL,
    "engine_count": _CAROUSEL,
    "engine_tick": _CAROUSEL,
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "mamba_scan": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
}
#: The attention kernel each route launches (``flash_attention.ops._route``:
#: float32 -> ``tf32x3``, bfloat16 at hd a multiple of 8 -> ``wgmma``, else
#: ``simt``).
ATTENTION_SOURCE = {
    "tf32x3": "src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_tf32x3.cu",
    "wgmma": "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_wgmma.cu",
    "simt": KERNEL_SOURCE["flash_attention"],
}
REPLACES = {
    "transfer_tick": "src/repro/kernels/lane_tick/lane_tick.py:81",
    "gcs_admit": "src/repro/kernels/lane_tick/lane_tick.py:194",
    "window_admit": "src/repro/kernels/lane_tick/lane_tick.py:292",
    # no Pallas kernel: XLA fuses these lines of the jitted tick
    "glue_begin": "src/repro/sim/batched.py:205-206 (XLA-fused)",
    "glue_complete": "src/repro/sim/batched.py:195,227-279,287,295-300,"
                     "332-333 (XLA-fused)",
    "glue_link_admit": "src/repro/sim/batched.py:280-286 (XLA-fused)",
    "glue_migrate": "src/repro/sim/batched.py:331,336-353 (XLA-fused)",
    "glue_wait_select": "src/repro/sim/batched.py:473-475 (jax.lax.top_k)",
    "carousel_tick":
        "src/repro/kernels/carousel_update/carousel_update.py:42",
    "engine_count":
        "src/repro/kernels/carousel_update/carousel_update.py:42",
    "engine_tick":
        "src/repro/kernels/carousel_update/carousel_update.py:58",
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


def graph_ms(torch, fn, n: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` with ``n`` calls captured in one
    CUDA graph and replayed (CUDA events around one replay, after a
    warm-up replay): the device's time for the calls without the host's
    Python between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def transfer_bound(torch, active, comp, n_months: int):
    """Bytes and operations ``transfer_tick`` needs at these inputs: the
    active flag, done and total in and new_done and the completion flag
    out for every file; the link id only of active transfers and the size
    only of completions (by the 32-byte sectors they touch); the per-link
    and per-lane vectors. Operations: a compare and a select per file, a
    rate, multiply, add and compare per active transfer, an add per
    completion."""
    L, S, _ = active.shape
    n = active.numel()
    need = (n * (1 + 4 + 4) + n * (4 + 1) + sector_bytes(torch, active, 4)
            + sector_bytes(torch, comp, 4) + L * 3 * S * 8
            + 3 * L * S * 4 + 3 * L * n_months * 4)
    return need, 2 * n + 4 * int(active.sum()) + int(comp.sum())


def gcs_tie_check(torch, want, sizes, used, limit, got, plain, n_passes,
                  ulps: int = 16):
    """Hold the kernel's GCS admission to the plain version's up to ties.

    Replays the plain passes (``ref.gcs_gate_distance``: the prefix and
    the gate in float64) and keeps, per candidate, the least distance of
    its gate value ``used + cumsum`` to the limit over the passes that
    still held it. A candidate the two admit differently must lie within
    ``ulps`` float32 ulps of a finite limit there: the kernel sums in
    another order than ``torch.cumsum``, and nothing else may differ.
    Returns the count of tied candidates and their bytes per lane."""
    from repro_torch.kernels.lane_tick import ref

    L = want.shape[0]
    sz = sizes.reshape(L, -1)
    adm, _, dist = ref.gcs_gate_distance(want, sizes, used, limit, n_passes)
    check(torch.equal(adm, plain.reshape(L, -1)),
          "gcs_admit: the replay of the plain passes disagrees with ref")
    diff = got.reshape(L, -1) != adm
    tol = torch.where(torch.isfinite(limit),
                      ulps * torch.finfo(torch.float32).eps
                      * limit.double().abs(),
                      torch.zeros_like(limit, dtype=torch.float64))
    bad = int((diff & ~(dist <= tol[:, None])).sum())
    check(bad == 0, f"gcs_admit: {bad} admission differences farther than "
                    f"{ulps} ulps from the limit")
    return int(diff.sum()), (sz * diff).sum(1)


def pricing_axes(days: float, n_files: int) -> dict:
    """The 216-config pricing grid's axes, seeds left out (2 of them)."""
    return {
        "base": "III",
        "cache_tb": [10.0, 20.0, 40.0, 80.0],
        "egress": ["internet", "direct", "interconnect"],
        "storage_price": [round(0.018 + 0.002 * i, 3) for i in range(9)],
        "days": days, "n_files": n_files,
    }


def pricing_specs(days: float, n_files: int):
    from repro_torch.core.scenarios import expand_grid, with_seeds

    specs = with_seeds(expand_grid(pricing_axes(days, n_files)), 2)
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
    need, n_ops = transfer_bound(torch, active, got[1], n_months)
    nb, kind = bound_ms(need, n_ops)
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
    # the same dense candidates under finite limits on half the lanes:
    # about 600k candidates a lane summed in two orders, each difference a
    # tie within 16 ulps of the limit
    dense_limit = torch.where(finite, used + 0.5 * (sizes * dense).sum(
        (1, 2)), inf_limit)
    dl = ops.gcs_admit(dense, sizes, used, dense_limit, dt, month, n_months)
    dlp = ref.gcs_admit(dense, sizes, used, dense_limit, dt, month,
                        n_months)
    torch.cuda.synchronize()
    dense_ties, _ = gcs_tie_check(torch, dense, sizes, used, dense_limit,
                                  dl[0], dlp[0], ref.GCS_ADMIT_PASSES)
    check(bool((dl[0] != dense)[finite].any()),
          "gcs_admit: the dense finite limit did not bind")
    del dl, dlp
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
        f"exact in {dense_ms:.4f} ms, dense case with finite limits on half "
        f"the lanes: {dense_ties} boundary ties (each within 16 ulps of the "
        f"limit), bound counts {(need + 4 * n) / 1e6:.2f}"
        f" MB ({need / 1e6:.2f} MB without the rank plane: bound "
        f"{nb_old:.4f} ms)")
    del want_m, dense, got, plain, dg, dp

    # -- window_admit: both candidate windows of a tick in one launch, the
    # K job window and the W = 4 wait-queue heads, some heads holding a
    # file of a K slot, against disk headroom that some candidates fill
    W = 4
    absent = rand(L, S, K) < 0.7
    size_k = sizes[:, :, :K].contiguous()
    fid_k = torch.randint(0, 64, (L, S, K), generator=gen, device=dev)
    valid_w = rand(L, S, W) < 0.8
    present_w = rand(L, S, W) < 0.2
    size_w = sizes[:, :, K:K + W].contiguous()
    idx_w = torch.where(rand(L, S, W) < 0.5,
                        fid_k[..., torch.arange(W, device=dev) % max(K, 1)],
                        torch.randint(64, F, (L, S, W), generator=gen,
                                      device=dev))
    limit_d = torch.full((L, S), 1e13, device=dev)
    used_d = limit_d - (size_k.sum(-1) + size_w.sum(-1)) * rand(L, S)
    wargs = (absent, size_k, fid_k, valid_w, present_w, size_w, idx_w,
             used_d, limit_d)
    before = ops.launch_counts()["window_admit"]
    got = ops.windows_admit(*wargs)
    check(ops.launch_counts()["window_admit"] == before + 1,
          "window_admit: not one launch for both windows")
    plain = ref.windows_admit(*wargs)
    torch.cuda.synchronize()
    for name, g, w in zip(("started", "admitted", "stale", "disk_used"),
                          got, plain):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"window_admit: {name} not bitwise")
    n_jump = int((plain[2] & ~present_w).sum())
    check(n_jump > 0 and bool(plain[0].any()) and bool(plain[1].any()),
          "window_admit: no started, admitted or jumped head exercised")
    live_w = valid_w & ~plain[2]
    # needed: the K and W masks in and out per slot (absent, started;
    # valid, present, stale, admitted), the size of absent slots and live
    # heads, the fid of started slots and the head index of valid heads
    # (by the sectors they touch); used, limit and used' per row
    need = (L * S * (2 * K + 4 * W) + sector_bytes(torch, absent, 4)
            + sector_bytes(torch, live_w, 4)
            + sector_bytes(torch, plain[0], 8)
            + sector_bytes(torch, valid_w, 8) + L * S * 12)
    nb, kind = bound_ms(need, 0.0)
    results["window_admit"] = dict(
        max_abs_err=float((got[3] - plain[3]).abs().max()),
        ms=time_ms(torch, lambda: ops.windows_admit(*wargs)),
        graph_ms=graph_ms(torch, lambda: ops.windows_admit(*wargs)),
        device_us=device_us(torch, lambda: ops.windows_admit(*wargs)),
        plain_ms=time_ms(torch, lambda: ref.windows_admit(*wargs)),
        bound_ms=nb, bound_by=kind, library_ms=None)
    log(f"kernel window_admit: K={K} and W={W} windows in one launch, "
        f"started/admitted/stale/disk_used bitwise, {n_jump} heads stale "
        f"because a K slot started their file; {need} bytes needed; "
        f"{results['window_admit']['graph_ms']:.4f} ms a call replayed "
        f"from a graph of 20 calls")
    for name, r in results.items():
        log(f"  {name}: ms {r['ms']:.4f} device_us {r['device_us']:.1f} "
            f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    return results


GLUE_STEPS = ("begin", "complete", "link_admit", "migrate", "wait_select")

#: Ticks of the sweep grid before the glue kernels are checked on its
#: state (the first ticks complete and migrate little), and the ticks
#: compared after it; both cut to fit a shorter horizon.
GLUE_STATE_TICK = 600
GLUE_WINDOW_TICKS = 200


@contextlib.contextmanager
def plain_glue():
    """The ``cuda`` tick with the plain glue (``tick_glue.ref``) in place
    of the glue kernels, the lane-tick kernels unchanged."""
    from repro_torch.kernels.tick_glue import ops, ref

    saved = {step: getattr(ops, step) for step in GLUE_STEPS}
    try:
        for step in GLUE_STEPS:
            setattr(ops, step, getattr(ref, step))
        yield
    finally:
        for step, fn in saved.items():
            setattr(ops, step, fn)


def same_state(torch, got, want, what: str) -> None:
    """Every tensor of two state dicts bitwise equal (floats by their
    bits)."""
    for key, w in want.items():
        g = got[key]
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"{what}: {key} not bitwise")


def restored_ms(torch, fn, restore, n: int = 10, warm: int = 2,
                key: str = None):
    """``fn``'s milliseconds per call by CUDA events recorded around each
    call, its state restored before each (``restore``, outside the
    events); with ``key``, also the device microseconds per call of the
    kernels whose name holds ``key`` (``torch.profiler`` over ``n`` more
    calls). Returns (ms, device_us or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pairs = []
    for i in range(warm + n):
        restore()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        if i >= warm:
            pairs.append((a, b))
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in pairs) / n
    if key is None:
        return ms, None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            restore()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and key in e.key) / n
    return ms, us


def glue_bytes(torch, pre, post, x, work_ints: int) -> dict:
    """Bytes each glue step needs at these inputs: the planes every
    element needs once (dense), the others by the 32-byte sectors that
    the step's masks touch, and the [L, 3S] vectors. ``pre`` and ``post``
    map each step to the state before and after it; ``x`` holds the
    tick's values (``now``, ``comp``, ``mig``, ``W``)."""
    from repro_torch.kernels.tick_glue.ref import ABSENT, PRESENT

    def sec(mask, itemsize):
        return sector_bytes(torch, mask, itemsize)

    st0 = pre["begin"]
    n = st0["tr_slot"].numel()
    R = st0["disk_used"].numel()
    out = {"begin": 2 * n + sec(st0["tr_slot"], 4) + 4 * work_ints}
    s, comp = pre["complete"], x["comp"]
    lt = torch.remainder(s["tr_link"], 3)
    inb, cm = comp & (lt != 2), comp & (lt == 2)
    no_cons = (s["pend_cnt"] == 0) & (s["fin_max"] <= x["now"])
    d1 = torch.where(inb, PRESENT, s["disk_state"])
    drop = cm & no_cons & (d1 == PRESENT)
    d2 = torch.where(drop, ABSENT, d1)
    cand = no_cons & (d2 == PRESENT) & x["limited"]
    dele = cand & (post["complete"]["disk_state"] == ABSENT)
    changed = post["complete"]["disk_state"] != s["disk_state"]
    out["complete"] = (
        23 * n + sec(s["tr_slot"] | comp, 4) + sec(comp, 1)
        + 2 * sec(comp, 4) + sec(cand, 4) + sec(cm, 4) + sec(cand, 1)
        + sec(drop | dele, 4) + sec(changed, 4) + 3 * sec(inb, 4)
        + sec(inb & (s["pend_cnt"] > 0), 4) + 5 * 4 * 3 * R + 8 * R)
    s, q = pre["link_admit"], pre["link_admit"]["lq_queued"]
    adm = q & ~post["link_admit"]["lq_queued"]
    out["link_admit"] = (n + 2 * sec(q, 4) + 2 * sec(adm, 1)
                         + sec(adm, 4) + 2 * 4 * 3 * R)
    s, m = pre["migrate"], x["mig"]
    queued = m & post["migrate"]["lq_queued"] & ~s["lq_queued"]
    direct = m & ~queued
    out["migrate"] = (n + 6 * sec(m, 4) + sec(direct, 1) + sec(direct, 4)
                      + sec(queued, 4) + sec(queued, 1) + 5 * 4 * 3 * R)
    # the wait flags dense, the ticket where a file waits; lowest and idx
    # out
    s = pre["wait_select"]
    out["wait_select"] = (n + sec(s["wq_wait"], 4)
                          + R * x["W"] * (4 + 8))
    return out


def glue_check(torch, label: str, st0, c, now, dt, month, n_months,
               tt=None, ga=None) -> dict:
    """One tick's glue from state ``st0`` through the kernels
    (``tick_glue.ops``) and the plain versions (``tick_glue.ref``) side by
    side, each step from the same state and inputs, every state tensor
    and output bitwise after each. The lane-tick kernels between the
    steps run once on the kernel side's values and feed both sides
    (``tt``: ``(new_done, comp)`` in place of ``transfer_tick``'s, ``ga``:
    ``(mig, rank)`` in place of ``gcs_admit``'s). Then each step is timed
    from its own state (restored before each call), the kernel and the
    plain version, beside the bound of the bytes it needs. Returns a
    result dict per step."""
    from repro_torch.kernels.lane_tick import ops as lt_ops
    from repro_torch.kernels.lane_tick.ref import GCS_ADMIT_PASSES
    from repro_torch.kernels.tick_glue import ops, ref
    from repro_torch.kernels.tick_glue.ref import BIG_TICKET
    from repro_torch.sim.batched import WAIT_ADMITS_PER_TICK as W

    def clone(s):
        return {k: v.clone() for k, v in s.items()}

    sizes = c["sizes"]
    k, p = clone(st0), clone(st0)
    pre, post, calls = {}, {}, {}
    x = {"now": now, "limited": c["limited"], "W": W}
    # begin
    pre["begin"] = clone(k)
    a_k, w_k = ops.begin(k, now, dt)
    a_p, w_p = ref.begin(p, now, dt)
    calls["begin"] = (lambda s, w: ops.begin(s, now, dt),
                      lambda s, w: ref.begin(s, now, dt))
    check(torch.equal(a_k, a_p), f"glue_begin ({label}): t_active")
    same_state(torch, k, p, f"glue_begin ({label})")
    post["begin"] = clone(k)
    if tt is None:
        tt = lt_ops.transfer_tick(k["tr_link"], a_k, k["tr_done"],
                                  k["tr_total"], sizes, c["bw"], c["mode"],
                                  dt, month, n_months)[:2]
    new_done, comp = tt
    x["comp"] = comp
    # complete
    pre["complete"] = clone(k)
    want_k, occ_k = ops.complete(k, c, now, new_done, comp, w_k)
    want_p, occ_p = ref.complete(p, c, now, new_done, comp, w_p)
    calls["complete"] = (
        lambda s, w: ops.complete(s, c, now, new_done, comp, w),
        lambda s, w: ref.complete(s, c, now, new_done, comp, w))
    check(torch.equal(want_k, want_p), f"glue_complete ({label}): want_mig")
    check(torch.equal(occ_k.view(torch.int32), occ_p.view(torch.int32)),
          f"glue_complete ({label}): occ3")
    same_state(torch, k, p, f"glue_complete ({label})")
    post["complete"] = clone(k)
    # link_admit
    pre["link_admit"] = clone(k)
    ops.link_admit(k, c, now, w_k)
    ref.link_admit(p, c, now, w_p)
    calls["link_admit"] = (lambda s, w: ops.link_admit(s, c, now, w),
                           lambda s, w: ref.link_admit(s, c, now, w))
    same_state(torch, k, p, f"glue_link_admit ({label})")
    post["link_admit"] = clone(k)
    if ga is None:
        ga = lt_ops.gcs_admit(want_k, sizes, k["gcs_used"], c["gcs_limit"],
                              dt, month, n_months, GCS_ADMIT_PASSES)
        ga = (ga[0], ga[3])
    mig, rank = ga
    x["mig"] = mig
    # migrate (occ3 is updated in place: each side its own copy)
    occ_k0 = occ_k.clone()
    pre["migrate"] = clone(k)
    ops.migrate(k, c, now, mig, rank, occ_k, w_k)
    ref.migrate(p, c, now, mig, rank, occ_p, w_p)
    occ_t = occ_k0.clone()
    calls["migrate"] = (
        lambda s, w: ops.migrate(s, c, now, mig, rank, occ_t, w),
        lambda s, w: ref.migrate(s, c, now, mig, rank, occ_t, w))
    check(torch.equal(occ_k.view(torch.int32), occ_p.view(torch.int32)),
          f"glue_migrate ({label}): occ3")
    same_state(torch, k, p, f"glue_migrate ({label})")
    post["migrate"] = clone(k)
    # wait_select (reads the wait queue, which no glue step writes)
    pre["wait_select"] = clone(k)
    sel_k = ops.wait_select(k, W, w_k)
    sel_p = ref.wait_select(p, W, w_p)
    calls["wait_select"] = (lambda s, w: ops.wait_select(s, W, w),
                            lambda s, w: ref.wait_select(s, W, w))
    for name, g, w in zip(("lowest", "idx"), sel_k, sel_p):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"glue_wait_select ({label}): {name} not bitwise")
    same_state(torch, k, p, f"glue_wait_select ({label})")
    post["wait_select"] = clone(k)
    need = glue_bytes(torch, pre, post, x, int(w_k.numel()))
    stats = dict(
        completions=int(comp.sum()), want_mig=int(want_k.sum()),
        admitted=int((pre["link_admit"]["lq_queued"]
                      & ~post["link_admit"]["lq_queued"]).sum()),
        migrations=int(mig.sum()),
        queued=int((post["migrate"]["lq_queued"]
                    & ~pre["migrate"]["lq_queued"]).sum()),
        waiting=int(k["wq_wait"].sum()),
        heads=int((sel_k[0] < BIG_TICKET).sum()))

    # timing: each step from its own state, restored before each call;
    # the kernels' work buffer zeroed as begin leaves it
    out = {}
    for step in GLUE_STEPS:
        s = clone(pre[step])
        w_kt = torch.zeros_like(w_k)
        w_pt = ref.begin(s, now, dt)[1]

        def restore(step=step, s=s, w=w_kt):
            for key, v in pre[step].items():
                s[key].copy_(v)
            w.zero_()
            if step == "migrate":
                occ_t.copy_(occ_k0)

        kern, plain = calls[step]
        ms, dev_us = restored_ms(torch, lambda: kern(s, w_kt), restore,
                                 key=f"tg_{step}_kernel")
        plain_ms, _ = restored_ms(torch, lambda: plain(s, w_pt), restore,
                                  n=5)
        nb, kind = bound_ms(need[step], 0.0)
        out[step] = dict(max_abs_err=0.0, ms=ms, device_us=dev_us,
                         plain_ms=plain_ms, bound_ms=nb, bound_by=kind,
                         library_ms=None, bytes=need[step])
    # the library call of the selection: torch.topk of the tickets, as
    # the tick took it before tg_wait_select (never on the port's path)
    s = pre["wait_select"]

    def topk():
        tickets = torch.where(s["wq_wait"], s["wq_ticket"], BIG_TICKET)
        return torch.topk(tickets, W, dim=-1, largest=False,
                          sorted=True)

    out["wait_select"]["library_ms"] = time_ms(torch, topk, n=10)
    out["wait_select"]["library_device_us"] = device_us(torch, topk, n=10)
    # what the card streams at tg_complete's bytes: a copy of half of
    # them (read once, written once), the dense floor beside its bound
    half = torch.empty(need["complete"] // 8, dtype=torch.float32,
                       device=sizes.device)
    dst = torch.empty_like(half)
    out["complete"]["copy_device_us"] = device_us(
        torch, lambda: dst.copy_(half), n=10)
    del half, dst
    log(f"glue kernels ({label}): every state tensor and output bitwise "
        f"after each step; {stats}; a copy of glue_complete's bytes "
        f"{out['complete']['copy_device_us']:.1f} us of device time; "
        f"torch.topk of the wait tickets {out['wait_select']['library_ms']:.4f}"
        f" ms, device {out['wait_select']['library_device_us']:.1f} us")
    for step, r in out.items():
        log(f"  glue_{step}: ms {r['ms']:.4f} device_us "
            f"{r['device_us']:.1f} plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}, {r['bytes'] / 1e6:.1f} "
            f"MB)")
    return out


def dense_glue_state(torch, st, c, now, share: float = 0.3):
    """A synthetic state at the sweep's shapes on the sweep's constants:
    about ``share`` of the planes completing, queued on a link and
    migrating, file states drawn from all three, half the files with
    pending jobs, busy link queues, about ``share`` of the files waiting
    in the wait queue. Returns ``(state, (new_done, comp), (mig,
    rank))``."""
    from repro_torch.kernels.lane_tick.ref import admission_rank

    dev = st["tr_slot"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(2020)
    L, S, F = st["tr_slot"].shape

    def rand():
        return torch.rand((L, S, F), generator=gen, device=dev)

    def ints(hi):
        return torch.randint(0, hi, (L, S, F), generator=gen, device=dev,
                             dtype=torch.int32)

    s = {k: v.clone() for k, v in st.items()}
    site = torch.arange(S, device=dev, dtype=torch.int32).view(1, S, 1)
    slot = rand() < 2 * share
    comp = slot & (rand() < 0.5)
    s["tr_slot"].copy_(slot)
    s["tr_link"].copy_(3 * site + ints(3))
    s["tr_total"].copy_(torch.where(slot, c["sizes"], float("inf")))
    s["tr_done"].copy_(torch.where(slot, c["sizes"] * rand(), 0.0))
    s["tr_start"].copy_(torch.where(slot, now - 30.0 * rand(),
                                    float("inf")))
    new_done = torch.where(comp, s["tr_total"], s["tr_done"])
    queued = ~slot & (rand() < share / (1 - 2 * share))
    s["lq_queued"].copy_(queued)
    busy = torch.rand(s["lq_next"].shape, generator=gen, device=dev) < 0.5
    s["lq_next"].copy_(s["lq_serve"] + torch.where(busy, 1000, 0))
    serve = torch.gather(s["lq_serve"].view(L, S, 3), -1,
                         (s["tr_link"] % 3).long())
    s["lq_ticket"].copy_(torch.where(queued, serve + ints(200) - 100, 0))
    s["disk_state"].copy_(ints(3))
    s["gcs_state"].copy_(ints(3))
    s["pend_cnt"].copy_(torch.where(rand() < 0.5, 0, ints(3) + 1))
    s["fin_max"].copy_(now + 100.0 * (rand() - 0.5))
    s["pend_tail"].copy_(1e3 * rand())
    mig = rand() < share
    s["wq_wait"].copy_(rand() < share)
    s["wq_ticket"].copy_(ints(1000))  # tied tickets: the index breaks ties
    return s, (new_done, comp), (mig, admission_rank(mig))


def glue_phase(torch, grid) -> dict:
    """The tick-glue kernels on the sweep grid. The ``cuda`` tick with the
    glue kernels, captured and replayed, and the same tick with the plain
    glue (eager, the same lane-tick kernels) run side by side: every
    state tensor bitwise after :data:`GLUE_STATE_TICK` ticks and after
    :data:`GLUE_WINDOW_TICKS` more (at most half the horizon, and the
    rest of it). On the fused loop's state at that tick, and on a dense
    synthetic state (:func:`dense_glue_state`), each glue kernel against
    its plain version (:func:`glue_check`). Returns the per-step results
    on the sweep's state and the tick of that state."""
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.sim.batched import TickLoop

    dev = torch.device("cuda")
    impl = resolve_tick_impl("cuda", dev)
    fused = TickLoop(grid, impl, dev, graph=True)
    plain = TickLoop(grid, impl, dev, graph=False)

    def advance_both(n):
        fused.advance(n)
        with plain_glue():
            plain.advance(n)
        torch.cuda.synchronize()
        same_state(torch, fused.st, plain.st,
                   f"fused against plain glue at tick {fused.t}")
        log(f"glue: the captured cuda tick with the glue kernels and the "
            f"eager one with the plain glue bitwise on all "
            f"{len(fused.st)} state tensors at tick {fused.t}")

    state_tick = min(GLUE_STATE_TICK, grid.n_ticks // 2)
    advance_both(state_tick)
    t = fused.st["tick"]
    c = fused.c
    now = c["times"].index_select(0, t).view(())
    dt = c["dts"].index_select(0, t).view(())
    month = c["month_idx"].index_select(0, t).view(())
    res = glue_check(torch, f"sweep state at tick {fused.t}", fused.st, c,
                     now, dt, month, grid.n_months)
    dense, tt, ga = dense_glue_state(torch, fused.st, c, now)
    glue_check(torch, "dense synthetic state, shares 0.3", dense, c, now,
               dt, month, grid.n_months, tt=tt, ga=ga)
    del dense, tt, ga
    advance_both(min(GLUE_WINDOW_TICKS, grid.n_ticks - state_tick))
    del fused, plain
    torch.cuda.empty_cache()
    return res, state_tick


def profile_phase(torch, grid, graph: bool, warm: int = 20,
                  n: int = 40) -> dict:
    """Where a tick's time goes on the ``cuda`` path, replayed from its
    CUDA graph (``graph``) or eager: after ``warm`` ticks, ``n`` ticks of
    the grid's loop (``sim.batched.TickLoop``, as ``simulate_packed``
    drives it) timed on the host clock, then the next ``n`` under
    ``torch.profiler`` for device time by kernel; the idle share is the
    device's unused part of the unprofiled wall time. Returns the wall and
    device-busy microseconds per tick (busy ``None`` when the profiler saw
    no kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.lane_tick import ops
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.sim.batched import TickLoop

    dev = torch.device("cuda")
    loop = TickLoop(grid, resolve_tick_impl("cuda", dev), dev, graph=graph)
    name = "captured" if graph else "eager"
    loop.advance(warm)
    torch.cuda.synchronize()
    # the same number of ticks once without the profiler: its own host
    # cost would inflate the wall time and so the idle share
    t0 = time.perf_counter()
    loop.advance(n)
    torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    # the eager ticks keep each GCS admission's candidate plane and mask
    # (references only: no device work added), counted afterwards; a
    # replayed tick runs no wrapper
    seen = []
    gcs_admit = ops.gcs_admit

    def keeping(want, *args, **kw):
        out = gcs_admit(want, *args, **kw)
        seen.append((want, out[0]))
        return out

    def run_keeping(n_ticks):
        ops.gcs_admit = keeping
        try:
            loop.advance(n_ticks)
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
        run_keeping(n)
        prof_wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only (the operators that launched them carry the
    # same time again)
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    ours_us = sum(r[1] for r in rows
                  if any(k in r[0] for k in ("tt_", "ga_", "wa_")))
    glue_us = {step: sum(r[1] for r in rows if f"tg_{step}_kernel" in r[0])
               for step in GLUE_STEPS}
    capture = (f"; capture {loop.capture_s * 1e3:.1f} ms, graph pool "
               f"{loop.pool_bytes} bytes" if graph else "")
    if not rows:
        log(f"profile {name} ({n} ticks after {warm + n}): wall "
            f"{wall_us / n:.1f} us/tick unprofiled ({prof_wall_us / n:.1f} "
            f"profiled); the profiler saw no kernel inside the replays"
            f"{capture}")
        return dict(wall_us=wall_us / n, busy_us=None)
    log(f"profile {name} ({n} ticks after {warm + n}): wall "
        f"{wall_us / n:.1f} us/tick unprofiled ({prof_wall_us / n:.1f} "
        f"profiled), device busy {busy_us / n:.1f} us/tick (idle share "
        f"{1 - busy_us / wall_us:.3f}), lane-tick kernels "
        f"{ours_us / n:.1f} us/tick, glue kernels "
        f"{sum(glue_us.values()) / n:.1f} us/tick ("
        + ", ".join(f"{k} {v / n:.1f}" for k, v in glue_us.items())
        + f"), {len(rows)} device kernels by name{capture}")
    for key, us, count in rows[:12]:
        log(f"  {us / n:9.1f} us/tick {count / n:6.1f}/tick  {key[:90]}")
    # torch.topk's kernels (gatherTopK, computeBlockDigitCounts, radix
    # select) and PyTorch's reductions (reduce_kernel), a tick
    topk = [r for r in rows if any(k in r[0].lower() for k in (
        "topk", "digitcount", "radix"))]
    reduce = [r for r in rows if "reduce_kernel" in r[0]]
    topk_us = sum(r[1] for r in topk) / n
    log(f"  torch.topk kernels: {len(topk)} names, {topk_us:.1f} us/tick; "
        f"PyTorch reductions (reduce_kernel): "
        f"{sum(r[2] for r in reduce) / n:.1f} launches/tick, "
        f"{sum(r[1] for r in reduce) / n:.1f} us/tick")
    # torch.cumsum by its operator: calls and the device time under them
    # (a replay runs no operator, so only the eager ticks show them)
    cumsum = [e for e in prof.key_averages() if e.key == "aten::cumsum"]
    cs_calls = sum(e.count for e in cumsum)
    cs_us = sum(e.device_time_total for e in cumsum)
    log(f"  torch.cumsum: {cs_calls / n:.1f} calls/tick, {cs_us / n:.1f} "
        f"us/tick of device time")
    if not graph:
        log(f"  GCS candidates per lane per tick, ticks {warm + n}-"
            f"{warm + 2 * n} (the profiled ones, counted after them): "
            f"{counts(n)}")
        # the same counts half-way through the horizon, where jobs have
        # finished and files lose their last consumer
        mid = max(warm + 2 * n, grid.n_ticks // 2)
        if mid + n <= grid.n_ticks:
            loop.advance(mid - loop.t)
            run_keeping(n)
            log(f"  GCS candidates per lane per tick, ticks {mid}-"
                f"{mid + n}: {counts(n)}")
    return dict(wall_us=wall_us / n, busy_us=busy_us / n, topk_us=topk_us,
                glue_us={k: v / n for k, v in glue_us.items()})


#: The decide phase's small grid, run on the kernels and on the plain path:
#: 2 caches x 2 egress options x 2 storage prices (x 2 seeds), at a 60 s
#: tick: the plain tick is host-bound here (61–152 ticks/s on an H100 80GB
#: HBM3 at 700 W, by the host's speed), so the 10 s tick's 2,161 ticks a
#: call cost 166–329 s a decide.
SMALL_DECIDE_AXES = {
    "base": "III", "cache_tb": [5.0, 20.0],
    "egress": ["internet", "direct"], "storage_price": [0.02, 0.026],
    "days": 0.25, "n_files": 20_000,
}
SMALL_DECIDE_TICK = 60.0


def decisions(doc: dict) -> dict:
    """What a decision report decides: the chosen point, the frontier's
    labels, the displaced cache TB and the break-even bracket."""
    b = doc["break_even"]
    return {"chosen": doc["chosen"] and doc["chosen"]["label"],
            "frontier": [p["label"] for p in doc["frontier"]],
            "min_cache_tb": doc["displaced_disk"]["min_cache_tb"],
            "break_even": b and b["bracket"],
            "claim_holds": doc["claim_holds"]}


def points_beyond_bar(a: dict, b: dict) -> list:
    """What of two reports differs beyond the Table-2 bar: the points'
    (baseline, chosen, frontier) jobs and cloud cost, and the displaced
    on-prem TB."""
    def close(x, y, floor=1.0):
        if x is None or y is None:
            return x is y
        return abs(x - y) <= TOL * max(abs(x), abs(y), floor)

    rows = [(a["baseline"], b["baseline"])]
    if a["chosen"] and b["chosen"]:
        rows.append((a["chosen"], b["chosen"]))
    rows += list(zip(a["frontier"], b["frontier"]))
    off = [p["label"] for p, q in rows
           if not (close(p["jobs_mean"], q["jobs_mean"])
                   and close(p["cost_usd_mean"], q["cost_usd_mean"]))]
    if not close(a["displaced_disk"]["displaced_tb"],
                 b["displaced_disk"]["displaced_tb"]):
        off.append("displaced_disk.displaced_tb")
    return off


def run_decide(torch, axes: dict, tick_impl: str, cache, tick: float = 10.0,
               **kw):
    """``decide(axes, SweepDriver(backend="torch", ...))`` on the card
    with the tracer on; returns the report, the driver, the per-call
    ``sweep.torch`` records and the wall seconds."""
    from repro_torch.obs.trace import get_tracer
    from repro_torch.sim.decide import decide
    from repro_torch.sim.sweep import SweepDriver

    tracer = get_tracer()
    tracer.reset()
    tracer.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv = SweepDriver(backend="torch", tick=tick, tick_impl=tick_impl,
                          device="cuda", cache=cache)
        report = decide(axes, drv, **kw)
        wall = time.perf_counter() - t0
        calls = [e["args"] for e in tracer.events
                 if e["name"] == "sweep.torch"]
    finally:
        tracer.disable()
        tracer.reset()
    return report, drv, calls, wall


def log_calls(what: str, calls) -> None:
    for i, c in enumerate(calls):
        log(f"  {what} call {i}: {c['specs']} specs, {c['lanes']} lanes, "
            f"pack {c['pack_s']:.2f} s, capture {c['capture_s']:.3f} s "
            f"(pool {c['pool_bytes']} B), sweep {c['sweep_s']:.2f} s, "
            f"{c['ticks'] / c['sweep_s']:.1f} ticks/s")


def decide_phase(torch, days: float, n_files: int) -> dict:
    """The §5.3 decision workflow on the card (see the module notes);
    returns each lane-tick and glue kernel's launches in the cold run."""
    import shutil
    import tempfile

    from repro_torch.kernels.lane_tick import ops
    from repro_torch.kernels.tick_glue import ops as glue_ops

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="decide_cache_", dir=ROOT / "build")
    try:
        axes = pricing_axes(days, n_files)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        alloc0 = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        glue_ops.reset_launch_counts()
        cold, drv, calls, wall = run_decide(torch, axes, "cuda", cache_dir,
                                            max_rounds=2)
        launched = {**ops.launch_counts(), **glue_ops.launch_counts()}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        alloc1 = torch.cuda.memory_allocated()
        doc = cold.to_json_dict()
        log(f"decide cold (216-config grid, {n_files} files/site, "
            f"{days:g} days, max_rounds=2, cuda): {wall:.2f} s, "
            f"{drv.sweep_calls} sweep calls, {drv.configs_run} configs, "
            f"{drv.lanes_simulated} lanes simulated, launches {launched}")
        log_calls("decide cold", calls)
        check(len(calls) == drv.sweep_calls and calls,
              f"decide cold: {len(calls)} sweep records for "
              f"{drv.sweep_calls} calls")
        check(all(n > 0 for n in launched.values())
              and set(launched) == set(ops.KERNELS + glue_ops.KERNELS),
              f"decide cold: a kernel was not launched ({launched})")
        log(f"decide cold: claim_holds {doc['claim_holds']}, "
            f"refine.lane_fraction {doc['refine']['lane_fraction']:.4f}, "
            f"displaced_disk.displaced_tb "
            f"{doc['displaced_disk']['displaced_tb']}, chosen "
            f"{doc['chosen'] and doc['chosen']['label']}, break-even "
            f"{doc['break_even'] and doc['break_even']['bracket']}")
        log(f"decide cold: device memory allocated {alloc0} B before, "
            f"{alloc1} B after (each sweep call's graph pool released)")
        check(alloc1 - alloc0 < max(c["pool_bytes"] for c in calls) // 2
              + (64 << 20), "decide cold: device memory held after the "
                            "workflow")
        for k in ("baseline", "chosen", "frontier"):
            rows = doc[k] if k == "frontier" else [doc[k]]
            check(all(r is None or all(
                v == v and abs(v) != float("inf")
                for v in r.values() if isinstance(v, float)) for r in rows),
                f"decide cold: non-finite number in {k}")

        warm, wdrv, wcalls, wwall = run_decide(torch, axes, "cuda",
                                               cache_dir, max_rounds=2)
        wdoc = warm.to_json_dict()
        log(f"decide warm (fresh driver, same cache): {wwall:.2f} s, "
            f"{wdrv.lanes_simulated} lanes simulated, {wdrv.configs_run} "
            f"configs run, {wdrv.cache_hits} cache hits, cache "
            f"{wdrv.cache.stats.as_dict()}")
        check(wdrv.lanes_simulated == 0 and not wcalls
              and wdrv.configs_run == 0, "decide warm: lanes simulated")
        check(wdrv.cache.stats.corrupt == 0, "decide warm: corrupt entries")
        cold_rest = {k: v for k, v in doc.items() if k != "stats"}
        warm_rest = {k: v for k, v in wdoc.items() if k != "stats"}
        check(json.dumps(cold_rest, sort_keys=True)
              == json.dumps(warm_rest, sort_keys=True),
              "decide warm: report differs from the cold run's")
        log("decide warm: report equal to the cold run's outside stats")

        small = {}
        for impl in ("cuda", "torch"):
            # one cache directory: the two engines' keys differ, so
            # neither run is served the other's entries
            rep, sdrv, scalls, swall = run_decide(
                torch, SMALL_DECIDE_AXES, impl, cache_dir,
                tick=SMALL_DECIDE_TICK, max_rounds=2)
            small[impl] = rep
            log(f"decide small ({impl}): {swall:.2f} s, "
                f"{sdrv.sweep_calls} sweep calls, {sdrv.lanes_simulated} "
                f"lanes simulated, cache {sdrv.cache.stats.as_dict()}")
            log_calls(f"decide small {impl}", scalls)
        a, b = (small[i].to_json_dict() for i in ("cuda", "torch"))
        off = points_beyond_bar(a, b)
        if decisions(a) != decisions(b) or off:
            for impl, rep in small.items():
                log(f"--- decide small report ({impl}) ---")
                log(rep.to_markdown())
        check(decisions(a) == decisions(b),
              f"decide small: cuda and plain decisions differ: "
              f"{decisions(a)} vs {decisions(b)}")
        check(not off, f"decide small: points beyond the Table-2 bar: {off}")
        log(f"decide small: cuda and plain decisions equal "
            f"{decisions(a)}; every point within the Table-2 bar")
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    log(f"decide phase: {time.perf_counter() - t_phase:.2f} s wall")
    return launched


def carousel_inputs(torch, gen, n: int, m: int):
    """``n`` transfers on ``m`` links, every one in flight, half the links
    shared and half per-transfer: a transfer's own rate is 10 kB/s to
    1 MB/s (log-uniform), so that completions spread over the ticks, and a
    shared link carries as much per transfer while it is full."""
    dev = torch.device("cuda")
    link_id = torch.randint(0, m, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    total = 1e6 + 1e9 * torch.rand(n, generator=gen, device=dev)
    done = total * torch.rand(n, generator=gen, device=dev)
    mode = (torch.arange(m, device=dev) % 2).to(torch.int32)
    bw = 10.0 ** (4.0 + 2.0 * torch.rand(m, generator=gen, device=dev))
    bw = torch.where(mode == 0, bw * (n / m), bw)
    return link_id, active, done, total, bw, mode


def engine_bound(torch, n_active0: int, n: int, m: int, completions):
    """Least time of the engine's ticks at this run's data, per tick:
    each tick reads every active flag, the link id, done and total of the
    active transfers, writes their done and the flags of the completed
    ones (the rates per link: bw, mode and count, 12 B a link); about five
    float operations an active transfer. Returns (ms per tick,
    bound_by)."""
    c = completions.to(torch.int64)
    active = n_active0 - torch.cumsum(c, 0) + c  # at the start of each tick
    n_ticks = int(c.numel())
    nb = (n * n_ticks + 16 * int(active.sum()) + int(c.sum())
          + 12 * m * n_ticks)
    ms, kind = bound_ms(nb, 5 * int(active.sum()))
    return ms / max(n_ticks, 1), kind


def engine_steady(torch, ops, args, dt: float, n_ticks: int,
                  want=None) -> dict:
    """A tick engine (``ops.CarouselEngine``, chunks of
    ``ops.ENGINE_CHUNK`` ticks) over ``n_ticks`` ticks of ``args``,
    measured in its steady state: after its warm-up and capture, a window
    of whole chunks, at least 100 ticks, on the host clock, the next
    window under ``torch.profiler`` (device time per tick, the idle share
    of the unprofiled wall), then the replays that remain timed with CUDA
    events and the host clock; the engine's final state is held bitwise
    to ``want`` (a plain engine's ``(active, done, completions)``) when
    given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = ops.CarouselEngine(*args, dt, n_ticks)
    chunk = engine.chunk
    window = -(-100 // chunk) * chunk
    lead = ops.ENGINE_WARMUP_TICKS + chunk
    engine.advance(lead)  # warm-up, capture and the first replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.advance(window)
    torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0) / window
    n_active = int(engine.active.sum())  # at the profiled window's start
    t_win = engine.t
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.advance(window)
        torch.cuda.synchronize()
    win_bound = engine_bound(torch, n_active, engine.active.numel(),
                             engine.bw.numel(),
                             engine.completions[t_win:engine.t])[0]
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows) / window
    tick_us = sum(e.self_device_time_total for e in rows
                  if "engine_tick" in e.key) / window
    n_rep = (n_ticks - lead - 2 * window) // chunk * chunk
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    engine.advance(n_rep)
    stop.record()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    engine.advance(n_ticks - engine.t)
    if want is not None:
        got = (engine.active, engine.done, engine.completions)
        for g, w, name in zip(got, want, ("active", "done", "completions")):
            check(torch.equal(g, w), f"engine (chunk {chunk}): {name} not "
                                     f"bitwise to the plain engine")
    return dict(chunk=chunk, window=window, wall_us=wall_us,
                busy_us=busy_us, tick_us=tick_us,
                idle=1 - busy_us / wall_us, n_rep=n_rep,
                active_share=n_active / engine.active.numel(),
                window_bound_us=1e3 * win_bound,
                ticks_per_s=n_rep / steady_s,
                ms=start.elapsed_time(stop) / n_rep,
                capture_ms=1e3 * engine.capture_s,
                kernels=len(rows))


def carousel_phase(torch, n: int = 1_000_000, n_ticks: int = 1000):
    """The carousel's two paths. The one-tick ``carousel_tick`` over ``n``
    transfers, every file of one site's catalogue in flight, on 6 links
    (Config III's 2 sites x 3 link types) and on 512 (the Pallas design's
    ceiling), half of them shared and half per-transfer, dt = 10 s: bars
    ``new_done``/``completed`` bitwise and counts exact against the plain
    version. The tick engine ``simulate_ticks`` for ``n_ticks`` ticks on
    6 links (``ops.CarouselEngine``: one count, then one kernel launch a
    tick, replayed from CUDA graphs): its final state bitwise and its
    per-tick completions equal to the plain engine's, and a second engine
    over the same ticks measured in its steady state
    (:func:`engine_steady`). Each path runs with the launch counts reset
    just before and read just after. Returns one (kernel, case, launches,
    result) per case."""
    from repro_torch.kernels.carousel_update import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4101)
    cases = {m: carousel_inputs(torch, gen, n, m) for m in (6, 512)}
    dt = 10.0
    none = dict.fromkeys(ops.KERNELS, 0)
    got, launches = {}, {}
    for m, a in cases.items():
        ops.reset_launch_counts()
        got[m] = ops.carousel_tick(*a, dt)
        launches[m] = ops.launch_counts()
        check(launches[m] == {**none, "carousel_tick": 1},
              f"carousel_tick M={m}: launches {launches[m]}")

    # the engine's path, as a caller runs it
    args = cases[6]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sim_k = ops.simulate_ticks(*args, dt, n_ticks, tick_impl="cuda",
                               device=dev)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    eng_launches = ops.launch_counts()
    check(eng_launches == {**none, "engine_count": 1,
                           "engine_tick": n_ticks},
          f"simulate_ticks: launches {eng_launches} in {n_ticks} ticks")
    t0 = time.perf_counter()
    again = ops.simulate_ticks(*args, dt, n_ticks, tick_impl="cuda",
                               device=dev)
    torch.cuda.synchronize()
    wall_k2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim_p = ops.simulate_ticks(*args, dt, n_ticks, tick_impl="torch",
                               device=dev)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    check(torch.equal(sim_k[0], sim_p[0]), "simulate_ticks: active differs")
    check(torch.equal(sim_k[1], sim_p[1]), "simulate_ticks: done differs")
    check(torch.equal(sim_k[2], sim_p[2]),
          "simulate_ticks: completions differ")
    check(all(torch.equal(x, y) for x, y in zip(again, sim_k)),
          "simulate_ticks: two calls differ")
    n_done = int(sim_k[2].sum())
    check(0 < n_done < n, f"simulate_ticks: {n_done} completions")
    log(f"carousel simulate_ticks: {n_ticks} ticks of {n} transfers on 6 "
        f"links, final state bitwise, {n_done} completions equal per tick; "
        f"engine {n_ticks / wall_k:.1f} ticks/s (the whole call: count, "
        f"warm-up, capture, replays; the engine's first call in this "
        f"process), {n_ticks / wall_k2:.1f} ticks/s a second call, plain "
        f"{n_ticks / wall_p:.1f} ticks/s; "
        f"launches {eng_launches} (replays counted): "
        f"{eng_launches['engine_tick'] / n_ticks:.3f} a tick after the "
        f"count")
    st = engine_steady(torch, ops, args, dt, n_ticks, want=sim_p)
    tick_bound, tick_kind = engine_bound(torch, n, n, 6, sim_p[2])
    log(f"carousel engine steady state (chunk {st['chunk']}): {st['n_rep']} "
        f"replayed ticks at {st['ticks_per_s']:.1f} ticks/s without the "
        f"capture ({st['ms']:.5f} ms a tick by events); capture "
        f"{st['capture_ms']:.2f} ms once; over {st['window']} ticks: wall "
        f"{st['wall_us']:.2f} us/tick unprofiled, device busy "
        f"{st['busy_us']:.2f} us/tick ({st['tick_us']:.2f} in the engine "
        f"kernel, {st['kernels']} device kernels by name), idle share "
        f"{st['idle']:.3f}, active share {st['active_share']:.4f} at its "
        f"start, bound {st['window_bound_us']:.2f} us/tick over it; bound "
        f"over all {n_ticks} ticks {1e3 * tick_bound:.2f} us/tick "
        f"({tick_kind}, this run's active transfers)")

    # plain versions of the engine's two kernels, on the same inputs
    link, act0 = args[0], args[1]
    cnt = torch.empty(6, dtype=torch.int32, device=dev)
    ops.engine_count(link, act0, cnt)
    plain_cnt = torch.bincount(link[act0].long(), minlength=6)
    check(torch.equal(cnt, plain_cnt.to(torch.int32)),
          "engine_count: counts differ from bincount")
    pa = [args[1].clone(), args[2].clone()]
    pc = torch.zeros((2, 6), dtype=torch.int32, device=dev)
    pc[1] = cnt
    ph = torch.zeros((3, 6), dtype=torch.int32, device=dev)
    pcomp = torch.zeros(n_ticks, dtype=torch.int32, device=dev)
    pt = [0]

    def plain_tick():
        ref.engine_tick(link, pa[0], pa[1], args[3], args[4], args[5], dt,
                        pt[0], pc, ph, pcomp)
        pt[0] += 1

    cnt_bound = bound_ms(n + 4 * int(act0.sum()) + 4 * 6, n)
    per_case = []
    for m, a in cases.items():
        want = ref.carousel_tick(*a, dt)
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
                     *a, dt, tick_impl="cuda")),
                 plain_ms=time_ms(torch, lambda: ref.carousel_tick(*a, dt)),
                 bound_ms=nb, bound_by=kind, library_ms=None)
        dev_us = device_us(torch, lambda: ops.carousel_tick(
            *a, dt, tick_impl="cuda"))
        r["device_us"] = dev_us
        per_case.append(("carousel_tick", f"N=1M M={m}",
                         launches[m]["carousel_tick"], r))
        log(f"carousel_tick M={m}: new_done/completed bitwise, counts exact, "
            f"{n_comp} completions; ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} bound_ms {nb:.4f} ({kind}); device time "
            f"{dev_us:.1f} us per call (profiler: memset and both kernels)")
    r = dict(max_abs_err=float((sim_k[1] - sim_p[1]).abs().max()),
             ms=st["ms"], plain_ms=time_ms(torch, plain_tick),
             bound_ms=tick_bound, bound_by=tick_kind, library_ms=None,
             device_us=st["tick_us"], wall_us=st["wall_us"],
             idle_share=st["idle"], ticks_per_s=st["ticks_per_s"],
             ticks_per_s_with_capture=n_ticks / wall_k,
             ticks_per_s_second_call=n_ticks / wall_k2,
             capture_ms=st["capture_ms"], chunk=st["chunk"])
    per_case.append(("engine_tick", f"N=1M M=6, simulate_ticks {n_ticks} "
                     f"ticks, ms per tick", eng_launches["engine_tick"], r))
    r = dict(max_abs_err=0.0,
             ms=time_ms(torch, lambda: ops.engine_count(link, act0, cnt)),
             plain_ms=time_ms(torch, lambda: torch.bincount(
                 link[act0].long(), minlength=6)),
             bound_ms=cnt_bound[0], bound_by=cnt_bound[1], library_ms=None,
             device_us=device_us(torch, lambda: ops.engine_count(
                 link, act0, cnt)))
    per_case.append(("engine_count", f"N=1M M=6, simulate_ticks' first "
                     f"tick", eng_launches["engine_count"], r))
    log(f"carousel engine_tick: ms {per_case[-2][3]['ms']:.5f} a tick, "
        f"plain_ms {per_case[-2][3]['plain_ms']:.4f} (ref.engine_tick); "
        f"engine_count: ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
        f"bound_ms {r['bound_ms']:.4f}, device {r['device_us']:.1f} us, "
        f"counts equal to bincount")
    return per_case


#: Attention cases: (label, B, nh, nkv, hd, T = S, dtype, causal, window).
#: Published widths, and hd 168: what ``repro``'s gemma3_27b config derives
#: (5376/32; the published head_dim is 128), kept as a width that is not a
#: power of two, with two query heads per kv head; hd 100 in bf16, a width
#: that is not a multiple of 8, is the SIMT kernel's route.
ATTENTION_CASES = (
    ("qwen3_4b", 1, 32, 8, 128, 4096, "bfloat16", True, 0),
    ("gemma3_27b local", 1, 32, 16, 128, 4096, "bfloat16", True, 1024),
    ("hd168 bf16", 1, 32, 16, 168, 4096, "bfloat16", True, 1024),
    ("hd168 f32", 1, 32, 16, 168, 2048, "float32", True, 1024),
    ("hymba_1_5b f32", 1, 25, 5, 64, 2048, "float32", True, 1024),
    ("hd100 bf16", 1, 32, 16, 100, 2048, "bfloat16", True, 1024),
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


def sdpa(torch, q, k, v, causal: bool, window: int):
    """One call of PyTorch's ``scaled_dot_product_attention`` computing what
    ``flash_attention`` computes on these inputs (``is_causal`` or a
    boolean mask, ``enable_gqa``): the yardstick, never on the port's
    path."""
    import torch.nn.functional as F

    T, S = q.shape[2], k.shape[2]
    rel = (torch.arange(T, device=q.device)[:, None]
           - torch.arange(S, device=q.device)[None, :])
    mask = rel >= 0 if causal else torch.ones_like(rel, dtype=torch.bool)
    if window > 0:
        mask &= rel < window
    gqa = {"enable_gqa": True} if k.shape[1] != q.shape[1] else {}
    if causal and window == 0:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      **gqa)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  **gqa)


def attention_phase(torch):
    """The attention path: ``flash_attention`` once per case of
    ``ATTENTION_CASES`` through the kernel, then each result against the
    plain version on the same inputs at ``ATTENTION_BARS``, and the times
    of the kernel, the plain version and PyTorch's
    ``scaled_dot_product_attention`` (the yardstick; the port never calls
    it). Returns one (case, launches, result) per case."""
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
        lib = sdpa(torch, q, k, v, causal, window)
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
        fa = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
        g_ms = graph_ms(torch, fa, n=10)
        # the profiler loses some or all of a session's kernels (late in
        # this run every one, in a process of its own at times): a reading
        # more than 5% off the graph replay's device time is not a
        # measurement, None
        prof_us = device_us(torch, fa, n=10)
        dev_us = prof_us if abs(prof_us - 1e3 * g_ms) <= 50 * g_ms else None
        r = dict(max_abs_err=float(err.max()), ms=time_ms(torch, fa, n=10),
                 graph_ms=g_ms, device_us=dev_us,
                 plain_ms=time_ms(torch, lambda: ref.attention(q, k, v, **kw),
                                  n=5),
                 library_ms=time_ms(torch, lib, n=10),
                 variant=route, source=ATTENTION_SOURCE[route])
        if dt_name == "bfloat16":
            flops = 4 * hd * pairs
            r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, flops,
                                                    BF16_OPS_PER_S)
            bounds = f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}"
        else:
            # three TF32 products per multiply on the tensor cores, beside
            # the one float32 product any SIMT design is held to
            flops = 12 * hd * pairs
            r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, flops,
                                                    TF32_OPS_PER_S)
            r["bound_ms_simt"] = bound_ms(n_bytes, 4 * hd * pairs)[0]
            bounds = (f"bound_ms {r['bound_ms']:.4f} (3xTF32 at 495 "
                      f"TFLOP/s, {r['bound_by']}), SIMT bound_ms "
                      f"{r['bound_ms_simt']:.4f} (67 TFLOP/s")
        per_case.append((f"{label} (nh {nh} nkv {nkv} hd {hd} T=S {T} "
                         f"{dt_name} window {window})", n_launch, r))
        dev_txt = (f"{dev_us:.1f}" if dev_us is not None else
                   f"not measured (profiler read {prof_us:.1f})")
        log(f"attention {label} (B={B} nh={nh} nkv={nkv} hd={hd} T=S={T} "
            f"{dt_name} causal={causal} window={window}, {route} kernel): "
            f"max abs err "
            f"{r['max_abs_err']:.3g} (bar atol {atol} rtol {rtol}; SDPA's "
            f"{lib_err:.3g}, {lib_bad} of {out.numel()} elements outside "
            f"the bar); elements not equal to the plain version: kernel "
            f"{ne}, SDPA {lib_ne}; ms "
            f"{r['ms']:.4f} graph_ms {g_ms:.4f} device_us {dev_txt} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"{bounds}, {flops / 1e9:.2f} GFLOP)")
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
        from repro_torch.kernels.tick_glue import ops as glue_ops
        from repro_torch.sim.batched import run_sweep_torch, simulate_packed
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
    glue, glue_tick = glue_phase(torch, grid)

    # -- small reference: CPU plain path against the card's kernels
    small = pricing_specs(0.1, 1000)
    cpu = run_sweep_torch(small, tick=60.0, tick_impl="torch", device="cpu")
    gpu = run_sweep_torch(small, tick=60.0, tick_impl="cuda", device="cuda")
    log(f"small reference: {lane_parity(cpu, gpu)} specs within the "
        f"Table-2 bar (CPU plain vs card kernels)")

    # -- sweep phase (the main path: run_sweep_torch, whose cuda tick
    # replays a CUDA graph), then the plain path, then the cuda path
    # replayed and eager on the packed grid, bitwise to each other
    log(f"sweep: horizon cut from the paper's 90 days to {days:g} days "
        f"({grid.n_ticks} ticks of 10 s); catalogue {n_files} files/site")
    runs = {}
    counts = None
    for impl in ("cuda", "torch"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        glue_ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_sweep_torch(specs, tick=10.0, tick_impl=impl,
                              device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {**ops.launch_counts(), **glue_ops.launch_counts()}
        if impl == "cuda":
            counts = launched
        runs[impl] = res
        log(f"sweep {impl}{' (captured)' if impl == 'cuda' else ''}: "
            f"{wall:.2f} s wall, {grid.n_ticks / wall:.1f} ticks/s, "
            f"{len(res) / wall:.2f} configs/s, launches {launched}")
    check(counts == {name: grid.n_ticks
                     for name in ops.KERNELS + glue_ops.KERNELS},
          f"main path launches {counts}, not one of each kernel in each of "
          f"{grid.n_ticks} ticks")
    n_ok = lane_parity(runs["torch"], runs["cuda"])
    log(f"sweep parity: {n_ok} specs within the Table-2 bar, jobs "
        f"submitted equal")
    outs = {}
    for eager in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[eager] = simulate_packed(grid, tick_impl="cuda", device="cuda",
                                      _eager=eager)
        wall = time.perf_counter() - t0
        log(f"simulate_packed cuda {'eager' if eager else 'captured'}: "
            f"{wall:.2f} s wall, {grid.n_ticks / wall:.1f} ticks/s "
            f"(packing not included)")
    for key, want in outs[True].items():
        check(outs[False][key].dtype == want.dtype
              and np.array_equal(outs[False][key], want),
              f"sweep: captured and eager cuda {key} not bitwise")
    log(f"sweep: captured and eager cuda paths bitwise on all "
        f"{len(outs[True])} outputs")
    prof = {graph: profile_phase(torch, grid, graph) for graph in (False,
                                                                   True)}
    for graph, p in prof.items():
        which = "captured" if graph else "eager"
        check(p.get("topk_us", 0.0) == 0.0,
              f"profile {which}: torch.topk kernels in the cuda tick")
    if prof[True]["busy_us"] is None:
        busy = prof[False]["busy_us"]
        log(f"profile captured: device busy taken from the eager profile, "
            f"{busy:.1f} us/tick: idle share "
            f"{1 - busy / prof[True]['wall_us']:.3f}")

    decide_launches = decide_phase(torch, days, n_files)

    # one entry per kernel and case: the lane-tick kernels at the sweep's
    # shapes with their launches on the sweep, then the three further
    # kernel paths, each driven with its count reset just before and read
    # just after each case
    shapes = (f"sweep shapes (L {grid.n_lanes}, S {len(grid.site_names)}, "
              f"F {n_files})")
    cases = [(name, shapes + (", the K and W=4 windows in one launch"
                              if name == "window_admit" else ""),
              counts[name], {**kern[name],
                             "launches_decide": decide_launches[name]})
             for name in ops.KERNELS]
    cases += [(f"glue_{step}", f"{shapes}, the sweep's state at tick "
               f"{glue_tick}", counts[f"glue_{step}"],
               {**glue[step],
                "launches_decide": decide_launches[f"glue_{step}"]})
              for step in GLUE_STEPS]
    cases += carousel_phase(torch)
    for name, phase in (("flash_attention", attention_phase),
                        ("mamba_scan", mamba_phase)):
        cases += [(name, *c) for c in phase(torch)]

    kernels = [dict(name=name, case=case, route="cuda",
                    source=r.get("source", KERNEL_SOURCE[name]),
                    replaces=REPLACES[name], launches=n,
                    **{k: r[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")},
                    **{k: r[k] for k in (
                        "variant", "device_us", "graph_ms",
                        "bound_ms_without_rank", "bound_ms_simt",
                        "copy_device_us", "library_device_us",
                        "wall_us", "idle_share",
                        "ticks_per_s", "ticks_per_s_with_capture",
                        "ticks_per_s_second_call",
                        "capture_ms", "chunk", "launches_decide")
                       if k in r})
               for name, case, n, r in cases]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} ({k['case']}) was not "
                                 f"launched on its path")
    check({k["name"] for k in kernels} == set(KERNEL_SOURCE),
          "the kernels line misses a kernel")
    check({k["variant"] for k in kernels if k["name"] == "flash_attention"}
          == set(ATTENTION_SOURCE), "the kernels line misses an attention "
                                    "route")
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
