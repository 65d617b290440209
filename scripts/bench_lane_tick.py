#!/usr/bin/env python3
"""Time the port's lane-tick kernels on one GPU, one at a time.

    python3 scripts/bench_lane_tick.py [--kernel gcs_admit|transfer_tick]
                                       [--reps 5] [--root DIR]

Inputs at the sweep's shapes in ``chip_smoke.py``: 8 lanes x 2 sites x
1,000,000 files, file sizes log-uniform between 1 MB and 10 GB.

``gcs_admit`` (the default): the pass-start occupancy up to 1 TB,
candidates drawn with a share of 2e-5 (the tick's: files whose last
consumer just finished), 1e-3, 3e-2 and 0.3; half the lanes get a finite
limit that cuts through their candidates (the occupancy plus half their
bytes), the other half none. Reports the admission differences against
the plain version and whether each is a tie within 16 ulps of the limit
(``chip_smoke.gcs_tie_check``), whether the migration rank is bitwise the
plain rank of the kernel's mask, and the bounds: the bytes the function
needs with the migration-rank plane and without it, at 3.35 TB/s.

``transfer_tick``: active transfers drawn with a share of 3e-4 (the
kernel phase's), 1e-2, 0.3 and 1.0 (unlimited link slots put every file
in flight), each within 1% of its total, random link types and modes,
links of 0.1 to 1 GB/s, dt 10 s. Reports whether new_done and the
completions are bitwise the plain version's and two calls bitwise equal,
the billing's largest relative error, and the bound: the bytes the
function needs at these inputs (``chip_smoke.transfer_bound``).

For each share: ``--reps`` timings of 20 calls (CUDA events after 3
warm-up calls, ``chip_smoke.time_ms``), the plain version's, the device
time per call from ``torch.profiler`` (``chip_smoke.device_us``) in all
and by kernel, the host's time to enqueue one call, and the wrapper's
launch count for one call. ``--root`` times the port of another checkout
(for example a parent commit unpacked with ``git archive`` under
``build/``) with this script's inputs and helpers. Prints the card, one
line per share and a JSON line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs

L, S, F = 8, 2, 1_000_000
SHARES = {"gcs_admit": (2e-5, 1e-3, 3e-2, 0.3),
          "transfer_tick": (3e-4, 1e-2, 0.3, 1.0)}
N_MONTHS = 4


def kernel_us(torch, fn, n: int = 20) -> dict:
    """Device time per call of each kernel ``fn`` launches, in
    microseconds (``torch.profiler``, over ``n`` calls after one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:40]: round(e.self_device_time_total / n, 2)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def timings(torch, fn, plain_fn, reps: int) -> dict:
    """``reps`` CUDA-event timings of ``fn`` (ms per call over 20 calls),
    the plain version's, device time per call in all and by kernel, and
    the host's time to enqueue one call."""
    ms = [cs.time_ms(torch, fn) for _ in range(reps)]
    plain_ms = cs.time_ms(torch, plain_fn, n=5)
    dev_us = cs.device_us(torch, fn)
    per_kernel = kernel_us(torch, fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    return dict(ms=ms, plain_ms=plain_ms, device_us=dev_us,
                host_enqueue_us=host_us, kernels_us=per_kernel)


def one_call_launches(ops, name, fn) -> int:
    before = ops.launch_counts()[name]
    fn()
    return ops.launch_counts()[name] - before


def bench_gcs(torch, gen, sizes, reps: int):
    from repro_torch.kernels.lane_tick import ops, ref

    dev = sizes.device
    used = 1e12 * torch.rand(L, generator=gen, device=dev)
    dt = torch.tensor(10.0, dtype=torch.float32, device=dev)
    month = torch.tensor(1, dtype=torch.int32, device=dev)
    finite = torch.arange(L, device=dev) % 2 == 0
    n = L * S * F
    rows = []
    for share in SHARES["gcs_admit"]:
        want = torch.rand((L, S, F), generator=gen, device=dev) < share
        wanted = (sizes * want).sum((1, 2))
        limit = torch.where(finite, used + 0.5 * wanted,
                            torch.tensor(float("inf"), device=dev))
        gargs = (want, sizes, used, limit, dt, month, N_MONTHS)

        def fn():
            return ops.gcs_admit(*gargs)

        launched = one_call_launches(ops, "gcs_admit", fn)
        got = fn()
        plain = ref.gcs_admit(*gargs)
        torch.cuda.synchronize()
        n_diff = int((got[0] != plain[0]).sum())
        ties_only = None  # not checked: a port without the float64 replay
        if hasattr(ref, "gcs_gate_distance"):
            try:  # every difference a tie within 16 ulps of the limit?
                cs.gcs_tie_check(torch, want, sizes, used, limit, got[0],
                                 plain[0], ref.GCS_ADMIT_PASSES)
                ties_only = True
            except cs.SmokeFailure:
                ties_only = False
        # the rank plane, bitwise against the plain version's rank of the
        # kernel's own mask
        rank_ok = bool(torch.equal(got[3], ref.admission_rank(got[0])))
        n_cand = int(want.sum())
        n_adm = int(got[0].sum())
        del plain, got
        t = timings(torch, fn, lambda: ref.gcs_admit(*gargs), reps)
        # needed: the candidate flag in and the admission out for every
        # file, the size only of candidates (by the 32-byte sectors read),
        # per-lane scalars and the month row; with the rank plane 4 bytes
        # more per file
        need = (n * (1 + 1) + cs.sector_bytes(torch, want, 4) + L * 4 * 3
                + L * N_MONTHS * 4)
        ops_n = 3 * n_cand * ref.GCS_ADMIT_PASSES
        nb_old, _ = cs.bound_ms(need, ops_n)
        nb, kind = cs.bound_ms(need + 4 * n, ops_n)
        rows.append(dict(share=share, candidates=n_cand, admitted=n_adm,
                         differences=n_diff, ties_only=ties_only,
                         rank_bitwise=rank_ok, launches=launched,
                         bound_ms=nb, bound_by=kind,
                         bound_ms_without_rank=nb_old, **t))
        print(f"share {share:g}: {n_cand} candidates, {n_adm} admitted, "
              f"{n_diff} differences (all ties within 16 ulps: {ties_only})"
              f", rank bitwise {rank_ok}; {_times(t)}; bound {nb:.4f} ms "
              f"({kind}; {nb_old:.4f} without the rank plane); {launched} "
              f"launch", flush=True)
        del want
    return rows


def bench_transfer(torch, gen, sizes, reps: int):
    from repro_torch.kernels.lane_tick import ops, ref

    dev = sizes.device
    site = torch.arange(S, device=dev).view(1, S, 1)
    ltype = torch.randint(0, 3, (L, S, F), generator=gen, device=dev)
    link_id = (3 * site + ltype).to(torch.int32)
    del ltype
    total = sizes
    done = total * (1.0 - 0.01 * torch.rand((L, S, F), generator=gen,
                                            device=dev))
    bw = 10.0 ** (8.0 + torch.rand((L, 3 * S), generator=gen, device=dev))
    mode = torch.randint(0, 2, (L, 3 * S), generator=gen, device=dev,
                         dtype=torch.int32)
    dt = torch.tensor(10.0, dtype=torch.float32, device=dev)
    month = torch.tensor(1, dtype=torch.int32, device=dev)
    rows = []
    for share in SHARES["transfer_tick"]:
        active = torch.rand((L, S, F), generator=gen, device=dev) < share
        args = (link_id, active, done, total, sizes, bw, mode, dt, month,
                N_MONTHS)

        def fn():
            return ops.transfer_tick(*args)

        launched = one_call_launches(ops, "transfer_tick", fn)
        got, again = fn(), fn()
        plain = ref.transfer_tick(*args)
        torch.cuda.synchronize()
        bitwise = (torch.equal(got[0], plain[0])
                   and torch.equal(got[1], plain[1]))
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        rel = max(float(((g - w).abs() / w.abs().clamp_min(1.0)).max())
                  for g, w in zip(got[2:], plain[2:]))
        n_act, n_comp = int(active.sum()), int(got[1].sum())
        need, n_ops = cs.transfer_bound(torch, active, got[1], N_MONTHS)
        nb, kind = cs.bound_ms(need, n_ops)
        del got, again, plain
        t = timings(torch, fn, lambda: ref.transfer_tick(*args), reps)
        rows.append(dict(share=share, active=n_act, completions=n_comp,
                         bitwise=bitwise, repeatable=repeat,
                         billing_rel_err=rel, launches=launched,
                         bound_ms=nb, bound_by=kind, bound_bytes=need, **t))
        print(f"share {share:g}: {n_act} active, {n_comp} completions, "
              f"new_done/comp bitwise {bitwise}, two calls equal {repeat}, "
              f"billing rel err {rel:.3g}; {_times(t)}; bound {nb:.4f} ms "
              f"({kind}, {need / 1e6:.1f} MB); {launched} launch",
              flush=True)
        del active
    return rows


def _times(t: dict) -> str:
    return (f"ms {' '.join(f'{x:.4f}' for x in t['ms'])}; plain "
            f"{t['plain_ms']:.4f} ms; device {t['device_us']:.1f} us; host "
            f"enqueue {t['host_enqueue_us']:.1f} us; per kernel (us) "
            f"{json.dumps(t['kernels_us'])}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(SHARES), default="gcs_admit",
                    help="the kernel to time (default gcs_admit)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timings of 20 calls per share (default 5)")
    ap.add_argument("--root", type=Path, default=None,
                    help="time the port of this checkout instead")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_lane_tick: CUDA is not available", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels import lane_tick

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"port: {Path(lane_tick.__file__).resolve().parents[3]}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1505)
    sizes = 10.0 ** (6.0 + 4.0 * torch.rand((L, S, F), generator=gen,
                                            device=dev))
    bench = bench_gcs if args.kernel == "gcs_admit" else bench_transfer
    rows = bench(torch, gen, sizes, args.reps)
    print(json.dumps({args.kernel: rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
