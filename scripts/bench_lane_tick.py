#!/usr/bin/env python3
"""Time the port's ``gcs_admit`` kernel (shared-GCS admission) on one GPU.

    python3 scripts/bench_lane_tick.py [--reps 5]

Inputs at the sweep's shapes in ``chip_smoke.py``: 8 lanes x 2 sites x
1,000,000 files, file sizes log-uniform between 1 MB and 10 GB, the
pass-start occupancy up to 1 TB. Candidates are drawn with a share of
2e-5 (the tick's: files whose last consumer just finished), 1e-3, 3e-2
and 0.3; half the lanes get a finite limit that cuts through their
candidates (the occupancy plus half their bytes), the other half none.
For each share: ``--reps`` timings of 20 calls (CUDA events after 3
warm-up calls, ``chip_smoke.time_ms``), the device time per call from
``torch.profiler`` (``chip_smoke.device_us``) in all and by kernel, the
host's time to enqueue one call, the candidate count, the admission
differences against the plain version and whether each is a tie within 16 ulps of the limit
(``chip_smoke.gcs_tie_check``), whether the migration rank is bitwise the
plain rank of the kernel's mask, and the bounds: the bytes the function
needs with the migration-rank plane and without it, at 3.35 TB/s.
Prints the card, one line per share and a JSON line. Needs CUDA.
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
SHARES = (2e-5, 1e-3, 3e-2, 0.3)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="timings of 20 calls per share (default 5)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_lane_tick: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels.lane_tick import ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1505)
    sizes = 10.0 ** (6.0 + 4.0 * torch.rand((L, S, F), generator=gen,
                                            device=dev))
    used = 1e12 * torch.rand(L, generator=gen, device=dev)
    dt = torch.tensor(10.0, dtype=torch.float32, device=dev)
    month = torch.tensor(1, dtype=torch.int32, device=dev)
    finite = torch.arange(L, device=dev) % 2 == 0
    n = L * S * F
    rows = []
    for share in SHARES:
        want = torch.rand((L, S, F), generator=gen, device=dev) < share
        wanted = (sizes * want).sum((1, 2))
        limit = torch.where(finite, used + 0.5 * wanted,
                            torch.tensor(float("inf"), device=dev))
        gargs = (want, sizes, used, limit, dt, month, N_MONTHS)
        before = ops.launch_counts()["gcs_admit"]
        got = ops.gcs_admit(*gargs)
        launched = ops.launch_counts()["gcs_admit"] - before
        plain = ref.gcs_admit(*gargs)
        torch.cuda.synchronize()
        n_diff = int((got[0] != plain[0]).sum())
        try:  # every difference a tie within 16 ulps of the limit?
            cs.gcs_tie_check(torch, want, sizes, used, limit, got[0],
                             plain[0], ref.GCS_ADMIT_PASSES)
            ties_only = True
        except cs.SmokeFailure:
            ties_only = False
        # the rank plane, where the kernel returns one (bitwise against the
        # plain version's rank of the kernel's own mask)
        rank_ok = None
        if len(got) == 4:
            rank_ok = bool(torch.equal(got[3], ref.admission_rank(got[0])))
        n_cand = int(want.sum())
        n_adm = int(got[0].sum())
        del plain

        def fn():
            return ops.gcs_admit(*gargs)

        ms = [cs.time_ms(torch, fn) for _ in range(args.reps)]
        plain_ms = cs.time_ms(torch, lambda: ref.gcs_admit(*gargs), n=5)
        dev_us = cs.device_us(torch, fn)
        per_kernel = kernel_us(torch, fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        # needed: the candidate flag in and the admission out for every
        # file, the size only of candidates (by the 32-byte sectors read),
        # per-lane scalars and the month row; with the rank plane 4 bytes
        # more per file
        need = (n * (1 + 1) + cs.sector_bytes(torch, want, 4) + L * 4 * 3
                + L * N_MONTHS * 4)
        ops_n = 3 * n_cand * ref.GCS_ADMIT_PASSES
        nb_old, _ = cs.bound_ms(need, ops_n)
        nb, kind = cs.bound_ms(need + 4 * n, ops_n)
        row = dict(share=share, candidates=n_cand, admitted=n_adm,
                   differences=n_diff, ties_only=ties_only,
                   rank_bitwise=rank_ok, launches=launched,
                   ms=ms, plain_ms=plain_ms, device_us=dev_us,
                   host_enqueue_us=host_us, bound_ms=nb, bound_by=kind,
                   bound_ms_without_rank=nb_old, kernels_us=per_kernel)
        rows.append(row)
        print(f"share {share:g}: {n_cand} candidates, {n_adm} admitted, "
              f"{n_diff} differences (all ties within 16 ulps: {ties_only})"
              f", rank bitwise {rank_ok}; ms "
              f"{' '.join(f'{t:.4f}' for t in ms)}; plain {plain_ms:.4f} "
              f"ms; device {dev_us:.1f} us; host enqueue {host_us:.1f} us; "
              f"bound {nb:.4f} ms ({kind}; {nb_old:.4f} without the rank "
              f"plane); {launched} launch; per kernel (us) "
              f"{json.dumps(per_kernel)}", flush=True)
        del want, got
    print(json.dumps({"gcs_admit": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
