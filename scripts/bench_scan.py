#!/usr/bin/env python3
"""Time the port's Mamba selective scan on one GPU: both entries of its
kernel, ``mamba_scan`` (dA and dBu given) and ``selective_scan`` (dA and
dBu formed in the kernel from u, dt, A and B), at hymba_1_5b's served
layer and at falcon_mamba_7b's widths.

    python3 scripts/bench_scan.py [--reps 5] [--root DIR] [--cases LABEL,...]

Cases, each with the final state (what prefill keeps): ``served`` (B 4, T
1536, D 3200, N 16, dt rank 100: a wave of hymba_1_5b's prefill on 4
slots) and ``falcon`` (B 1, T 2048, D 8192, N 16, dt rank 256). The inputs
are ``chip_smoke.selective_inputs``' (bf16 u, B and C, the last two column
slices of one projection; float32 dt and A), from one seeded generator;
``mamba_scan`` takes the dA and dBu that the model's three lines form from
them (float32, 1.26 GB each served, 1.07 GB at falcon's widths) and C in
float32. For each case and entry: ``--reps`` timings of 10 calls (CUDA
events after 3 warm-up calls, ``chip_smoke.time_ms``), 10 calls replayed
in a CUDA graph (``chip_smoke.graph_ms``), the device time per call from
``torch.profiler`` (``chip_smoke.device_us``), the launches counted, the
largest error of y and h_T against the plain version and its ms, the
bound (``chip_smoke.scan_bound``: ``mamba_scan`` its bytes at 3.35 TB/s;
``selective_scan`` the larger of its bytes and its state-steps at the
float32 and ``MUFU`` instructions a state-step of its kernel's hot loop,
from the SASS, at one a lane and clock, with the loop's whole count a
state-step beside it), the kernel instance's registers and
spills (``-Xptxas -v`` build log) and its dynamic shared memory (the ring,
``ops.scan_geometry``). ``--root`` times the port of another checkout (for
example a parent commit unpacked with ``git archive`` under ``build/``) on
the same inputs; an entry that port lacks is skipped. Prints the card,
one line per case and entry, and a JSON line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs

#: label -> (B, T, D, N, dt rank)
CASES = {
    "served": (4, 1536, 3200, 16, 100),
    "falcon": (1, 2048, 8192, 16, 256),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="timings of 10 calls per case (default 5)")
    ap.add_argument("--root", type=Path, default=None,
                    help="time the port of this checkout instead")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated labels (default all)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_scan: CUDA is not available", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import ops, ref

    wanted = args.cases.split(",")
    unknown = set(wanted) - set(CASES)
    if unknown:
        print(f"bench_scan: no case {sorted(unknown)}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"port: {Path(ops.__file__).resolve().parents[4]}")
    _build.build(["mamba_scan"])
    usage = _build.ptxas_usage("mamba_scan")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for label in wanted:
        B, T, D, N, dtr = CASES[label]
        gen = torch.Generator(device=dev)
        gen.manual_seed(2929)
        u, dt, A, Bm, Cm = cs.selective_inputs(torch, B, T, D, N, dtr,
                                               torch.bfloat16, gen)
        # the model's three lines (ref.scan_inputs; written out here, as
        # another checkout's port may not have them)
        dA = torch.exp(dt[..., None] * A)
        dBu = (dt * u.float())[..., None] * Bm.float()[..., None, :]
        C = Cm.float().contiguous()
        entries = {"mamba_scan": (dA, dBu, C),
                   "selective_scan": (u, dt, A, Bm, Cm)}
        for entry, xs in entries.items():
            if not hasattr(ops, entry):
                print(f"{label} {entry}: not in this port", flush=True)
                continue
            kernel, plain = getattr(ops, entry), getattr(ref, entry)
            fused = entry == "selective_scan"
            before = ops.launch_counts()[entry]
            y, h = kernel(*xs, return_state=True)
            torch.cuda.synchronize()
            launched = ops.launch_counts()[entry] - before
            want_y, want_h = plain(*xs, return_state=True)
            torch.cuda.synchronize()
            err = max(float((y - want_y).abs().max()),
                      float((h - want_h).abs().max()))
            outside = (cs.n_outside(y, want_y, 1e-4, 1e-4)
                       + cs.n_outside(h, want_h, 1e-4, 1e-4))
            del want_y, want_h

            def fn():
                return kernel(*xs, return_state=True)

            ms = [cs.time_ms(torch, fn, n=10) for _ in range(args.reps)]
            g_ms = cs.graph_ms(torch, fn, n=10)
            dev_us = cs.device_us(torch, fn, n=10)
            plain_ms = cs.time_ms(torch, lambda: plain(*xs, return_state=True),
                                  n=2, warm=1)
            bnd = cs.scan_bound(torch, entry, xs, y, h)
            bound, by, n_bytes = (bnd["bound_ms"], bnd["bound_by"],
                                  bnd["n_bytes"])
            sass = bnd["sass"]
            # the kernel instance's build numbers; the ring of the port's
            # launch geometry, where it has one
            regs = {k: v for k, v in usage.items()
                    if (k.startswith(f"ms_scan_kernel<{int(fused)},")
                        and k.endswith(f",{ops.group_log2(N)},"
                                       f"{int(N % 4 == 0)}>")
                        and ("__nv_bfloat16" in k) == fused)
                    or k == "ms_kernel"}
            smem = None
            if hasattr(ops, "scan_geometry"):
                warps, steps = ops.scan_geometry(B, D, N, sms, fused,
                                                 2 if fused else 4)
                tile = warps * 32 >> ops.group_log2(N)
                smem = ops.STAGES * steps * ops.step_bytes(
                    fused, tile, N, 2 if fused else 4)
            row = dict(case=label, entry=entry, B=B, T=T, D=D, N=N,
                       launches=launched, ms=ms, graph_ms=g_ms,
                       device_ms=dev_us / 1e3, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, bound_bytes=n_bytes,
                       share_of_bound=bound / g_ms, max_abs_err=err,
                       outside=outside, ptxas=regs, smem_dynamic=smem,
                       sass=sass)
            rows.append(row)
            print(f"{label} {entry} (B {B} T {T} D {D} N {N}, final state;"
                  f" {launched} launch): ms "
                  f"{' '.join(f'{t:.4f}' for t in ms)}; graph "
                  f"{g_ms:.4f} ms; device {dev_us:.1f} us; plain "
                  f"{plain_ms:.3f} ms; bound {bound:.4f} ms ({by}, "
                  f"{n_bytes / 1e9:.3f} GB"
                  + (f", {sass['operations_per_state_step']:.2f} "
                     f"operations a state-step; the hot loop runs "
                     f"{sass['per_state_step']:.2f} instructions" if sass
                     else "")
                  + f"), {100 * bound / g_ms:.1f}% of it; max abs err "
                  f"{err:.3g}, {outside} outside 1e-4; ptxas {regs}; ring "
                  f"{smem} B", flush=True)
            del y, h
        del dA, dBu, C, entries
        torch.cuda.empty_cache()
    print(json.dumps({"scan": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
