#!/usr/bin/env python3
"""Time the port's attention kernels on one GPU: the bf16 route (``wgmma``)
in each of its head-width buckets and with each loader, or the float32
route.

    python3 scripts/bench_attention.py [--dtype bfloat16|float32]
                                       [--reps 5] [--root DIR]
                                       [--cases LABEL,...]

Cases, causal, one layer, B = 1. bfloat16 (T = S = 4096): the bf16
cases of ``chip_smoke.py`` (qwen3_4b, gemma3_27b's local layers, hd 168,
hd 100 at its head counts and window), one case in each other bucket (hd
64 at qwen3_4b's head counts, hd 256 with 16 query heads on 8 kv heads),
and hd 97 (32 query heads on 16, no window), an odd width: hd 100 and 97
go through the wgmma kernel's thread loader (8-byte ``cp.async``; loads
through registers), the others through TMA. float32 (T = S = 2048): the two
float32 cases of ``chip_smoke.py`` (hd 168, hymba_1_5b) and hd 128 and hd
256 at the head counts of the bf16 cases of those widths. For each case:
``--reps`` timings of 10 calls (CUDA events after 3 warm-up calls,
``chip_smoke.time_ms``), the device time per call from ``torch.profiler``
(``chip_smoke.device_us``), the host's time to enqueue one call, the
launches of the kernel its route picks (and its loader, where the port
has one), the largest error and the elements
outside the bar against the plain version (bf16: the share unequal), one
call of PyTorch's SDPA (``chip_smoke.sdpa``), and the bound: bf16 4*hd
flops per unmasked pair at 989 TFLOP/s; float32 12*hd at dense TF32's 495
(three products per multiply on split operands) beside the SIMT ceiling,
4*hd at 67. ``--root`` times the port of another checkout (for example a
parent commit unpacked with ``git archive`` under ``build/``) with this
script's inputs and helpers. Prints the card, one line per case and a
JSON line. Needs CUDA.
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

#: dtype -> (T = S, cases (label, nh, nkv, hd, window))
CASES = {
    "bfloat16": (4096, (
        ("qwen3_4b", 32, 8, 128, 0),
        ("gemma3_27b local", 32, 16, 128, 1024),
        ("hd168", 32, 16, 168, 1024),
        ("hd64", 32, 8, 64, 0),
        ("hd256", 16, 8, 256, 0),
        ("hd100", 32, 16, 100, 1024),
        ("hd97", 32, 16, 97, 0),
    )),
    "float32": (2048, (
        ("hd168", 32, 16, 168, 1024),
        ("hymba_1_5b", 25, 5, 64, 1024),
        ("hd128", 32, 8, 128, 0),
        ("hd256", 16, 8, 256, 0),
    )),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=sorted(CASES), default="bfloat16",
                    help="the route to time (default bfloat16)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timings of 10 calls per case (default 5)")
    ap.add_argument("--root", type=Path, default=None,
                    help="time the port of this checkout instead")
    ap.add_argument("--cases", default=None,
                    help="comma-separated labels of the cases to run "
                         "(default all of the dtype's)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_attention: CUDA is not available", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels.flash_attention import ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"port: {Path(ops.__file__).resolve().parents[4]}")
    # the plain version's products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    T, cases = CASES[args.dtype]
    if args.cases is not None:
        # inputs come from one generator in case order: keep the order
        wanted = set(args.cases.split(","))
        unknown = wanted - {c[0] for c in cases}
        if unknown:
            print(f"bench_attention: no case {sorted(unknown)}",
                  file=sys.stderr)
            return 2
    atol, rtol = cs.ATTENTION_BARS[args.dtype]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2604)
    rows = []
    for label, nh, nkv, hd, window in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((1, nh, T, hd), (1, nkv, T, hd),
                                 (1, nkv, T, hd)))
        if args.cases is not None and label not in wanted:
            continue
        kw = dict(causal=True, window=window)
        route = ops._route(dtype, hd)
        # the parent of the thread loader has no loaders
        loader = (ops._loader(hd) if route == "wgmma"
                  and hasattr(ops, "_loader") else None)
        key = f"flash_attention_{route}"
        before = ops.launch_counts()
        out = ops.flash_attention(q, k, v, **kw)
        after = ops.launch_counts()
        launched = after[key] - before[key]
        if loader == "threads":
            tkey = "flash_attention_wgmma_threads"
            if after[tkey] - before[tkey] != launched:
                raise SystemExit(f"{label}: the thread loader launched "
                                 f"{after[tkey] - before[tkey]} times")
        want = ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        outside = cs.n_outside(out, want, atol, rtol)
        unequal = int((out != want).sum())
        del want

        def fn():
            return ops.flash_attention(q, k, v, **kw)

        ms = [cs.time_ms(torch, fn, n=10) for _ in range(args.reps)]
        dev_us = cs.device_us(torch, fn, n=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        library_ms = cs.time_ms(torch, cs.sdpa(torch, q, k, v, **kw), n=10)
        pairs = nh * cs.unmasked_pairs(T, T, True, window)
        if args.dtype == "bfloat16":
            bound = cs.bound_ms(0, 4 * hd * pairs, cs.BF16_OPS_PER_S)[0]
            bound_simt = None
        else:
            bound = cs.bound_ms(0, 12 * hd * pairs, cs.TF32_OPS_PER_S)[0]
            bound_simt = cs.bound_ms(0, 4 * hd * pairs)[0]
        row = dict(case=label, nh=nh, nkv=nkv, hd=hd, window=window, T=T,
                   dtype=args.dtype, route=route, loader=loader,
                   launches=launched, ms=ms,
                   device_ms=dev_us / 1e3, host_enqueue_ms=host_us / 1e3,
                   library_ms=library_ms, bound_ms=bound,
                   bound_ms_simt=bound_simt, max_abs_err=err,
                   outside=outside, unequal_share=unequal / out.numel())
        rows.append(row)
        simt = ("" if bound_simt is None
                else f", SIMT bound {bound_simt:.4f} ms")
        print(f"{label} (nh {nh} nkv {nkv} hd {hd} window {window} T=S {T} "
              f"{args.dtype}, {route} kernel"
              f"{'' if loader is None else f', {loader} loader'}, "
              f"{launched} launch): ms "
              f"{' '.join(f'{t:.4f}' for t in ms)}; device {dev_us:.1f} us; "
              f"host enqueue {host_us:.1f} us; SDPA {library_ms:.4f} ms; "
              f"bound {bound:.4f} ms{simt}; max abs err {err:.3g}, "
              f"{outside} outside atol {atol} rtol {rtol}, "
              f"{unequal / out.numel():.4%} unequal", flush=True)
    print(json.dumps({f"attention_{args.dtype}": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
