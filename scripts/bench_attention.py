#!/usr/bin/env python3
"""Time the port's bf16 attention kernel (the ``wgmma`` route) in each of
its head-width buckets on one GPU.

    python3 scripts/bench_attention.py [--reps 5]

Cases, T = S = 4096, causal, one layer, B = 1: the three bf16 cases of
``chip_smoke.py`` (qwen3_4b, gemma3_27b's local layers, hd 168) and one
case in each other bucket (hd 64 at qwen3_4b's head counts, hd 256 with
16 query heads on 8 kv heads). For each case: ``--reps`` timings of 10
calls (CUDA events after 3 warm-up calls, ``chip_smoke.time_ms``), the
device time per call from ``torch.profiler`` (``chip_smoke.device_us``),
the host's time to enqueue one call, the elements unequal to the plain
version, and the bound (4*hd flops per unmasked pair at 989 TFLOP/s).
Prints the card, one line per case and a JSON line. Needs CUDA.
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

#: (label, nh, nkv, hd, window)
CASES = (
    ("qwen3_4b", 32, 8, 128, 0),
    ("gemma3_27b local", 32, 16, 128, 1024),
    ("hd168", 32, 16, 168, 1024),
    ("hd64", 32, 8, 64, 0),
    ("hd256", 16, 8, 256, 0),
)
T = 4096


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="timings of 10 calls per case (default 5)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_attention: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels.flash_attention import ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2604)
    rows = []
    for label, nh, nkv, hd, window in CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((1, nh, T, hd), (1, nkv, T, hd),
                                 (1, nkv, T, hd)))
        kw = dict(causal=True, window=window)
        before = ops.launch_counts()["flash_attention_wgmma"]
        out = ops.flash_attention(q, k, v, **kw)
        launched = ops.launch_counts()["flash_attention_wgmma"] - before
        want = ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
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
        flops = 4 * hd * nh * cs.unmasked_pairs(T, T, True, window)
        nb, _ = cs.bound_ms(0, flops, cs.BF16_OPS_PER_S)
        row = dict(case=label, nh=nh, nkv=nkv, hd=hd, window=window,
                   launches=launched, ms=ms, device_ms=dev_us / 1e3,
                   host_enqueue_ms=host_us / 1e3, bound_ms=nb,
                   unequal_share=unequal / out.numel())
        rows.append(row)
        print(f"{label} (nh {nh} nkv {nkv} hd {hd} window {window}): ms "
              f"{' '.join(f'{t:.4f}' for t in ms)}; device {dev_us:.1f} us; "
              f"host enqueue {host_us:.1f} us; bound {nb:.4f} ms; "
              f"{unequal / out.numel():.4%} unequal; {launched} wgmma "
              f"launch", flush=True)
    print(json.dumps({"attention_bf16": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
