#!/usr/bin/env python3
"""Time the port's model serving path on one GPU: hymba_1_5b at its full
width served through ``ServeLoop`` on the kernels (``impl="cuda"``), as
``chip_smoke.py``'s serve phase serves it.

    python3 scripts/bench_serve.py [--reps 2] [--root DIR] [--decode-steps N]

For float32 and bf16 in turn: the weights from the serve phase's seed,
its 8 requests of 1,280-1,536 tokens on 4 slots with 32 new tokens each
(``chip_smoke.serve_requests``), then ``--reps`` serve runs
(``chip_smoke.serve_run``: each wave's prefill and each decode step timed
by CUDA events, launches counted, peak device memory), each printed with
its wall s, tok/s, prefill ms a wave and decode ms a step; then one
profile of the first wave's prefill and a decode step
(``chip_smoke.serve_profile``: device ms by kernel group against the
events' ms, and the idle share). ``--decode-steps N`` then prefills the
first wave once through the kernels and once through the plain path and
times N decode steps after each (host clock, synchronised after each
step), with the device allocations (``cudaMalloc``) the steps made.
``--root`` serves with the port of another checkout (for example a
parent commit unpacked with ``git archive`` under ``build/``) on the same
weights and requests; run it beside this checkout's in one call (parent,
change, change, parent) to compare the two on one card. Prints the card,
one line per dtype and run, and a JSON line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs


def decode_after_prefill(torch, cfg, params, requests, impl: str,
                         n: int) -> dict:
    """The first wave prefilled with ``impl``, then ``n`` decode steps
    from its cache, each timed on the host clock to a synchronise: ms a
    step (mean, median, min, max) and the device allocations the steps
    made (``num_device_alloc``)."""
    import torch.nn.functional as F

    from repro_torch.models import init_cache, prefill
    from repro_torch.serve.engine import make_decode_step

    wave = requests[:cs.SERVE_SLOTS]
    T = max(r.prompt.shape[0] for r in wave)
    toks = torch.stack([F.pad(r.prompt, (T - r.prompt.shape[0], 0))
                        for r in wave]).cuda()
    logits, cache = prefill(cfg, params, {"tokens": toks},
                            init_cache(cfg, cs.SERVE_SLOTS, cs.SERVE_MAX_LEN),
                            impl=impl)
    cur = logits.argmax(-1)[:, None]
    step = make_decode_step(cfg)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
    ms = []
    for i in range(n):
        t0 = time.perf_counter()
        cur, _, cache = step(params, cur, cache, T + i)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return dict(impl=impl, steps=n, ms_mean=float(np.mean(ms)),
                ms_median=float(np.median(ms)), ms_min=min(ms),
                ms_max=max(ms),
                device_allocs=torch.cuda.memory_stats().get(
                    "num_device_alloc", 0) - allocs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2,
                    help="serve runs per dtype (default 2)")
    ap.add_argument("--root", type=Path, default=None,
                    help="serve with the port of this checkout instead")
    ap.add_argument("--decode-steps", type=int, default=0,
                    help="decode steps timed after each prefill path "
                         "(default 0: none)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_serve: CUDA is not available", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    print(f"port: {Path(_build.__file__).resolve().parents[3]}")
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config(cs.SERVE_ARCH)
    requests = cs.serve_requests(torch, base.vocab_size)
    rows = []
    for dt_name in ("float32", "bfloat16"):
        cfg = base.replace(dtype=getattr(torch, dt_name))
        gen = torch.Generator(device="cuda").manual_seed(1515)
        params = init_params(cfg, gen, "cuda")
        for rep in range(args.reps):
            r = cs.serve_run(torch, cfg, params, requests, "cuda")
            toks = sum(len(v) for v in r["out"].values())
            dec = r["decode_ms"]
            row = dict(dtype=dt_name, rep=rep, wall_s=r["wall"],
                       tokens=toks, tok_per_s=toks / r["wall"],
                       prefill_ms=r["prefill_ms"],
                       decode_ms_mean=float(np.mean(dec)),
                       decode_ms_min=min(dec), decode_ms_max=max(dec),
                       decode_steps=len(dec), launches=r["launches"],
                       peak_bytes=r["peak"])
            rows.append(row)
            print(f"{dt_name} run {rep}: {r['wall']:.2f} s wall, {toks} "
                  f"tokens, {toks / r['wall']:.1f} tok/s; prefill ms a wave "
                  f"{[round(x, 2) for x in r['prefill_ms']]}; decode ms a "
                  f"step mean {row['decode_ms_mean']:.3f} (min {min(dec):.3f},"
                  f" max {max(dec):.3f}, {len(dec)} steps); launches "
                  f"{r['launches']}; peak device memory "
                  f"{r['peak'] / 1e9:.3f} GB [{card}]", flush=True)
            del r
        p = cs.serve_profile(torch, cfg, params, requests)
        groups = p["prefill_groups"]
        busy = sum(groups.values())
        dec_busy = sum(ms for _, ms, _ in p["decode_kernels"])
        dec_n = sum(n for _, _, n in p["decode_kernels"])
        rows.append(dict(dtype=dt_name, profile=True,
                         prefill_ms=p["prefill_ms"], prefill_groups=groups,
                         prefill_idle=1 - busy / p["prefill_ms"],
                         decode_ms=p["decode_ms"], decode_device_ms=dec_busy,
                         decode_kernels=dec_n,
                         decode_idle=1 - dec_busy / p["decode_ms"]))
        print(f"{dt_name} prefill wave: {p['prefill_ms']:.3f} ms by events, "
              f"device ms attention {groups['attention']:.3f} scan "
              f"{groups['scan']:.3f} matmul {groups['matmul']:.3f} rest "
              f"{groups['rest']:.3f}, total {busy:.3f} (idle share "
              f"{1 - busy / p['prefill_ms']:.3f}); decode step "
              f"{p['decode_ms']:.3f} ms by events, device {dec_busy:.3f} ms "
              f"in {dec_n} kernels (idle share "
              f"{1 - dec_busy / p['decode_ms']:.3f}) [{card}]", flush=True)
        for impl in ("cuda", "torch") if args.decode_steps else ():
            d = decode_after_prefill(torch, cfg, params, requests, impl,
                                     args.decode_steps)
            rows.append(dict(dtype=dt_name, decode=True, **d))
            print(f"{dt_name} decode after the {impl} prefill: "
                  f"{d['steps']} steps, ms a step mean {d['ms_mean']:.3f} "
                  f"median {d['ms_median']:.3f} min {d['ms_min']:.3f} max "
                  f"{d['ms_max']:.3f}; {d['device_allocs']} device "
                  f"allocations [{card}]", flush=True)
        del params, p
        torch.cuda.empty_cache()
    print(json.dumps({"serve": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
