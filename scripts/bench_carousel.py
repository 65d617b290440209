#!/usr/bin/env python3
"""Time the port's carousel tick engine (``simulate_ticks``) on one GPU.

    python3 scripts/bench_carousel.py [--reps 3] [--chunks 8,16,32,64,128]
                                      [--root DIR]

Inputs of ``chip_smoke.py``'s carousel phase (``chip_smoke.carousel_inputs``,
seed 4101): 1,000,000 transfers, every one in flight, on 6 links, half
shared and half per-transfer, dt = 10 s, 1,000 ticks.

Per rep: ``simulate_ticks`` on the ``cuda`` path as a caller runs it, ticks/s
on the host clock around the whole call (for the tick engine: its count,
warm-up, capture and replays), and its final state and every tick's
completions held bitwise to the plain engine's. Where the checkout has
the tick engine (``ops.CarouselEngine``), first the steps of its first
run in the process (``first_call``), and after each rep, for each chunk of
``--chunks``: the engine in its steady state (``chip_smoke.engine_steady``:
ticks/s and ms a tick without the capture, wall and device microseconds a
tick over at least 100 ticks, the idle share, the capture's milliseconds);
where it has not (a parent checkout), ``simulate_ticks`` over 128 ticks on
the host clock and again under ``torch.profiler``, for the same wall,
device time and idle share. ``--root`` times the port of another checkout
(for example a parent commit unpacked with ``git archive`` under
``build/``) with this script's inputs and helpers. Prints the card, one
line per measurement and a JSON line. Needs CUDA.
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

N, M, N_TICKS, DT = 1_000_000, 6, 1000, 10.0


def whole_call(torch, ops, args, want) -> float:
    """Ticks/s of one ``simulate_ticks`` call on the ``cuda`` path, its
    result held bitwise to ``want``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ops.simulate_ticks(*args, DT, N_TICKS, tick_impl="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for g, w in zip(got, want):
        cs.check(torch.equal(g, w), "simulate_ticks: not bitwise to the "
                                    "plain engine")
    return N_TICKS / wall


def first_call(torch, ops, args, want) -> dict:
    """Seconds of each step of the tick engine's first run in this process,
    each step synchronised: loading the kernel library, building the
    engine (copies, buffers, the count), the warm-up ticks, the first
    chunk (its capture and replay), the ticks left; the result held
    bitwise to ``want``."""
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    step("load", ops._LIB.get)
    engine = step("build", lambda: ops.CarouselEngine(*args, DT, N_TICKS))
    step("warm-up", lambda: engine.advance(ops.ENGINE_WARMUP_TICKS))
    step("first chunk", lambda: engine.advance(engine.chunk))
    step("rest", lambda: engine.advance(N_TICKS - engine.t))
    steps["capture"] = engine.capture_s
    for g, w in zip((engine.active, engine.done, engine.completions), want):
        cs.check(torch.equal(g, w), "engine: not bitwise to the plain "
                                    "engine")
    return steps


def loop_profile(torch, ops, args, n: int = 128) -> dict:
    """Wall and device time a tick of ``simulate_ticks`` over ``n`` ticks
    (a checkout without the tick engine: one Python loop a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        ops.simulate_ticks(*args, DT, n, tick_impl="cuda")
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_us = 1e6 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / n
    return dict(wall_us=wall_us, busy_us=busy_us,
                idle=1 - busy_us / wall_us)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3,
                    help="repetitions of each measurement (default 3)")
    ap.add_argument("--chunks", default="8,16,32,64,128",
                    help="engine chunk sizes to measure (default "
                         "8,16,32,64,128)")
    ap.add_argument("--root", type=Path, default=None,
                    help="time the port of this checkout instead")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_carousel: CUDA is not available", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels.carousel_update import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"port: {Path(ops.__file__).resolve().parents[4]}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4101)
    inputs = cs.carousel_inputs(torch, gen, N, M)
    want = ops.simulate_ticks(*inputs, DT, N_TICKS, tick_impl="torch")
    engine = hasattr(ops, "CarouselEngine")
    default = getattr(ops, "ENGINE_CHUNK", None)
    out = {"whole_call_ticks_per_s": [], "steady": {}}
    if engine:
        out["first_call_s"] = first_call(torch, ops, inputs, want)
        print("first run of the engine in this process, seconds by step: "
              + ", ".join(f"{k} {v:.5f}"
                          for k, v in out["first_call_s"].items()))
    for rep in range(args.reps):
        tps = whole_call(torch, ops, inputs, want)
        out["whole_call_ticks_per_s"].append(tps)
        print(f"rep {rep}: simulate_ticks {tps:.1f} ticks/s (whole call)")
        if not engine:
            p = loop_profile(torch, ops, inputs)
            out["steady"].setdefault("loop", []).append(p)
            print(f"rep {rep}: loop over 128 ticks: wall {p['wall_us']:.2f} "
                  f"us/tick, device {p['busy_us']:.2f} us/tick, idle share "
                  f"{p['idle']:.3f}")
            continue
        for chunk in (int(c) for c in args.chunks.split(",")):
            ops.ENGINE_CHUNK = chunk  # the whole calls keep the default
            try:
                st = cs.engine_steady(torch, ops, inputs, DT, N_TICKS,
                                      want=want)
            finally:
                ops.ENGINE_CHUNK = default
            out["steady"].setdefault(str(chunk), []).append(st)
            print(f"rep {rep} chunk {chunk}: {st['ticks_per_s']:.1f} "
                  f"ticks/s steady ({st['ms']:.5f} ms/tick by events), "
                  f"capture {st['capture_ms']:.2f} ms; over {st['window']} "
                  f"ticks "
                  f"wall {st['wall_us']:.2f} us/tick, device "
                  f"{st['busy_us']:.2f} us/tick (engine kernel "
                  f"{st['tick_us']:.2f}), idle share {st['idle']:.3f}, "
                  f"active share {st['active_share']:.4f}, bound "
                  f"{st['window_bound_us']:.2f} us/tick")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
