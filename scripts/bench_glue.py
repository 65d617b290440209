#!/usr/bin/env python3
"""Time the sweep tick's completion glue and wait-queue selection on one
GPU, of this checkout's port or of another.

    python3 scripts/bench_glue.py [--reps 3] [--root DIR]

Inputs: ``chip_smoke.py``'s sweep grid (8 lanes x 2 sites x 1,000,000
files), its ``cuda`` tick replayed to tick 600, and on that state the
dense synthetic one (``chip_smoke.dense_glue_state``: about 0.3 of the
planes completing, queued, migrating and waiting). On each state:

- ``complete``: the wrapper of ``tick_glue.ops.complete`` from the same
  state (restored before each call): CUDA-event ms, and by
  ``torch.profiler`` the device µs of ``tg_complete_kernel`` and of
  PyTorch's reductions (``reduce_kernel``: the masked-size sums of a port
  that still takes them); beside them the bound of the bytes it needs
  (``chip_smoke.glue_bytes``) and the device µs of a copy of those bytes
  (what the card streams at that size);
- the wait-queue heads: ``tick_glue.ops.wait_select`` where the port has
  it (device µs of ``tg_wait_select_kernel``), and ``torch.topk`` of the
  tickets (its library call, and what a port without it runs) beside the
  bound of the bytes the selection needs.

``--root`` times the port of another checkout (a parent commit unpacked
with ``git archive`` under ``build/``) with this script's helpers; its
kernels build into its own ``build/``. Prints the card, a line per
reading and one JSON line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: A ticket above every real one (the tick's).
BIG_TICKET = 2 ** 30


def state_at(torch, grid, tick: int):
    """The sweep grid's ``cuda`` loop (replayed) advanced to ``tick``:
    ``(state, constants, now, dt, new_done, comp)``, the last two from the
    next tick's ``transfer_tick`` on that state."""
    from repro_torch.kernels.lane_tick import ops as lt_ops
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.kernels.tick_glue import ops
    from repro_torch.sim.batched import TickLoop

    dev = torch.device("cuda")
    loop = TickLoop(grid, resolve_tick_impl("cuda", dev), dev, graph=True)
    loop.advance(tick)
    st, c = loop.st, loop.c
    t = st["tick"]
    now = c["times"].index_select(0, t).view(())
    dt = c["dts"].index_select(0, t).view(())
    month = c["month_idx"].index_select(0, t).view(())
    probe = {k: v.clone() for k, v in st.items()}
    active, _ = ops.begin(probe, now, dt)
    new_done, comp = lt_ops.transfer_tick(
        probe["tr_link"], active, probe["tr_done"], probe["tr_total"],
        c["sizes"], c["bw"], c["mode"], dt, month, grid.n_months)[:2]
    return st, c, now, dt, new_done, comp


def kernel_us(torch, fn, restore, keys, n: int = 10):
    """Device µs per call of ``fn`` (its state restored before each, the
    restore's own kernels left out) by the profiler, summed over the
    kernels whose name holds each of ``keys``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    restore()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            restore()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return {k: sum(e.self_device_time_total for e in rows if k in e.key) / n
            for k in keys}


def bench_state(torch, label, st0, c, now, dt, new_done, comp, reps):
    from repro_torch.kernels.tick_glue import ops
    from repro_torch.sim.batched import WAIT_ADMITS_PER_TICK as W

    s = {k: v.clone() for k, v in st0.items()}
    work = ops.begin(s, now, dt)[1]

    def restore():
        for key, v in st0.items():
            s[key].copy_(v)
        work.zero_()

    # complete: the wrapper, its kernel and any reductions it launches
    call = lambda: ops.complete(s, c, now, new_done, comp, work)  # noqa: E731
    ms = [cs.restored_ms(torch, call, restore)[0] for _ in range(reps)]
    dev = kernel_us(torch, call, restore, ("tg_complete_kernel",
                                           "reduce_kernel"))
    # the bytes it needs (chip_smoke.glue_bytes on one step's state)
    restore()
    pre = {k: v.clone() for k, v in s.items()}
    call()
    post = {k: v.clone() for k, v in s.items()}
    need = cs.glue_bytes(
        torch, {"begin": pre, "complete": pre, "link_admit": post,
                "migrate": post, "wait_select": post},
        {"complete": post, "link_admit": post, "migrate": post},
        {"now": now, "comp": comp, "limited": c["limited"], "W": W,
         "mig": torch.zeros_like(comp)}, int(work.numel()))["complete"]
    half = torch.empty(need // 8, dtype=torch.float32, device=comp.device)
    dst = torch.empty_like(half)
    copy_us = cs.device_us(torch, lambda: dst.copy_(half), n=10)
    del half, dst
    out = {"complete": dict(ms=ms, kernel_us=dev["tg_complete_kernel"],
                            reduce_us=dev["reduce_kernel"], bytes=need,
                            bound_ms=cs.bound_ms(need, 0.0)[0],
                            copy_device_us=copy_us)}
    print(f"{label}: complete ms {ms} kernel {dev['tg_complete_kernel']:.1f}"
          f" us, reductions {dev['reduce_kernel']:.1f} us; bound "
          f"{out['complete']['bound_ms']:.4f} ms ({need / 1e6:.1f} MB); a "
          f"copy of those bytes {copy_us:.1f} us", flush=True)

    # the wait-queue heads: the kernel where the port has it, and topk
    def topk():
        tickets = torch.where(s["wq_wait"], s["wq_ticket"], BIG_TICKET)
        return torch.topk(tickets, W, dim=-1, largest=False, sorted=True)

    restore()
    sel = {"topk": dict(ms=[cs.time_ms(torch, topk, n=10)
                            for _ in range(reps)],
                        device_us=cs.device_us(torch, topk, n=10))}
    if hasattr(ops, "wait_select"):
        def select():
            return ops.wait_select(s, W, work)
        got = select()
        want = topk()
        check_low = torch.equal(got[0], want.values)
        sel["kernel"] = dict(
            ms=[cs.restored_ms(torch, select, work.zero_)[0]
                for _ in range(reps)],
            device_us=kernel_us(torch, select, work.zero_,
                                ("tg_wait_select_kernel",))[
                "tg_wait_select_kernel"],
            lowest_equal_to_topk=check_low)
    n = s["wq_wait"].numel()
    R = s["disk_used"].numel()
    sel_bytes = n + cs.sector_bytes(torch, s["wq_wait"], 4) + R * W * 12
    sel["bytes"] = sel_bytes
    sel["bound_ms"] = cs.bound_ms(sel_bytes, 0.0)[0]
    sel["waiting"] = int(s["wq_wait"].sum())
    print(f"{label}: wait heads {json.dumps(sel)}", flush=True)
    out["wait_select"] = sel
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3,
                    help="timings of each reading (default 3)")
    ap.add_argument("--root", type=Path, default=None,
                    help="time the port of this checkout instead")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_glue: CUDA is not available", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.core.scenarios import pack_specs
    from repro_torch.kernels import tick_glue

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    port = Path(tick_glue.__file__).resolve().parents[3]
    print(f"port: {port}")
    grid = pack_specs(cs.pricing_specs(0.1, 1_000_000), tick=10.0)
    st, c, now, dt, new_done, comp = state_at(torch, grid,
                                              cs.GLUE_STATE_TICK)
    res = {"port": str(port)}
    res["tick_600"] = bench_state(torch, "sweep state at tick 600", st, c,
                                  now, dt, new_done, comp, args.reps)
    dense, (nd, cm), _ = cs.dense_glue_state(torch, st, c, now)
    res["dense"] = bench_state(torch, "dense synthetic state", dense, c,
                               now, dt, nd, cm, args.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
