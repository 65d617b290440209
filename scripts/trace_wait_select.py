#!/usr/bin/env python3
"""Where ``tg_wait_select``'s time goes on one GPU: per-block timestamps
of an instrumented build of the kernel, in the replayed sweep tick and
alone.

    python3 scripts/trace_wait_select.py [--root DIR] [--ticks 60,600]

Copies the port's ``src/`` (of this checkout, or of ``--root``: a
checkout whose kernel holds the anchors of :data:`STAMPS`, or the script
stops) to ``build/trace_wait_select/`` and adds to ``tg_wait_select_kernel`` a
``%globaltimer`` stamp a block (thread 0) at five points: its start, the
end of its flag stream (after a barrier), its partial list written, its
ticket taken (``last_block``), and, in the launch's last block, the end
of the merge; a C entry point copies the stamps out. The kernel's code is
otherwise the port's, so its time moves by the stamps' own few stores.
Then ``chip_smoke.py``'s sweep grid (8 lanes x 2 sites x 1,000,000 files)
runs its ``cuda`` tick, replayed from its CUDA graph, to each of
``--ticks`` and one tick more, and the stamps of the selection in each
replayed tick are read; then three calls alone on that state with the L2
cache warm, and three with it flushed. Prints, per reading, microseconds
from the first block's start: the 0, 50, 90 and 100% points over the
blocks of each stamp, and the stamps of the block that ended last and of
each row's block 0 (which alone keys the files that do not wait). The
globaltimer advances in steps of about 0.26 µs on an H100. Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: Where the instrumented copy goes (``build/`` is not committed).
TRACE_DIR = ROOT / "build" / "trace_wait_select"

KERNEL = "repro_torch/kernels/tick_glue/csrc/tick_glue.cu"

#: (anchor, replacement) pairs that add the stamps; each anchor must
#: occur exactly once in the kernel source.
STAMPS = (
    ("template <int C>\n__global__ void __launch_bounds__(kThreads, C <= 4 ? "
     "kFlagBlocksPerSm : 1)\ntg_wait_select_kernel(",
     "__device__ unsigned long long g_stamps[65536 * 5];\n"
     "__device__ __forceinline__ unsigned long long stamp() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n\n"
     "template <int C>\n__global__ void __launch_bounds__(kThreads, C <= 4 ? "
     "kFlagBlocksPerSm : 1)\ntg_wait_select_kernel("),
    ("  int64_t k[C];\n#pragma unroll\n  for (int j = 0; j < C; ++j) "
     "k[j] = kNoKey;\n  for_each_flag<",
     "  const int64_t bid = static_cast<int64_t>(r) * gridDim.x + "
     "blockIdx.x;\n  if (threadIdx.x == 0) g_stamps[bid * 5] = stamp();\n"
     "  int64_t k[C];\n#pragma unroll\n  for (int j = 0; j < C; ++j) "
     "k[j] = kNoKey;\n  for_each_flag<"),
    ("  int64_t* part = keys + (static_cast<int64_t>(r) * nb + blockIdx.x) "
     "* C;\n",
     "  __syncthreads();\n  if (threadIdx.x == 0) g_stamps[bid * 5 + 1] = "
     "stamp();\n  int64_t* part = keys + (static_cast<int64_t>(r) * nb + "
     "blockIdx.x) * C;\n"),
    ("  if (!last_block(work.ticket_wait)) return;\n",
     "  __syncthreads();\n  if (threadIdx.x == 0) g_stamps[bid * 5 + 2] = "
     "stamp();\n  const bool last = last_block(work.ticket_wait);\n"
     "  if (threadIdx.x == 0) g_stamps[bid * 5 + 3] = stamp();\n"
     "  if (!last) return;\n"),
    ("      idx[q * W + j0] = i;\n    }\n  }\n}\n",
     "      idx[q * W + j0] = i;\n    }\n  }\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) g_stamps[bid * 5 + 4] = stamp();\n}\n"),
    ("const char* tg_error_string(int code) {",
     "int tg_wait_stamps(void* dst, long long n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, n * 8));"
     "\n}\n\nconst char* tg_error_string(int code) {"),
)

#: Bytes written to leave the selection's planes out of the L2 cache (50
#: MB on an H100).
L2_FLUSH_BYTES = 128 << 20

#: The stamps' names, in order.
POINTS = ("start", "stream end", "list written", "ticket", "merge end")


def instrument(src: Path) -> Path:
    """A copy of ``src`` (a checkout's ``src/``) under :data:`TRACE_DIR`
    with the stamps in ``tg_wait_select_kernel``; its kernels build into
    this checkout's ``build/repro_torch``. Returns the copy's ``src``."""
    if TRACE_DIR.exists():
        shutil.rmtree(TRACE_DIR)
    dst = TRACE_DIR / "src"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    (TRACE_DIR / "build").symlink_to(ROOT / "build")
    path = dst / KERNEL
    text = path.read_text()
    for anchor, new in STAMPS:
        n = text.count(anchor)
        if n != 1:
            raise SystemExit(f"trace_wait_select: {n} matches of an anchor "
                             f"in {KERNEL}: {anchor[:60]!r}")
        text = text.replace(anchor, new)
    path.write_text(text)
    return dst


def report(torch, lib, label: str, R: int, nb: int) -> dict:
    """The stamps of the last launch: per point the 0/50/90/100% points
    over the blocks, the last block's and block 0's, in µs from the first
    start."""
    torch.cuda.synchronize()
    n = R * nb * 5
    buf = torch.zeros(n, dtype=torch.int64, device="cuda")
    err = lib.tg_wait_stamps(buf.data_ptr(), n)
    if err != 0:
        raise RuntimeError(f"tg_wait_stamps: CUDA error {err}")
    t = buf.view(R * nb, 5).cpu().double()
    t = (t - t[:, 0].min()) / 1e3
    qs = torch.tensor([0.0, 0.5, 0.9, 1.0], dtype=torch.float64)
    last = int(t[:, 4].argmax())
    out = {"label": label, "blocks_a_row": nb,
           "points": {p: [round(float(v), 2)
                          for v in torch.quantile(t[:, i], qs)]
                      for i, p in enumerate(POINTS[:4])},
           "last_block": {"row": last // nb, "block": last % nb,
                          **{p: round(float(t[last, i]), 2)
                             for i, p in enumerate(POINTS)}},
           "block0_stream_end": [round(float(v), 2)
                                 for v in torch.quantile(t[0::nb, 1], qs)]}
    print(f"{label}: {out}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="trace the port of this checkout")
    ap.add_argument("--ticks", default="60,600",
                    help="ticks to read the replayed tick at")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("trace_wait_select: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(instrument(args.root.resolve() / "src")))
    from repro_torch.core.scenarios import pack_specs
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.kernels.tick_glue import ops
    from repro_torch.sim.batched import WAIT_ADMITS_PER_TICK as W
    from repro_torch.sim.batched import TickLoop

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    ticks = sorted(int(x) for x in args.ticks.split(","))
    grid = pack_specs(cs.pricing_specs(0.25, 1_000_000), tick=10.0)
    loop = TickLoop(grid, resolve_tick_impl("cuda", dev), dev, graph=True)
    lib = ops._LIB.get()
    lib.tg_wait_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.tg_wait_stamps.restype = ctypes.c_int
    L, S, F = loop.st["wq_wait"].shape
    R = L * S
    nb = ops.flag_blocks(F, R, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    for tick in ticks:
        loop.advance(tick - loop.t)
        for _ in range(2):
            waiting = int(loop.st["wq_wait"].sum())
            report(torch, lib, f"replayed tick {loop.t} ({waiting} files "
                   f"waiting)", R, nb)
            loop.advance(1)
    st = loop.st
    work = ops.begin(st, torch.tensor(0.0, device=dev),
                     torch.tensor(10.0, device=dev))[1]
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    for cold in (False, True):
        for i in range(3):
            if cold:
                flush.zero_()
            work.zero_()
            ops.wait_select(st, W, work)
            report(torch, lib, f"alone at tick {loop.t}, "
                   f"{'L2 flushed' if cold else 'L2 warm'} ({i})", R, nb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
