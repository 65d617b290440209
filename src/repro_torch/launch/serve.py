"""Serving entry point: batched greedy decoding on a (reduced) model, the
port's counterpart of ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --requests 8

Serves the arch's smoke config with random weights (a generator seeded 0)
and random 16-token prompts (request ``i`` from a generator seeded ``i``)
on the CUDA device, through the attention and Mamba-scan kernels;
``--device cpu`` runs the plain PyTorch path on the CPU. Every decoder
arch serves (a vision one on its text alone, as ``ServeLoop`` feeds tokens
only); the enc-dec one (seamless-m4t) needs encoder frames, which
``ServeLoop`` has no place for, and exits with its ``ValueError``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import canonical, get_smoke_config
from repro_torch.kernels.registry import resolve_device
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeLoop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(canonical(args.arch))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    loop = ServeLoop(cfg, params, batch_slots=args.slots,
                     max_len=args.max_len)
    reqs = [
        Request(rid=i,
                prompt=torch.randint(0, cfg.vocab_size, (16,),
                                     generator=torch.Generator().manual_seed(i)),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.time()
    out = loop.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
