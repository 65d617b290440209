"""Serve a small model with batched requests on the PyTorch port
(continuous batching loop).

The port's counterpart of ``examples/serve_small.py``: greedy-decodes a
wave of prompts through prefill + decode steps with per-layer KV caches
(ring buffers on sliding-window archs), on the CUDA device through the
attention and Mamba-scan kernels; ``--device cpu`` runs the plain PyTorch
path on the CPU.

    python examples/serve_small_torch.py [--arch hymba_1_5b] [--device cpu]

The weights come from a generator seeded 0 on the device and request
``i``'s 12-token prompt from a CPU generator seeded ``100 + i``, so the
tokens are not the JAX example's (whose draws are ``jax.random``'s);
:func:`run` serves any weights and prompts given to it.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import canonical, get_smoke_config  # noqa: E402
from repro_torch.kernels.registry import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve.engine import Request, ServeLoop  # noqa: E402

BATCH_SLOTS, MAX_LEN, PROMPT_LEN = 4, 128, 12


def run(cfg, params, prompts, max_new: int = 8, impl: str = "auto"):
    """Serve ``prompts`` (1-D token tensors, request ``i`` the ``i``-th)
    with ``max_new`` tokens each on ``ServeLoop(cfg, params, 4 slots,
    max_len 128, impl)`` on the device that holds ``params``; returns the
    tokens by request id and the wall seconds (synchronised)."""
    loop = ServeLoop(cfg, params, batch_slots=BATCH_SLOTS, max_len=MAX_LEN,
                     impl=impl)
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    t0 = time.time()
    out = loop.run(reqs)
    if loop.device.type == "cuda":
        torch.cuda.synchronize(loop.device)
    return out, time.time() - t0


def main(argv=None) -> dict:
    """Serve the example's requests and print them; return the tokens by
    request id, the token count, the seconds and the rate."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="hymba_1_5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(canonical(args.arch))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompts = [torch.randint(0, cfg.vocab_size, (PROMPT_LEN,),
                             generator=torch.Generator().manual_seed(100 + i))
               for i in range(args.requests)]

    out, dt = run(cfg, params, prompts, args.max_new)
    total_tokens = sum(len(v) for v in out.values())
    for rid in sorted(out):
        print(f"request {rid}: {out[rid]}")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"\n{len(prompts)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s on {where}, reduced config)")
    return {"tokens": out, "total_tokens": total_tokens, "seconds": dt,
            "tok_per_s": total_tokens / dt, "device": where}


if __name__ == "__main__":
    main()
