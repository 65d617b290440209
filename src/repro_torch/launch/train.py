"""End-to-end training driver on one card, the port's counterpart of
``repro.launch.train``.

Wires together: arch config -> model init -> single-card plan -> HCDC
tiered data pipeline -> train step -> checkpoint manager (+ restart) ->
failure detector. ``--reduced`` (the default) trains the arch's smoke
config; ``--full`` its published config on one card, with
``parallel.plan_for``'s single-card rules and one microbatch: ``repro``'s
``train_4k`` shape (a 256-row global batch over a production mesh) does
not fit one card, so ``--batch`` and ``--seq`` size the step.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --steps 20 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba_1_5b \
      --full --steps 3 --batch 2 --seq 2048

Runs on the CUDA device through the attention and Mamba-scan kernels
(their plain versions in the backward); ``--device cpu`` runs the plain
PyTorch path on the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.ckpt.failover import FailureDetector
from repro_torch.configs import canonical, get_config, get_smoke_config
from repro_torch.core.hotcold import MigrationPolicy
from repro_torch.data.pipeline import SyntheticCorpus, TokenPipeline
from repro_torch.data.tiered_store import TierSpec, TieredStore
from repro_torch.kernels.registry import resolve_device
from repro_torch.models import init_params
from repro_torch.parallel.sharding import ParallelPlan, plan_for
from repro_torch.sim.cloud import GCSCostModel
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step


def make_store() -> TieredStore:
    """Default HCDC tier topology (Table 4 rates scaled to shard sizes)."""
    return TieredStore(
        archival=TierSpec("tape", None, latency_s=1.0, bandwidth=60e6),
        cold=TierSpec("gcs", 50e9, latency_s=0.05, bandwidth=300e6,
                      cost_model=GCSCostModel()),
        hot=TierSpec("ssd", 2e9, latency_s=0.0, bandwidth=1e9),
        migration=MigrationPolicy(min_popularity=0),
    )


def train(arch: str, steps: int = 20, reduced: bool = True,
          batch: int = 8, seq: int = 128, ckpt_dir: Optional[str] = None,
          resume: bool = False, use_store: bool = True,
          log_every: int = 5, device=None,
          impl: str = "auto") -> Dict[str, Any]:
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if reduced else get_config(arch)
    plan = ParallelPlan(microbatches=1) if reduced else plan_for(cfg)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = make_optimizer(plan.optimizer)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, plan, impl=impl)

    corpus = SyntheticCorpus(cfg.vocab_size, seq, batch, n_shards=4 * steps)
    store = make_store() if use_store else None
    pipeline = TokenPipeline(corpus, store=store, epochs=4)

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        state, start, extra = ckpt.restore({"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        pipeline.restore(extra.get("pipeline", {"position": start}))

    detector = FailureDetector(timeout_s=60.0)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        batch_np = next(pipeline)
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch_dev)
        detector.heartbeat("worker-0", time.time())
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f}", flush=True)
        if ckpt and (step + 1) % 10 == 0:
            ckpt.save_async(step + 1, params, opt_state,
                            extra={"pipeline": pipeline.state()})
    if ckpt:
        ckpt.wait()
    out = {
        "losses": losses,
        "wall_s": time.time() - t0,
        "final_loss": losses[-1] if losses else None,
        "store_stats": dict(store.stats) if store else {},
        "data_wait_s": pipeline.prefetcher.total_wait_s if store else 0.0,
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    out = train(canonical(args.arch), steps=args.steps, reduced=args.reduced,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                resume=args.resume, device=args.device)
    print(f"done: final_loss={out['final_loss']:.4f} wall={out['wall_s']:.1f}s "
          f"store={out['store_stats']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
