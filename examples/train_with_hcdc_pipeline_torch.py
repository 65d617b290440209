"""End-to-end driver on the PyTorch port: train a (reduced) model for a few
hundred steps with the HCDC tiered data pipeline feeding batches,
checkpointing + restart.

The port's counterpart of ``examples/train_with_hcdc_pipeline.py``. The
tiered store meters every shard fetch: first epoch reads hit the archival
tier; later epochs hit the cloud cold tier (cheaper + faster) — the
training-loop incarnation of the paper's cfg-III result. The run prints
the loss curve and the storage/cost report. It trains on the CUDA device,
the attention kernel forward and its plain version backward; ``--device
cpu`` runs the plain PyTorch path on the CPU.

    python examples/train_with_hcdc_pipeline_torch.py [--steps 200] [--device cpu]

The default checkpoint directory is ``repro_torch_ckpt`` in the temporary
directory (``/tmp`` unless ``TMPDIR`` says otherwise), never the JAX
example's: the two write the same layout.
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import train  # noqa: E402

BATCH, SEQ, LOG_EVERY = 8, 64, 20


def run(arch: str, steps: int, ckpt_dir: str, device=None,
        impl: str = "auto") -> dict:
    """``launch.train.train`` at the example's settings (the arch's smoke
    config, 8 x 64 tokens a step, the tiered store, a checkpoint every 10
    steps); returns its record: losses, wall seconds, store statistics,
    data wait."""
    return train(arch, steps=steps, reduced=True, batch=BATCH, seq=SEQ,
                 ckpt_dir=ckpt_dir, use_store=True, log_every=LOG_EVERY,
                 device=device, impl=impl)


def main(argv=None) -> dict:
    """Train and print the report; return ``run``'s record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", type=str, default="qwen3_4b")
    ap.add_argument("--ckpt-dir", type=str,
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    out = run(args.arch, args.steps, args.ckpt_dir, args.device)

    print(f"\nfinal loss: {out['final_loss']:.4f} "
          f"(first: {out['losses'][0]:.4f}) wall={out['wall_s']:.1f}s")
    s = out["store_stats"]
    print("HCDC store: "
          f"archival_reads={s['archival_reads']} cold_hits={s['cold_hits']} "
          f"hot_hits={s['hot_hits']} migrated={s['migrated_bytes']/1e9:.2f}GB "
          f"cold_egress=${s['cold_egress_usd']:.4f} "
          f"stragglers_refetched={s['straggler_refetches']}")
    print(f"data wait total: {out['data_wait_s']:.2f}s (simulated fetch "
          f"latency absorbed by the carousel prefetcher)")
    return out


if __name__ == "__main__":
    main()
