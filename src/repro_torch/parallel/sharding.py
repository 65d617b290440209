"""The single-card part of ``repro.parallel.sharding``: ``ParallelPlan``'s
fields that a step on one card reads and ``plan_for``'s rules for them.

``repro``'s plan also carries the mesh's decisions (FSDP, sequence
sharding of caches and activations, the remat policy knob, the MoE
layer's shard-local dispatch and expert replication) and ``plan_for``
sizes microbatches from the mesh's data-parallel width. None of that has
a counterpart on one card: the mesh, the logical sharding rules and FSDP
wait for a multi-GPU design (``ROADMAP.md`` queue 1 item 3). What stays
is what the train step and the optimizer choice read.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ParallelPlan:
    """Per-arch training decisions on one card."""

    microbatches: int = 1         # grad-accumulation steps in train_step
    optimizer: str = "adamw"      # "adamw" | "adafactor"
    grad_accum_dtype: str = "f32" # "f32" | "bf16": the microbatch sum's type


def plan_for(cfg: ModelConfig) -> ParallelPlan:
    """``repro``'s single-card rules (``plan_for``): Adafactor above 200 B
    parameters (400 GB of bf16 weights), microbatch gradients summed in
    bf16. ``repro``'s ``train_4k`` microbatch count comes from the mesh
    (its 256-row global batch over the data axis); on one card the plan
    keeps one microbatch and the caller sizes the batch."""
    params_b = cfg.param_count() * 2  # bf16 bytes
    return ParallelPlan(
        microbatches=1,
        optimizer="adafactor" if params_b > 200e9 * 2 else "adamw",
        grad_accum_dtype="bf16",
    )
