"""Checkpoint/restart and failure handling (the port's counterpart of
``repro.ckpt``)."""

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.ckpt.failover import ElasticPlanner, FailureDetector

__all__ = ["CheckpointManager", "FailureDetector", "ElasticPlanner"]
