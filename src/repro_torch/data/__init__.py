"""Data substrate: HCDC tiered store and token pipeline, host code (the
port's copy of ``repro.data``)."""

from repro_torch.data.pipeline import SyntheticCorpus, TokenPipeline
from repro_torch.data.tiered_store import Shard, TieredStore, TierSpec

__all__ = ["TieredStore", "TierSpec", "Shard", "TokenPipeline",
           "SyntheticCorpus"]
