"""Token pipeline: synthetic corpus -> global batches, a copy of
``repro.data.pipeline`` (host code, numpy batches bitwise ``repro``'s;
the train driver moves them to the device).

``SyntheticCorpus`` generates deterministic token shards (seeded per shard
id, so any worker can regenerate any shard — convenient for elastic
rescale and restart). ``TokenPipeline`` composes the corpus with the HCDC
``TieredStore``: each global step consumes one shard through the carousel
prefetcher and yields a host-side numpy batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.data.tiered_store import Shard, SlidingWindowPrefetcher, TieredStore


@dataclass
class SyntheticCorpus:
    vocab_size: int
    seq_len: int
    batch: int          # rows per shard (= global batch per step)
    n_shards: int = 1024

    def shard_sizes(self) -> List[Shard]:
        size = self.batch * (self.seq_len + 1) * 4  # int32 tokens
        return [Shard(sid, float(size)) for sid in range(self.n_shards)]

    def materialize(self, sid: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(sid)
        toks = rng.integers(0, self.vocab_size,
                            (self.batch, self.seq_len + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TokenPipeline:
    def __init__(self, corpus: SyntheticCorpus,
                 store: Optional[TieredStore] = None,
                 epochs: int = 1, seed: int = 0):
        self.corpus = corpus
        self.store = store
        rng = np.random.default_rng(seed)
        schedule: List[int] = []
        for _ in range(epochs):
            schedule.extend(rng.permutation(corpus.n_shards).tolist())
        self.schedule = schedule
        if store is not None:
            store.register(corpus.shard_sizes())
            self.prefetcher = SlidingWindowPrefetcher(store, schedule)
        else:
            self.prefetcher = None
        self._i = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._i >= len(self.schedule):
            raise StopIteration
        if self.prefetcher is not None:
            sid, _wait = self.prefetcher.next_shard()
        else:
            sid = self.schedule[self._i]
        self._i += 1
        return self.corpus.materialize(sid)

    def state(self) -> Dict[str, int]:
        """Checkpointable position (restart resumes mid-epoch)."""
        return {"position": self._i}

    def restore(self, state: Dict[str, int]) -> None:
        self._i = int(state["position"])
        if self.prefetcher is not None:
            self.prefetcher.pos = self._i
