"""Host-side data-parallel sharding iterator.

A copy of textboost_tpu/data/sharding.py.  Counterpart of `Wrapper`
(reference textboost/dataset.py:827-882): an infinite, per-epoch-shuffled
index stream, strided across (process, worker) shards — `keys[shift::mod]`
with mod = world * workers, shift = rank * workers + worker — with
pad-or-drop remainder handling.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class ShardedIndexIterator:
    def __init__(
        self,
        num_examples: int,
        *,
        shard_id: int = 0,
        num_shards: int = 1,
        shuffle: bool = True,
        repeat: bool = True,
        seed: int = 0,
        drop_remainder: bool = False,
    ):
        assert 0 <= shard_id < num_shards
        self.num_examples = num_examples
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.repeat = repeat
        self.seed = seed
        self.drop_remainder = drop_remainder

    def _epoch_keys(self, epoch: int) -> np.ndarray:
        keys = np.arange(self.num_examples)
        if self.shuffle:
            # Per-epoch deterministic shuffle (dataset.py:858-860).
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(keys)
        shard = keys[self.shard_id :: self.num_shards]
        # Pad-or-drop so every shard sees the same count (dataset.py:862-867).
        per_shard = self.num_examples // self.num_shards
        remainder = self.num_examples % self.num_shards
        if remainder:
            if self.drop_remainder:
                shard = shard[:per_shard]
            else:
                target = per_shard + 1
                if len(shard) < target:
                    pad = shard[: target - len(shard)] if len(shard) else keys[:target]
                    shard = np.concatenate([shard, pad])
        return shard

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            for idx in self._epoch_keys(epoch):
                yield int(idx)
            if not self.repeat:
                return
            epoch += 1


def process_shard_info(num_workers: int = 1, worker_id: int = 0):
    """(shard_id, num_shards) for this process x dataloader worker.  The
    port trains in one process for now, so the world is one process."""
    world, rank = 1, 0
    return rank * num_workers + worker_id, world * num_workers
