"""Host-side index stream and the process's shard of the data.

Counterpart of textboost_tpu/data/sharding.py.  `ShardedIndexIterator` is
the reference's `Wrapper` (textboost/dataset.py:827-882) for one shard: an
infinite, per-epoch-shuffled index stream.  The port does not stride it
over the processes, as the reference and the JAX package do (`keys[shift::
mod]`): every rank walks the one global stream and takes its rows of each
global batch (data/loader.py), so that a run does not depend on its world
size.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class ShardedIndexIterator:
    def __init__(self, num_examples: int, *, shuffle: bool = True, repeat: bool = True,
                 seed: int = 0):
        self.num_examples = num_examples
        self.shuffle = shuffle
        self.repeat = repeat
        self.seed = seed

    def _epoch_keys(self, epoch: int) -> np.ndarray:
        keys = np.arange(self.num_examples)
        if self.shuffle:
            # Per-epoch deterministic shuffle (dataset.py:858-860).
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(keys)
        return keys

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            for idx in self._epoch_keys(epoch):
                yield int(idx)
            if not self.repeat:
                return
            epoch += 1


def process_shard_info(num_workers: int = 1, worker_id: int = 0, tp: int = 1):
    """(shard_id, num_shards) for this process x dataloader worker: the dp
    index and dp size of the torch.distributed group laid out as (dp, tp)
    (parallel/mesh.py: rank = dp_index * tp + tp_index), so that the ranks
    of a tp group load the same rows; one process without a group."""
    from ..parallel.mesh import rank, world_size

    return rank() // tp * num_workers + worker_id, world_size() // tp * num_workers
