"""Prefetching batch loader.

Counterpart of textboost_tpu/data/loader.py::PrefetchLoader (:58-248), and
of the reference's DataLoader + Wrapper stack (train_textboost.py:872-909):
an infinite stream of collated numpy batches, produced ahead of the train
step by a thread pool.  Determinism: sample i of step s uses
rng = default_rng((seed, s, i)), whatever the threads' scheduling, so the
two packages yield the same bytes, and a resumed run that starts at step s
(`set_start_step`) yields the batches a straight run yields there.

Data parallel: shard k of n yields rows [k*B, (k+1)*B) of the global batch
of n*B: every shard walks the one global index stream and keys each
sample's rng on its global slot, (seed, s, k*B + i).  The shards'
batches, concatenated, are the one-process batch of n*B, so a run does not
depend on its world size.  The trainer's shard is its dp index
(data/sharding.py::process_shard_info), so the ranks of one tensor-parallel
group load the same rows.  (The JAX loader strides the index stream over
the processes, `keys[shard::n]`, and keys the rng on the local slot: its
shards of a one-image dataset are byte-identical, and the prior-prompt
shards are not the one-process batch.)

The JAX loader's worker processes (`num_procs`) are not ported: on an H100
host the paper run's step was no faster with them, and they took seconds
to start (PERF.md).  The threads never touch CUDA.  The JAX package's
DeviceBatchPrefetcher (a ring of device batches) is not ported: the trainer
copies each host batch to the card one step ahead, from pinned memory with
non_blocking.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from .sharding import ShardedIndexIterator


class PrefetchLoader:
    """A thread pool of `num_workers` builds each batch ahead of the step;
    call `stop()` to end the producer."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate: Callable,
        *,
        shard_id: int = 0,
        num_shards: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
    ):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard {shard_id} of {num_shards}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.seed = seed
        self.shard_id, self.num_shards = shard_id, num_shards
        self.indices = ShardedIndexIterator(len(dataset), shuffle=shuffle, repeat=True,
                                            seed=seed)
        self.num_workers = max(1, num_workers)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._start_step = 0

    def set_start_step(self, step: int) -> None:
        """Start the stream at batch `step` (a resumed run carries on where
        the checkpoint left it instead of replaying batch 0)."""
        if self._thread is not None:
            raise RuntimeError("set_start_step must come before iteration starts")
        self._start_step = int(step)

    def _produce(self):
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            index_iter = iter(self.indices)
            step = self._start_step
            global_batch = self.batch_size * self.num_shards
            first = self.shard_id * self.batch_size  # this shard's first global slot
            for _ in range(step * global_batch):
                next(index_iter)
            while not self._stop.is_set():
                idxs = [next(index_iter) for _ in range(global_batch)]
                slots = range(first, first + self.batch_size)
                samples = list(pool.map(
                    lambda slot: self.dataset.__getitem__(
                        idxs[slot], rng=np.random.default_rng((self.seed, step, slot))),
                    slots))
                batch = self.collate(samples)
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                step += 1
        except BaseException as e:  # noqa: BLE001 — re-raised by __iter__
            self._error = e
        finally:
            pool.shutdown(wait=False)

    def __iter__(self) -> Iterator[Dict]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._produce, daemon=True)
            self._thread.start()
        while True:
            try:
                yield self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    return
                if self._error is not None:
                    raise self._error
                if not self._thread.is_alive():
                    raise RuntimeError("the prefetch producer stopped")

    def stop(self):
        """End the producer (batches already queued are dropped)."""
        self._stop.set()
