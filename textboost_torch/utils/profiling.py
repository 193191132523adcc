"""Step timing and device memory of the train loop.

`StepTimer` is a copy of textboost_tpu/utils/profiling.py::StepTimer
(:31-49): rolling steps/sec and wall time on the host clock, logged with the
training metrics.  On the card the loop runs ahead of the device until a
metrics fetch synchronises it, so a window's mean step time is right and a
single step's is not.
"""
from __future__ import annotations

import collections
import time
from typing import Dict

import torch


class StepTimer:
    """Rolling steps/sec + wall time, logged alongside training metrics."""

    def __init__(self, window: int = 50):
        self.times = collections.deque(maxlen=window)
        self.start = time.perf_counter()
        self._last = self.start

    def tick(self) -> Dict[str, float]:
        now = time.perf_counter()
        self.times.append(now - self._last)
        self._last = now
        dt = sum(self.times) / len(self.times)
        return {
            "step_time_ms": dt * 1000.0,
            "steps_per_sec": 1.0 / dt if dt > 0 else 0.0,
            "wall_time_s": now - self.start,
        }


def device_memory_stats(device: torch.device) -> Dict[str, float]:
    """Allocated and peak device memory in GiB (empty off CUDA)."""
    if device.type != "cuda":
        return {}
    return {
        "dev0_bytes_in_use_gib": torch.cuda.memory_allocated(device) / 2**30,
        "dev0_peak_bytes_in_use_gib": torch.cuda.max_memory_allocated(device) / 2**30,
    }
