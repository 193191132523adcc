"""The traced part of a `--trace 1` run: torch.profiler over a few steps or
calls of the window, its chrome trace written to a file, and the numbers
the per-layer metrics read from it.

The traced span is a host annotation (`portbench.traced`) that opens after
the device has drained and closes after it has drained again, so that it
holds every device operation of the traced work.  Device operations are the
trace's kernels, memcpys and memsets; `busy_us` is the length of their
union inside the span, the rest is idle.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
from typing import Dict, List, Optional, Tuple

import torch

SPAN = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation", "python_function")
TOP = 10


class Tracer:
    """start() / stop() around the traced work; finish(), once the window
    has closed, writes the trace and sets `summary`."""

    def __init__(self, path: str):
        self.path = path
        self.prof = None
        self.span = None
        self.summary: Optional[Dict] = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.span = torch.profiler.record_function(SPAN)
        self.span.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.stop()

    def finish(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        with open(self.path) as f:
            self.summary = summarize(json.load(f))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(trace: Dict) -> Dict:
    """{"window_us", "busy_us", "kernels": {name: [count, us]} (kernels only),
    "device_ops" (the TOP kernels longest in total, [name, s]), "idle_gaps" (the TOP longest gaps
    inside the span, [host op running at the gap's middle, s])}."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"the trace holds no {SPAN!r} span")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    kernels: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    device = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if e["cat"] == "kernel":
                kernels[e["name"]][0] += 1
                kernels[e["name"]][1] += b - a
            if b > t0 and a < t1:
                device.append((max(a, t0), min(b, t1)))
    busy = _union(device)
    gaps, last = [], t0
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if t1 > last:
        gaps.append((last, t1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and e.get("name") != SPAN))
    starts = [h[0] for h in host]

    def host_at(t: float) -> str:
        inner = None
        for a, b, name in host[:bisect.bisect_right(starts, t)]:
            if a <= t <= b and (inner is None or a >= inner[0]):
                inner = (a, name)
        return inner[1] if inner else "(no host op)"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_us": t1 - t0,
        "busy_us": sum(b - a for a, b in busy),
        "kernels": {k: list(v) for k, v in kernels.items()},
        "device_ops": [[k, v[1] / 1e6] for k, v in sorted(kernels.items(),
                                                          key=lambda kv: -kv[1][1])[:TOP]],
        "idle_gaps": [[host_at((a + b) / 2), (b - a) / 1e6] for a, b in longest],
    }
