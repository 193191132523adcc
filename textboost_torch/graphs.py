"""CUDA graphs: capture once, replay, and keep the kernels' launch counts.

The port's counterpart of the JAX package's compiled programs: a
`torch.cuda.CUDAGraph` records a function's kernels once and replays them
with one launch from the host, where an eager call dispatches each kernel
from Python.  The train step's graph (train/graph.py::CapturedStep) and
the sampling trajectory's (`CapturedSampler`, which pipelines/
text_to_image.py holds when its caller asks for it) are built on `Graph`.

* A replay makes no Python call, so the kernels' launch counters
  (ops/flash_attention.py, ops/group_norm.py) would miss it: each graph
  records the counters' delta over its capture, takes it back (a capture
  launches nothing), and adds it at every replay (`LaunchDelta`).  Other
  host-side bookkeeping of the captured work (the data-parallel
  all-reduce's counts, parallel/mesh.py) goes through `per_replay`: run at
  once outside a capture, at each replay of the capturing graph inside one.
* Warm-ups and captures run on one side stream per device
  (`capture_stream`).
* A graph reads its inputs at the addresses it was captured at (the flash
  kernels take their TMA maps as kernel parameters, which the graph keeps):
  callers copy each call's inputs into the captured ones (`static_copy`).

Graphs need CUDA.  `set_capture(False)` turns capture off everywhere (tests
and chip_smoke take eager references with it); it is not a CLI flag, as
the JAX package has none for its compiled programs.
"""
from __future__ import annotations

import collections
import contextlib
import math
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from .ops import flash_attention as fa
from .ops import group_norm as gn

MAX_SIGNATURES = 6  # textboost_tpu/train/aot.py::_AOT_MEMO_MAX

# A sampling graph pays its capture back only over enough calls of its
# signature: the call that captures costs CAPTURE_EXTRA of an eager call
# more than one (the capture, then its replay), and each later replay saves
# REPLAY_SAVING of one.  Measured at the paper's validation round (sd21base,
# 16 images of 512 px, 25 DPM-Solver++ steps, CFG 7.5: 2.576 s eager, 5.135 s
# capturing, 2.492 s replayed) by textboost_torch/tools/graph_costs.py on an
# NVIDIA H100 80GB HBM3 at 700 W; sd15's and sd21's rounds pay back later
# still (PERF.md section 5).  The trainer's validation rounds
# (train/graph.py::validation_eager_reason) and the eval's chunks
# (eval/__main__.py::sampler_signatures) name a signature to a
# `CapturedSampler` only from this many calls.
CAPTURE_EXTRA = 0.9930
REPLAY_SAVING = 0.0328
# The first call runs eagerly (the capture's warm-up), the second captures.
VALIDATION_CAPTURE_ROUNDS = 2 + math.ceil(CAPTURE_EXTRA / REPLAY_SAVING)  # 33

_capture = True


def set_capture(enabled: bool) -> None:
    """Capture where a caller asks for graphs on CUDA (the default), or not."""
    global _capture
    _capture = bool(enabled)


def capture_enabled() -> bool:
    return _capture


# -- the kernels' launch counters --------------------------------------------
def launch_counts() -> Dict[str, object]:
    """The four wrappers' launch counts and the flash kernels' variant counts."""
    return {"flash": fa.launches, "flash_bwd": fa.bwd_launches,
            "gn": gn.launches, "gn_bwd": gn.bwd_launches,
            "variants": collections.Counter(fa.variant_counts),
            "bwd_variants": collections.Counter(fa.bwd_variant_counts)}


def set_launch_counts(counts: Dict[str, object]) -> None:
    """Set the counters to `counts` (the variant Counters in place)."""
    fa.launches, fa.bwd_launches = counts["flash"], counts["flash_bwd"]
    gn.launches, gn.bwd_launches = counts["gn"], counts["gn_bwd"]
    for live, value in ((fa.variant_counts, counts["variants"]),
                        (fa.bwd_variant_counts, counts["bwd_variants"])):
        live.clear()
        live.update(value)


class LaunchDelta:
    """The launches one capture counted: taken back when it ends (a capture
    launches nothing) and added at each replay."""

    def __init__(self):
        self.delta: Optional[Dict[str, object]] = None

    @contextlib.contextmanager
    def recording(self):
        before = launch_counts()
        try:
            yield
        finally:
            after = launch_counts()
            self.delta = {key: after[key] - before[key] for key in after}
            set_launch_counts(before)

    def add(self) -> None:
        now = launch_counts()
        set_launch_counts({key: now[key] + self.delta[key] for key in now})


# -- host work a replay repeats -------------------------------------------------
_host_work: Optional[List[Callable[[], None]]] = None  # the capturing graph's


def capturing() -> bool:
    """Whether a graph is capturing: its host work is kept for its replays."""
    return _host_work is not None


def per_replay(fn: Callable[[], None]) -> None:
    """Run `fn` (host-side bookkeeping of device work, such as a counter)
    now, or, while a graph captures, at each of its replays instead: a
    capture runs nothing on the card, and a replay makes no Python call."""
    if _host_work is not None:
        _host_work.append(fn)
    else:
        fn()


@contextlib.contextmanager
def recording_host_work(work: List[Callable[[], None]]):
    """Inside the block, `per_replay` appends to `work` (a capture's)."""
    global _host_work
    outer, _host_work = _host_work, work
    try:
        yield work
    finally:
        _host_work = outer


# -- graphs --------------------------------------------------------------------
_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream that warm-ups and captures run on, one per device."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def run_eager(device, fn: Callable):
    """fn() on the capture stream of a CUDA `device` (a warm-up: the
    workspaces and caches it makes are those the capture then finds), or
    simply fn() elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        return fn()
    stream = capture_stream(device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


class Graph:
    """One CUDA graph.  `capture(fn)` records fn's kernels without running
    them, `replay()` runs them and returns what fn returned at the capture
    (the same tensors each time); warm-ups go through `run_eager`.  Graphs
    given one `pool` share its memory, and must then replay in the order
    they were captured.  Keeps the capture's wall ms, the bytes it reserved
    (its pool's growth), the launches it counted, the host work it
    deferred (`per_replay`) and the replays."""

    def __init__(self, device, pool=None):
        self.device = torch.device(device)
        self.pool = pool
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.outputs = None
        self.launches = LaunchDelta()
        self.host_work: List[Callable[[], None]] = []
        self.replays = 0
        self.capture_ms: Optional[float] = None
        self.pool_bytes: Optional[int] = None

    def capture(self, fn: Callable) -> None:
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        self.host_work = []
        with self.launches.recording(), recording_host_work(self.host_work):
            with torch.cuda.graph(self.graph, pool=self.pool, stream=capture_stream(self.device),
                                  capture_error_mode="thread_local"):
                self.outputs = fn()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

    def replay(self):
        self.graph.replay()
        self.launches.add()
        for fn in self.host_work:
            fn()
        self.replays += 1
        return self.outputs

    def stats(self) -> Dict[str, float]:
        return {"capture_ms": self.capture_ms, "pool_bytes": self.pool_bytes,
                "replays": self.replays}


def static_copy(static: Dict[str, torch.Tensor], values: Dict[str, torch.Tensor],
                what: str) -> None:
    """Copy `values` into the static buffers of a captured graph; raises if
    the keys, shapes or dtypes changed (a graph takes fixed ones)."""
    if set(values) != set(static):
        raise ValueError(f"{what}: the inputs {sorted(values)} are not the captured "
                         f"{sorted(static)}")
    for key, value in values.items():
        if value.shape != static[key].shape or value.dtype != static[key].dtype:
            raise ValueError(f"{what}: input {key} is {value.dtype} {tuple(value.shape)}, the "
                             f"graph was captured at {static[key].dtype} "
                             f"{tuple(static[key].shape)}")
        static[key].copy_(value)


def sampler_key(batch: int, height: int, width: int, steps: int, guidance_scale: float,
                sampler: str) -> Tuple:
    """A sampling call's signature: the key of its graph in a
    `CapturedSampler`.  TextToImagePipeline.__call__ looks its graphs up by
    it, and a caller names the signatures it wants captured with it."""
    return (batch, height, width, steps, guidance_scale > 1.0, sampler, guidance_scale)


class CapturedSampler:
    """Sampling trajectories as CUDA graphs, one for each signature its
    caller names: the counterpart of the JAX package's compiled sampler.  A
    named signature's first call runs eagerly (the capture's warm-up), its
    second captures and replays, later ones replay; any other signature
    runs eagerly.  A capture pays back only over calls that repeat, so a
    caller names a signature (`sampler_key`) only when it knows it repeats
    VALIDATION_CAPTURE_ROUNDS times or more.  At most MAX_SIGNATURES, as the JAX package's
    `_AOT_MEMO_MAX`.  The graphs share one memory pool: a replay's images
    are read before the next replay, so no graph reads what another
    overwrote.

    `__call__(key, guard, fn, inputs)` returns fn(inputs); `guard` names
    what the graph reads besides `inputs` (the weights' addresses), and a
    graph whose guard changed is dropped.  A failed capture raises."""

    def __init__(self, signatures: Iterable[Tuple]):
        self.signatures = set(signatures)
        if len(self.signatures) > MAX_SIGNATURES:
            raise ValueError(f"{len(self.signatures)} sampling signatures, at most "
                             f"{MAX_SIGNATURES}")
        self.entries: Dict[Tuple, Dict] = {}
        self.pool = None

    def __call__(self, key: Tuple, guard, fn: Callable, inputs: Dict[str, torch.Tensor]):
        if key not in self.signatures:
            return fn(inputs)
        entry = self.entries.get(key)
        if entry is not None and entry["guard"] != guard:
            del self.entries[key]
            entry = None
        if entry is None:
            device = next(iter(inputs.values())).device
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            entry = self.entries[key] = {"graph": Graph(device, self.pool), "guard": guard,
                                         "static": None}
            return run_eager(device, lambda: fn(inputs))
        graph = entry["graph"]
        if entry["static"] is None:
            static = entry["static"] = {k: v.clone() for k, v in inputs.items()}
            try:
                graph.capture(lambda: fn(static))
            except Exception as e:
                del self.entries[key]
                raise RuntimeError(f"capturing the sampling trajectory {key} as a CUDA graph "
                                   f"failed") from e
        else:
            static_copy(entry["static"], inputs, f"the captured sampling trajectory {key}")
        return graph.replay()

    def stats(self) -> Dict[Tuple, Dict[str, float]]:
        return {key: entry["graph"].stats() for key, entry in self.entries.items()
                if entry["static"] is not None}

    def release(self) -> None:
        """Drop every graph and the pool."""
        self.entries.clear()
        self.pool = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
