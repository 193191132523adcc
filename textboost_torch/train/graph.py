"""The train step as a CUDA graph, and where the trainer captures.

Counterpart of textboost_tpu/train/aot.py, which compiles the train step
ahead of time into one XLA program and the validation rounds' sampling
into another (textboost_tpu/pipelines/text_to_image.py::
build_sample_program).  The port records each into a `torch.cuda.CUDAGraph`
once and replays it (textboost_torch/graphs.py): one launch from the host
where an eager step dispatches thousands of kernels from Python.

* Two envelopes.  `eager_reason` is where the step is captured: where the
  JAX trainer jits it (textboost_tpu/train/trainer.py:728: every config,
  the UNet's LoRA, the image prior and accumulation included) less what
  one card can neither hold nor check: tensor parallelism, more than one
  process (capture across NCCL ranks waits for a check on two cards), the
  gloo backend (its all-reduce goes through a host copy), a device other
  than CUDA, and `graphs.set_capture(False)`.  An NCCL launch at world 1
  is captured, its all-reduce inside the graph.  `envelope_reason` is the
  memo's: textboost_tpu/train/aot.py:132-141's gate (no UNet LoRA, no
  image prior, tp 1, no accumulation, one process, and no torch.distributed
  launch), where aot.py compiles ahead of time and keeps its memo.
* `CapturedStep` runs the trainer's step inside the capture envelope:
  WARMUP_STEPS eager steps on the capture stream (real steps of the run,
  WARMUP_STEPS x --gradient_accumulation_steps micro-steps, which also
  create AdamW's state, the accumulation buffers, cuBLAS's workspaces, the
  GroupNorm plans' occupancy cache, the loaded kernel libraries and the
  NCCL communicator), then one capture per micro-step position (train/
  step.py::micro_step_position: "only" without accumulation, else "first",
  "middle", "last": at most three graphs in one memory pool, captured and
  replayed in that order), then replays; the host picks a micro-step's
  graph by the micro-step count.  Each call copies the batch and the draws
  into static buffers, which every position's graph reads: the flash
  kernels take their TMA maps as kernel parameters, which the graph keeps,
  so the inputs stay at fixed addresses.  After each replay the
  learning-rate schedule and the micro-step count move on the host
  (train/step.py::TrainStep.finish).
* `validation_eager_reason` decides the validation rounds' sampling graph
  (graphs.py::CapturedSampler over `validation_signature`): inside the
  step's envelope (a tensor-parallel UNet reduces over the host in its
  forward, which no graph holds), and only for a run with enough rounds to
  pay the capture back (graphs.VALIDATION_CAPTURE_ROUNDS).

* `_AOT_MEMO` is the counterpart of aot.py's memo of the same name
  (:80-124), keyed by `_memo_key` (the config without
  `_PER_INSTANCE_FIELDS`, the spec, the device, the dtype, the vocabulary
  size, the first added id and the step's eager reason).  An entry
  (`MemoEntry`) holds what the step reads: the trainable and the frozen
  text encoder, the UNet, the VAE, the optimizer and its state, the null
  embedding, the target norm, the original rows and the step itself (a
  `CapturedStep` with its graph and static buffers).  The next instance of
  a `--sequential` sweep with the same key binds itself into those tensors
  in place (trainer.py) and replays from its first step, with no warm-up
  and no capture.  It keeps one entry (`_AOT_MEMO_MAX`), where aot.py
  keeps 6: an entry there is a compiled program, here it pins its graph's
  pool and the step's state on the card (about 10.7 GiB at sd21base, 512
  px, PERF.md), so a new key releases the old entry before its instance
  warms up and captures, and a sweep holds no more than the parent's one
  instance at a time.  The memo serves aot.py's envelope
  (`envelope_reason`) on every device, and no config outside it, as
  aot.py:144-150 looks its memo up only inside its gate (on the CPU the
  entry holds the eager step, so that the binding is tested there); an
  entry is taken by one
  trainer at a time and handed back when its run ends.  The validation
  rounds' sampling graph is not kept: the trainer releases it at the run's
  end.  Tests clear the memo with
  `monkeypatch.setattr(graph, "_AOT_MEMO", {})`.

Inside the capture envelope a failed capture or replay raises: nothing
falls back to eager.  Graphs need CUDA; on the CPU the trainer runs the
same static-buffer code eagerly.  `graphs.set_capture(False)` turns
capture off (tests and chip_smoke take eager references with it); it is
not a CLI flag, as the JAX package has none for its compiled step.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import graphs
from ..graphs import Graph, capture_enabled, run_eager, static_copy
from .step import micro_step_position

WARMUP_STEPS = 3

def eager_reason(cfg, device, world: int = 1, backend: Optional[str] = None) -> Optional[str]:
    """Why the train step of `cfg` runs eagerly on `device` in a launch of
    `world` processes over `backend` (the torch.distributed backend, None
    without a launch), or None when it is captured: the JAX trainer's
    compiled step (every config) less what one card cannot hold or check."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"the device is {device.type} (CUDA graphs need CUDA)"
    if cfg.mesh_tp > 1:
        return f"--mesh_tp {cfg.mesh_tp}"
    if world > 1:
        return f"{world} processes (capture across NCCL ranks waits for a check on two cards)"
    if backend is not None and backend != "nccl":
        return f"the {backend} backend (its all-reduce goes through a host copy)"
    if not capture_enabled():
        return "capture turned off (graphs.set_capture(False))"
    return None


def envelope_reason(cfg, world: int = 1, distributed: bool = False) -> Optional[str]:
    """Why `cfg` in a launch of `world` processes is outside the envelope of
    the JAX package's ahead-of-time compile (aot.py:132-141, and no
    torch.distributed launch), or None: where the memo keeps its entries."""
    if cfg.unet_params_to_train != "none":
        return f"--unet_params_to_train {cfg.unet_params_to_train}"
    if cfg.with_image_prior:
        return "--with_image_prior"
    if cfg.mesh_tp > 1:
        return f"--mesh_tp {cfg.mesh_tp}"
    if cfg.gradient_accumulation_steps > 1:
        return f"--gradient_accumulation_steps {cfg.gradient_accumulation_steps}"
    if world > 1:
        return f"{world} processes"
    if distributed:
        return "a torch.distributed launch"
    return None


def validation_rounds(cfg, start_step: int = 0) -> int:
    """The validation rounds a run from `start_step` holds: one at every
    multiple of --validation_steps up to --max_train_steps."""
    if not (cfg.validation_prompts and cfg.validation_steps):
        return 0
    return cfg.max_train_steps // cfg.validation_steps - start_step // cfg.validation_steps


def validation_eager_reason(cfg, step_reason: Optional[str], rounds: int) -> Optional[str]:
    """Why the validation rounds' sampling runs eagerly, or None when its
    graph is captured (at the second of `rounds` rounds): the step's
    envelope (`step_reason`, `eager_reason`'s answer), and a capture that
    pays back over the rounds left."""
    if step_reason is not None:
        return step_reason
    if rounds < graphs.VALIDATION_CAPTURE_ROUNDS:
        return (f"{rounds} validation rounds, too few to pay a capture back (it pays from "
                f"{graphs.VALIDATION_CAPTURE_ROUNDS})")
    return None


def validation_signature(cfg, spec) -> Optional[Tuple]:
    """The (batch, height, width, steps, do_cfg, sampler) of the trainer's
    validation rounds (textboost_tpu/train/aot.py::validation_signature):
    25 steps at CFG 7.5 over every prompt's images; None when validation
    is off."""
    if not (cfg.validation_prompts and cfg.validation_steps):
        return None
    batch = len(cfg.validation_prompts) * max(cfg.num_validation_images, 1)
    res = spec.resolution
    return (batch, res, res, 25, True, cfg.validation_scheduler)


class CapturedStep:
    """The train step (train/step.py::TrainStep) as CUDA graphs: `warmup`
    whole steps (`warmup` x `accumulate` micro-steps) run eagerly on the
    capture stream, then each micro-step position (step.py::
    micro_step_position) is captured at its first call, `step.body` on
    static copies of the batch and the draws, and replayed; after each
    replay `step.finish`.  The positions' graphs share one memory pool.
    Returns the step's metrics: after the capture, the position's graph's
    output tensors, which its next replay overwrites.  A failed capture
    raises.  `new_graph()` makes a position's graph (default: a
    `graphs.Graph` on the shared pool; tests pass a stand-in)."""

    def __init__(self, step, device, warmup: int = WARMUP_STEPS, accumulate: int = 1,
                 new_graph: Optional[Callable[[], Graph]] = None):
        self.step = step
        self.device = torch.device(device)
        self.warmup = warmup
        self.accumulate = max(accumulate, 1)
        self.graphs: Dict[str, Graph] = {}  # by micro-step position, in capture order
        self.eager_steps = 0  # micro-steps
        self._new_graph = new_graph
        self._pool = None
        self._static: Optional[Dict[str, Dict[str, torch.Tensor]]] = None

    @property
    def captured(self) -> bool:
        return bool(self.graphs)

    @property
    def replays(self) -> int:
        """Micro-step replays, over every position's graph."""
        return sum(g.replays for g in self.graphs.values())

    def _make_graph(self) -> Graph:
        if self._new_graph is not None:
            return self._new_graph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return Graph(self.device, self._pool)

    def __call__(self, state, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        if not self.graphs and self.eager_steps < self.warmup * self.accumulate:
            self.eager_steps += 1
            return run_eager(self.device, lambda: self.step(state, batch, draws))
        if self._static is None:
            self._static = {"batch": {k: v.clone() for k, v in batch.items()},
                            "draws": {k: v.clone() for k, v in draws.items()}}
        else:
            static_copy(self._static["batch"], batch, "the captured train step's batch")
            static_copy(self._static["draws"], draws, "the captured train step's draws")
        position = micro_step_position(state.step, self.accumulate) if self.accumulate > 1 \
            else "only"
        graph = self.graphs.get(position)
        if graph is None:
            static = self._static
            graph = self._make_graph()
            try:
                if hasattr(self.step, "prepare_capture"):
                    self.step.prepare_capture()
                graph.capture(lambda: self.step.body(state, static["batch"], static["draws"]))
            except Exception as e:
                raise RuntimeError(f"capturing the train step ({position} micro-step) as a CUDA "
                                   f"graph failed (inside the envelope the step does not fall "
                                   f"back to eager)") from e
            self.graphs[position] = graph
        metrics = graph.replay()
        self.step.finish(state)
        return metrics

    def stats(self) -> Dict[str, float]:
        """The graphs' number, capture ms and pool bytes (summed over the
        positions), micro-step replays and eager micro-steps."""
        per = [g.stats() for g in self.graphs.values()]
        out = {key: sum(s[key] for s in per) for key in ("capture_ms", "pool_bytes")
               if per and all(s.get(key) is not None for s in per)}
        return {**out, "graphs": len(per), "replays": self.replays,
                "eager_steps": self.eager_steps}

    def release(self) -> None:
        """Drop the graphs, their pool and the static buffers; the next call
        warms up again."""
        self.graphs = {}
        self._pool = None
        self.eager_steps, self._static = 0, None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


# -- the cross-instance memo (textboost_tpu/train/aot.py::_AOT_MEMO) ----------
# Config fields that cannot change what the step reads or how: host paths,
# token strings (the step sees only the vocabulary size and the first added
# id, which the key carries), trackers and resume state.  A copy of aot.py's
# set; every other field splits the key.
_PER_INSTANCE_FIELDS = frozenset({
    "instance_data_dir", "class_data_dir", "output_dir", "logging_dir",
    "placeholder_token", "instance_token", "initializer_token",
    "class_token", "concepts_list", "resume_from_checkpoint",
    "human_prompts_path", "report_to", "null_embedding_path",
})
_AOT_MEMO: dict = {}
_AOT_MEMO_MAX = 1  # aot.py keeps 6; one entry here pins GiBs (module docstring)


def _memo_key(kind, cfg, spec, device, dtype, *extra) -> Tuple:
    """aot.py::_memo_key with the device in place of the mesh."""
    cfg_d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else vars(cfg)
    cfg_items = tuple((k, repr(v)) for k, v in sorted(cfg_d.items())
                      if k not in _PER_INSTANCE_FIELDS)
    return (kind, cfg_items, repr(spec), str(torch.device(device)), str(dtype), extra)


@dataclasses.dataclass
class MemoEntry:
    """What one instance's step reads, kept for the next instance with the
    same key, which copies its own values into these tensors in place."""

    text_encoder: Any  # trainable: its grown fp32 table and LoRA adapters
    frozen_text_encoder: Any
    unet: Any
    vae: Any
    optimizer: torch.optim.Optimizer
    null_embedding: torch.Tensor
    target_norm: torch.Tensor
    original_rows: torch.Tensor
    train_step: Any  # CapturedStep (its graph and static buffers) or the eager step
    busy: bool = True  # taken by a trainer


def memo_take(key: Tuple) -> Optional[MemoEntry]:
    """The entry of `key`, now taken; None when there is none or another
    trainer holds it."""
    entry = _AOT_MEMO.get(key)
    if entry is None or entry.busy:
        return None
    entry.busy = True
    return entry


def memo_put(key: Tuple, entry: MemoEntry) -> None:
    """Keep `entry` (taken) under `key`; the oldest entries past
    _AOT_MEMO_MAX are evicted, their graphs released at once (a taken one's
    when it is handed back)."""
    while len(_AOT_MEMO) >= _AOT_MEMO_MAX:
        old = _AOT_MEMO.pop(next(iter(_AOT_MEMO)))
        if not old.busy:
            _release(old)
    _AOT_MEMO[key] = entry


def memo_give_back(key: Tuple, entry: MemoEntry) -> None:
    """A run that took `entry` has ended: the next instance may take it."""
    entry.busy = False
    if _AOT_MEMO.get(key) is not entry:  # evicted meanwhile
        _release(entry)


def memo_drop(key: Tuple) -> None:
    """Drop and release the entry of `key` (a run that failed with it)."""
    entry = _AOT_MEMO.pop(key, None)
    if entry is not None:
        _release(entry)


def release_memo() -> None:
    """Drop and release every entry."""
    while _AOT_MEMO:
        _release(_AOT_MEMO.pop(next(iter(_AOT_MEMO))))


def _release(entry: MemoEntry) -> None:
    if isinstance(entry.train_step, CapturedStep):
        entry.train_step.release()


@torch.no_grad()
def copy_module_(dst: torch.nn.Module, src: torch.nn.Module, skip=()) -> None:
    """Copy `src`'s parameters and buffers into `dst`'s in place (names in
    `skip` apart); nothing when they are one module."""
    if dst is src:
        return
    theirs = dict(itertools.chain(src.named_parameters(), src.named_buffers()))
    for name, t in itertools.chain(dst.named_parameters(), dst.named_buffers()):
        if name not in skip:
            t.copy_(theirs[name])


@torch.no_grad()
def reset_optimizer_(optimizer: torch.optim.Optimizer) -> None:
    """The optimizer's state as a fresh one's first update finds it, in
    place: AdamW's moments and step count zero (a fresh optimizer creates
    them as zeros at its first step)."""
    for state in optimizer.state.values():
        for value in state.values():
            if isinstance(value, torch.Tensor):
                value.zero_()
