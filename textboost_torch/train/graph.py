"""The train step as a CUDA graph, and where the trainer captures.

Counterpart of textboost_tpu/train/aot.py, which compiles the train step
ahead of time into one XLA program and the validation rounds' sampling
into another (textboost_tpu/pipelines/text_to_image.py::
build_sample_program).  The port records each into a `torch.cuda.CUDAGraph`
once and replays it (textboost_torch/graphs.py): one launch from the host
where an eager step dispatches thousands of kernels from Python.

* `eager_reason` is the envelope of the JAX package's compiled step, plus
  a CUDA device and one process; outside it the step runs eagerly and the
  trainer says why.
* `CapturedStep` runs the trainer's step inside that envelope:
  WARMUP_STEPS eager steps on the capture stream (real steps of the run,
  which also create AdamW's state, cuBLAS's workspaces, the GroupNorm
  plans' occupancy cache and the loaded kernel libraries), then one
  capture, then replays.  Each call copies the batch and the draws into
  static buffers: the flash kernels take their TMA maps as kernel
  parameters, which the graph keeps, so the inputs stay at fixed
  addresses.  After each replay the learning-rate schedule and the
  micro-step count move on the host (train/step.py::TrainStep.finish).
* `validation_eager_reason` decides the validation rounds' sampling graph
  (graphs.py::CapturedSampler over `validation_signature`): inside the
  step's envelope (a tensor-parallel UNet reduces over the host in its
  forward, which no graph holds), and only for a run with enough rounds to
  pay the capture back (VALIDATION_CAPTURE_ROUNDS).

Inside the envelope a failed capture or replay raises: nothing falls back
to eager.  Graphs need CUDA; on the CPU the trainer runs as it did, the
same static-buffer code eagerly.  `graphs.set_capture(False)` turns
capture off (tests and chip_smoke take eager references with it); it is
not a CLI flag, as the JAX package has none for its compiled step.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..graphs import Graph, capture_enabled, static_copy

WARMUP_STEPS = 3

# The validation rounds' sampling graph pays its capture back only over
# enough rounds: a round that captures costs CAPTURE_EXTRA of an eager
# round more than one (the capture, then its replay), and each later
# replay saves REPLAY_SAVING of one.  Measured at the paper's validation
# (sd21base, 16 images of 512 px, 25 DPM-Solver++ steps, CFG 7.5: 2.576 s
# eager, 5.135 s capturing, 2.492 s replayed) by textboost_torch/tools/
# graph_costs.py on an NVIDIA H100 80GB HBM3 at 700 W; sd15's and sd21's
# rounds pay back later still (PERF.md section 5).
CAPTURE_EXTRA = 0.9930
REPLAY_SAVING = 0.0328
# The first round runs eagerly (the capture's warm-up), the second captures.
VALIDATION_CAPTURE_ROUNDS = 2 + math.ceil(CAPTURE_EXTRA / REPLAY_SAVING)  # 33


def eager_reason(cfg, device, world: int = 1, distributed: bool = False) -> Optional[str]:
    """Why the train step of `cfg` runs eagerly on `device` in a launch of
    `world` processes (`distributed`: under torch.distributed), or None when
    it is captured: the envelope of textboost_tpu/train/aot.py::
    launch_step_aot (:132-141), a CUDA device, and the capture switch."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"the device is {device.type} (CUDA graphs need CUDA)"
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
        return "a torch.distributed launch (its gradient all-reduce is not captured)"
    if not capture_enabled():
        return "capture turned off (graphs.set_capture(False))"
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
    if rounds < VALIDATION_CAPTURE_ROUNDS:
        return (f"{rounds} validation rounds, too few to pay a capture back (it pays from "
                f"{VALIDATION_CAPTURE_ROUNDS})")
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
    """The train step (train/step.py::TrainStep) as a CUDA graph: `warmup`
    eager calls on the capture stream, then the capture of `step.body` on
    static copies of the batch and the draws, then replays; after each
    replay `step.finish`.  Returns the step's metrics: after the capture,
    the graph's output tensors, which every replay overwrites.  A failed
    capture raises."""

    def __init__(self, step, device, warmup: int = WARMUP_STEPS, graph: Optional[Graph] = None):
        self.step = step
        self.device = torch.device(device)
        self.warmup = warmup
        self.graph = graph if graph is not None else Graph(self.device)
        self.eager_steps = 0
        self.captured = False
        self._static: Optional[Dict[str, Dict[str, torch.Tensor]]] = None

    def __call__(self, state, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        if not self.captured and self.eager_steps < self.warmup:
            self.eager_steps += 1
            return self.graph.run_eager(lambda: self.step(state, batch, draws))
        if not self.captured:
            static = self._static = {
                "batch": {k: v.clone() for k, v in batch.items()},
                "draws": {k: v.clone() for k, v in draws.items()}}
            try:
                self.graph.capture(lambda: self.step.body(state, static["batch"],
                                                          static["draws"]))
            except Exception as e:
                raise RuntimeError("capturing the train step as a CUDA graph failed (inside "
                                   "the envelope the step does not fall back to eager)") from e
            self.captured = True
        else:
            static_copy(self._static["batch"], batch, "the captured train step's batch")
            static_copy(self._static["draws"], draws, "the captured train step's draws")
        metrics = self.graph.replay()
        self.step.finish(state)
        return metrics

    def stats(self) -> Dict[str, float]:
        return {**self.graph.stats(), "eager_steps": self.eager_steps}

    def release(self) -> None:
        """Drop the graph, its pool and the static buffers; the next call
        warms up again."""
        self.graph = Graph(self.device)
        self.eager_steps, self.captured, self._static = 0, False, None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
