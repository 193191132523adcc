"""The (dp, tp) mesh over torch.distributed: the axes of
textboost_tpu/parallel/mesh.py, one process per card (the reference ran
one torchrun/NCCL process per card, train_textboost.py:560-565,918-926,1108).

    python -m torch.distributed.run --nproc_per_node 2 -m textboost_torch.train ... [--mesh_tp 2]

The world is laid out as the JAX mesh's `reshape(dp, tp)`: rank =
dp_index * tp + tp_index.  The tp ranks of one dp index form a
tensor-parallel group (parallel/tensor.py shards the frozen UNet and text
encoder over it); they load the same rows and draw the same noise.  Each
dp index loads its rows of the global batch (data/loader.py), runs the
step on them, and `GradReducer` averages what trains once per micro-step,
before the gradient surgery, the clip and AdamW, so that every rank
applies the same update.  Rank 0 alone writes files.

No `DistributedDataParallel`: it would reduce the whole [vocab, hidden]
token-embedding gradient (202 MB per step at sd21base), where only the
LoRA weights, the added embedding rows (and the UNet's LoRA, when it
trains) change.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import graphs

logger = logging.getLogger("textboost_torch")

# What torchrun (python -m torch.distributed.run) sets in each rank's environment.
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether this process is a rank of a torchrun launch."""
    return all(k in os.environ for k in LAUNCH_ENV)


def choose_backend(device_type: str, local_world: int, cards: int) -> str:
    """NCCL when the ranks run on CUDA with a card each; gloo when ranks
    share a card (NCCL refuses two ranks on one device) or run on the CPU."""
    return "nccl" if device_type == "cuda" and local_world <= cards else "gloo"


def init_distributed(device: str = "cuda") -> Optional[str]:
    """Join the process group of a torchrun launch (its address, world and
    rank from the environment); returns the backend, or None when the
    process was not launched (the world is this one process)."""
    if not launched():
        return None
    if dist.is_initialized():
        return dist.get_backend()
    from ..device import resolve_device

    dev = resolve_device(device)  # under a launch: this rank's card, made current
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, int(os.environ["LOCAL_WORLD_SIZE"]), cards)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", **kwargs)
    msg = (f"torch.distributed: rank {dist.get_rank()} of {dist.get_world_size()} "
           f"(local {os.environ['LOCAL_RANK']} of {os.environ['LOCAL_WORLD_SIZE']}), backend "
           f"{backend}, device {dev}")
    logger.info(msg)
    print(msg, flush=True)
    return backend


@contextlib.contextmanager
def distributed(device: str = "cuda") -> Iterator[Optional[str]]:
    """The block as a rank of a torchrun launch: joins its process group
    (`init_distributed`) unless one is joined already, and leaves it after
    the block when it joined it; yields the backend (None in one process)."""
    owned = not dist.is_initialized() and init_distributed(device) is not None
    try:
        yield dist.get_backend() if dist.is_initialized() else None
    finally:
        if owned:
            dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op in one process)."""
    if dist.is_initialized():
        dist.barrier()


def gather_to_main(value: Any) -> Optional[List[Any]]:
    """Every rank's `value` (any picklable object) on rank 0, in rank order,
    None on the other ranks; [value] in one process.  A collective: every
    rank calls it, in the same order."""
    if not dist.is_initialized():
        return [value]
    out = [None] * dist.get_world_size() if is_main() else None
    dist.gather_object(value, out, dst=0)
    return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (dp, tp) layout, and its groups: the ranks
    of its tp group (one dp index) and of its dp group (one tp index);
    None where the axis has one rank or no process group exists."""

    dp: int
    tp: int
    rank: int
    dp_index: int = 0
    tp_index: int = 0
    tp_group: Optional[dist.ProcessGroup] = dataclasses.field(default=None, compare=False)
    dp_group: Optional[dist.ProcessGroup] = dataclasses.field(default=None, compare=False)


def make_mesh(dp: Optional[int] = None, tp: int = 1, world: Optional[int] = None) -> Mesh:
    """The (dp, tp) layout of `world` processes (default: the launched
    world); dp defaults to world // tp.  The JAX trainer shrinks dp to fit
    the batch (textboost_tpu/train/trainer.py:300-307), but launched
    processes cannot be shrunk, so a mismatch raises.  At tp > 1 under a
    process group, every rank creates every tp group, then every dp group,
    in the same order (`new_group` is collective)."""
    world = world_size() if world is None else world
    dp = dp or max(world // tp, 1)
    if dp * tp != world:
        raise ValueError(
            f"--mesh_dp {dp} x --mesh_tp {tp} = {dp * tp} processes, but {world} were "
            f"launched: multi-card training runs one process per card (python -m "
            f"torch.distributed.run --nproc_per_node {dp * tp} -m textboost_torch.train ...)")
    r = rank()
    groups = {}
    if tp > 1 and dist.is_initialized():
        for name, members in (
                [("tp_group", range(d * tp, (d + 1) * tp)) for d in range(dp)]
                + [("dp_group", range(t, world, tp)) for t in range(tp)]):
            group = dist.new_group(list(members))
            if r in members:
                groups[name] = group
    return Mesh(dp=dp, tp=tp, rank=r, dp_index=r // tp, tp_index=r % tp, **groups)


class GradReducer:
    """The data-parallel reduce of one micro-step: `(loss, aux) ->
    (loss, aux)` averaged over the ranks, with the trainable gradients
    averaged in place.  One flat fp32 buffer holds the gradients of
    `params` (the LoRA weights), the added rows `[first_added_id:]` of the
    embedding's gradient and the step's loss scalars; one all_reduce(SUM)
    over it, then a division by the world size.  Under tensor parallelism
    the ranks of a tp group hold equal copies of all of these but the
    gradients of the `params` in `tp_partial` (the UNet's LoRA on a
    column-parallel to_k / to_v: each rank holds its heads' part), which
    are summed over the tp group and averaged over dp: the one world sum,
    divided by dp.  Under
    gloo a CUDA buffer goes through a pinned host copy.  `calls` and
    `bytes` count the reduces, `replayed` those a CUDA graph of the step
    ran (over NCCL at world 1, the all-reduce inside the graph: counted at
    each replay through graphs.per_replay, as the kernels' launches are),
    `milliseconds()` the time of each reduce that ran eagerly (a graph's
    are not timed)."""

    SCALARS = ("den_loss", "kpl", "prior_loss")

    def __init__(self, embedding: torch.nn.Parameter, first_added_id: int,
                 params: Sequence[torch.nn.Parameter],
                 tp_partial: Sequence[torch.nn.Parameter] = (), tp: int = 1):
        self.embedding = embedding
        self.first_added_id = first_added_id
        self.params = list(params)
        self.world = world_size()
        partial = {id(p) for p in tp_partial} if tp > 1 else set()
        # Each gradient's divisor, in buffer order (the embedding's rows first).
        self.divisors = [self.world] + [self.world // tp if id(p) in partial else self.world
                                        for p in self.params]
        self.calls = 0
        self.bytes = 0
        self.replayed = 0
        self._host_ms: List[float] = []
        self._marks: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._host: Optional[torch.Tensor] = None

    def gradients(self) -> List[torch.Tensor]:
        """The reduced gradients (views into `.grad`), in buffer order."""
        for p in self.params:
            if p.grad is None:  # a weight the loss did not reach: its zero gradient
                p.grad = torch.zeros_like(p)
        return [self.embedding.grad[self.first_added_id:]] + [p.grad for p in self.params]

    def values(self) -> int:
        """The number of values one reduce moves."""
        return (self.embedding[self.first_added_id:].numel()
                + sum(p.numel() for p in self.params) + 1 + len(self.SCALARS))

    def _all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        if flat.is_cuda and dist.get_backend() == "gloo":
            if self._host is None or self._host.numel() != flat.numel():
                self._host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            self._host.copy_(flat)
            dist.all_reduce(self._host)
            return flat.copy_(self._host)
        dist.all_reduce(flat)
        return flat

    def prepare_capture(self) -> None:
        """Before the step's capture: an eager reduce has run, so the
        backend's communicator exists (NCCL makes it at the first
        collective; a capture cannot)."""
        if self.calls == 0:
            raise RuntimeError("the all-reduce is captured before any ran eagerly: its "
                               "communicator is made by the first, eager one")

    def _count(self, nbytes: int, replayed: bool) -> None:
        self.calls += 1
        self.bytes += nbytes
        self.replayed += replayed

    def milliseconds(self) -> List[float]:
        """Each eager reduce's time: on a card, CUDA events on its stream
        around the all_reduce (the wait for the other ranks and gloo's host
        copies included); on the CPU, the host clock."""
        for _, end in self._marks:
            end.synchronize()
        return self._host_ms + [a.elapsed_time(b) for a, b in self._marks]

    def __call__(self, loss: torch.Tensor,
                 aux: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        grads = self.gradients()
        scalars = [loss] + [aux[k] for k in self.SCALARS]
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [s.reshape(1).float() for s in scalars])
        captured = graphs.capturing()
        timed = flat.is_cuda and not captured
        if timed:
            marks = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            marks[0].record()
        t0 = time.perf_counter()
        flat = self._all_reduce(flat)
        if timed:
            marks[1].record()
            self._marks.append(marks)
        elif not captured:
            self._host_ms.append(1e3 * (time.perf_counter() - t0))
        offset = 0
        for g, divisor in zip(grads, self.divisors):
            g.copy_(flat[offset:offset + g.numel()].div_(divisor).view_as(g))
            offset += g.numel()
        flat[offset:].div_(self.world)
        loss, *rest = flat[offset:]
        graphs.per_replay(functools.partial(self._count, flat.numel() * flat.element_size(),
                                            captured))
        return loss, {**aux, **dict(zip(self.SCALARS, rest))}
