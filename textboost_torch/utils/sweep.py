"""Sweep launching for the runners (counterpart of textboost_tpu/utils/sweep.py).

`run_sweep` runs a runner's jobs.  `launch_waves` (`--parallel N`) runs
them in waves of N subprocesses, each pinned to one GPU by
`CUDA_VISIBLE_DEVICES` in the child's environment (set before the child
imports torch: a process that has initialised CUDA ignores it); each
child's output goes to its run dir's `train_stdout.log`.  Otherwise
`run_job` runs one job at a time, in-process (`--sequential`:
`textboost_torch.train.main`, then the trainer's card memory is freed
before the next) or as a subprocess.  Each job is `python -m
textboost_torch.train <flags> --device <device>`; a subprocess job spans
the cards the runner sees (its `-g` list, else every visible card) as one
data-parallel launch, `python -m torch.distributed.run --standalone
--nproc_per_node=gcd(cards, batch)`, as the reference's runner launched
torchrun over `-g`'s cards; with the DB runner's `--mesh-tp T`, T·gcd(cards
/ T, batch) ranks, each tp group of T splitting the frozen models.
"""
from __future__ import annotations

import gc
import math
import os
import subprocess
import sys
from typing import Callable, List, Optional, Sequence, Tuple

TRAIN_MODULE = "textboost_torch.train"
LAUNCHER = "torch.distributed.run"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launch_args(nproc: int = 1) -> List[str]:
    """The `-m` arguments of one job: the trainer, under torchrun on this
    host when it spans `nproc` > 1 processes."""
    if nproc > 1:
        return ["-m", LAUNCHER, "--standalone", f"--nproc_per_node={nproc}", "-m", TRAIN_MODULE]
    return ["-m", TRAIN_MODULE]


def train_command(cmd: List[str], device: str, nproc: int = 1) -> List[str]:
    """The argv of one job's subprocess."""
    return [sys.executable, *launch_args(nproc), *cmd, f"--device={device}"]


def visible_cards(gpus: Optional[str], device: str) -> List[str]:
    """The cards the runner's jobs may use: `-g`'s comma-separated ids, else
    every card this process sees (none for a CPU device)."""
    if not device.startswith("cuda"):
        return []
    if gpus:
        return [g.strip() for g in gpus.split(",") if g.strip()]
    import torch

    return [str(i) for i in range(torch.cuda.device_count())]


def ranks_per_job(cards: int, batch: int, tp: int = 1) -> int:
    """The processes of one subprocess job: one per card, tp per group, as
    many groups as divide the global batch.  Raises when the cards do not
    divide into tp groups."""
    if tp > 1 and (cards < tp or cards % tp):
        raise ValueError(f"--mesh-tp {tp} splits the frozen models over groups of {tp} cards, "
                         f"but {cards} cards are visible: name a multiple of {tp} with -g")
    return tp * math.gcd(cards // tp, batch) if cards > 1 else 1


def archiver(outdir: str, device: str, nproc: int = 1):
    """-> archive(name, cmd): writes the run dir's cmd.txt, one argument a line."""

    def archive(name, cmd):
        run_dir = os.path.join(outdir, name)
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "cmd.txt"), "w") as f:
            f.write("\n".join([" ".join(["python", *launch_args(nproc)]), *cmd,
                               f"--device={device}"]))
    return archive


def run_sweep(args, jobs: Sequence[Tuple[str, List[str]]], outdir: str) -> None:
    """Run a runner's (name, flags) jobs as its flags say: `--parallel N`
    waves of one card each, else one job at a time, in-process with
    `--sequential`, else as a subprocess over the visible cards."""
    cards = visible_cards(args.gpu, args.device)
    if args.parallel > 1 and not args.sequential:
        if len(cards) > args.parallel:
            raise ValueError(
                f"--parallel {args.parallel} runs one card per job, but {len(cards)} cards are "
                f"visible: name {args.parallel} with -g, or drop --parallel to train each job "
                f"over all of them")
        launch_waves(jobs, args.parallel, outdir, archiver(outdir, args.device), device=args.device,
                     dry_run=args.dry_run, cards=cards)
        return
    nproc = (1 if args.sequential
             else ranks_per_job(len(cards), args.batch_size, getattr(args, "mesh_tp", 1)))
    archive = archiver(outdir, args.device, nproc)
    env = {"CUDA_VISIBLE_DEVICES": ",".join(cards)} if args.gpu and cards else {}
    for name, cmd in jobs:
        print(f"=== {name}: python {' '.join(launch_args(nproc))} {' '.join(cmd)}")
        if args.dry_run:
            continue
        run_job(cmd, sequential=args.sequential, device=args.device, nproc=nproc, env=env)
        archive(name, cmd)


def child_env(**extra: str) -> dict:
    """This process's environment with the repo on PYTHONPATH (the children
    run `python -m textboost_torch...`) and `extra` set."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=REPO if not path else f"{REPO}{os.pathsep}{path}",
                **extra)


def launch_waves(
    jobs: Sequence[Tuple[str, List[str]]],
    parallel: int,
    outdir: str,
    archive: Callable[[str, List[str]], None],
    *,
    device: str = "cuda",
    dry_run: bool = False,
    cards: Sequence[str] = (),
) -> int:
    """Run (name, flags) training jobs in waves of `parallel` subprocesses,
    one GPU each: slot k takes `cards[k]` (default: card k; fewer cards
    than slots are shared round-robin).  Returns the
    number of jobs that exited nonzero."""
    failed = 0
    for i in range(0, len(jobs), parallel):
        procs = []
        for slot, (name, cmd) in enumerate(jobs[i:i + parallel]):
            print(f"=== {name}: python -m {TRAIN_MODULE} {' '.join(cmd)}")
            if dry_run:
                continue
            run_dir = os.path.join(outdir, name)
            os.makedirs(run_dir, exist_ok=True)
            log = open(os.path.join(run_dir, "train_stdout.log"), "w")
            proc = subprocess.Popen(train_command(cmd, device), stdout=log,
                                    stderr=subprocess.STDOUT,
                                    env=child_env(CUDA_VISIBLE_DEVICES=(
                                        cards[slot % len(cards)] if cards else str(slot))))
            procs.append((proc, log, name, cmd))
        for proc, log, name, cmd in procs:
            code = proc.wait()
            log.close()
            if code != 0:
                failed += 1
                print(f"!!! {name} exited {code} "
                      f"(see {os.path.join(outdir, name, 'train_stdout.log')})")
            archive(name, cmd)
    return failed


def run_job(cmd: List[str], *, sequential: bool, device: str = "cuda", nproc: int = 1,
            env: Optional[dict] = None) -> None:
    """Run one training job: in-process when `sequential` (the flags list is
    parsed as argv; sys.argv is not touched), else as a subprocess of
    `nproc` ranks with `env` added to its environment."""
    if not sequential:
        subprocess.run(train_command(cmd, device, nproc), check=False,
                       env=child_env(**(env or {})))
        return
    import torch

    from .. import train

    train.main([*cmd, f"--device={device}"])
    # The trainer has handed its memo entry back (the bundle, the step's
    # graph, its optimizer: train/graph.py, models/pretrained.py), which the
    # next job with the same key binds itself into; the rest of it, its
    # loaders and a bundle the memos do not keep are garbage now: free their
    # card memory before the next job, or the peak doubles.
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
