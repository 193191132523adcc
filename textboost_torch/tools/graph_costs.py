"""What the CUDA graphs cost and save in a training run, on the card.

    python -m textboost_torch.tools.graph_costs [--trees OLD_TREE] [--configs paper sd15 sd21]
        [--json OUT]

For each configuration, `python -m textboost_torch.train`'s trainer runs
STEPS steps with a validation round every CADENCE (ROUNDS rounds), each run
a process of its own: with capture off (every step and round eager), with
capture on (the step captured after its warm-up steps; the validation
rounds' graph forced on, captured at the second round and replayed at the
later ones, whatever graphs.py::VALIDATION_CAPTURE_ROUNDS says), and,
for each tree of `--trees` (an older checkout of this repository, for
instance the parent commit unpacked with `git archive`), that tree's own
trainer as it stands.  Each process reports torch.cuda.max_memory_reserved
(what the caching allocator and the graphs' private pools held: what a
smaller card must fit) and max_memory_allocated over the run, each
validation round's wall seconds (synchronized), and the graphs' numbers.

The configurations are the paper's flags (`run_textboost_db.py::build_cmd`
with the runner's defaults: sd21base, 512 px, batch 8, four validation
prompts of four images, DPM-Solver++), the same at sd15, and sd21 at
768 px with PNDM validation and --augment_device; all bf16, random weights
from --seed 0, no checkpoints.  The summary gives, from this tree's eager
and captured runs of one configuration, what a capturing round costs more
than an eager round (CAPTURE_EXTRA, a fraction of the eager round) and what
a replay saves (REPLAY_SAVING): the numbers behind VALIDATION_CAPTURE_ROUNDS.
Prints one JSON line a process and a summary with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

STEPS = 10
CADENCE = 2
ROUNDS = STEPS // CADENCE
PROMPTS = ("photo of a <0>", "a <0> in the jungle", "a <0> in the bucket",
           "a <0> on a beach")

_CHILD_PROGRAM = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch

mode, flags = sys.argv[1], sys.argv[2:]
from textboost_torch.train import main, trainer as trainer_mod
if mode == "eager":
    from textboost_torch.graphs import set_capture
    set_capture(False)
elif mode == "captured":
    from textboost_torch import graphs
    graphs.VALIDATION_CAPTURE_ROUNDS = 2
rounds = []
real = trainer_mod.Trainer.run_validation

def timed(self, step):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = real(self, step)
    torch.cuda.synchronize()
    rounds.append(time.perf_counter() - t0)
    return out

trainer_mod.Trainer.run_validation = timed
t0 = time.perf_counter()
result = main(flags)
wall = time.perf_counter() - t0
print("GRAPH_COSTS " + json.dumps({
    "mode": mode, "wall_s": wall, "reserved_bytes": torch.cuda.max_memory_reserved(),
    "allocated_bytes": torch.cuda.max_memory_allocated(), "validation_s": rounds,
    "graphs": {k: v for k, v in result.items() if "graph" in k}}), flush=True)
"""


def config_flags(name: str, instance_dir: str, output_dir: str):
    flags = [
        "--model_preset=sd21base", f"--instance_data_dir={instance_dir}",
        f"--output_dir={output_dir}", "--class_token=teapot", "--instance_token=<0>",
        f"--validation_steps={CADENCE}", "--placeholder_token=<teapot>",
        "--initializer_token=brown teapot", "--validation_prompts", *PROMPTS,
        "--resolution=512", "--lora_rank=4", "--learning_rate=0.0001",
        "--emb_learning_rate=0.001", "--train_batch_size=8", f"--max_train_steps={STEPS}",
        "--checkpointing_steps=0", "--gradient_accumulation_steps=1",
        "--unet_params_to_train=none", "--augment=pda", "--augment_p=0.5", "--null_prob=0.1",
        "--kpl_weight=0.1", "--template=imagenet_small", "--mixed_precision=bf16",
        "--mesh_tp=1", "--num_samples=1", "--augment_inversion", "--report_to=none", "--seed=0"]
    if name == "sd15":
        flags[0] = "--model_preset=sd15"
    elif name == "sd21":
        flags[0] = "--model_preset=sd21"
        flags[flags.index("--resolution=512")] = "--resolution=768"
        flags += ["--augment_device", "--validation_scheduler=PNDMScheduler"]
    return flags


def run(tree: str, mode: str, flags, timeout: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", _CHILD_PROGRAM, mode, *flags], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("GRAPH_COSTS ")]
    if proc.returncode or not lines:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"{tree} {mode}: exit {proc.returncode}")
    return json.loads(lines[-1][len("GRAPH_COSTS "):])


def summary(eager: dict, captured: dict) -> dict:
    """CAPTURE_EXTRA and REPLAY_SAVING from one configuration's eager and
    captured runs: the eager run's rounds 2-ROUNDS are the warm eager round,
    the captured run's round 2 captures, its rounds 3-ROUNDS replay."""
    warm = sum(eager["validation_s"][1:]) / (ROUNDS - 1)
    capture = captured["validation_s"][1]
    replay = sum(captured["validation_s"][2:]) / (ROUNDS - 2)
    return {"eager_round_s": warm, "capture_round_s": capture, "replay_round_s": replay,
            "capture_extra": (capture - warm) / warm, "replay_saving": (warm - replay) / warm}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trees", nargs="*", default=[], help="older checkouts to run beside this one")
    p.add_argument("--configs", nargs="+", default=["paper", "sd15", "sd21"],
                   choices=["paper", "sd15", "sd21"])
    p.add_argument("--json", default=None, help="write every run's numbers here")
    p.add_argument("--timeout", type=int, default=900, help="seconds a process")
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    runs = []
    with tempfile.TemporaryDirectory() as work:
        instance_dir = os.path.join(work, "instance")
        os.makedirs(instance_dir)
        image = np.random.default_rng(1).integers(0, 256, (768, 768, 3), dtype=np.uint8)
        Image.fromarray(image).save(os.path.join(instance_dir, "teapot.png"))
        for name in args.configs:
            for tree, mode in ([(t, "tree") for t in args.trees]
                               + [(here, "eager"), (here, "captured")]):
                out = os.path.join(work, f"{name}-{len(runs)}")
                r = run(os.path.abspath(tree), mode, config_flags(name, instance_dir, out),
                        args.timeout)
                r.update(config=name, tree=tree)
                runs.append(r)
                print(json.dumps(r), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    for name in args.configs:
        of = {r["mode"] if r["tree"] == here else r["tree"]: r for r in runs
              if r["config"] == name}
        s = summary(of["eager"], of["captured"])
        gib = {k: (round(r["reserved_bytes"] / 2**30, 3), round(r["allocated_bytes"] / 2**30, 3))
               for k, r in of.items()}
        print(f"{name}: peak (reserved, allocated) GiB {gib}; validation round eager "
              f"{s['eager_round_s']:.4f} s, capturing {s['capture_round_s']:.4f} s, replayed "
              f"{s['replay_round_s']:.4f} s: CAPTURE_EXTRA {s['capture_extra']:.4f}, "
              f"REPLAY_SAVING {s['replay_saving']:.4f}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
