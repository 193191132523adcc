"""StyleDrop style-personalization sweep runner of the port (the flags of
the root run_textboost_sdrp.py, plus --device).

    python -m textboost_torch.run_textboost_sdrp -m sd21 --sequential

Per style instance, runs `python -m textboost_torch.train` for 150 steps at
batch 4 with the style augmentation ops (`--augment_ops=style`), mixing,
and the style's caption template as --template; launched as
run_textboost_db.py launches its jobs (subprocesses, `--sequential` or
`--parallel N`), with a `cmd.txt` per run dir.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

# (subject_name, per-style template, initializer token), the reference's list.
INSTANCES = [
    ("00", "A seascape and cliffs in {}", "watercolor painting style"),
    ("01", "A house in {}", "watercolor painting style"),
    ("02", "A cat in {}", "watercolor painting style"),
    ("03", "Row of flowers in {}", "watercolor painting style"),
    ("04", "A village in {}", "oil painting style"),
    ("05", "A village in {}", "line drawing style"),
    ("07", "A portrait of a person wearing a hat in {}", "oil painting style"),
    ("08", "A woman walking a dog in {}", "flat cartoon illustration style"),
    ("09", "A woman working on a laptop in {}", "flat cartoon illustration style"),
    ("10", "A Christmas tree in {}", "sticker style"),
    ("11", "A wave in {}", "abstract rainbow colored flowing smoke wave design"),
    ("12", "A mushroom in {}", "glowing style"),
    ("15", "Slices of watermelon and clouds in the background in {}", "3D rendering style"),
    ("16", "A house in {}", "3D rendering style"),
    ("17", "A thumbs up in {}", "glowing style"),
    ("18", "A female figure with exaggerated proportions in {}", "modern 3D rendering style"),
    ("19", "A bear in {} animal", "kid crayon drawing style"),
    ("21", "A flower in {}", "melting golden 3D rendering style"),
    ("22", "A Viking face with beard in {}", "wooden sculpture style"),
]




def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Run TextBoost style experiment")
    parser.add_argument("-g", "--gpu", type=str, default=None,
                        help="comma-separated cards the jobs use (CUDA_VISIBLE_DEVICES); a job "
                        "spans them data-parallel, or with --parallel N each of N jobs takes "
                        "one (default: every visible card)")
    parser.add_argument("-m", "--model", type=str, default="sd21")
    parser.add_argument("--instances", type=str, nargs="+", default=None)
    parser.add_argument("--augment", type=str, default="pda")
    parser.add_argument("--lora-rank", type=int, default=4)
    parser.add_argument("--null-prob", type=float, default=0.1)
    parser.add_argument("--kpl-weight", type=float, default=0.1)
    parser.add_argument("--no-weighted-sample", action="store_true", default=False)
    parser.add_argument("--no-inversion", action="store_true", default=False)
    # The reference's 150/4/25, as flags like the DB runner's --total-steps.
    parser.add_argument("--total-steps", type=int, default=150)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--validation-steps", type=int, default=25)
    parser.add_argument("--checkpointing-steps", type=int, default=25)
    parser.add_argument("--desc", type=str, default=None)
    parser.add_argument("--data-dir", type=str, default="./datasets/styledrop")
    parser.add_argument("--parallel", type=int, default=1,
                        help="run N instances concurrently, each subprocess pinned to one "
                        "GPU by CUDA_VISIBLE_DEVICES")
    parser.add_argument("--sequential", action="store_true",
                        help="run jobs in-process (no subprocess), as "
                        "run_textboost_db --sequential")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(args) -> None:
    instances = ([t for t in INSTANCES if t[0] in args.instances]
                 if args.instances is not None else INSTANCES)
    outdir = f"output/tb_style-{args.model}"
    if args.desc is not None:
        outdir += f"-{args.desc}"
    os.makedirs(outdir, exist_ok=True)
    model = args.model.lower().replace("-", "").replace(".", "")
    run_jobs(args, instances, outdir, model)


def build_cmd(args, name, template, init_token, outdir, model):
    cmd = [
        f"--model_preset={model}",
        f"--instance_data_dir={os.path.join(args.data_dir, name)}",
        f"--output_dir=./{outdir}/{name}",
        "--instance_token=<0>",
        "--validation_prompts",
        "A man in <0>",
        "A cat in <0>",
        "Flowers in <0>",
        "A dog in <0>",
        f"--validation_steps={args.validation_steps}",
        "--placeholder_token", f"<{name}>",
        "--initializer_token", init_token,
        f"--lora_rank={args.lora_rank}",
        "--learning_rate=1e-4",
        "--emb_learning_rate=1e-3",
        f"--train_batch_size={args.batch_size}",
        f"--max_train_steps={args.total_steps}",
        f"--checkpointing_steps={args.checkpointing_steps}",
        "--gradient_accumulation_steps=1",
        f"--augment={args.augment}",
        f"--kpl_weight={args.kpl_weight}",
        f"--null_prob={args.null_prob}",
        "--template", template,
        "--augment_ops=style",
        "--mixing",
        "--mixed_precision=bf16",
    ]
    if not args.no_inversion:
        cmd.append("--augment_inversion")
    if args.no_weighted_sample:
        cmd.append("--disable_weighted_sample")
    return cmd


def run_jobs(args, instances, outdir, model) -> None:
    from .utils.sweep import run_sweep

    run_sweep(args, [(name, build_cmd(args, name, template, init_token, outdir, model))
                     for name, template, init_token in instances], outdir)


if __name__ == "__main__":
    main(parse_args())
