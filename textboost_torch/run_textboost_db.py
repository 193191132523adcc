"""DreamBooth 30-instance sweep runner of the port (the flags of the root
run_textboost_db.py, plus --device).

    python -m textboost_torch.run_textboost_db -m sd21base --sequential

Per instance, composes the paper's training flags (250 steps, batch 8, LoRA
r=4, imagenet_small templates, paired augmentation with inversion) with
`build_cmd` and runs `python -m textboost_torch.train` on them: one
subprocess per instance (default), in-process one after the other
(`--sequential`), or in waves of N subprocesses with one GPU each
(`--parallel N`).  With more than one card visible (`-g 0,1`, as the
reference's runner named torchrun's cards), a subprocess job trains over
them data-parallel under `python -m torch.distributed.run`
(utils/sweep.py), and with `--mesh-tp T` each group of T cards splits the
frozen models tensor-parallel (the cards must divide into such groups).  Each run dir gets a `cmd.txt` naming the command that
ran (the module, its flags and --device); the JAX runner's copy of the
training script is not made (the package is the repo's).
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

# (subject_name, class, initializer token prefix), the reference's list.
INSTANCES = [
    ("backpack", "backpack", "red"),
    ("backpack_dog", "backpack", "character"),
    ("bear_plushie", "stuffed animal", "bear"),
    ("berry_bowl", "bowl", "white"),
    ("can", "can", "beer"),
    ("candle", "candle", "jar"),
    ("cat", "cat", "orange"),
    ("cat2", "cat", "gray"),
    ("clock", "clock", "yellow"),
    ("colorful_sneaker", "sneaker", "color"),
    ("dog", "dog", "corgi"),
    ("dog2", "dog", "fluffy"),
    ("dog3", "dog", "poodle"),
    ("dog5", "dog", "dachshund"),
    ("dog6", "dog", "corgi"),
    ("dog7", "dog", "retriever"),
    ("dog8", "dog", "border collie"),
    ("duck_toy", "toy", "rubber"),
    ("fancy_boot", "boot", "fringe"),
    ("grey_sloth_plushie", "stuffed animal", "sloth"),
    ("monster_toy", "toy", "stuffed"),
    ("pink_sunglasses", "glasses", "pink"),
    ("poop_emoji", "toy", "poop"),
    ("rc_car", "toy", "car"),
    ("red_cartoon", "cartoon", "devil"),
    ("robot_toy", "toy", "robot"),
    ("shiny_sneaker", "sneaker", "rainbow"),
    ("teapot", "teapot", "brown"),
    ("vase", "vase", "red"),
    ("wolf_plushie", "stuffed animal", "dog"),
]

RESOLUTION = {"sd14": 512, "sd15": 512, "sd21base": 512, "sd21": 768, "tiny": 128}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Run TextBoost experiment")
    parser.add_argument("-g", "--gpu", type=str, default=None,
                        help="comma-separated cards the jobs use (CUDA_VISIBLE_DEVICES); a job "
                        "spans them data-parallel, or with --parallel N each of N jobs takes "
                        "one (default: every visible card)")
    parser.add_argument("-n", "--num-samples", type=int, default=1)
    parser.add_argument("-m", "--model", type=str, default="sd21base")
    parser.add_argument("--instances", type=str, nargs="+", default=None)
    parser.add_argument("--lora-rank", type=int, default=4)
    parser.add_argument("--total-steps", type=int, default=250)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--emb-lr", type=float, default=1e-3)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--train-params", type=str, default="none")
    parser.add_argument("--augment", type=str, default="pda")
    parser.add_argument("--augment-p", type=float, default=0.5)
    parser.add_argument("--null-prob", type=float, default=0.1)
    parser.add_argument("--kpl-weight", type=float, default=0.1)
    parser.add_argument("--no-weighted-sample", action="store_true", default=False)
    parser.add_argument("--no-inversion", action="store_true", default=False)
    parser.add_argument("--mixing", action="store_true", default=False)
    parser.add_argument("--desc", type=str, default=None)
    parser.add_argument("--data-dir", type=str, default="datasets/dreambooth_n1_train")
    parser.add_argument("--mesh-tp", type=int, default=1,
                        help="tensor parallel: split the frozen UNet and text encoder over "
                        "groups of T cards (a subprocess job over a multiple of T cards)")
    parser.add_argument("--sequential", action="store_true",
                        help="run in-process instead of one subprocess per instance")
    parser.add_argument("--parallel", type=int, default=1,
                        help="run N instances concurrently, each subprocess pinned to one "
                        "GPU by CUDA_VISIBLE_DEVICES")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--outdir", type=str, default=None,
                        help="sweep output dir (default output/tb-<model>-<n>)")
    parser.add_argument("--validation-steps", type=int, default=None,
                        help="override validation cadence (default total_steps//5; 0 disables)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def build_cmd(args, name, cls, init_token, outdir):
    model = args.model.lower().replace("-", "").replace(".", "")
    resolution = RESOLUTION.get(model, 512)
    init_token = f"{init_token} {cls}"
    identifier = "<0>"
    val_steps = (args.validation_steps if getattr(args, "validation_steps", None) is not None
                 else args.total_steps // 5)
    cmd = [
        f"--model_preset={model}",
        f"--instance_data_dir={os.path.join(args.data_dir, name)}",
        f"--output_dir={os.path.join(outdir, name)}",
        f"--class_token={cls}",
        f"--instance_token={identifier}",
        f"--validation_steps={val_steps}",
        f"--placeholder_token=<{name}>",
        f"--initializer_token={init_token}",
        "--validation_prompts",
        f"photo of a {identifier}",
        f"a {identifier} in the jungle",
        f"a {identifier} in the bucket",
        f"painting of a {identifier} in the Monet style",
        f"--resolution={resolution}",
        f"--lora_rank={args.lora_rank}",
        f"--learning_rate={args.lr}",
        f"--emb_learning_rate={args.emb_lr}",
        f"--train_batch_size={args.batch_size}",
        f"--max_train_steps={args.total_steps}",
        f"--checkpointing_steps={args.total_steps // 5}",
        "--gradient_accumulation_steps=1",
        f"--unet_params_to_train={args.train_params}",
        f"--augment={args.augment}",
        f"--augment_p={args.augment_p}",
        f"--null_prob={args.null_prob}",
        f"--kpl_weight={args.kpl_weight}",
        "--template=imagenet_small",
        "--mixed_precision=bf16",
        f"--mesh_tp={args.mesh_tp}",
    ]
    if args.num_samples is not None:
        cmd.append(f"--num_samples={args.num_samples}")
    if not args.no_inversion:
        cmd.append("--augment_inversion")
    if args.no_weighted_sample:
        cmd.append("--disable_weighted_sample")
    if args.augment == "none":
        cmd.append("--center_crop")
    if args.mixing:
        cmd.append("--mixing")
    return cmd


def main(args) -> None:
    from .utils.sweep import run_sweep

    instances = ([t for t in INSTANCES if t[0] in args.instances]
                 if args.instances is not None else INSTANCES)
    num_str = "all" if args.num_samples is None else f"n{args.num_samples}"
    if args.outdir:
        outdir = args.outdir
    else:
        outdir = f"output/tb-{args.model}-{num_str}"
        if args.desc is not None:
            outdir += f"-{args.desc}"
    os.makedirs(outdir, exist_ok=True)
    run_sweep(args, [(name, build_cmd(args, name, cls, init_token, outdir))
                     for name, cls, init_token in instances], outdir)


if __name__ == "__main__":
    main(parse_args())
