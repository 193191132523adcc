"""Single-prompt sampling CLI of the port (the flags of the root inference.py,
plus --device).

    python -m textboost_torch.inference <model dir> --model sd15 \\
        --prompt "photo of a <v*> dog" --seeds 0 1 2 3 --output grid.jpg

Loads a trained TextBoost model dir (PEFT adapter + token bins) over a base
model, samples one prompt across the seeds with DPM-Solver++ in one batched
call, and writes per-seed images or a 1xN grid.  Each seed's latent is drawn
as [1, h, w, 4] from `torch.Generator(device).manual_seed(seed)`: the JAX
package's threefry latents cannot be reproduced, so the two CLIs give
different images for the same seed.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str, help="path to model")
    parser.add_argument("--model", type=str, default="sd21base")
    parser.add_argument(
        "--prompt", type=str, default="photo of a <dog> dog",
        help="[<INSTANCE> SUBJECT] for TextBoost models.",
    )
    parser.add_argument("--outdir", type=str, default="./benchmarks")
    parser.add_argument("--checkpoint", type=int, default=None)
    parser.add_argument("--skip-gen", action="store_true")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--guidance-scale", type=float, default=7.5)
    parser.add_argument("--lora-rank", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def generate(args: argparse.Namespace) -> np.ndarray:
    """Load the model dir and sample the prompt once per seed, all seeds in
    one batch.  Returns uint8 [N, H, W, 3]."""
    from .device import resolve_device
    from .pipelines.loading import load_textboost_pipeline

    device = resolve_device(args.device)
    pipeline = load_textboost_pipeline(
        args.path.rstrip("/"), args.model, checkpoint=args.checkpoint,
        lora_rank=args.lora_rank, device=device,
    )
    lh = lw = pipeline.spec.resolution // 8
    latents = torch.cat([
        torch.randn((1, lh, lw, 4), generator=torch.Generator(device).manual_seed(s),
                    device=device)
        for s in args.seeds
    ])
    return pipeline(
        [args.prompt] * len(args.seeds),
        num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale,
        latents=latents,
    )


def main(args: argparse.Namespace) -> None:
    from PIL import Image

    images = list(generate(args))
    if args.output is not None:
        Image.fromarray(np.concatenate(images, axis=1)).save(args.output)
        print(f"Saved grid to {args.output}")
    else:
        for seed, image in zip(args.seeds, images):
            output = args.prompt.replace(" ", "_") + f"_{seed}.jpg"
            Image.fromarray(image).save(output)
            print(f"Saved {output}")


if __name__ == "__main__":
    main(parse_args())
