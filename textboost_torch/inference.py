"""Single-prompt sampling CLI of the port (the flags of the root inference.py,
plus --device).

    python -m textboost_torch.inference <model dir> --model sd15 \\
        --prompt "photo of a <v*> dog" --seeds 0 1 2 3 --output grid.jpg

Loads a trained TextBoost model dir (PEFT adapters + token bins) over a base
model (`--model`: a preset name, a diffusers snapshot dir or the JAX
package's native snapshot dir), samples one prompt across the seeds with
DPM-Solver++ in one batched call, and writes per-seed images or a 1xN grid.
Each seed's latent is drawn as [1, h, w, 4] from
`torch.Generator(device).manual_seed(seed)`: the JAX package's threefry
latents cannot be reproduced, so the two CLIs give different images for the
same seed.

Over several ranks (one process per card, as the trainer launches):

    python -m torch.distributed.run --nproc_per_node 2 -m textboost_torch.inference <model dir> ...

When the seeds divide over the W ranks (the JAX CLI's condition for
sharding its batch over a dp mesh of its devices, inference.py:66-72), rank
r samples the contiguous block seeds[r*n/W:(r+1)*n/W] in one call, as a
dp-sharded batch splits; rank 0 gathers the images in seed order and alone
writes them.  Otherwise rank 0 samples every seed, as the JAX CLI then runs
the batch on one device, and the other ranks wait for it.  A rank's images
are the bits a one-process run over its seeds gives; against all seeds in
one batch they may differ in the last bits (the GPU libraries pick their
algorithms by batch size).
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str, help="path to model")
    parser.add_argument("--model", type=str, default="sd21base",
                        help="base model: a preset name, or a diffusers or native snapshot dir")
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


def seeds_of_rank(seeds: Sequence[int], world: int, rank: int) -> Tuple[List[int], bool]:
    """(the seeds rank `rank` of `world` samples, whether they are sharded):
    a contiguous block when they divide over the ranks, else all of them on
    rank 0 and none elsewhere."""
    n = len(seeds)
    if world > 1 and n % world == 0:
        return list(seeds[rank * n // world:(rank + 1) * n // world]), True
    return (list(seeds) if rank == 0 else []), False


def sample_seeds(args: argparse.Namespace, seeds: Sequence[int]) -> np.ndarray:
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
        for s in seeds
    ])
    return pipeline(
        [args.prompt] * len(seeds),
        num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale,
        latents=latents,
    )


def generate(args: argparse.Namespace) -> Optional[np.ndarray]:
    """Every seed's image, uint8 [N, H, W, 3] in seed order.  In a rank of a
    launch whose process group is joined (`main` joins it), the seeds are
    shared out as the module docstring says and the images are returned on
    rank 0 alone (None on the others)."""
    from .parallel import mesh

    world, rank = mesh.world_size(), mesh.rank()
    if world == 1:
        return sample_seeds(args, args.seeds)
    mine, sharded = seeds_of_rank(args.seeds, world, rank)
    if rank == 0:
        print(f"Sharding the {len(args.seeds)} seeds over {world} ranks, "
              f"{len(args.seeds) // world} a rank" if sharded else
              f"{len(args.seeds)} seeds do not divide over {world} ranks: rank 0 samples "
              "them all", flush=True)
    images = sample_seeds(args, mine) if mine else None
    if not sharded:
        mesh.barrier()
        return images
    parts = mesh.gather_to_main(images)
    return None if parts is None else np.concatenate(parts)


def main(args: argparse.Namespace) -> None:
    from PIL import Image

    from .parallel import mesh

    with mesh.distributed(args.device):
        out = generate(args)
    if out is None:  # another rank's images: rank 0 writes them
        return
    images = list(out)
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
