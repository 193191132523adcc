"""Class-prior image generation for --with_image_prior.

Counterpart of textboost_tpu/train/prior_generation.py (the reference's
`generate_prior_images`, textboost/utils.py:50-114): when the class dir
holds fewer than `num_prior_images` images, the missing ones are sampled
from the base pipeline (the frozen modules; the adapters are all zero
before training, so they add nothing) with `PromptDataset` prompts, in
batches of `sample_batch_size`, 25 DPM-Solver++ steps at CFG 7.5.  File
names are `{i}-{sha1}-{caption}.jpg`, from which the dataset reads the
caption back.  Each batch's latents come from a `torch.Generator` seeded
from (seed, start): torch cannot reproduce the JAX package's threefry
draws, so the two packages generate different images for one seed.  The
JAX package's optional BLIP captioning (which its trainer never turns on)
needs transformers' BLIP and is not carried: the prompt is the caption.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

from ..data.datasets import PromptDataset


def batch_seed(seed: int, start: int) -> int:
    """The generator seed of the batch that starts at index `start`."""
    return int(np.random.SeedSequence((seed, start)).generate_state(1, np.uint64)[0] >> 1)


def generate_prior_images(
    pipeline,
    class_images_dir: str,
    class_token: str,
    num_prior_images: int,
    *,
    sample_batch_size: int = 4,
    num_inference_steps: int = 25,
    guidance_scale: float = 7.5,
    seed: int = 0,
    write: bool = True,
) -> int:
    """Top up `class_images_dir` to `num_prior_images` images with
    `pipeline` (a TextToImagePipeline).  Returns the number generated.
    With `write` False the images are sampled and not saved: a
    tensor-parallel peer's part of the sampling.  It counts the dir before
    its first sampling call, which the writer cannot finish without it, so
    both count the same images."""
    from PIL import Image

    class_images_dir = Path(class_images_dir)
    if write:
        class_images_dir.mkdir(parents=True, exist_ok=True)
    cur = len(list(class_images_dir.iterdir())) if class_images_dir.is_dir() else 0
    if cur >= num_prior_images:
        return 0
    prompt = f"a photo of {class_token}"
    dataset = PromptDataset(prompt, num_prior_images - cur)
    made = 0
    for start in range(0, len(dataset), sample_batch_size):
        idxs = list(range(start, min(start + sample_batch_size, len(dataset))))
        prompts = [dataset[i]["prompt"] for i in idxs]
        generator = torch.Generator(pipeline.device).manual_seed(batch_seed(seed, start))
        images = pipeline(prompts, num_inference_steps=num_inference_steps,
                          guidance_scale=guidance_scale, generator=generator)
        for i, arr, caption in zip(idxs, images, prompts):
            made += 1
            if not write:
                continue
            img = Image.fromarray(arr)
            digest = hashlib.sha1(img.tobytes()).hexdigest()  # noqa: S324 — a name, not security
            img.save(os.path.join(class_images_dir,
                                  f"{i + cur}-{digest}-{caption.replace(' ', '_')}.jpg"))
    return made
