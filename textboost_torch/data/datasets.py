"""Datasets: instance (and class-prior) images, the KPL prompt stream, and
the prompts of prior generation.

Counterpart of textboost_tpu/data/datasets.py (TextBoostDataset :118-289
with paired augmentation and the class-prior images of --with_image_prior,
without the plans of --augment_device, ROADMAP.md queue A;
InstructPix2PixDataset :292, PriorDataset :322, PromptDataset :377),
drawing the same numbers from the same per-sample numpy generators, so the
two packages give byte-identical batches for one seed.  Host-side numpy; images decode
with PIL, imported when an image is read.  Batches carry uint8 NHWC pixels, normalized on the device by the
train step.
"""
from __future__ import annotations

import collections
import json
import os
import random
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .human_prompts import EXTENDED_HUMAN_PROMPTS
from .templates import resolve_template
from .tokenizer import tokenize_prompt


def get_images_path(data_root, max_samples=None) -> List[Path]:
    data_root = Path(data_root)
    if not data_root.exists():
        raise ValueError("Data root doesn't exists.")
    paths = sorted(p for p in data_root.iterdir() if p.is_file())
    return paths[:max_samples] if max_samples is not None else paths


def load_rgb(path):
    """A PIL RGB image with its EXIF orientation applied."""
    from PIL import Image
    from PIL.ImageOps import exif_transpose

    image = exif_transpose(Image.open(path))
    if image.mode != "RGB":
        image = image.convert("RGB")
    return image


class _DecodedImageCache:
    """Small thread-safe LRU of decoded images: one-shot training reads the
    same instance image every step.  Copies are returned so that the caller
    (augmentation) cannot change the cached original."""

    def __init__(self, capacity: int = 64):
        self._cap = capacity
        self._lock = threading.Lock()
        self._items = collections.OrderedDict()

    def get(self, path):
        key = str(path)
        with self._lock:
            img = self._items.get(key)
            if img is not None:
                self._items.move_to_end(key)
                return img.copy()
        img = load_rgb(path)
        with self._lock:
            self._items[key] = img
            if len(self._items) > self._cap:
                self._items.popitem(last=False)
        return img.copy()


def resize_shorter_side(image, size: int):
    """torchvision v2.Resize(size, LANCZOS) semantics: shorter side -> size
    (an image already at that size is returned as it is)."""
    from PIL import Image

    w, h = image.size
    if w <= h:
        nw, nh = size, max(round(h * size / w), size)
    else:
        nw, nh = max(round(w * size / h), size), size
    if (nw, nh) == (w, h):
        return image
    return image.resize((nw, nh), Image.LANCZOS)


def crop_with_offsets(image, size: int, center: bool,
                      rng: np.random.Generator) -> Tuple[object, int, int]:
    """Center or random crop -> (image, top, left) (dataset.py:342-351)."""
    w, h = image.size
    if center:
        top = max(0, int(round((h - size) / 2.0)))
        left = max(0, int(round((w - size) / 2.0)))
    else:
        top = int(rng.integers(0, max(h - size, 0) + 1))
        left = int(rng.integers(0, max(w - size, 0) + 1))
    return image.crop((left, top, left + size, top + size)), top, left


class TextBoostDataset:
    """Instance images with templated, optionally augmented captions.

    Returns per-sample dicts of numpy arrays; batching via `collate`.
    `augment_pipe` (data/augment.py::PairedAugmentation) transforms the
    decoded image and its caption before the resize and crop.  With
    `prior_data_root` (--with_image_prior) each sample also carries a class
    image (the first `num_prior` files of the dir, in name order) with its
    caption: the instance template filled with `class_token`, else the
    caption in the file name (`{i}-{sha1}-{caption}.jpg`, written by
    train/prior_generation.py)."""

    def __init__(
        self,
        concepts_list: Sequence[Dict],
        tokenizer,
        num_instance: Optional[int] = None,
        template="a {}",
        prior_data_root: Optional[str] = None,
        class_token: Optional[str] = None,
        num_prior: Optional[int] = None,
        size: int = 512,
        center_crop: bool = False,
        augment_pipe=None,
        seed: int = 0,
    ):
        self.size = size
        self.center_crop = center_crop
        self.tokenizer = tokenizer
        self.template = resolve_template(template)
        self.augment_pipe = augment_pipe
        self.seed = seed
        self._cache = _DecodedImageCache()

        self.instance_images_path: List[Tuple[Path, str]] = []
        for concept in concepts_list:
            for p in get_images_path(concept["instance_data_dir"], num_instance):
                self.instance_images_path.append((p, concept["instance_token"]))
        self.num_instance_images = len(self.instance_images_path)
        self._length = self.num_instance_images

        self.class_token = class_token
        self.prior_data_root = None
        if prior_data_root is not None:
            self.prior_data_root = Path(prior_data_root)
            self.prior_data_root.mkdir(parents=True, exist_ok=True)
            self.class_images_path = sorted(self.prior_data_root.iterdir())
            self.num_prior_images = (min(len(self.class_images_path), num_prior)
                                     if num_prior is not None else len(self.class_images_path))
            self._length = max(self.num_prior_images, self.num_instance_images)

    def __len__(self):
        return self._length

    def _prep_image(self, image, rng) -> Tuple[np.ndarray, int, int]:
        image = resize_shorter_side(image, self.size)
        image, top, left = crop_with_offsets(image, self.size, self.center_crop, rng)
        return np.asarray(image, dtype=np.uint8), top, left

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng((self.seed, index, random.randrange(1 << 30)))
        sample: Dict = {}

        path, instance_token = self.instance_images_path[index % self.num_instance_images]
        prompt_idx = int(rng.integers(0, len(self.template)))
        prompt = self.template[prompt_idx].format(instance_token)
        image = self._cache.get(path)
        if self.augment_pipe is not None:
            image, prompt, mask = self.augment_pipe(image, prompt, rng)
            if mask is not None:  # [h, w] at the latent resolution
                sample["mask"] = np.asarray(mask, dtype=np.float32)[..., None]
        sample["original_size"] = (image.width, image.height)
        sample["image"], top, left = self._prep_image(image, rng)
        sample["crop_top_left"] = (top, left)
        sample["input_ids"] = tokenize_prompt(self.tokenizer, prompt)[0]
        sample["prompt"] = prompt

        if self.prior_data_root:
            prior_path = self.class_images_path[index % self.num_prior_images]
            prior_image = self._cache.get(prior_path)
            if self.class_token is not None:
                prior_prompt = self.template[prompt_idx].format(self.class_token)
            else:  # the caption in the generated file name: idx-hash-caption.jpg
                prior_prompt = (os.path.basename(prior_path).split("-")[1].split(".")[0]
                                .replace("_", " "))
            if "mask" in sample:  # class images are not augmented: all of each counts
                sample["prior_mask"] = np.ones_like(sample["mask"])
            sample["class_image"], ptop, pleft = self._prep_image(prior_image, rng)
            sample["class_crop_top_left"] = (ptop, pleft)
            sample["class_input_ids"] = tokenize_prompt(self.tokenizer, prior_prompt)[0]
        return sample

    @staticmethod
    def collate(samples: Sequence[Dict], with_prior_preservation: bool = False) -> Dict:
        """Class examples are concatenated AFTER the instance examples, so
        that the image prior runs in the same forward pass
        (dataset.py:430-436); `prompt` keeps the instance captions."""
        input_ids = [s["input_ids"] for s in samples]
        pixel_values = [s["image"] for s in samples]
        if with_prior_preservation:
            input_ids += [s["class_input_ids"] for s in samples]
            pixel_values += [s["class_image"] for s in samples]
        batch = {
            "input_ids": np.stack(input_ids).astype(np.int32),
            "pixel_values": np.stack(pixel_values),  # uint8 NHWC
            "prompt": [s["prompt"] for s in samples],
        }
        if "mask" in samples[0]:
            masks = [s["mask"] for s in samples]
            if "prior_mask" in samples[0]:
                masks += [s["prior_mask"] for s in samples]
            batch["mask"] = np.stack(masks).astype(np.float32)
        return batch


class InstructPix2PixDataset:
    """Human-written prompt bank from a jsonl of {input, output} rows
    (dataset.py:161-193); the built-in bank when the file is missing."""

    def __init__(self, json_file: Optional[str], num_samples: Optional[int] = None):
        self.data: List[str] = []
        if json_file and os.path.isfile(json_file):
            with open(json_file) as f:
                rows = [json.loads(line) for line in f if line.strip()]
            for row in rows:
                self.data.append(row["input"])
                out = row.get("output")
                if out is not None and out != "NONE":
                    self.data.append(out)
        else:
            self.data = list(EXTENDED_HUMAN_PROMPTS)
        if num_samples is not None:
            self.data = self.data[:num_samples]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int) -> str:
        return self.data[index]


class PriorDataset:
    """KPL prompt stream: null with p=null_prob, class-template with
    p=template_prob, else the human-written prompt (dataset.py:196-269)."""

    def __init__(
        self,
        source: InstructPix2PixDataset,
        tokenizer,
        additional_template=None,
        additional_category=None,
        template_prob: float = 0.1,
        null_prob: float = 0.1,
        seed: int = 0,
    ):
        self.data = list(source.data)
        self.tokenizer = tokenizer
        self.template_prob = template_prob
        self.null_prob = null_prob
        self.seed = seed

        template = resolve_template(additional_template) if additional_template else [""]
        categories = (
            additional_category
            if isinstance(additional_category, list)
            else [additional_category]
        )
        self.template_data = [
            t.format(c) for t in template for c in categories if c is not None
        ] or [""]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng((self.seed, index, random.randrange(1 << 30)))
        r = rng.random()
        if r < self.null_prob:
            prompt = ""
        elif r < self.null_prob + self.template_prob:
            prompt = self.template_data[int(rng.integers(0, len(self.template_data)))]
        else:
            prompt = self.data[index]
        return {
            "prompt": prompt,
            "input_ids": tokenize_prompt(self.tokenizer, prompt)[0],
        }

    @staticmethod
    def collate(samples: Sequence[Dict]) -> Dict:
        return {
            "prompt": [s["prompt"] for s in samples],
            "input_ids": np.stack([s["input_ids"] for s in samples]).astype(np.int32),
        }


class PromptDataset:
    """Index-stamped prompts for prior image generation (dataset.py:694-726)."""

    def __init__(self, prompt: str, num_samples: int):
        self.prompt = prompt
        self.num_samples = num_samples

    def __len__(self):
        return self.num_samples

    def __getitem__(self, index: int):
        return {"prompt": self.prompt, "index": index}
