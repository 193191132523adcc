"""Auxiliary datasets: DrawBench, JsonDataset and StyleDrop (counterpart of
textboost_tpu/data/aux_datasets.py, over the port's dataset helpers and
tokenizer).

DrawBench (textboost/dataset.py:121-158) reads its prompt list from a URL;
JsonDataset (:460-607) reads styledrop.json records whose images are URLs
cached to disk on first access (the reference's undefined
`num_instance_images` attribute is defined here, as in the JAX package);
StyleDrop (:729-767) resolves its style images through that JSON.  The
URLs are fetched only when no cached copy exists (`cache_file`, the image
cache dir); a local image path is read as it is.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from .datasets import crop_with_offsets, load_rgb, resize_shorter_side
from .native import normalize_u8
from .tokenizer import tokenize_prompt

DRAWBENCH_URL = (
    "https://raw.githubusercontent.com/google-research/google-research/"
    "master/dpok/dataset/drawbench/data_meta.json"
)


def _fetch_text(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:  # noqa: S310
        return r.read().decode()


def _fetch_image(url: str, cache_path: str):
    if not url.startswith(("http://", "https://")):
        return load_rgb(url)  # already a local image path
    if not os.path.isfile(cache_path):
        import urllib.request

        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        urllib.request.urlretrieve(url, cache_path)  # noqa: S310
    return load_rgb(cache_path)


class DrawBench:
    """DrawBench prompt benchmark: (prompt, category) pairs."""

    def __init__(self, tokenizer, num_samples: Optional[int] = None, cache_file=None):
        if cache_file and os.path.isfile(cache_file):
            with open(cache_file) as f:
                text = f.read()
        else:
            text = _fetch_text(DRAWBENCH_URL)
            if cache_file:
                with open(cache_file, "w") as f:
                    f.write(text)
        self.data = []
        prompt = category = None
        for i, line in enumerate(text.split("\n")[1:-1]):
            if i % 3 == 0:
                prompt = line.split('"')[1]
            elif i % 3 == 1:
                category = line.split('"')[3].lower()
            else:
                self.data.append((prompt, category))
        if num_samples is not None:
            self.data = self.data[:num_samples]
        self.tokenizer = tokenizer

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        prompt, cls = self.data[index]
        return {"prompt": prompt, "class": cls,
                "input_ids": tokenize_prompt(self.tokenizer, prompt)[0]}


class JsonDataset:
    """styledrop.json records {image: url, caption, token}; the images are
    cached to disk on first access.  Samples carry float32 NHWC pixels in
    [-1, 1]."""

    def __init__(
        self,
        json_file: str,
        tokenizer,
        cache_dir: str = "data/json_cache",
        size: int = 512,
        center_crop: bool = True,
        template: str = "{}",
        seed: int = 0,
    ):
        with open(json_file) as f:
            raw = json.load(f)
        self.records: List[dict] = raw if isinstance(raw, list) else list(raw.values())
        self.tokenizer = tokenizer
        self.cache_dir = cache_dir
        self.size = size
        self.center_crop = center_crop
        self.template = template
        self.seed = seed
        self.num_instance_images = len(self.records)

    def __len__(self):
        return self.num_instance_images

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng((self.seed, index))
        rec = self.records[index % self.num_instance_images]
        url = rec.get("image") or rec.get("url")
        name = os.path.basename(url).split("?")[0] or f"{index}.jpg"
        image = _fetch_image(url, os.path.join(self.cache_dir, name))
        image = resize_shorter_side(image, self.size)
        image, _, _ = crop_with_offsets(image, self.size, self.center_crop, rng)
        prompt = self.template.format(rec.get("caption") or rec.get("token") or "")
        return {
            "image": normalize_u8(np.asarray(image, dtype=np.uint8)),
            "prompt": prompt,
            "input_ids": tokenize_prompt(self.tokenizer, prompt)[0],
        }


class StyleDrop:
    """StyleDrop reference style images, resolved through data/styledrop.json."""

    def __init__(self, tokenizer, json_file: str = "data/styledrop.json", **kw):
        self._inner = JsonDataset(json_file, tokenizer, **kw)

    def __len__(self):
        return len(self._inner)

    def __getitem__(self, index):
        return self._inner[index]
