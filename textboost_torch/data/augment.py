"""Paired image/caption augmentation ("paug").

A copy of textboost_tpu/data/augment.py (the port imports nothing from the
JAX package): the same ops, the same draws in the same order, so one seed
gives the same bytes and captions in both packages.  Counterpart of
textboost/augment/paired_augmentation.py: each augmentation transforms the
image AND injects a matching caption fragment — natural language normally,
learnable pseudo-tokens when `inversion` is on.  Pure PIL + numpy (no
torchvision): edge padding via np.pad(mode="edge"), center-scaling via
resize + center crop/pad.

Caption fragments for inversion mode come from a `caption_map`
(base placeholder -> actual sub-token string, e.g. "<zoom-in>" ->
"<zoom-in_0> <zoom-in_1>") built by the trainer from the tokens it adds,
so pairing stays correct for any tokenizer's sub-token split.  Defaults
match the reference's hardcoded CLIP-BPE splits
(paired_augmentation.py:35-37, 104-107, 155-160, 263).

All randomness flows through an explicit numpy Generator, making every
sample reproducible from (seed, step, index).

Every op is split into PLAN (all RNG draws + caption edit + numeric
params) and EXECUTE (deterministic pixel work).  `adjust_scale` executes
through the native bicubic op (data/native.py), whose failure to build
raises; `exec_adjust_scale_pil` is its plain PIL version.
"""
from __future__ import annotations

import io
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import PIL.Image
import PIL.ImageEnhance
import PIL.ImageOps
from PIL import Image

REFERENCE_CAPTION_MAP = {
    "<grayscale>": "<grayscale_0> <grayscale_1>",
    "<zoom-in>": "<zoom-in_0> <zoom-in_1>",
    "<zoom-out>": "<zoom-out_0> <zoom-out_1>",
    "<collage>": "<collage_0> <collage_1>",
    "<crop>": "<crop>",
    "<hflip>": "<hflip>",
    "<left>": "<left_0> <left_1> <left_2>",
    "<right>": "<right_0> <right_0> <right_0>",  # sic: reference repeats _0
    "<rot90>": "<rot90_0> <rot90_1>",
    "<rot270>": "<rot270_0> <rot270_1>",
    "<dimmed>": "<dimmed>",
    "<bright>": "<bright>",
    "<jpeg>": "<jpeg_0> <jpeg_1>",
}

AugOut = Tuple[Image.Image, str]
Plan = Dict  # {"op": str, ...numeric params}


def _center_crop_or_pad(image: Image.Image, tw: int, th: int) -> Image.Image:
    """Center crop to (tw, th), zero-padding if the image is smaller
    (torchvision center_crop semantics)."""
    w, h = image.size
    if w < tw or h < th:
        canvas = Image.new("RGB", (max(w, tw), max(h, th)), (0, 0, 0))
        canvas.paste(image, ((canvas.width - w) // 2, (canvas.height - h) // 2))
        image, (w, h) = canvas, canvas.size
    left, top = (w - tw) // 2, (h - th) // 2
    return image.crop((left, top, left + tw, top + th))


def _edge_pad(image: Image.Image, pad_w: int, pad_h: int) -> Image.Image:
    arr = np.asarray(image)
    arr = np.pad(arr, ((pad_h, pad_h), (pad_w, pad_w), (0, 0)), mode="edge")
    return Image.fromarray(arr)


def _inverse_affine_matrix(w: int, h: int, scale: float, tx: float = 0.0,
                           ty: float = 0.0):
    """torchvision `_get_inverse_affine_matrix` specialised to angle=0,
    shear=0 about the image center — the exact matrix
    `v2.functional.affine` hands to `PIL.Image.transform`
    (paired_augmentation.py:26-33)."""
    cx, cy = w * 0.5, h * 0.5
    inv = 1.0 / scale
    m2 = inv * (-cx - tx) + cx
    m5 = inv * (-cy - ty) + cy
    return inv, m2, m5


# ---------------------------------------------------------------------------
# adjust_scale (zoom in/out)
# ---------------------------------------------------------------------------
def plan_adjust_scale(size, prompt, inversion, rng, captions):
    """Zoom in/out about center, edge-filled (paired_augmentation.py:20-49).

    Matches the reference's pad -> v2.functional.affine(scale, BICUBIC) ->
    center_crop composition sample-for-sample: the affine is PIL
    `Image.transform` with torchvision's inverse matrix, and the trailing
    center-crop is fused into the transform's output window (folding the
    crop offset into the matrix is exact — PIL's output-coordinate
    conventions are linear in the offset)."""
    scale = rng.uniform(0.34, 1.4)
    w0, h0 = size
    pad_w = pad_h = 0
    if scale < 1.0:
        ph_ = round((h0 / scale - h0) / 2)
        pw_ = round((w0 / scale - w0) / 2)
        if ph_ > 0 and pw_ > 0:
            pad_w, pad_h = pw_, ph_
    if inversion:
        if scale < 0.6:
            add = captions["<zoom-out>"] + " "
        elif scale > 1.2:
            add = captions["<zoom-in>"] + " "
        else:
            add = ""
    else:
        if scale <= 0.6:
            add = rng.choice(["a far away ", "very small "])
        elif scale >= 1.2:
            add = rng.choice(["zoomed in ", "close up "])
        else:
            add = ""
    return (
        {"op": "scale", "scale": float(scale), "pad_w": pad_w, "pad_h": pad_h},
        add + prompt,
    )


def _scale_matrix(image: Image.Image, p: Plan):
    w0, h0 = image.size
    pw, ph = w0 + 2 * p["pad_w"], h0 + 2 * p["pad_h"]
    inv, m2, m5 = _inverse_affine_matrix(pw, ph, p["scale"])
    left = int(round((pw - w0) / 2.0))
    top = int(round((ph - h0) / 2.0))
    return (inv, 0.0, m2 + inv * left, 0.0, inv, m5 + inv * top)


def exec_adjust_scale(image: Image.Image, p: Plan) -> Image.Image:
    """The zoom through the native bicubic op (the pad is virtual)."""
    from .native import affine_scale_bicubic

    matrix = _scale_matrix(image, p)
    return Image.fromarray(affine_scale_bicubic(
        np.asarray(image), p["pad_w"], p["pad_h"], image.width, image.height,
        matrix[0], matrix[2], matrix[4], matrix[5],
    ))


def exec_adjust_scale_pil(image: Image.Image, p: Plan) -> Image.Image:
    """The plain version of `exec_adjust_scale`: materialize the edge pad,
    then PIL's affine transform."""
    matrix = _scale_matrix(image, p)
    size = image.size
    if p["pad_w"] or p["pad_h"]:
        image = _edge_pad(image, p["pad_w"], p["pad_h"])
    return image.transform(size, Image.AFFINE, matrix, resample=Image.BICUBIC)


def adjust_scale(image, prompt, inversion, rng, captions) -> AugOut:
    p, prompt = plan_adjust_scale(image.size, prompt, inversion, rng, captions)
    return exec_adjust_scale(image, p), prompt


# ---------------------------------------------------------------------------
# rotate
# ---------------------------------------------------------------------------
def plan_rotate(size, prompt, inversion, rng, captions):
    direction = rng.integers(0, 2)
    if direction == 0:
        tok, nat = captions["<rot90>"], "90 degrees counter clockwise rotated "
    else:
        tok, nat = captions["<rot270>"], "90 degrees clockwise rotated "
    if inversion:
        prompt = tok + " " + prompt if rng.random() < 0.5 else prompt + ", " + tok
    else:
        prompt = nat + prompt
    return {"op": "rotate", "direction": int(direction)}, prompt


def exec_rotate(image: Image.Image, p: Plan) -> Image.Image:
    return image.transpose(
        Image.ROTATE_90 if p["direction"] == 0 else Image.ROTATE_270
    )


def rotate(image, prompt, inversion, rng, captions) -> AugOut:
    p, prompt = plan_rotate(image.size, prompt, inversion, rng, captions)
    return exec_rotate(image, p), prompt


# ---------------------------------------------------------------------------
# horizontal_flip
# ---------------------------------------------------------------------------
def plan_horizontal_flip(size, prompt, inversion, rng, captions):
    if inversion:
        tok = captions["<hflip>"]
        prompt = tok + " " + prompt if rng.random() < 0.5 else prompt + ", " + tok
    else:
        prompt = (
            "horizontally flipped " + prompt
            if rng.random() < 0.5
            else prompt + ", horizontally flipped"
        )
    return {"op": "hflip"}, prompt


def exec_horizontal_flip(image: Image.Image, p: Plan) -> Image.Image:
    return image.transpose(Image.FLIP_LEFT_RIGHT)


def horizontal_flip(image, prompt, inversion, rng, captions) -> AugOut:
    p, prompt = plan_horizontal_flip(image.size, prompt, inversion, rng, captions)
    return exec_horizontal_flip(image, p), prompt


# ---------------------------------------------------------------------------
# horizontal_translate
# ---------------------------------------------------------------------------
def plan_horizontal_translate(size, prompt, inversion, rng, captions):
    """Shift left/right by 15-30% width, edge-filled
    (paired_augmentation.py:91-126).

    The reference's pad(edge) -> affine(translate, NEAREST) -> center_crop
    composition reduces exactly to an integer column shift with one edge
    column replicated into the vacated band; computed as two numpy slice
    copies instead of materializing the padded array."""
    direction = rng.integers(0, 2)
    w, _ = size
    shift = int(rng.uniform(0.15, 0.3) * w)
    if direction == 0:
        add = captions["<left>"] if inversion else "on the left"
    else:
        add = captions["<right>"] if inversion else "on the right"
    return (
        {"op": "translate", "direction": int(direction), "shift": shift},
        prompt + " " + add,
    )


def exec_horizontal_translate(image: Image.Image, p: Plan) -> Image.Image:
    w, _ = image.size
    shift = p["shift"]
    arr = np.asarray(image)
    out = np.empty_like(arr)
    if p["direction"] == 0:  # content moves left; right edge replicated
        out[:, : w - shift] = arr[:, shift:]
        out[:, w - shift:] = arr[:, -1:]
    else:  # content moves right; left edge replicated
        out[:, shift:] = arr[:, : w - shift]
        out[:, :shift] = arr[:, :1]
    return Image.fromarray(out)


def horizontal_translate(image, prompt, inversion, rng, captions) -> AugOut:
    p, prompt = plan_horizontal_translate(
        image.size, prompt, inversion, rng, captions
    )
    return exec_horizontal_translate(image, p), prompt


# ---------------------------------------------------------------------------
# adjust_brightness
# ---------------------------------------------------------------------------
def plan_adjust_brightness(size, prompt, inversion, rng, captions):
    if rng.random() < 0.5:
        factor = rng.uniform(0.4, 0.6)
        add = captions["<dimmed>"] if inversion else "dimmed"
    else:
        factor = rng.uniform(1.3, 1.5)
        add = captions["<bright>"] if inversion else "bright"
    prompt = add + " " + prompt if rng.random() < 0.5 else prompt + f", {add}"
    return {"op": "brightness", "factor": float(factor)}, prompt


def exec_adjust_brightness(image: Image.Image, p: Plan) -> Image.Image:
    return PIL.ImageEnhance.Brightness(image).enhance(p["factor"])


def adjust_brightness(image, prompt, inversion, rng, captions) -> AugOut:
    p, prompt = plan_adjust_brightness(
        image.size, prompt, inversion, rng, captions
    )
    return exec_adjust_brightness(image, p), prompt


# ---------------------------------------------------------------------------
# grayscale
# ---------------------------------------------------------------------------
def plan_grayscale(size, prompt, inversion, rng, captions):
    add = captions["<grayscale>"] if inversion else "grayscale"
    return {"op": "grayscale"}, f"{prompt}, {add}"


def exec_grayscale(image: Image.Image, p: Plan) -> Image.Image:
    return PIL.ImageOps.grayscale(image).convert("RGB")


def grayscale(image, prompt, inversion, rng, captions) -> AugOut:
    p, prompt = plan_grayscale(image.size, prompt, inversion, rng, captions)
    return exec_grayscale(image, p), prompt


# ---------------------------------------------------------------------------
# crop (random resized crop, 1:1 ratio)
# ---------------------------------------------------------------------------
def _plan_random_resized_crop(size, rng, scale=(0.08, 1.0), ratio=(0.75, 4.0 / 3.0)):
    width, height = size
    area = width * height * rng.uniform(*scale)
    aspect = rng.uniform(*ratio)
    nw = min(int(round(math.sqrt(area * aspect))), width)
    nh = min(int(round(math.sqrt(area / aspect))), height)
    x = int(rng.integers(0, width - nw + 1))
    y = int(rng.integers(0, height - nh + 1))
    return x, y, nw, nh


def random_resized_crop(image, target_size, rng, scale=(0.08, 1.0), ratio=(0.75, 4.0 / 3.0)):
    x, y, nw, nh = _plan_random_resized_crop(image.size, rng, scale, ratio)
    return image.crop((x, y, x + nw, y + nh)).resize(target_size, Image.BICUBIC)


def plan_crop(size, prompt, inversion, rng, captions):
    x, y, nw, nh = _plan_random_resized_crop(size, rng, ratio=(1.0, 1.0))
    add = captions["<crop>"] if inversion else "cropped"
    prompt = f"{add} {prompt}" if rng.random() < 0.5 else f"{prompt}, {add}"
    return {"op": "crop", "x": x, "y": y, "nw": nw, "nh": nh}, prompt


def exec_crop(image: Image.Image, p: Plan) -> Image.Image:
    return image.crop(
        (p["x"], p["y"], p["x"] + p["nw"], p["y"] + p["nh"])
    ).resize(image.size, Image.BICUBIC)


def crop(image, prompt, inversion, rng, captions) -> AugOut:
    p, prompt = plan_crop(image.size, prompt, inversion, rng, captions)
    return exec_crop(image, p), prompt


# ---------------------------------------------------------------------------
# jpeg_compression
# ---------------------------------------------------------------------------
def plan_jpeg_compression(size, prompt, inversion, rng, captions):
    quality = int(rng.integers(25, 75))
    add = captions["<jpeg>"] if inversion else "JPEG"
    prompt = f"{add} {prompt}" if rng.random() < 0.5 else f"{prompt}, {add}"
    return {"op": "jpeg", "quality": quality}, prompt


def exec_jpeg_compression(image: Image.Image, p: Plan) -> Image.Image:
    buf = io.BytesIO()
    image.save(buf, format="JPEG", quality=p["quality"])
    buf.seek(0)
    return Image.open(buf).convert("RGB")


def jpeg_compression(image, prompt, inversion, rng, captions) -> AugOut:
    p, prompt = plan_jpeg_compression(
        image.size, prompt, inversion, rng, captions
    )
    return exec_jpeg_compression(image, p), prompt


# ---------------------------------------------------------------------------
# square_photo_collage
# ---------------------------------------------------------------------------
def plan_square_photo_collage(size, prompt, inversion, rng, captions):
    """2x2 or 3x3 tiled grid with black borders
    (paired_augmentation.py:240-264)."""
    axis = int(rng.integers(2, 4))
    add = captions["<collage>"] + " " if inversion else "photo collage of "
    return {"op": "collage", "axis": axis}, add + prompt


def exec_square_photo_collage(image: Image.Image, p: Plan) -> Image.Image:
    axis = p["axis"]
    w, h = image.size
    gw, gh = w // axis, h // axis
    small = np.asarray(image.resize((gw, gh), Image.BICUBIC)).copy()
    small[0, :] = 0
    small[-1, :] = 0
    small[:, 0] = 0
    small[:, -1] = 0
    grid = np.tile(small, (axis, axis, 1))
    return Image.fromarray(grid)


def square_photo_collage(image, prompt, inversion, rng, captions) -> AugOut:
    p, prompt = plan_square_photo_collage(
        image.size, prompt, inversion, rng, captions
    )
    return exec_square_photo_collage(image, p), prompt


# Wrapper fn -> (planner, executor): the pipeline stores the public wrapper
# objects in its op groups (unchanged external surface) and dispatches to
# plan/execute through this registry.
_OP_IMPLS = {
    adjust_scale: (plan_adjust_scale, exec_adjust_scale),
    rotate: (plan_rotate, exec_rotate),
    horizontal_flip: (plan_horizontal_flip, exec_horizontal_flip),
    horizontal_translate: (plan_horizontal_translate, exec_horizontal_translate),
    adjust_brightness: (plan_adjust_brightness, exec_adjust_brightness),
    grayscale: (plan_grayscale, exec_grayscale),
    crop: (plan_crop, exec_crop),
    jpeg_compression: (plan_jpeg_compression, exec_jpeg_compression),
    square_photo_collage: (plan_square_photo_collage, exec_square_photo_collage),
}

_EXECUTORS = {
    "scale": exec_adjust_scale,
    "rotate": exec_rotate,
    "hflip": exec_horizontal_flip,
    "translate": exec_horizontal_translate,
    "brightness": exec_adjust_brightness,
    "grayscale": exec_grayscale,
    "crop": exec_crop,
    "jpeg": exec_jpeg_compression,
    "collage": exec_square_photo_collage,
    "base_hflip": exec_horizontal_flip,
}


def execute_plan_pil(image: Image.Image, steps: List[Plan]) -> Image.Image:
    for p in steps:
        image = _EXECUTORS[p["op"]](image, p)
    return image


class PairedAugmentation:
    """<=1 op per group (geometric / other / color) with the reference's
    probabilities (paired_augmentation.py:269-351)."""

    def __init__(
        self,
        hflip: str = "false",
        inversion: bool = False,
        p: float = 0.5,
        color_prob: float = 0.2,
        augment_prompt: bool = True,
        ops: str = "object",
        caption_map: Optional[Dict[str, str]] = None,
        seed: Optional[int] = None,
    ):
        if hflip.lower() not in ("true", "false", "inversion"):
            raise ValueError(f"Invalid hflip value: {hflip}")
        self.hflip = hflip.lower() == "true"
        self.inversion = inversion
        self.p = p
        self.color_prob = color_prob
        self.augment_prompt = augment_prompt
        self.captions = dict(REFERENCE_CAPTION_MAP)
        if caption_map:
            self.captions.update(caption_map)
        self._rng = np.random.default_rng(seed)

        if ops == "object":
            self.geometric_ops = [adjust_scale, crop, horizontal_translate]
            self.color_ops = [grayscale]
            self.other_ops = [square_photo_collage]
        elif ops == "style":
            self.geometric_ops = []
            self.color_ops = [grayscale]
            self.other_ops = []
        else:
            raise ValueError(f"Unknown augment ops bank: {ops}")
        if hflip.lower() == "inversion":
            self.geometric_ops.append(horizontal_flip)

    def plan(
        self,
        size: Tuple[int, int],
        prompt: str,
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[List[Plan], str]:
        """All RNG draws for one sample — op selection, per-op parameters,
        caption edits — with the exact draw order of the fused path, so a
        seeded stream plans the same augmentation the original code
        applied.  Returns (steps, prompt); pixels untouched."""
        rng = rng if rng is not None else self._rng
        steps: List[Plan] = []

        if self.hflip and rng.random() < 0.5:
            steps.append({"op": "base_hflip"})

        for group, prob in (
            (self.geometric_ops, self.p),
            (self.other_ops, self.p),
            (self.color_ops, self.color_prob),
        ):
            if group and rng.random() < prob:
                op = group[int(rng.integers(0, len(group)))]
                planner = _OP_IMPLS[op][0]
                params, new_prompt = planner(
                    size, prompt, self.inversion, rng, self.captions
                )
                steps.append(params)
                if self.augment_prompt:
                    prompt = new_prompt
        return steps, prompt

    def __call__(
        self,
        image: Image.Image,
        prompt: str,
        rng: Optional[np.random.Generator] = None,
    ):
        if not isinstance(image, PIL.Image.Image):
            raise TypeError(f"Invalid image type ({type(image)}). Must be PIL Image.")
        steps, prompt = self.plan(image.size, prompt, rng)
        return execute_plan_pil(image, steps), prompt, None
