"""What a run hands to the program and to the reference alike, made from
the run's seed: the weights, the CLIP tokenizer files and the instance
image.

Weights are drawn on the device by one `torch.Generator` per component in
three large calls (a normal draw over every tensor at once, then each
tensor's scale and offset), in bfloat16, the type the program serves them
in.  The layout and the names come from the reference's modules built on
the meta device, which carry diffusers' and transformers' keys.  The scales
follow the published initialisers: a linear or convolution weight of fan-in
f has standard deviation f^-1/2 in the UNet and the VAE and 0.02 in CLIP;
embeddings 0.02 (positions 0.01); biases 0.02; norm weights 1 + 0.1 z and
biases 0.05 z.  LoRA A has standard deviation 1/r (PEFT's gaussian init);
LoRA B is zero where training starts, and 0.01 where an instance arrives
trained.
"""
from __future__ import annotations

import collections
import json
import os
import struct
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from .reference import models as ref_models
from .reference.tokenizer import bytes_to_unicode, clean_text, pre_tokenize

PARTS = ("text_encoder", "unet", "vae")
SEED_OFFSETS = {"text_encoder": 0, "unet": 1, "vae": 2}
VOCAB = 49408
N_MERGES = 3000


def _scale(part: str, name: str, shape: Tuple[int, ...], lora_b: float) -> Tuple[float, float]:
    """(std, mean) of one tensor."""
    leaf = name.rsplit(".", 1)[-1]
    if ".lora_A." in name:
        return 1.0 / shape[0], 0.0
    if ".lora_B." in name:
        return lora_b, 0.0
    if "norm" in name.rsplit(".", 2)[-2]:  # LayerNorm and GroupNorm affines
        return (0.1, 1.0) if leaf == "weight" else (0.05, 0.0)
    if leaf == "bias":
        return 0.02, 0.0
    if "embedding" in name:
        return (0.01 if "position" in name else 0.02), 0.0
    if part == "text_encoder":
        return 0.02, 0.0
    fan_in = int(np.prod(shape[1:]))
    return fan_in ** -0.5, 0.0


def layout(config: dict, lora_rank: int) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """{part: {key: shape}} of the three components (the reference's
    modules on the meta device)."""
    mods = ref_models.build(ref_models.Ops(), config, lora_rank=lora_rank)
    return {part: {k: tuple(v.shape) for k, v in mods[part].state_dict().items()}
            for part in PARTS}


def make_weights(config: dict, seed: int, device, *, lora_rank: int, lora_b: float = 0.0,
                 dtype=torch.bfloat16) -> Dict[str, Dict[str, torch.Tensor]]:
    """{part: {key: tensor}}: views into one flat tensor per component."""
    out = {}
    for part, shapes in layout(config, lora_rank).items():
        names = list(shapes)
        sizes = [int(np.prod(shapes[k])) for k in names]
        stats = torch.tensor([_scale(part, k, shapes[k], lora_b) for k in names],
                             dtype=torch.float32)
        counts = torch.tensor(sizes, device=device)
        gen = torch.Generator(device).manual_seed(seed * 8 + SEED_OFFSETS[part])
        flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
        flat.mul_(torch.repeat_interleave(stats[:, 0].to(device, dtype), counts))
        flat.add_(torch.repeat_interleave(stats[:, 1].to(device, dtype), counts))
        views, offset = {}, 0
        for k, n in zip(names, sizes):
            views[k] = flat[offset:offset + n].view(shapes[k])
            offset += n
        out[part] = views
    return out


def rows(seed: int, n: int, hidden: int, device, std: float = 0.02,
         dtype=torch.bfloat16) -> torch.Tensor:
    """n embedding rows of an instance's added tokens."""
    gen = torch.Generator(device).manual_seed(seed * 8 + 5)
    return torch.randn(n, hidden, generator=gen, device=device, dtype=dtype).mul_(std)


def write_instance_image(path: str, seed: int, size: int = 512) -> None:
    """A size x size RGB PNG: smooth colour ramps and noise, from the seed."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1)
    img = np.stack([xx, yy, 1.0 - xx * yy], -1) * 200 + rng.normal(0, 20, (size, size, 3))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)


def _learn_merges(texts: Iterable[str], n_merges: int):
    """Byte-level BPE merges over `texts`: the most frequent pair first, ties
    by the pair's text."""
    byte_map = bytes_to_unicode()
    words = collections.Counter("".join(byte_map[b] for b in w.encode("utf-8"))
                                for t in texts for w in pre_tokenize(clean_text(t)))
    seqs = [list(w[:-1]) + [w[-1] + "</w>"] for w in words]
    weight = list(words.values())
    counts, where = collections.Counter(), collections.defaultdict(set)
    for i, s in enumerate(seqs):
        for pair in zip(s, s[1:]):
            counts[pair] += weight[i]
            where[pair].add(i)
    merges = []
    while counts and len(merges) < n_merges:
        best = max(counts.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(best)
        for i in where.pop(best):
            s = seqs[i]
            for pair in zip(s, s[1:]):
                counts[pair] -= weight[i]
                if counts[pair] <= 0:
                    del counts[pair]
                if pair != best:
                    where[pair].discard(i)
            new, j = [], 0
            while j < len(s):
                if j + 1 < len(s) and (s[j], s[j + 1]) == best:
                    new.append(s[j] + s[j + 1])
                    j += 2
                else:
                    new.append(s[j])
                    j += 1
            seqs[i] = new
            for pair in zip(new, new[1:]):
                counts[pair] += weight[i]
                where[pair].add(i)
    return merges


def write_tokenizer(path: str, texts: Iterable[str], pad_token: str) -> None:
    """A CLIP tokenizer dir with a dense 49408-entry vocab: the 512 byte
    symbols in CLIP's order, N_MERGES merges learned from `texts`, filler
    entries that no merge reaches, <|startoftext|> / <|endoftext|> at
    49406 / 49407.  `pad_token` "!" is sd2's special_tokens_map,
    "<|endoftext|>" sd1's."""
    merges = _learn_merges(texts, N_MERGES)
    symbols = list(bytes_to_unicode().values())
    entries = symbols + [s + "</w>" for s in symbols]
    seen = set(entries)
    for a, b in merges:
        if a + b not in seen:
            seen.add(a + b)
            entries.append(a + b)
    specials = ["<|startoftext|>", "<|endoftext|>"]
    entries += [f"<|filler-{i}|>" for i in range(VOCAB - len(specials) - len(entries))]
    vocab = {tok: i for i, tok in enumerate(entries + specials)}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    special = {name: {"content": tok, "lstrip": False, "normalized": True, "rstrip": False,
                      "single_word": False}
               for name, tok in (("bos_token", specials[0]), ("eos_token", specials[1]),
                                 ("unk_token", specials[1]))}
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump({**special, "pad_token": pad_token}, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({**special, "pad_token": "<|endoftext|>", "model_max_length": 77,
                   "do_lower_case": True, "errors": "replace", "add_prefix_space": False,
                   "tokenizer_class": "CLIPTokenizer"}, f)


_ST_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16"}


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """The safetensors layout: an 8-byte little-endian header length, the
    JSON header, the raw bytes in header order."""
    names = sorted(tensors)
    header, offset = {}, 0
    for k in names:
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for k in names:
            f.write(tensors[k].detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
