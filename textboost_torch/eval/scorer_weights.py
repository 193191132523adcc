"""Scorer weights: published torch checkpoints read into the port's scorers.

Counterpart of textboost_tpu/eval/scorer_weights.py and of the
`convert_scorers.py` step it needs: the port's scorer modules carry the
checkpoints' own key names, so a checkpoint loads by name, strictly
(`clip_scorer.load_strict`), with no conversion and no flax.  A checkpoint
is a dir (the safetensors shards an `*.index.json` names, else every
`.safetensors` file, else the `.bin`/`.pth` files), a `.safetensors` file,
or a torch pickle (`.bin`, `.pth`, `.pt` or no suffix; read with
`torch.load(weights_only=True, mmap=True)`).  `Checkpoint` reads safetensors
through `lora/peft_io.py`'s readers, by offset, one tensor when it is
copied into the module, so a sharded 44 GB T5 is never held whole (nor one
shard) in host memory.

The layouts read (the ones convert_scorers.py reads for the JAX package):
  * `<weights_dir>/clip`: a transformers `CLIPModel` (ViT-L/14-336);
  * `<weights_dir>/dino`: DINOv2 ViT-L/14 in the facebookresearch hub layout,
    or a transformers `Dinov2Model` (mapped by `hf_dinov2_to_fb`);
  * `<vqa_dir>/t5`: a transformers `T5ForConditionalGeneration`;
    `<vqa_dir>/vision`: a transformers `CLIPModel` / `CLIPVisionModel` (its
    `vision_model.*`); `<vqa_dir>/projector`: the LLaVA `mm_projector`
    (`nn.Sequential` keys `0.*` / `2.*`, any prefix); each part may also
    carry a `.safetensors`, `.bin`, `.pth` or `.pt` suffix.
Keys a checkpoint holds that the model has no use for are dropped by name
only: the `position_ids` buffers, CLIP's `logit_scale`, DINOv2's
`mask_token`, T5's tied `embed_tokens` copies, and what the cut vision
tower of clip-flant5 does not run.

Each part may instead be a flax param tree converted for the JAX package
by `convert_scorers.py`, read in the JAX package's precedence
(textboost_tpu/eval/scorer_weights.py::_maybe_msgpack, eval/vqa.py's
`_load_params`): `<part>.safetensors` whose names are `params/...` (the
streaming converter's output), then `<part>.msgpack`
(`flax.serialization.to_bytes`, read by utils/msgpack.py), then the torch
checkpoint.  A `.safetensors` of transformers' names is a torch checkpoint.
Both tree files are mapped, not read whole; the trees go through
`*_state_dict_from_jax` into the same strict load.

`*_state_dict_from_jax` carry the JAX package's scorer param trees (numpy
arrays or torch tensors) into the port's keys; `clip_tree_from_state_dict`
and `dino_tree_from_state_dict` are their inverses, for writing the trees
the JAX package reads.
"""
from __future__ import annotations

import functools
import json
import os
import re
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple, Union

import torch

from ..lora.peft_io import safetensors_header, safetensors_mapped, safetensors_readers
from ..models.convert import (
    _nb,
    _wb,
    as_float32,
    flatten_tree,
    jax_tree_from_state_dict,
    state_dict_from_jax,
    unflatten_tree,
)
from ..utils import msgpack
from .clip_scorer import CLIPConfig, CLIPScorer, layers_run, load_strict
from .dino import DINOScorer, ViTConfig

CLIP_IGNORED = ("text_model.embeddings.position_ids", "vision_model.embeddings.position_ids",
                "logit_scale")
DINO_IGNORED = ("mask_token",)
T5_TIED = ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight")
SUFFIXES = ("", ".safetensors", ".bin", ".pth", ".pt")
VQA_PARTS = ("vision", "projector", "t5")

class Checkpoint(Mapping):
    """{key: tensor} of a torch checkpoint, each tensor read when it is
    looked up (see the module docstring for what `path` may be)."""

    def __init__(self, path: str):
        self.path = path
        self._get: Dict[str, Callable[[], torch.Tensor]] = {}
        for f in self._files(path):
            if f.endswith(".safetensors"):
                self._get.update(safetensors_readers(f))
            else:
                self._add_torch(f)

    @staticmethod
    def _files(path: str):
        if not os.path.isdir(path):
            return [path]
        names = sorted(os.listdir(path))
        for name in names:
            if name.endswith(".index.json"):
                with open(os.path.join(path, name)) as f:
                    shards = sorted(set(json.load(f)["weight_map"].values()))
                return [os.path.join(path, s) for s in shards]
        for suffixes in ((".safetensors",), (".bin", ".pth", ".pt")):
            files = [os.path.join(path, n) for n in names if n.endswith(suffixes)]
            if files:
                return files
        raise FileNotFoundError(f"no .safetensors, .bin or .pth files under {path}")

    def _add_torch(self, path: str) -> None:
        try:  # the zipfile format: tensors stay on disk until read
            blob = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        except RuntimeError:  # the legacy format loads whole
            blob = torch.load(path, map_location="cpu", weights_only=True)
        state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
        for key, val in state.items():
            self._get[key] = functools.partial(lambda v: v, val)

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._get[key]()

    def __iter__(self) -> Iterator[str]:
        return iter(self._get)

    def __len__(self) -> int:
        return len(self._get)


class Renamed(Mapping):
    """A lazy view of `base` under new keys: {new key: base key}."""

    def __init__(self, base: Mapping, names: Dict[str, str]):
        self.base, self.names = base, names

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.base[self.names[key]]

    def __iter__(self) -> Iterator[str]:
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)


def _dropping(base: Mapping, drop) -> Renamed:
    return Renamed(base, {k: k for k in base if not drop(k)})


def _is_jax_tree(path: str) -> bool:
    return any(k.startswith("params/") for k in safetensors_header(path))


def read_jax_tree(base: str) -> Optional[Mapping]:
    """The flax param tree converted for the JAX package at `base`, in its
    precedence: `base.safetensors` of `params/...` names, then
    `base.msgpack`; None when there is neither."""
    path = base + ".safetensors"
    if os.path.isfile(path) and _is_jax_tree(path):
        return unflatten_tree({tuple(k.split("/")): v
                               for k, v in safetensors_mapped(path).items()})
    if os.path.isfile(base + ".msgpack"):
        return msgpack.load(base + ".msgpack")
    return None


def resolve(base: str) -> Optional[str]:
    """The torch checkpoint at `base` (with one of SUFFIXES), None when there
    is none (a `.safetensors` flax tree is not one)."""
    for suffix in SUFFIXES:
        path = base + suffix
        if os.path.exists(path) and not (suffix == ".safetensors" and _is_jax_tree(path)):
            return path
    return None


def _from_tree(base: str, tree: Mapping, convert: Callable[[Mapping], Mapping]) -> Mapping:
    try:
        return convert(tree)
    except (KeyError, AttributeError, TypeError) as e:
        raise ValueError(f"{base}: the flax tree there does not fit the scorer ({e!r})") from e


def clip_weights(path: str) -> Mapping:
    """A transformers CLIPModel checkpoint -> the CLIP scorer's weights."""
    return _dropping(Checkpoint(path), lambda k: k in CLIP_IGNORED)


def hf_dinov2_to_fb(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A transformers Dinov2Model state dict -> the facebookresearch hub
    layout (q, k and v concatenated into qkv)."""
    out: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, torch.Tensor]] = {}
    for k in state:
        v = state[k]
        if k == "embeddings.cls_token":
            out["cls_token"] = v
        elif k == "embeddings.mask_token":
            continue
        elif k == "embeddings.position_embeddings":
            out["pos_embed"] = v
        elif k == "embeddings.register_tokens":
            out["register_tokens"] = v
        elif k.startswith("embeddings.patch_embeddings.projection."):
            out["patch_embed.proj." + k.rsplit(".", 1)[1]] = v
        elif k.startswith("layernorm."):
            out["norm." + k.split(".", 1)[1]] = v
        elif k.startswith("encoder.layer."):
            _, _, i, rest = k.split(".", 3)
            base = f"blocks.{i}"
            if rest.startswith("attention.attention."):
                proj, wb = rest.rsplit(".", 2)[-2:]
                qkv.setdefault(f"{base}.attn.qkv.{wb}", {})[proj] = v
            elif rest.startswith("attention.output.dense."):
                out[f"{base}.attn.proj.{rest.rsplit('.', 1)[1]}"] = v
            elif rest.startswith("layer_scale1."):
                out[f"{base}.ls1.gamma"] = v
            elif rest.startswith("layer_scale2."):
                out[f"{base}.ls2.gamma"] = v
            else:  # norm1/norm2/mlp.fc1/mlp.fc2
                out[f"{base}.{rest}"] = v
        else:
            raise KeyError(f"unmapped transformers DINOv2 key {k}")
    for key, parts in qkv.items():
        out[key] = torch.cat([parts["query"], parts["key"], parts["value"]], dim=0)
    return out


def dino_weights(path: str) -> Mapping:
    """A DINOv2 checkpoint (hub or transformers layout) -> the DINO scorer's
    weights."""
    ckpt = Checkpoint(path)
    if any(k.startswith("encoder.layer.") for k in ckpt):
        return hf_dinov2_to_fb(ckpt)
    return _dropping(ckpt, lambda k: k in DINO_IGNORED)


def vision_tower_weights(path: str, num_layers: int, feature_layer: Optional[int]) -> Mapping:
    """The `vision_model.*` of a transformers CLIP checkpoint (or a bare
    vision transformer's keys) -> a CLIPVisionModel cut at `feature_layer`:
    the blocks it does not run and the post-LN are dropped by name."""
    ckpt = Checkpoint(path)
    prefix = "vision_model." if any(k.startswith("vision_model.") for k in ckpt) else ""
    n_run = layers_run(num_layers, feature_layer)
    names = {}
    for key in ckpt:
        if not key.startswith(prefix):
            continue
        sub = key[len(prefix):]
        m = re.match(r"encoder\.layers\.(\d+)\.", sub)
        if sub == "embeddings.position_ids" or (m and int(m.group(1)) >= n_run) or (
                feature_layer is not None and sub.startswith("post_layernorm.")):
            continue
        names[sub] = key
    return Renamed(ckpt, names)


def projector_weights(path: str) -> Mapping:
    """LLaVA's mm_projector (`[prefix.]{index}.{weight,bias}`) -> the port's
    nn.Sequential: the i-th linear by index order at index 2i."""
    ckpt = Checkpoint(path)
    by_index: Dict[int, Dict[str, str]] = {}
    for key in ckpt:
        m = re.search(r"(?:^|\.)(\d+)\.(weight|bias)$", key)
        if not m:
            raise KeyError(f"{path}: {key} is not an mm_projector linear")
        by_index.setdefault(int(m.group(1)), {})[m.group(2)] = key
    return Renamed(ckpt, {f"{2 * i}.{wb}": key for i, idx in enumerate(sorted(by_index))
                          for wb, key in by_index[idx].items()})


def t5_weights(path: str, tied: bool) -> Mapping:
    """A transformers T5ForConditionalGeneration checkpoint -> the port's T5:
    the embed_tokens copies of `shared` (and `lm_head` when tied) dropped."""
    ckpt = Checkpoint(path)
    drop = set(T5_TIED) | ({"lm_head.weight"} if tied else set())
    names = {k: k for k in ckpt if k not in drop}
    if "shared.weight" not in names and "encoder.embed_tokens.weight" in ckpt:
        names["shared.weight"] = "encoder.embed_tokens.weight"
    return Renamed(ckpt, names)


def load_vqa_parts(model, weights_dir: str) -> None:
    """Load `<weights_dir>/{vision,projector,t5}` (a flax tree or a torch
    checkpoint each, see the module docstring) into a CLIPT5Model."""
    for part in VQA_PARTS:
        base = os.path.join(weights_dir, part)
        tree = read_jax_tree(base)
        path = None if tree is not None else resolve(base)
        if tree is not None:
            weights = _from_tree(base, tree, VQA_FROM_JAX[part])
        elif path is None:
            raise FileNotFoundError(f"{base} (a torch checkpoint, with or without one of "
                                    f"{SUFFIXES[1:]}, or a flax tree: .safetensors of "
                                    "params/ names, .msgpack) is missing")
        elif part == "vision":
            weights = vision_tower_weights(path, model.vision_config.num_hidden_layers,
                                           model.vision.feature_layer)
        elif part == "projector":
            weights = projector_weights(path)
        else:
            weights = t5_weights(path, model.t5_config.tie_word_embeddings)
        load_strict(getattr(model, part), weights)


def part_weights(base: str, name: str) -> Optional[Mapping]:
    """The weights of the CLIP (`name` "clip") or DINO ("dino") scorer at
    `base`: a flax tree, else a torch checkpoint (see the module
    docstring); None when there is neither."""
    read, from_jax = {"clip": (clip_weights, clip_state_dict_from_jax),
                      "dino": (dino_weights, dino_state_dict_from_jax)}[name]
    tree = read_jax_tree(base)
    if tree is not None:
        return _from_tree(base, tree, from_jax)
    path = resolve(base)
    return None if path is None else read(path)


def load_scorers(weights_dir: str, device: Union[str, torch.device] = "cuda"
                 ) -> Tuple[CLIPScorer, DINOScorer]:
    """<weights_dir>/{clip,dino} (a flax tree or a torch checkpoint each) ->
    (CLIPScorer, DINOScorer) at their published geometry; a missing part is
    a seeded random init, with a warning."""
    out = []
    for name, scorer, config in (("clip", CLIPScorer, CLIPConfig()),
                                 ("dino", DINOScorer, ViTConfig())):
        base = os.path.join(weights_dir, name)
        weights = part_weights(base, name)
        if weights is None:
            print(f"WARNING: {base} missing; the {name.upper()} scorer is random-init.")
        out.append(scorer(config, weights=weights, device=device))
    return tuple(out)


# ---------------------------------------------------------------------------
# The JAX package's scorer param trees -> the port's keys (parity tests)
# ---------------------------------------------------------------------------
def _vision_from_jax(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    sub = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
           "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
           "layer_norm1": "layer_norm1", "layer_norm2": "layer_norm2",
           "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for path, leaf in flatten_tree(tree).items():
        arr = as_float32(leaf)
        if path[0] == "patch_embedding":
            out[prefix + "embeddings.patch_embedding.weight"] = arr.permute(3, 2, 0, 1)
        elif path[0] == "class_embedding":
            out[prefix + "embeddings.class_embedding"] = arr
        elif path[0] == "position_embedding":
            out[prefix + "embeddings.position_embedding.weight"] = arr
        elif path[0] in ("pre_layrnorm", "post_layernorm"):
            out[f"{prefix}{path[0]}.{_nb(path[1])}"] = arr
        else:
            i = re.match(r"layers_(\d+)$", path[0]).group(1)
            key = f"{prefix}encoder.layers.{i}.{sub[path[1]]}."
            if path[2] == "kernel":
                out[key + "weight"] = arr.T
            else:
                out[key + _nb(path[2])] = arr
    return out


def clip_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX CLIPScorer's param tree -> the port's CLIPModel state dict."""
    tree = params["params"]
    out = dict(state_dict_from_jax("text_encoder", {"params": tree["text_model"]}))
    out.update(_vision_from_jax(tree["vision_model"], "vision_model."))
    out["text_projection.weight"] = as_float32(tree["text_projection"]["kernel"]).T
    out["visual_projection.weight"] = as_float32(tree["visual_projection"]["kernel"]).T
    return out


def dino_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX DINOScorer's param tree -> the port's ViTFeatures state dict."""
    out = {}
    for path, leaf in flatten_tree(params["params"]).items():
        arr = as_float32(leaf)
        if path[0] == "patch_embed":
            out[f"patch_embed.proj.{_wb(path[1])}"] = (arr.permute(3, 2, 0, 1)
                                                       if path[1] == "kernel" else arr)
        elif path[0] in ("cls_token", "pos_embed", "register_tokens"):
            out[path[0]] = arr.reshape(1, -1, arr.shape[-1])
        elif path[0] == "norm":
            out[f"norm.{_nb(path[1])}"] = arr
        else:
            i = re.match(r"blocks_(\d+)$", path[0]).group(1)
            name = {"ls1": "ls1", "ls2": "ls2", "norm1": "norm1", "norm2": "norm2",
                    "qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
                    "fc2": "mlp.fc2"}[path[1]]
            if path[1] in ("ls1", "ls2"):
                out[f"blocks.{i}.{name}.gamma"] = arr
            elif path[1] in ("norm1", "norm2"):
                out[f"blocks.{i}.{name}.{_nb(path[2])}"] = arr
            else:
                out[f"blocks.{i}.{name}.{_wb(path[2])}"] = arr.T if path[2] == "kernel" else arr
    return out


def t5_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX T5ForConditionalGeneration's param tree -> the port's keys."""
    out = {}
    for path, leaf in flatten_tree(params["params"]).items():
        arr = as_float32(leaf)
        if path[0] == "shared":
            out["shared.weight"] = arr
        elif path[0] == "lm_head":
            out["lm_head.weight"] = arr.T
        elif path[1] == "final_layer_norm":
            out[f"{path[0]}.final_layer_norm.weight"] = arr
        else:
            stack, i, sub = path[0], re.match(r"block_(\d+)$", path[1]).group(1), path[2]
            base = f"{stack}.block.{i}.layer"
            ff = 2 if stack == "decoder" else 1
            if sub == "self_attn" and path[3] == "relative_attention_bias":
                out[f"{base}.0.SelfAttention.relative_attention_bias.weight"] = arr
            elif sub in ("self_attn", "cross_attn", "ff"):
                mod = {"self_attn": "0.SelfAttention", "cross_attn": "1.EncDecAttention",
                       "ff": f"{ff}.DenseReluDense"}[sub]
                out[f"{base}.{mod}.{path[3]}.weight"] = arr.T
            else:
                idx = {"self_attn_norm": 0, "cross_attn_norm": 1, "ff_norm": ff}[sub]
                out[f"{base}.{idx}.layer_norm.weight"] = arr
    return out


def projector_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX mm_projector's param tree -> the port's nn.Sequential keys."""
    out = {}
    for path, leaf in flatten_tree(params["params"]).items():
        i = int(re.match(r"linear_(\d+)$", path[0]).group(1))
        arr = as_float32(leaf)
        out[f"{2 * i}.{_wb(path[1])}"] = arr.T if path[1] == "kernel" else arr
    return out


VQA_FROM_JAX = {"vision": lambda params: _vision_from_jax(params["params"], ""),
                "projector": projector_state_dict_from_jax, "t5": t5_state_dict_from_jax}


def vqa_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX CLIPT5Model's {vision, projector, t5} trees -> the port's
    CLIPT5Model state dict."""
    return {f"{part}.{k}": v for part in VQA_PARTS
            for k, v in VQA_FROM_JAX[part](params[part]).items()}


# ---------------------------------------------------------------------------
# The port's scorer state dicts -> the JAX package's trees
# ---------------------------------------------------------------------------
_VISION_SUB = {"self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
               "self_attn.v_proj": "v_proj", "self_attn.out_proj": "out_proj",
               "layer_norm1": "layer_norm1", "layer_norm2": "layer_norm2",
               "mlp.fc1": "fc1", "mlp.fc2": "fc2"}


def _leaf(wb: str, norm: bool) -> str:
    return ("scale" if norm else "kernel") if wb == "weight" else "bias"


def _vision_to_jax(state: Mapping[str, torch.Tensor], prefix: str) -> Dict:
    flat = {}
    for key, arr in state.items():
        sub = key[len(prefix):]
        if sub == "embeddings.patch_embedding.weight":
            flat[("patch_embedding", "kernel")] = arr.permute(2, 3, 1, 0)
        elif sub == "embeddings.class_embedding":
            flat[("class_embedding",)] = arr
        elif sub == "embeddings.position_embedding.weight":
            flat[("position_embedding",)] = arr
        elif sub.startswith(("pre_layrnorm.", "post_layernorm.")):
            name, wb = sub.split(".")
            flat[(name, _leaf(wb, True))] = arr
        else:
            i, rest = re.match(r"encoder\.layers\.(\d+)\.(.+)$", sub).groups()
            mod, wb = rest.rsplit(".", 1)
            norm = mod.startswith("layer_norm")
            flat[(f"layers_{i}", _VISION_SUB[mod], _leaf(wb, norm))] = (
                arr.T if wb == "weight" and not norm else arr)
    return unflatten_tree(flat)


def clip_tree_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict:
    """The port's CLIPModel state dict (transformers' keys) -> the JAX
    CLIPScorer's param tree (views of the tensors): the inverse of
    `clip_state_dict_from_jax`."""
    text = {k: v for k, v in state.items() if k.startswith("text_model.")}
    vision = {k: v for k, v in state.items() if k.startswith("vision_model.")}
    tree = {"text_model": jax_tree_from_state_dict("text_encoder", text)["params"],
            "vision_model": _vision_to_jax(vision, "vision_model."),
            "text_projection": {"kernel": state["text_projection.weight"].T},
            "visual_projection": {"kernel": state["visual_projection.weight"].T}}
    return {"params": tree}


def dino_tree_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ViTFeatures state dict (the hub layout) -> the JAX
    DINOScorer's param tree (views of the tensors): the inverse of
    `dino_state_dict_from_jax`."""
    flat = {}
    for key, arr in state.items():
        if key.startswith("patch_embed.proj."):
            wb = key.rsplit(".", 1)[1]
            flat[("patch_embed", _leaf(wb, False))] = arr.permute(2, 3, 1, 0) if wb == "weight" else arr
        elif key == "cls_token":
            flat[(key,)] = arr.reshape(-1)
        elif key in ("pos_embed", "register_tokens"):
            flat[(key,)] = arr.reshape(-1, arr.shape[-1])
        elif key.startswith("norm."):
            flat[("norm", _leaf(key.split(".")[1], True))] = arr
        else:
            i, rest = re.match(r"blocks\.(\d+)\.(.+)$", key).groups()
            mod, wb = rest.rsplit(".", 1)
            name = mod.rsplit(".", 1)[-1]  # attn.qkv -> qkv, mlp.fc1 -> fc1, ls1 -> ls1
            if wb == "gamma":
                flat[(f"blocks_{i}", name)] = arr
            elif name in ("norm1", "norm2"):
                flat[(f"blocks_{i}", name, _leaf(wb, True))] = arr
            else:
                flat[(f"blocks_{i}", name, _leaf(wb, False))] = arr.T if wb == "weight" else arr
    return {"params": unflatten_tree(flat)}
