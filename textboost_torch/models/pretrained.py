"""Model bundles: the three modules of a model family, loaded or seeded, and placed.

Counterpart of textboost_tpu/models/pretrained.py.  A snapshot dir loads in
the JAX package's search order: its native layout first (`spec.json`, whose
`name` picks the spec, and `{text_encoder,unet,vae}.msgpack`, the flax
param trees its `save_snapshot` writes; read by the port's own msgpack
codec, utils/msgpack.py, and mapped by `convert.state_dict_from_jax`),
then a diffusers snapshot (`model_index.json` layout) through
`convert.read_snapshot`, its family taken from the text encoder's width
unless a preset names it.  A native snapshot holds base weights only: LoRA
leaves found in one are passed over (flax's `from_state_dict` reads only
the keys of the JAX loader's base template), so the adapters keep their
fresh init.  `save_snapshot` writes the native layout, fp32 leaves in the
JAX layout, that the JAX package's `load_models` reads.  A preset is filled with a seeded random init that
follows the JAX package's flax initializers: lecun-normal (truncated)
Dense/Conv kernels with zero biases in the UNet and VAE, normal(0.02)
kernels and embeddings in CLIP, LoRA A ~ N(0, 1/r) and B = 0, ones/zeros
norms.  The random numbers come from one `torch.Generator` per component
(seeds seed, seed+1, seed+2), drawn on the target device; the UNet's
cross-attention LoRA, when asked for, draws from its own (seed+7, the JAX
trainer's key for it), after the base weights, so that the frozen UNet is
the same with and without it.

A preset's bundle is kept in a one-entry memo (`_PRESET_MEMO`, the JAX
package's, textboost_tpu/models/pretrained.py): a `--sequential` sweep and
the eval load the same seeded base once.  The UNet and the VAE are shared
by every taker of the entry; the text encoder, which a trainer grows and
trains and a pipeline binds an instance into, is not: the memo keeps a
pristine copy (`ModelBundle.frozen_text_encoder`, the trainer's frozen
reference, which no taker changes) and each taker gets a fresh copy of it.
A taker that changes a tensor of the shared parts in place (training the
UNet's LoRA, loading weights into them) spends the entry: each tensor's
address, shape and version counter are checked at every take, and the next
load builds anew.  Snapshot dirs are never kept (their contents can change
between calls, the JAX rule), nor is a load with `memo=False` (a
tensor-parallel run splits the frozen modules in place).  Tests clear the
memo with `monkeypatch.setattr(pretrained, "_PRESET_MEMO", {})`.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import math
import os
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device
from ..lora.partition import lora_parameters
from .clip import CLIPTextModel
from .configs import ModelSpec, get_spec
from ..utils import msgpack
from .convert import (
    flatten_tree,
    jax_tree_from_state_dict,
    read_snapshot,
    snapshot_family,
    state_dict_from_jax,
    unflatten_tree,
)
from .layers import GroupNorm, LoRALinear, set_impl
from .unet import UNet2DCondition
from .vae import AutoencoderKL

PARTS = ("text_encoder", "unet", "vae")
NATIVE_SPEC = "spec.json"  # the native snapshot's marker: {"name": <preset>}
UNET_LORA_SEED_OFFSET = 7

# std of a standard normal truncated to [-2, 2]; flax's truncated_normal
# divides by it so that the kept samples have the requested stddev.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class ModelBundle:
    spec: ModelSpec
    text_encoder: CLIPTextModel
    unet: UNet2DCondition
    vae: AutoencoderKL
    # The memo's pristine text encoder, equal to `text_encoder` as loaded
    # and shared by every taker of the entry: read it, never change it.
    # None for a load the memo does not keep.
    frozen_text_encoder: Optional[CLIPTextModel] = None


# One entry: {"key", "bundle" (its text_encoder the pristine copy), "guard"}.
_PRESET_MEMO: dict = {}


def _fingerprint(*modules: nn.Module) -> Tuple:
    """Address, shape, dtype and version counter of every tensor of
    `modules`: any in-place change, a `.data` swap or a split alters it."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype, t._version) for m in modules
                 for t in itertools.chain(m.parameters(), m.buffers()))


def _take_memo(key) -> Optional[ModelBundle]:
    """The memo's bundle for `key` with a fresh copy of its pristine text
    encoder and the shared modules' switches as a load sets them; None (the
    entry dropped if it was spent) when there is none."""
    if _PRESET_MEMO.get("key") != key:
        return None
    kept = _PRESET_MEMO["bundle"]
    if _fingerprint(kept.text_encoder, kept.unet, kept.vae) != _PRESET_MEMO["guard"]:
        _PRESET_MEMO.clear()  # a taker changed a shared tensor
        return None
    for mod in (kept.unet, kept.vae):
        set_impl(mod, "auto")
        mod.eval()
    kept.unet.gradient_checkpointing = False
    te = copy.deepcopy(kept.text_encoder).requires_grad_(True)  # as a load makes it
    return ModelBundle(kept.spec, te, kept.unet, kept.vae, frozen_text_encoder=kept.text_encoder)


def memo_bytes() -> int:
    """Bytes of the memo's pristine text encoder (0 without an entry)."""
    if not _PRESET_MEMO:
        return 0
    te = _PRESET_MEMO["bundle"].text_encoder
    return sum(t.numel() * t.element_size() for t in itertools.chain(te.parameters(),
                                                                     te.buffers()))


def build_models(spec: ModelSpec, *, lora_rank: int = 0, unet_lora_rank: int = 0,
                 device: Union[str, torch.device] = "meta"):
    """Uninitialised (text_encoder, unet, vae) of `spec` on `device`
    ("meta" allocates nothing)."""
    with torch.device(device):
        return (
            CLIPTextModel(spec.text_encoder, lora_rank=lora_rank),
            UNet2DCondition(spec.unet, cross_lora_rank=unet_lora_rank),
            AutoencoderKL(spec.vae),
        )


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    fan_in = w.shape[1] * (w[0, 0].numel() if w.dim() > 2 else 1)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


def _lora_modules(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, LoRALinear) and m.lora_rank > 0]


@torch.no_grad()
def init_lora_(model: nn.Module, gen: torch.Generator) -> None:
    """LoRA A ~ N(0, 1/r), B = 0 for every adapter of `model`."""
    for mod in _lora_modules(model):
        mod.lora_A.weight.normal_(0.0, 1.0 / mod.lora_rank, generator=gen)
        mod.lora_B.weight.zero_()


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator, *, clip: bool,
                 lora: bool = True) -> None:
    """Seeded init following the flax initializers (see module docstring);
    the LoRA adapters are drawn in line after their base weight, or left to
    `init_lora_` when `lora` is False."""
    adapters = {id(m) for mod in _lora_modules(model) for m in (mod.lora_A, mod.lora_B)}
    for mod in model.modules():
        if id(mod) in adapters:
            continue  # filled with their LoRALinear below
        if isinstance(mod, (nn.LayerNorm, GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=gen)
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            if clip:
                mod.weight.normal_(0.0, 0.02, generator=gen)
            else:
                _lecun_normal_(mod.weight, gen)
            if mod.bias is not None:
                mod.bias.zero_()
            if lora and isinstance(mod, LoRALinear) and mod.lora_rank > 0:
                init_lora_(mod, gen)


def _load_part(name: str, mod: nn.Module, state_dict) -> None:
    """Copy a snapshot part into `mod`: every key of each side must be on
    the other, but for the LoRA adapters (`lora_parameters`), which no
    snapshot holds."""
    adapters = {id(p) for p in lora_parameters(mod)}
    lora = {key for key, p in mod.named_parameters() if id(p) in adapters}
    missing, unexpected = mod.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if k not in lora]
    if missing or unexpected:
        raise KeyError(f"the snapshot's {name} does not fit the port's: missing {missing[:5]} "
                       f"({len(missing)}), unexpected {unexpected[:5]} ({len(unexpected)})")


def read_native_snapshot(path: str) -> Tuple[str, Dict[str, Dict[str, torch.Tensor]]]:
    """(spec name, {part: state dict}) of a native snapshot dir: each
    `<part>.msgpack` tree, its LoRA leaves passed over, under the port's
    keys (fp32 tensors over the files' mappings; bf16 leaves cast)."""
    with open(os.path.join(path, NATIVE_SPEC)) as f:
        name = json.load(f)["name"]
    parts = {}
    for part in PARTS:
        file = os.path.join(path, f"{part}.msgpack")
        if not os.path.isfile(file):
            raise FileNotFoundError(f"{file} is missing: a native snapshot holds spec.json and "
                                    f"{', '.join(p + '.msgpack' for p in PARTS)}")
        tree = msgpack.load(file)
        flat = flatten_tree(tree.get("params", tree))
        base = {p: v for p, v in flat.items() if p[-1] not in ("lora_a", "lora_b")}
        try:
            parts[part] = state_dict_from_jax(part, unflatten_tree(base))
        except KeyError as e:
            raise KeyError(f"{file}: {e}") from e
    return name, parts


def save_snapshot(bundle: ModelBundle, out_dir: str) -> None:
    """Write `bundle`'s base weights as a native snapshot: `spec.json` and
    each part's flax param tree, fp32 leaves in the JAX layout (the LoRA
    adapters are left out), one leaf copied to the host at a time."""
    os.makedirs(out_dir, exist_ok=True)
    for part in PARTS:
        mod = getattr(bundle, part)
        adapters = {id(p) for p in lora_parameters(mod)}
        state = {k: v.detach() for k, v in mod.state_dict(keep_vars=True).items()
                 if id(v) not in adapters}
        with open(os.path.join(out_dir, f"{part}.msgpack"), "wb") as f:
            msgpack.dump(jax_tree_from_state_dict(part, state), f, convert=lambda t: t.float())
    with open(os.path.join(out_dir, NATIVE_SPEC), "w") as f:
        json.dump({"name": bundle.spec.name}, f)


def load_models(
    model_name_or_path: Optional[str] = None,
    *,
    preset: Optional[str] = None,
    lora_rank: int = 0,
    unet_lora_rank: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    vae_dtype: Optional[torch.dtype] = None,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    memo: bool = True,
) -> ModelBundle:
    """Snapshot dir (native or diffusers) or preset name -> ModelBundle of frozen-ready
    modules in eval mode, on `device`, cast to `dtype` (the VAE to
    `vae_dtype` when given; GroupNorm affines and LoRA adapters stay fp32).
    `preset` names the family of a diffusers snapshot in place of the
    inferred one; a native snapshot's spec.json names its own (as in the JAX
    package, `preset` is then not read).  A preset's bundle comes from the
    memo when `memo` (module docstring)."""
    dev = resolve_device(device)
    memo_key = (model_name_or_path, preset, lora_rank, unet_lora_rank, str(dtype),
                str(vae_dtype), seed, str(dev))
    disk = bool(model_name_or_path and os.path.isdir(model_name_or_path))
    if memo and not disk:
        kept = _take_memo(memo_key)
        if kept is not None:
            return kept
        _PRESET_MEMO.clear()  # the old entry's memory goes before the new one is built
    snapshot = None
    if disk:
        if os.path.isfile(os.path.join(model_name_or_path, NATIVE_SPEC)):
            spec_name, snapshot = read_native_snapshot(model_name_or_path)
            spec = get_spec(spec_name)
        elif os.path.isfile(os.path.join(model_name_or_path, "model_index.json")):
            snapshot = read_snapshot(model_name_or_path)
            spec = get_spec(preset or snapshot_family(model_name_or_path))
        else:
            raise FileNotFoundError(f"{model_name_or_path} holds neither spec.json (a native "
                                    "snapshot) nor model_index.json (a diffusers snapshot)")
    else:
        spec = get_spec(preset or model_name_or_path or "sd15")
    modules = build_models(spec, lora_rank=lora_rank, unet_lora_rank=unet_lora_rank,
                           device="meta")
    out = []
    for i, (name, mod) in enumerate(zip(PARTS, modules)):
        mod_dtype = vae_dtype if name == "vae" and vae_dtype else dtype
        mod = mod.to_empty(device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        if snapshot is None:
            init_weights(mod, gen, clip=name == "text_encoder", lora=name == "text_encoder")
            mod = mod.to(mod_dtype)
        else:
            mod = mod.to(mod_dtype)  # the copy casts each tensor once, as stored
            _load_part(name, mod, snapshot.pop(name))
            if name == "text_encoder":
                init_lora_(mod, gen)
        if name == "unet":
            init_lora_(mod, torch.Generator(device=dev).manual_seed(seed + UNET_LORA_SEED_OFFSET))
        out.append(mod.eval())
    bundle = ModelBundle(spec, *out)
    if memo and not disk:
        pristine = copy.deepcopy(bundle.text_encoder)
        kept = ModelBundle(spec, pristine, bundle.unet, bundle.vae)
        _PRESET_MEMO.update(key=memo_key, bundle=kept,
                            guard=_fingerprint(pristine, bundle.unet, bundle.vae))
        bundle.frozen_text_encoder = pristine
    return bundle
