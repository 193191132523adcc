"""Weights from the JAX package's param trees into the port's modules.

`state_dict_from_jax(kind, params)` takes a JAX param tree (`{"params":
{...}}` as nested dicts of numpy arrays) of the text encoder, UNet or VAE
and returns the port's state dict.  The name mapping is a copy of
textboost_tpu/models/convert.py (flax path -> diffusers/transformers key);
the layout rules are: Dense kernel [in, out] -> weight [out, in]; Conv
kernel HWIO -> OIHW; lora_a [in, r] -> lora_A.weight [r, in]; lora_b
[r, out] -> lora_B.weight [out, r].  Only numpy is needed: the tree is
flattened here, without flax.

`read_snapshot` reads a local diffusers snapshot (the `model_index.json`
layout) into the port's state dicts: the counterpart of
`_load_torch_dir` and `load_diffusers_snapshot` of
textboost_tpu/models/convert.py.  The port's keys are diffusers' and
transformers' own, so no name mapping is needed beyond the legacy VAE
attention names and the text encoder's `position_ids` buffer.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..lora.peft_io import load_safetensors, safetensors_header

Path = Tuple[str, ...]


def flatten_tree(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    """Nested dicts -> {path tuple: leaf}."""
    out: Dict[Path, np.ndarray] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def _wb(leaf: str) -> str:
    return {"kernel": "weight", "bias": "bias"}[leaf]


def _nb(leaf: str) -> str:
    return {"scale": "weight", "bias": "bias"}[leaf]


def clip_key(path: Path) -> Tuple[str, str]:
    """CLIP flax path -> (torch key, kind in linear|norm|embed)."""
    if path[0] == "token_embedding":
        return "text_model.embeddings.token_embedding.weight", "embed"
    if path[0] == "position_embedding":
        return "text_model.embeddings.position_embedding.weight", "embed"
    if path[0] == "final_layer_norm":
        return f"text_model.final_layer_norm.{_nb(path[-1])}", "norm"
    m = re.match(r"layers_(\d+)$", path[0])
    if m:
        i = m.group(1)
        rest = path[1:]
        if rest[0] == "self_attn":
            return f"text_model.encoder.layers.{i}.self_attn.{rest[1]}.{_wb(path[-1])}", "linear"
        if rest[0] in ("layer_norm1", "layer_norm2"):
            return f"text_model.encoder.layers.{i}.{rest[0]}.{_nb(path[-1])}", "norm"
        if rest[0] == "mlp":
            return f"text_model.encoder.layers.{i}.mlp.{rest[1]}.{_wb(path[-1])}", "linear"
    raise KeyError(f"No torch mapping for CLIP leaf: {'/'.join(path)}")


def unet_key(path: Path) -> Tuple[str, str]:
    """UNet flax path -> (torch key, kind in linear|conv|norm)."""
    name = "/".join(path)
    leaf = path[-1]

    def attn_inner(prefix: str, rest: Path) -> Tuple[str, str]:
        if rest[0] == "norm":
            return f"{prefix}.norm.{_nb(leaf)}", "norm"
        if rest[0] in ("proj_in", "proj_out"):
            return f"{prefix}.{rest[0]}.{_wb(leaf)}", "conv"
        m = re.match(r"transformer_blocks_(\d+)$", rest[0])
        if m:
            inner = rest[1:]
            base = f"{prefix}.transformer_blocks.{m.group(1)}"
            if inner[0] in ("attn1", "attn2"):
                sub = "to_out.0" if inner[1] == "to_out" else inner[1]
                return f"{base}.{inner[0]}.{sub}.{_wb(leaf)}", "linear"
            if inner[0] in ("norm1", "norm2", "norm3"):
                return f"{base}.{inner[0]}.{_nb(leaf)}", "norm"
            if inner[0] == "ff":
                if inner[1] == "net_0":
                    return f"{base}.ff.net.0.proj.{_wb(leaf)}", "linear"
                return f"{base}.ff.net.2.{_wb(leaf)}", "linear"
        raise KeyError(f"No torch mapping for attention leaf: {name}")

    def resnet_inner(prefix: str, rest: Path) -> Tuple[str, str]:
        part = rest[0]
        if part in ("norm1", "norm2"):
            return f"{prefix}.{part}.{_nb(leaf)}", "norm"
        if part in ("conv1", "conv2", "conv_shortcut"):
            return f"{prefix}.{part}.{_wb(leaf)}", "conv"
        if part == "time_emb_proj":
            return f"{prefix}.time_emb_proj.{_wb(leaf)}", "linear"
        raise KeyError(f"No torch mapping for resnet leaf: {name}")

    if path[0] in ("conv_in", "conv_out"):
        return f"{path[0]}.{_wb(leaf)}", "conv"
    if path[0] == "conv_norm_out":
        return f"conv_norm_out.{_nb(leaf)}", "norm"
    if path[0] == "time_embedding_linear_1":
        return f"time_embedding.linear_1.{_wb(leaf)}", "linear"
    if path[0] == "time_embedding_linear_2":
        return f"time_embedding.linear_2.{_wb(leaf)}", "linear"
    m = re.match(r"(down|up)_(\d+)_(resnet|attn)_(\d+)$", path[0])
    if m:
        prefix = f"{m.group(1)}_blocks.{m.group(2)}."
        if m.group(3) == "resnet":
            return resnet_inner(prefix + f"resnets.{m.group(4)}", path[1:])
        return attn_inner(prefix + f"attentions.{m.group(4)}", path[1:])
    m = re.match(r"down_(\d+)_downsample$", path[0])
    if m:
        return f"down_blocks.{m.group(1)}.downsamplers.0.conv.{_wb(leaf)}", "conv"
    m = re.match(r"up_(\d+)_upsample$", path[0])
    if m:
        return f"up_blocks.{m.group(1)}.upsamplers.0.conv.{_wb(leaf)}", "conv"
    if path[0] in ("mid_resnet_0", "mid_resnet_1"):
        return resnet_inner(f"mid_block.resnets.{path[0][-1]}", path[1:])
    if path[0] == "mid_attn":
        return attn_inner("mid_block.attentions.0", path[1:])
    raise KeyError(f"No torch mapping for UNet leaf: {name}")


def vae_key(path: Path) -> Tuple[str, str]:
    """VAE flax path -> (torch key, kind in linear|conv|norm)."""
    name = "/".join(path)
    leaf = path[-1]
    if path[0] in ("quant_conv", "post_quant_conv"):
        return f"{path[0]}.{_wb(leaf)}", "conv"
    side, rest = path[0], path[1:]  # encoder | decoder
    if rest[0] in ("conv_in", "conv_out"):
        return f"{side}.{rest[0]}.{_wb(leaf)}", "conv"
    if rest[0] == "conv_norm_out":
        return f"{side}.conv_norm_out.{_nb(leaf)}", "norm"
    m = re.match(r"(down|up)_(\d+)_resnet_(\d+)$", rest[0])
    if m:
        prefix = f"{side}.{m.group(1)}_blocks.{m.group(2)}.resnets.{m.group(3)}"
    elif rest[0] in ("mid_resnet_0", "mid_resnet_1"):
        prefix = f"{side}.mid_block.resnets.{rest[0][-1]}"
    elif rest[0] == "mid_attn":
        sub, kind = {
            "group_norm": ("group_norm", "norm"),
            "to_q": ("to_q", "linear"),
            "to_k": ("to_k", "linear"),
            "to_v": ("to_v", "linear"),
            "to_out": ("to_out.0", "linear"),
        }[rest[1]]
        suffix = _nb(leaf) if kind == "norm" else _wb(leaf)
        return f"{side}.mid_block.attentions.0.{sub}.{suffix}", kind
    else:
        m = re.match(r"(down|up)_(\d+)_(downsample|upsample)$", rest[0])
        if not m:
            raise KeyError(f"No torch mapping for VAE leaf: {name}")
        return f"{side}.{m.group(1)}_blocks.{m.group(2)}.{m.group(3)}rs.0.conv.{_wb(leaf)}", "conv"
    part = rest[1]
    if part in ("norm1", "norm2"):
        return f"{prefix}.{part}.{_nb(leaf)}", "norm"
    return f"{prefix}.{part}.{_wb(leaf)}", "conv"


KEY_MAPPERS = {"text_encoder": clip_key, "unet": unet_key, "vae": vae_key}


def state_dict_from_jax(kind: str, params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX param tree of `kind` (text_encoder|unet|vae) -> port state dict
    (fp32 CPU tensors)."""
    mapper = KEY_MAPPERS[kind]
    tree = params["params"] if "params" in params else params
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in flatten_tree(tree).items():
        arr = np.asarray(leaf, np.float32)
        if path[-1] in ("lora_a", "lora_b"):  # the TE's q/k/v or the UNet's attn2 to_k/to_v
            if kind == "vae":
                raise KeyError(f"No torch mapping for VAE leaf: {'/'.join(path)}")
            base, _ = mapper(path[:-1] + ("kernel",))
            key = base[: -len("weight")] + ("lora_A.weight" if path[-1] == "lora_a" else "lora_B.weight")
            arr = arr.T  # [in, r] -> [r, in]; [r, out] -> [out, r]
        else:
            key, kind_ = mapper(path)
            if kind_ == "linear" and arr.ndim == 2:
                arr = arr.T
            elif kind_ == "conv" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif kind_ == "conv" and arr.ndim == 2:
                arr = arr.T
        out[key] = torch.tensor(arr)  # a copy: JAX's arrays are read-only
    return out


# Hub checkpoints written by pre-0.17 diffusers name the VAE attention
# query/key/value/proj_attn (proj layers sometimes as [out, in, 1, 1]
# convs); diffusers remaps them at load time, and so does the port.
_VAE_LEGACY_ATTN = {
    "to_q": "query",
    "to_k": "key",
    "to_v": "value",
    "to_out.0": "proj_attn",
}


def remap_legacy_vae_keys(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A VAE state dict with legacy attention names -> current names."""
    legacy_to_new = {v: k for k, v in _VAE_LEGACY_ATTN.items()}
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        if ".attentions.0." in key:
            base, rest = key.split(".attentions.0.")
            sub, suffix = rest.rsplit(".", 1)
            if sub in legacy_to_new:
                key = f"{base}.attentions.0.{legacy_to_new[sub]}.{suffix}"
                if val.dim() == 4 and tuple(val.shape[2:]) == (1, 1):
                    val = val[:, :, 0, 0]
        out[key] = val
    return out


TOKEN_EMBEDDING_KEY = "text_model.embeddings.token_embedding.weight"
# Older transformers checkpoints carry this buffer; the port's CLIP computes
# the positions, so the key is dropped by name (and no other).
POSITION_IDS_KEY = "text_model.embeddings.position_ids"
FAMILY_BY_WIDTH = {768: "sd15", 1024: "sd21base"}  # the text encoder's width


def _weight_files(path: str, suffix: str):
    return sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(suffix))


def read_weights_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every `*.safetensors` file of a snapshot part's folder, else its
    `.bin` files (torch pickles, loaded with weights_only) -> {key: CPU
    tensor in the stored dtype (BF16 as float32)}."""
    files = _weight_files(path, ".safetensors")
    if files:
        return {k: torch.from_numpy(v) for f in files for k, v in load_safetensors(f).items()}
    bins = _weight_files(path, ".bin")
    if not bins:
        raise FileNotFoundError(f"No weight files under {path}")
    out: Dict[str, torch.Tensor] = {}
    for f in bins:
        out.update(torch.load(f, map_location="cpu", weights_only=True))
    return out


def snapshot_family(path: str) -> str:
    """sd15 or sd21base from the text encoder's width (768 / 1024), read from
    the safetensors header (from the `.bin` file when there is none)."""
    te_dir = os.path.join(path, "text_encoder")
    shape = None
    for f in _weight_files(te_dir, ".safetensors"):
        info = safetensors_header(f).get(TOKEN_EMBEDDING_KEY)
        shape = info["shape"] if info else shape
    if shape is None:
        shape = list(read_weights_dir(te_dir)[TOKEN_EMBEDDING_KEY].shape)
    if shape[1] not in FAMILY_BY_WIDTH:
        raise ValueError(f"{path}: a text encoder of width {shape[1]} is neither sd15 (768) "
                         "nor sd21base (1024)")
    return FAMILY_BY_WIDTH[shape[1]]


def read_snapshot(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"text_encoder", "unet", "vae": state dict} of a diffusers snapshot
    dir, under the port's keys."""
    te = read_weights_dir(os.path.join(path, "text_encoder"))
    te.pop(POSITION_IDS_KEY, None)
    return {"text_encoder": te, "unet": read_weights_dir(os.path.join(path, "unet")),
            "vae": remap_legacy_vae_keys(read_weights_dir(os.path.join(path, "vae")))}
