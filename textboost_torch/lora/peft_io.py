"""On-disk artifacts of a TextBoost run, read and written by the port.

Counterpart of textboost_tpu/lora/peft_io.py:
  1. the PEFT text-encoder adapter dir (`adapter_model.safetensors` +
     `adapter_config.json`, keys
     `base_model.model.text_model.encoder.layers.{i}.self_attn.{q,k,v}_proj.lora_{A,B}.weight`);
  2. per-token textual-inversion files `{token}.bin` holding {token: tensor}.

The safetensors format is read and written here with numpy and `struct`
(no safetensors package): an 8-byte little-endian header length, a JSON
header {name: {dtype, shape, data_offsets}}, then the raw little-endian
tensor bytes.
"""
from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..models.clip import CLIPTextModel

_LAYER_RE = re.compile(r"layers\.(\d+)\.self_attn\.([qkv]_proj)\.lora_([AB])\.weight")

PEFT_PREFIX = "base_model.model.text_model.encoder.layers"

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a .safetensors file -> {name: numpy array} (BF16 as float32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        raw = data[start:end]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<"))
        out[name] = arr.reshape(info["shape"]).copy()
    return out


def save_safetensors(tensors: Dict[str, np.ndarray], path: str) -> None:
    """Write {name: numpy array} as a .safetensors file."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        header[name] = {
            "dtype": _ST_NAMES[arr.dtype.newbyteorder("=")],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _lora_modules(text_encoder: CLIPTextModel):
    """{(layer, proj): LoRALinear} of the encoder's q/k/v projections."""
    out = {}
    for i, layer in enumerate(text_encoder.text_model.encoder.layers):
        for proj in ("q_proj", "k_proj", "v_proj"):
            out[(str(i), proj)] = getattr(layer.self_attn, proj)
    return out


def lora_tensors(text_encoder: CLIPTextModel) -> Dict[str, np.ndarray]:
    """{PEFT key: fp32 numpy copy} of the encoder's q/k/v adapters."""
    tensors: Dict[str, np.ndarray] = {}
    for (layer, proj), mod in _lora_modules(text_encoder).items():
        if mod.lora_rank == 0:
            raise ValueError("the text encoder was built without LoRA (lora_rank=0)")
        for ab, lin in (("A", mod.lora_A), ("B", mod.lora_B)):
            tensors[f"{PEFT_PREFIX}.{layer}.self_attn.{proj}.lora_{ab}.weight"] = (
                lin.weight.detach().float().cpu().numpy()
            )
    return tensors


def write_lora_adapter(
    tensors: Dict[str, np.ndarray],
    out_dir: str,
    rank: int,
    alpha: float = None,
    base_model_name: str = "",
    target_modules: Sequence[str] = ("q_proj", "k_proj", "v_proj"),
) -> str:
    """Write a PEFT-compatible LoRA adapter dir from `lora_tensors` output."""
    os.makedirs(out_dir, exist_ok=True)
    save_safetensors(tensors, os.path.join(out_dir, "adapter_model.safetensors"))
    config = {
        "peft_type": "LORA",
        "auto_mapping": None,
        "base_model_name_or_path": base_model_name,
        "task_type": None,
        "inference_mode": True,
        "r": rank,
        "lora_alpha": alpha if alpha is not None else rank,
        "lora_dropout": 0.0,
        "fan_in_fan_out": False,
        "bias": "none",
        "init_lora_weights": "gaussian",
        "target_modules": list(target_modules),
        "modules_to_save": None,
    }
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return out_dir


def export_lora_adapter(text_encoder: CLIPTextModel, out_dir: str, rank: int, **kwargs) -> str:
    """Write a PEFT-compatible LoRA adapter dir from the encoder's adapters
    (`write_lora_adapter`'s keyword arguments pass through)."""
    return write_lora_adapter(lora_tensors(text_encoder), out_dir, rank, **kwargs)


@torch.no_grad()
def import_lora_adapter(text_encoder: CLIPTextModel, adapter_dir: str) -> None:
    """Copy a PEFT adapter's weights into the encoder's LoRA modules, in place
    (the encoder must have been built with the adapter's rank)."""
    tensors = load_safetensors(os.path.join(adapter_dir, "adapter_model.safetensors"))
    modules = _lora_modules(text_encoder)
    for name, arr in tensors.items():
        m = _LAYER_RE.search(name)
        if not m:
            raise ValueError(f"Unrecognized adapter key: {name}")
        layer, proj, ab = m.groups()
        mod = modules.get((layer, proj))
        if mod is None or mod.lora_rank == 0:
            raise ValueError(
                f"text encoder has no LoRA at layer {layer} {proj}; was it built with lora_rank>0?"
            )
        weight = (mod.lora_A if ab == "A" else mod.lora_B).weight
        if tuple(arr.shape) != tuple(weight.shape):
            raise ValueError(
                f"Rank mismatch for {name}: adapter {arr.shape} vs model {tuple(weight.shape)}"
            )
        weight.copy_(torch.from_numpy(arr))


def token_bin_filename(token: str) -> str:
    """`{token}.bin` with the `<>` of the token stripped from the filename
    (the dict key inside keeps them)."""
    return token.replace("<", "").replace(">", "") + ".bin"


def export_token_embeddings(
    embedding,
    token_to_id: Dict[str, int],
    out_dir: str,
    aug_tokens: Sequence[str] = (),
) -> List[str]:
    """Write one `{token}.bin` per learned token ({token: tensor} torch
    pickle).  Tokens in `aug_tokens` are saved as [1, hidden], the others
    as [hidden]."""
    emb = torch.as_tensor(embedding).detach().float().cpu()
    os.makedirs(out_dir, exist_ok=True)
    aug = set(aug_tokens)
    paths = []
    for token, tid in token_to_id.items():
        path = os.path.join(out_dir, token_bin_filename(token))
        row = emb[tid].clone()
        if token in aug:
            row = row[None, :]
        torch.save({token: row}, path)
        paths.append(path)
    return paths


def import_token_embeddings(paths: Sequence[str]) -> Dict[str, np.ndarray]:
    """Load `{token}.bin` files -> {token: [hidden] float32}, skipping the
    optimizer/scheduler state files a checkpoint dir also holds."""
    out: Dict[str, np.ndarray] = {}
    for path in paths:
        if os.path.basename(path) in ("optimizer.bin", "scheduler.bin", "scaler.pt"):
            continue
        blob = torch.load(path, map_location="cpu", weights_only=True)
        for token, tensor in blob.items():
            vec = np.asarray(tensor.detach().float().numpy())
            if vec.ndim == 2 and vec.shape[0] == 1:
                vec = vec[0]
            out[token] = vec
    return out
