"""On-disk artifacts of a TextBoost run, read and written by the port.

Counterpart of textboost_tpu/lora/peft_io.py:
  1. the PEFT text-encoder adapter dir (`adapter_model.safetensors` +
     `adapter_config.json`, keys
     `base_model.model.text_model.encoder.layers.{i}.self_attn.{q,k,v}_proj.lora_{A,B}.weight`);
  2. the UNet's cross-attention adapter dir `unet/` of
     `--unet_params_to_train crossattn_kv`, in the same layout, keyed by
     diffusers module paths (`base_model.model.down_blocks.1.attentions.0.
     transformer_blocks.0.attn2.to_k.lora_A.weight`, target_modules
     attn2.to_k / attn2.to_v), as the JAX package writes it in place of the
     reference's full `unet.save_pretrained`;
  3. per-token textual-inversion files `{token}.bin` holding {token: tensor}.

The safetensors format is read and written here, for the whole port, with
torch and `struct` (no safetensors package): an 8-byte little-endian header
length, a JSON header {name: {dtype, shape, data_offsets}}, then the raw
little-endian tensor bytes.
"""
from __future__ import annotations

import functools
import json
import os
import re
import struct
from typing import Callable, Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.clip import CLIPTextModel
from ..models.layers import LoRALinear

_LAYER_RE = re.compile(r"layers\.(\d+)\.self_attn\.([qkv]_proj)\.lora_([AB])\.weight")

PEFT_PREFIX = "base_model.model.text_model.encoder.layers"
UNET_PEFT_PREFIX = "base_model.model"
UNET_TARGETS = ("attn2.to_k", "attn2.to_v")
_UNET_KEY_RE = re.compile(re.escape(UNET_PEFT_PREFIX) + r"\.(.+)\.lora_([AB])\.weight$")

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def _read_header(f) -> Tuple[Dict[str, dict], int]:
    (n,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(n)), 8 + n


def safetensors_header(path: str) -> Dict[str, dict]:
    """The JSON header of a .safetensors file: {name: {dtype, shape,
    data_offsets}} (and `__metadata__`), without reading any tensor."""
    with open(path, "rb") as f:
        return _read_header(f)[0]


def _read_tensor(path: str, data_start: int, name: str, info: dict) -> torch.Tensor:
    begin, end = info["data_offsets"]
    t = torch.empty(info["shape"], dtype=_ST_DTYPES[info["dtype"]])
    raw = t.reshape(-1).view(torch.uint8).numpy()
    if raw.nbytes != end - begin:
        raise ValueError(f"{path}: {name} spans {end - begin} bytes, its shape and dtype "
                         f"{raw.nbytes}")
    with open(path, "rb") as f:
        f.seek(data_start + begin)
        if f.readinto(raw) != raw.nbytes:
            raise ValueError(f"{path}: {name} is cut short")
    return t


def safetensors_readers(path: str) -> Dict[str, Callable[[], torch.Tensor]]:
    """{name: reader} of a .safetensors file, read from its header alone.
    Each reader reads its tensor from its offset straight into a CPU tensor
    of the stored dtype (BF16 kept), so a caller holds one tensor at a time,
    never the file (little-endian host)."""
    with open(path, "rb") as f:
        header, data_start = _read_header(f)
    return {name: functools.partial(_read_tensor, path, data_start, name, info)
            for name, info in header.items() if name != "__metadata__"}


def safetensors_mapped(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a .safetensors file over a copy-on-write
    mapping of it: nothing is read until a tensor is (BF16 kept)."""
    import mmap

    with open(path, "rb") as f:
        header, data_start = _read_header(f)
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _ST_DTYPES[info["dtype"]]
        if end == begin:  # frombuffer takes no empty span
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        t = torch.frombuffer(buf, dtype=dtype, offset=data_start + begin,
                             count=(end - begin) // dtype.itemsize)
        out[name] = t.reshape(info["shape"])
    return out


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a .safetensors file -> {name: numpy array} (BF16 as float32)."""
    out: Dict[str, np.ndarray] = {}
    for name, read in safetensors_readers(path).items():
        t = read()
        out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def save_safetensors(tensors: Mapping[str, Union[np.ndarray, torch.Tensor]], path: str) -> None:
    """Write {name: numpy array or torch tensor} as a .safetensors file
    (BF16 kept).  Tensors on a device are copied to the host one at a
    time, as they are written."""
    items = [(name, torch.as_tensor(tensors[name])) for name in sorted(tensors)]
    header, offset = {}, 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for _, t in items:
            f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())


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


def unet_lora_weights(unet) -> Dict[str, torch.nn.Parameter]:
    """{PEFT key: weight} of the UNet's cross-attention adapters (A and B of
    each LoRA projection built with a rank), in module order: the one
    enumeration that the `unet/` dir, its importer and the checkpoint's
    state share."""
    weights: Dict[str, torch.nn.Parameter] = {}
    for name, mod in unet.named_modules():
        if isinstance(mod, LoRALinear) and mod.lora_rank > 0:
            for ab, lin in (("A", mod.lora_A), ("B", mod.lora_B)):
                weights[f"{UNET_PEFT_PREFIX}.{name}.lora_{ab}.weight"] = lin.weight
    return weights


def unet_lora_tensors(unet) -> Dict[str, np.ndarray]:
    """{PEFT key: fp32 numpy copy} of the UNet's cross-attention adapters."""
    weights = unet_lora_weights(unet)
    if not weights:
        raise ValueError("the UNet was built without its cross-attention LoRA")
    return {key: w.detach().float().cpu().numpy() for key, w in weights.items()}


def export_unet_lora_adapter(unet, out_dir: str, rank: int, **kwargs) -> str:
    """Write the UNet's cross-attention adapters as the PEFT-style `unet/`
    dir (`write_lora_adapter`'s keyword arguments pass through)."""
    return write_lora_adapter(unet_lora_tensors(unet), out_dir, rank,
                              target_modules=UNET_TARGETS, **kwargs)


def adapter_rank(adapter_dir: str) -> int:
    """The rank `r` of an adapter dir's adapter_config.json."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        return int(json.load(f)["r"])


@torch.no_grad()
def import_unet_lora_adapter(unet, adapter_dir: str) -> None:
    """Copy a `unet/` adapter's weights into the UNet's cross-attention LoRA
    modules, in place (the UNet must have been built with the adapter's
    rank, `cross_lora_rank`).  The adapter must hold every one of the
    UNet's LoRA weights: a partial one raises before anything is copied."""
    tensors = load_safetensors(os.path.join(adapter_dir, "adapter_model.safetensors"))
    weights = unet_lora_weights(unet)
    for name, arr in tensors.items():
        m = _UNET_KEY_RE.match(name)
        if not m:
            raise ValueError(f"Unrecognized UNet adapter key: {name}")
        if name not in weights:
            raise ValueError(f"the UNet has no cross-attention LoRA at {m.group(1)}; was it "
                             "built with cross_lora_rank > 0?")
        if tuple(arr.shape) != tuple(weights[name].shape):
            raise ValueError(f"Rank mismatch for {name}: adapter {arr.shape} vs model "
                             f"{tuple(weights[name].shape)}")
    missing = [key for key in weights if key not in tensors]
    if missing:
        raise ValueError(f"the adapter in {adapter_dir} lacks {len(missing)} of the UNet's "
                         f"{len(weights)} LoRA weights, e.g. {missing[:2]}")
    for name, arr in tensors.items():
        weights[name].copy_(torch.from_numpy(arr))


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
