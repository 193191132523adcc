"""Checkpoint save/restore: the compact trainer state + reference-format exports.

Counterpart of textboost_tpu/train/checkpoint.py, in a format of the port's
own (no orbax): `checkpoint-{step}/` holds
  1. `state.pt` (torch.save of plain tensors and Python scalars, loaded
     with weights_only) and `meta.json`: the compact trainer state;
  2. the PEFT adapter dir `text_encoder/` (and `unet/` when the UNet's
     cross-attention LoRA trains, textboost_tpu/train/checkpoint.py:227-240);
  3. one `{token}.bin` per learned token,
so a periodic checkpoint loads on its own, as the final export does.
Retention follows checkpoints_total_limit (train_textboost.py:1159-1175).

Compact, as the JAX docstring argues (:13-26): frozen weights never go to
disk.  The optimizer pins the original vocabulary rows (their gradient is
zeroed every step, so their AdamW moments stay exactly zero, and the rows
are restored after each update), so the state needs only the ADDED
embedding rows and their moments, the LoRA A/B (the UNet's too, when it
trains) and their moments, both
AdamW groups' step counts, the LR scheduler's state, the step, and the
state of the `torch.Generator` the step's draws come from.  Restore writes
them back into the live modules, optimizer, scheduler and generator; it
assumes the base weights the run started from, which resuming a run with
the same flags and seed rebuilds.

The device-to-host copy is synchronous (a few MB); the files are written on
one writer thread, whose exception is kept and raised at the join.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..lora.partition import FROZEN_LABEL, LORA_LABEL, param_labels
from ..lora.peft_io import (
    UNET_TARGETS,
    export_token_embeddings,
    unet_lora_weights,
    write_lora_adapter,
)

FORMAT = "textboost_torch-compact-v1"
_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")


def checkpoint_dirs(output_dir: str) -> List[str]:
    """Names of the `checkpoint-N` dirs under `output_dir`, by step."""
    if not os.path.isdir(output_dir):
        return []
    entries = [d for d in os.listdir(output_dir) if _CKPT_RE.match(d)]
    return sorted(entries, key=lambda d: int(_CKPT_RE.match(d).group(1)))


def prune_checkpoints(output_dir: str, total_limit: Optional[int]) -> None:
    """Remove the oldest checkpoints so that one more keeps at most
    `total_limit` (the reference makes room before saving, :1165-1175)."""
    if total_limit is None:
        return
    dirs = checkpoint_dirs(output_dir)
    if len(dirs) >= total_limit:
        for d in dirs[: len(dirs) - total_limit + 1]:
            shutil.rmtree(os.path.join(output_dir, d), ignore_errors=True)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    dirs = checkpoint_dirs(output_dir)
    return os.path.join(output_dir, dirs[-1]) if dirs else None


def _embedding_index(optimizer: torch.optim.Optimizer, embedding: torch.Tensor) -> int:
    """Index of the embedding in the optimizer's state_dict numbering."""
    ids = [id(p) for group in optimizer.param_groups for p in group["params"]]
    return ids.index(id(embedding))


def _cpu(value):
    return value.detach().cpu().clone() if isinstance(value, torch.Tensor) else value


def _unet_lora(unet) -> Dict[str, torch.Tensor]:
    """{PEFT key: weight} of the UNet's LoRA adapters (`unet_lora_weights`);
    raises if any other UNet parameter trains (it would be left out of the
    checkpoint)."""
    weights = unet_lora_weights(unet)
    kept = {id(w) for w in weights.values()}
    for name, p in unet.named_parameters():
        if p.requires_grad and id(p) not in kept:
            raise ValueError(f"trainable UNet parameter {name} is not in the compact checkpoint")
    return weights


@torch.no_grad()
def snapshot(text_encoder, optimizer, lr_scheduler, generator: torch.Generator, *,
             step: int, micro_step: int, first_added_id: int, unet=None) -> Dict:
    """CPU copy of the compact state (synchronous); `unet` is given when its
    cross-attention LoRA trains.  Raises if a trainable parameter would be
    left out."""
    labels = param_labels(text_encoder)
    for name, p in text_encoder.named_parameters():
        if p.requires_grad and labels[name] == FROZEN_LABEL:
            raise ValueError(f"trainable parameter {name} is not in the compact checkpoint")
    emb = text_encoder.token_embedding.weight
    opt = optimizer.state_dict()
    emb_idx = _embedding_index(optimizer, emb)
    state = {}
    for idx, entry in opt["state"].items():
        entry = dict(entry)
        if idx == emb_idx:  # only the added rows' moments are not zero
            for key in ("exp_avg", "exp_avg_sq"):
                entry[key] = entry[key][first_added_id:]
        state[idx] = {k: _cpu(v) for k, v in entry.items()}
    return {
        "step": int(step),
        "micro_step": int(micro_step),
        "added_rows": _cpu(emb[first_added_id:].float()),
        "lora": {name: _cpu(p) for name, p in text_encoder.named_parameters()
                 if labels[name] == LORA_LABEL},
        "unet_lora": ({key: _cpu(p) for key, p in _unet_lora(unet).items()}
                      if unet is not None else {}),
        "optimizer": {"state": state, "param_groups": opt["param_groups"]},
        "lr_scheduler": lr_scheduler.state_dict(),
        "generator": generator.get_state(),
    }


def write_checkpoint(ckpt_dir: str, payload: Dict, *, first_added_id: int,
                     token_to_id: Dict[str, int], aug_tokens: Sequence[str],
                     lora_rank: int, base_model_name: str) -> None:
    """The files of one checkpoint, from a `snapshot`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save(payload, os.path.join(ckpt_dir, "state.pt"))
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump({"format": FORMAT, "first_added_id": int(first_added_id),
                   "step": payload["step"]}, f)
    if lora_rank > 0:
        tensors = {"base_model.model." + name: t.float().numpy()
                   for name, t in payload["lora"].items()}
        write_lora_adapter(tensors, os.path.join(ckpt_dir, "text_encoder"), rank=lora_rank,
                           base_model_name=base_model_name)
    if payload["unet_lora"]:
        write_lora_adapter({key: t.float().numpy() for key, t in payload["unet_lora"].items()},
                           os.path.join(ckpt_dir, "unet"), rank=lora_rank,
                           base_model_name=base_model_name, target_modules=UNET_TARGETS)
    export_token_embeddings(payload["added_rows"],
                            {t: tid - first_added_id for t, tid in token_to_id.items()},
                            ckpt_dir, aug_tokens=aug_tokens)


def save_checkpoint(output_dir: str, step: int, payload: Dict, *,
                    total_limit: Optional[int] = None,
                    **write_kwargs) -> Tuple[str, threading.Thread]:
    """Prune, then write `checkpoint-{step}/` from `payload` (a `snapshot`)
    on a daemon thread, which keeps its exception in `.exception` and its
    wall time in `.seconds`.  Returns (checkpoint dir, thread)."""
    prune_checkpoints(output_dir, total_limit)
    ckpt_dir = os.path.join(output_dir, f"checkpoint-{step}")

    def run():
        t0 = time.perf_counter()
        try:
            write_checkpoint(ckpt_dir, payload, **write_kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised at the join
            thread.exception = e
        thread.seconds = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True, name=f"ckpt-writer-{step}")
    thread.exception, thread.seconds = None, None
    thread.start()
    return ckpt_dir, thread


def resolve_checkpoint(path: str) -> Optional[str]:
    """`path` if it is a checkpoint dir, else its latest checkpoint (None
    when it holds none)."""
    if _CKPT_RE.match(os.path.basename(os.path.normpath(path))):
        return path
    return latest_checkpoint(path)


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, text_encoder, optimizer, lr_scheduler,
                       generator: torch.Generator, first_added_id: int, unet=None) -> Dict:
    """Write a checkpoint's state back into the live modules (the UNet's
    cross-attention LoRA when `unet` is given), optimizer, scheduler and
    generator.  Returns {"step", "micro_step"}."""
    meta_path = os.path.join(ckpt_dir, "meta.json")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{ckpt_dir} has no meta.json: not a textboost_torch checkpoint")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{ckpt_dir} has format {meta.get('format')!r}, not {FORMAT!r}")
    if meta.get("first_added_id") != int(first_added_id):
        raise ValueError(
            f"checkpoint {ckpt_dir} was saved with first_added_id="
            f"{meta.get('first_added_id')}, this run has {first_added_id}: "
            "did the token configuration change?")
    payload = torch.load(os.path.join(ckpt_dir, "state.pt"), map_location="cpu",
                         weights_only=True)
    emb = text_encoder.token_embedding.weight
    if payload["added_rows"].shape != emb[first_added_id:].shape:
        raise ValueError(f"checkpoint {ckpt_dir} holds {tuple(payload['added_rows'].shape)} "
                         f"added rows, this run {tuple(emb[first_added_id:].shape)}")
    emb[first_added_id:] = payload["added_rows"].to(emb.dtype)
    params = dict(text_encoder.named_parameters())
    for name, value in payload["lora"].items():
        params[name].copy_(value)
    unet_lora = _unet_lora(unet) if unet is not None else {}
    saved_unet_lora = payload.get("unet_lora", {})  # absent from checkpoints before it
    if set(unet_lora) != set(saved_unet_lora):
        raise ValueError(f"checkpoint {ckpt_dir} holds {len(saved_unet_lora)} UNet LoRA "
                         f"tensors, this run trains {len(unet_lora)}: did "
                         "--unet_params_to_train change?")
    for key, value in saved_unet_lora.items():
        unet_lora[key].copy_(value)
    opt = payload["optimizer"]
    emb_idx = _embedding_index(optimizer, emb)
    state = {}
    for idx, entry in opt["state"].items():
        entry = dict(entry)
        if idx == emb_idx:
            for key in ("exp_avg", "exp_avg_sq"):
                full = torch.zeros(emb.shape, dtype=entry[key].dtype)
                full[first_added_id:] = entry[key]
                entry[key] = full
        state[idx] = entry
    optimizer.load_state_dict({"state": state, "param_groups": opt["param_groups"]})
    lr_scheduler.load_state_dict(payload["lr_scheduler"])
    generator.set_state(payload["generator"])
    return {"step": payload["step"], "micro_step": payload["micro_step"]}
