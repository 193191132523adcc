"""Tensor-parallel validation at a preset's real dims, without weights.

Counterpart of textboost_tpu/parallel/validate.py, which lowers the JAX
train step over a (dp, tp) mesh of `ShapeDtypeStruct`s.  Here every model
is built on the meta device (shapes only, no memory): the UNet (with its
cross-attention LoRA), the frozen text encoder and the trainable one.  For
each rank of the tp group the frozen two are split by that rank's plan
(parallel/tensor.py::shard_), and the shards of every split weight are
checked to tile the whole: each index of its split axis held by exactly
one rank.  On one rank's shards (they all have the same shapes) the
step's text encodes and the UNet's forward and backward run (the
collectives are counted, not run, on the meta device): the report gives a
train step's all-reduces.  The trainable encoder stays whole, as in the
trainer.

    python -m textboost_torch.parallel.validate --preset sd21base --tp 2
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import torch

from ..models.clip import CLIPTextModel
from ..models.configs import get_spec
from ..models.layers import set_impl
from ..models.unet import UNet2DCondition
from .tensor import TP_RULES, TensorParallel, shard_, tp_rule_report


def _models(spec, lora_rank: int, dtype: torch.dtype) -> Dict[str, torch.nn.Module]:
    with torch.device("meta"):
        models = {"unet": UNet2DCondition(spec.unet, cross_lora_rank=lora_rank),
                  "frozen_text_encoder": CLIPTextModel(spec.text_encoder, lora_rank=lora_rank),
                  "text_encoder": CLIPTextModel(spec.text_encoder, lora_rank=lora_rank)}
    for name, model in models.items():
        model.to(dtype)
        set_impl(model, "math")  # the kernels take no meta tensors
        for key, p in model.named_parameters():
            p.requires_grad_(name == "text_encoder" or ".lora_" in key)
    return models


def validate_tp_rules_at_shape(preset: str = "sd15", tp: int = 2, batch: int = 2,
                               lora_rank: int = 4, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The tp rules' report at `preset`'s dims: the weights each rule
    splits (`tp_rule_matches`, over the UNet and the frozen encoder, as the
    JAX report counts them), those a rule matched that stay whole
    (`whole`), and the all-reduces of a train step at `batch` in `dtype`
    (`collectives`: forward and backward calls, bytes; the frozen
    encoder's KPL encode and the UNet's forward and backward with its LoRA
    training).  Raises when a rank's shards do not tile a weight or the
    sharded step's shapes are not the whole step's."""
    spec = get_spec(preset)
    full = _models(spec, lora_rank, dtype)
    counts = {pattern: 0 for pattern, _ in TP_RULES}
    whole: Dict[str, tuple] = {}
    for name in ("unet", "frozen_text_encoder"):
        c, w = tp_rule_report(full[name], tp)
        counts = {k: counts[k] + c[k] for k in counts}
        whole.update({f"{name}/{k}": v for k, v in w.items()})
    shapes = {name: {k: tuple(p.shape) for k, p in m.named_parameters()}
              for name, m in full.items()}

    held: Dict[str, Tuple[int, List[torch.Tensor]]] = {}  # key -> (dim, each rank's indices)
    size = spec.unet.sample_size
    meta = torch.device("meta")
    ids = torch.zeros(batch, spec.text_encoder.max_position_embeddings, dtype=torch.long,
                      device=meta)
    for rank in range(tp):
        models = _models(spec, lora_rank, dtype)
        group = TensorParallel(None, tp, rank)
        for name in ("unet", "frozen_text_encoder"):
            plan = shard_(models[name], group)
            params = dict(models[name].named_parameters())
            for key, (_, dim, idx) in plan.splits.items():
                want = list(shapes[name][key])
                want[dim] = len(idx)
                if list(params[key].shape) != want:
                    raise AssertionError(f"rank {rank}'s {name} {key} is {tuple(params[key].shape)}, "
                                         f"its plan {tuple(want)}")
                held.setdefault(f"{name}/{key}", (dim, []))[1].append(idx)
        if rank < tp - 1:
            continue  # every rank's shards have the same shapes: one step suffices
        hidden, _ = models["text_encoder"](ids)
        with torch.no_grad():
            ref, _ = models["frozen_text_encoder"](ids, use_lora=False)
        pred = models["unet"](torch.empty(batch, spec.unet.in_channels, size, size, device=meta,
                                          dtype=dtype),
                              torch.zeros(batch, dtype=torch.long, device=meta), hidden)
        if ref.shape != hidden.shape or pred.shape != (batch, spec.unet.out_channels, size, size):
            raise AssertionError(f"rank {rank}: the sharded step gave {tuple(ref.shape)} and "
                                 f"{tuple(pred.shape)}")
        pred.float().sum().backward()
    for key, (dim, parts) in held.items():
        name, weight = key.split("/", 1)
        n = shapes[name][weight][dim]
        if len(parts) != tp or not torch.equal(torch.cat(parts).sort().values, torch.arange(n)):
            raise AssertionError(f"the shards of {key} on {len(parts)} of {tp} ranks do not "
                                 f"tile its {n} indices")
    return {"preset": preset, "tp": tp, "batch": batch, "tp_rule_matches": counts,
            "whole": whole, "split_weights": len(held),
            "collectives": {"fwd": group.kinds.count("fwd"), "bwd": group.kinds.count("bwd"),
                            "bytes": sum(group.bytes)}}


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="sd15")
    parser.add_argument("--tp", type=int, default=2)
    args = parser.parse_args(argv)
    print(json.dumps(validate_tp_rules_at_shape(args.preset, args.tp)))


if __name__ == "__main__":
    main()
