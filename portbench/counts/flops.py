"""Model FLOPs: the operations of the matrix products and convolutions that
the work needs, counted by `torch.utils.flop_counter.FlopCounterMode` over
the reference on the meta device, whatever implements them.

A train step counts the VAE encode, the text encoder's three passes (the
captions with LoRA, the KPL prompts with LoRA and without), the UNet
forward, and the backward that the loss needs: activation gradients through
the UNet and the text encoder, and weight gradients only for the LoRA
weights and the token table.  Nothing is recomputed.  A sampling call
counts the text encoder on both guidance branches, `steps` UNet forwards
at twice the batch, and the VAE decode.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import models


def _meta(config: dict, lora_rank: int):
    mods = models.build(models.Ops(), config, lora_rank=lora_rank, device="meta")
    for m in mods.values():
        m.requires_grad_(False)
    return mods


def train_step(config: dict, batch: int, lora_rank: int) -> int:
    mods = _meta(config, lora_rank)
    te, unet, vae = mods["text_encoder"], mods["unet"], mods["vae"]
    for k, p in te.named_parameters():
        p.requires_grad_(".lora_" in k)
    res, lat = config["resolution"], config["unet"]["in_channels"]
    dev = "meta"
    hidden = config["text_encoder"]["hidden_size"]
    table = torch.empty(config["text_encoder"]["vocab_size"] + 16, hidden, device=dev,
                        requires_grad=True)
    ids = torch.zeros(batch, 77, dtype=torch.long, device=dev)
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            vae.encode(torch.empty(batch, 3, res, res, device=dev))
        ctx = te(ids, table=table)
        pred = unet(torch.empty(batch, lat, res // 8, res // 8, device=dev),
                    torch.zeros(batch, dtype=torch.long, device=dev), ctx)
        tuned = te(ids, table=table)
        with torch.no_grad():
            te(ids, use_lora=False)
        (pred.square().mean() + tuned.square().mean()).backward()
    return counter.get_total_flops()


def sample_call(config: dict, batch: int, steps: int, lora_rank: int) -> int:
    mods = _meta(config, lora_rank)
    te, unet, vae = mods["text_encoder"], mods["unet"], mods["vae"]
    res, lat = config["resolution"], config["unet"]["in_channels"]
    dev = "meta"
    ids = torch.zeros(batch, 77, dtype=torch.long, device=dev)
    ctx = torch.empty(2 * batch, 77, config["text_encoder"]["hidden_size"], device=dev)
    x = torch.empty(2 * batch, lat, res // 8, res // 8, device=dev)
    t = torch.zeros(2 * batch, dtype=torch.long, device=dev)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        unet(x, t, ctx)
    unet_flops = counter.get_total_flops()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        vae.decode(torch.empty(batch, lat, res // 8, res // 8, device=dev))
    return _te_flops(te, ids, 2) + steps * unet_flops + counter.get_total_flops()


def _te_flops(te, ids, passes: int) -> int:
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        te(ids)
    return passes * counter.get_total_flops()
