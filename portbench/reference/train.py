"""The TextBoost train step, written out for the reference, in float32.

One step on a batch of uint8 pixels [B, H, W, 3], caption ids [B, 77] and
KPL prompt ids [B, 77], with the draws of `draws`:
  1. pixels / 127.5 - 1 -> VAE encode -> latents = (mean + e^(logvar/2) eps)
     x the VAE's scaling factor;
  2. noisy = sqrt(a_t) latents + sqrt(1 - a_t) noise, a_t of the scaled-linear
     DDPM schedule (1000 steps, 0.00085 .. 0.012);
  3. the CLIP encoder with its LoRA over the grown token table, and
     TextBoost's null patch (empty prompts take the null embedding, position
     0 of every row its first vector);
  4. the UNet's epsilon prediction, its mean squared error against the
     noise;
  5. KPL: 1 - cosine, over the last axis, between the tuned encoder and the
     frozen one (no LoRA, the base table) on the KPL prompts, both patched,
     averaged, times the KPL weight;
  6. backward into the table and the LoRA weights; the table's rows below
     the first added id get no gradient; the LoRA gradients are clipped
     together to a global norm of `max_grad_norm`;
  7. AdamW with two groups (the table at `emb_lr`, the LoRA weights at
     `lr`), decoupled decay;
  8. the original rows restored exactly, and every added row scaled to a
     norm of at most the target norm (the mean row norm of the grown table
     before training).
The UNet's forward and backward run over micro-batches of the batch, each
weighted by its share of the mean, so that the reference fits in memory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .models import null_patch


def alphas_cumprod(n: int = 1000, beta_start: float = 0.00085, beta_end: float = 0.012):
    """float32 [n]: computed in float64, cast once."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n, dtype=np.float64) ** 2
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))


def draws(generator: torch.Generator, batch: int, latent_shape, n_timesteps: int = 1000):
    """A step's random numbers, in the order they are drawn: the posterior's
    epsilon and the noise, fp32 [B, C, h, w], then uniform timesteps [B]."""
    dev = generator.device
    shape = (batch, *latent_shape)
    return {"vae_eps": torch.randn(shape, generator=generator, device=dev),
            "noise": torch.randn(shape, generator=generator, device=dev),
            "timesteps": torch.randint(0, n_timesteps, (batch,), generator=generator,
                                       device=dev)}


@dataclasses.dataclass
class StepSpec:
    first_added: int
    eos_id: int
    vae_scaling: float
    kpl_weight: float = 0.1
    lr: float = 1e-4
    emb_lr: float = 1e-3
    betas: tuple = (0.9, 0.999)
    weight_decay: float = 1e-2
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    micro_batch: int = 2


class Trainer:
    """The reference's trainable state and its step.  `text_encoder` holds
    the LoRA weights that train; `table` is the grown token table (fp32)."""

    def __init__(self, text_encoder, unet, vae, table: torch.Tensor, null: torch.Tensor,
                 spec: StepSpec):
        self.te, self.unet, self.vae, self.spec = text_encoder, unet, vae, spec
        for mod in (text_encoder, unet, vae):
            mod.requires_grad_(False)
        self.base_table = text_encoder.text_model.embeddings.token_embedding.weight
        self.table = torch.nn.Parameter(table.clone())
        self.lora = self.lora_tensors()
        for p in self.lora.values():
            p.requires_grad_(True)
        self.original = table[:spec.first_added].clone()
        with torch.no_grad():
            self.target_norm = torch.linalg.vector_norm(table, dim=-1).mean()
        self.null = null
        self.alphas = alphas_cumprod().to(table.device)
        self.opt = torch.optim.AdamW(
            [{"params": [self.table], "lr": spec.emb_lr},
             {"params": list(self.lora.values()), "lr": spec.lr}],
            betas=spec.betas, eps=spec.eps, weight_decay=spec.weight_decay)

    def lora_tensors(self) -> Dict[str, torch.nn.Parameter]:
        return {k: p for k, p in self.te.named_parameters() if ".lora_" in k}

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The trainable tensors by name: `embedding` (the added rows) and
        every LoRA weight."""
        return {"embedding": self.table[self.spec.first_added:], **self.lora}

    def encode(self, ids, use_lora=True, table=None):
        return null_patch(self.te(ids, use_lora=use_lora, table=table), ids, self.null,
                          self.spec.eos_id)

    def step(self, batch: Dict[str, torch.Tensor], drawn: Dict[str, torch.Tensor]) -> Dict:
        """One step; returns the loss and each leaf's gradient norm as the
        optimizer gets it."""
        spec = self.spec
        pixels = batch["pixel_values"].float().div(127.5).sub(1.0).permute(0, 3, 1, 2)
        b = pixels.shape[0]
        self.opt.zero_grad(set_to_none=True)
        total = 0.0
        for s in range(0, b, spec.micro_batch):
            sl = slice(s, s + spec.micro_batch)
            with torch.no_grad():
                mean, logvar = self.vae.encode(pixels[sl].contiguous())
                latents = (mean + torch.exp(0.5 * logvar) * drawn["vae_eps"][sl]) * spec.vae_scaling
            a = self.alphas[drawn["timesteps"][sl]].view(-1, 1, 1, 1)
            noisy = a.sqrt() * latents + (1 - a).sqrt() * drawn["noise"][sl]
            hidden = self.encode(batch["input_ids"][sl], table=self.table)
            pred = self.unet(noisy, drawn["timesteps"][sl], hidden)
            part = (pred - drawn["noise"][sl]).square().mean() * (pred.shape[0] / b)
            part.backward()
            total += float(part.detach())
        prior = batch["prior_input_ids"]
        tuned = self.encode(prior, table=self.table)
        with torch.no_grad():
            ref = self.encode(prior, use_lora=False, table=self.base_table)
        cos = (tuned * ref).sum(-1) / torch.clamp(
            torch.linalg.vector_norm(tuned, dim=-1) * torch.linalg.vector_norm(ref, dim=-1),
            min=1e-8)
        kpl = spec.kpl_weight * (1.0 - cos).mean()
        kpl.backward()
        total += float(kpl.detach())
        with torch.no_grad():
            self.table.grad[:spec.first_added] = 0.0
            lora = list(self.lora.values())
            norm = torch.sqrt(sum(p.grad.square().sum() for p in lora))
            scale = torch.clamp(spec.max_grad_norm / torch.clamp(norm, min=1e-12), max=1.0)
            for p in lora:
                p.grad.mul_(scale)
            grads = {"embedding": float(torch.linalg.vector_norm(
                self.table.grad[spec.first_added:]))}
            grads.update({k: float(torch.linalg.vector_norm(p.grad))
                          for k, p in self.lora.items()})
        self.opt.step()
        with torch.no_grad():
            self.table[:spec.first_added] = self.original
            added = self.table[spec.first_added:]
            norms = torch.linalg.vector_norm(added, dim=-1, keepdim=True)
            added.mul_(torch.minimum(self.target_norm, norms) / torch.clamp(norms, min=1e-12))
        return {"loss": total, "grad_norms": grads}

    def first_grads(self) -> Dict[str, float]:
        """Each leaf's first gradient norm from the optimizer's state after
        one step: its first moment over (1 - beta1)."""
        out = {}
        for name, p in self.leaves().items():
            param = self.table if name == "embedding" else p
            m = self.opt.state[param]["exp_avg"]
            if name == "embedding":
                m = m[self.spec.first_added:]
            out[name] = float(torch.linalg.vector_norm(m)) / (1 - self.spec.betas[0])
        return out

    def snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.leaves().items()}

    @torch.no_grad()
    def load(self, state: Dict[str, torch.Tensor]) -> None:
        """Set the trainable tensors to `state` (a `snapshot`'s keys)."""
        for k, v in self.leaves().items():
            v.copy_(state[k])


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference's norm of that leaf and of the median leaf,
    for the leaves in `keep`."""
    median = float(np.median([reference[k] for k in keep]))
    return {k: abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in keep}


def gap(program: Dict[str, float], reference: Dict[str, float], keep: List[str]) -> float:
    """The worst leaf's `leaf_gaps`."""
    return max(leaf_gaps(program, reference, keep).values())
