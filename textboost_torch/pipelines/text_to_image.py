"""Text-to-image sampling pipeline (counterpart of
textboost_tpu/pipelines/text_to_image.py).

CLIP encode with the null-embedding patch, a sampler of
samplers/solvers.py (DPM-Solver++(2M) by default) over the CFG-doubled UNet (batch order [negative, positive]), VAE decode, clip to
[-1, 1] and the uint8 conversion on the device before the host copy.
Latents come in as [B, h, w, 4] and images go out as uint8 [B, H, W, 3],
the JAX package's layout; the models run NCHW inside.

`trajectory` (encode -> sampler -> decode) is the scope of the JAX
package's `build_sample_program`.  It runs eagerly unless the caller gives
the pipeline a `graphs.CapturedSampler` (`self.graphs`; the trainer does
for its validation rounds when they pay a capture back): then on CUDA a
signature it names (batch, height, width, steps, CFG, sampler, guidance
scale) runs as a CUDA graph, eagerly at its first call, captured and
replayed at the second, replayed after.  The prompts' ids, the negative
ids, the latents, the guidance scalar and DDPM's noise are made eagerly
and are the graph's inputs; the finiteness check and the host copy run
after it.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.tokenizer import tokenize_prompt
from ..device import resolve_device
from ..models.clip import CLIPTextModel
from ..models.configs import ModelSpec, get_spec
from ..models.textboost import apply_null_embedding_patch
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL
from ..ops.schedule import NoiseSchedule
from ..samplers.solvers import get_sampler, predrawn_noises
from .. import graphs


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float images -> uint8, on the images' device."""
    return ((images.float() + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8)


class TextToImagePipeline:
    def __init__(
        self,
        spec: Union[str, ModelSpec],
        tokenizer,
        text_encoder: CLIPTextModel,
        unet: UNet2DCondition,
        vae: AutoencoderKL,
        *,
        null_embedding=None,
        fixed_special: bool = False,
        device: Union[str, torch.device] = "cuda",
        freeze: bool = True,
    ):
        """`freeze` moves the modules to `device`, puts them in eval mode
        and turns their gradients off; freeze=False takes them as they are
        (the trainer's validation samples through its live modules)."""
        self.spec = get_spec(spec) if isinstance(spec, str) else spec
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        modules = (text_encoder, unet, vae)
        if freeze:
            modules = (m.to(self.device).eval().requires_grad_(False) for m in modules)
        self.text_encoder, self.unet, self.vae = modules
        self.null_embedding = (
            None if null_embedding is None
            else torch.as_tensor(null_embedding, dtype=torch.float32, device=self.device)
        )
        self.fixed_special = fixed_special
        sch = self.spec.scheduler
        self.schedule = NoiseSchedule.create(
            num_train_timesteps=sch.num_train_timesteps,
            beta_start=sch.beta_start,
            beta_end=sch.beta_end,
            beta_schedule=sch.beta_schedule,
            prediction_type=sch.prediction_type,
        )
        self.graphs: Optional[graphs.CapturedSampler] = None  # eager unless a caller sets it

    def release_graphs(self) -> None:
        """Drop the sampling graphs and their memory."""
        if self.graphs is not None:
            self.graphs.release()

    def _graph_guard(self) -> Tuple:
        """The addresses and shapes of every weight a graph reads: a graph
        captured over other tensors (another instance bound) is stale."""
        tensors = itertools.chain(*(itertools.chain(m.parameters(), m.buffers())
                                    for m in (self.text_encoder, self.unet, self.vae)))
        if self.null_embedding is not None:
            tensors = itertools.chain(tensors, [self.null_embedding])
        return tuple((t.data_ptr(), tuple(t.shape)) for t in tensors)

    def encode_prompts(self, prompts: Sequence[str]) -> np.ndarray:
        return tokenize_prompt(self.tokenizer, list(prompts))

    def _encode(self, ids: torch.Tensor) -> torch.Tensor:
        hidden, _ = self.text_encoder(ids)
        return apply_null_embedding_patch(
            hidden, ids, self.null_embedding,
            self.spec.text_encoder.eos_token_id, self.fixed_special,
        )

    @torch.inference_mode()
    def __call__(
        self,
        prompt: Union[str, Sequence[str]],
        *,
        negative_prompt: str = "",
        num_inference_steps: int = 25,
        guidance_scale: float = 7.5,
        height: Optional[int] = None,
        width: Optional[int] = None,
        latents=None,
        generator: Optional[torch.Generator] = None,
        sampler: str = "dpm++2m",
        output_type: str = "uint8",
    ) -> np.ndarray:
        """Sample images with `sampler` (a name of solvers.SAMPLERS); returns
        uint8 [B, H, W, 3] ("uint8") or float32 in [-1, 1] ("float").
        Raises if a decoded image is not finite."""
        sample = get_sampler(sampler)
        if output_type not in ("uint8", "float"):
            raise ValueError(f"output_type {output_type!r} not in ('uint8', 'float')")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        batch = len(prompts)
        height = height or self.spec.resolution
        width = width or self.spec.resolution
        dev = self.device

        ids = torch.from_numpy(self.encode_prompts(prompts)).to(dev)
        neg_ids = torch.from_numpy(self.encode_prompts([negative_prompt] * batch)).to(dev)
        if latents is None:
            latents = torch.randn((batch, height // 8, width // 8, 4), generator=generator,
                                  device=dev, dtype=torch.float32)
        latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)
        if latents.dim() == 3:
            latents = latents[None].expand(batch, *latents.shape)
        x = latents.permute(0, 3, 1, 2).contiguous()
        do_cfg = guidance_scale > 1.0
        guidance = (torch.tensor(guidance_scale, dtype=torch.float32, device=dev)
                    if do_cfg else None)
        if self.graphs is not None and dev.type == "cuda" and graphs.capture_enabled():
            inputs = {"ids": ids, "neg_ids": neg_ids, "x": x}
            if guidance is not None:
                inputs["guidance"] = guidance
            noises = predrawn_noises(sample, x.shape, num_inference_steps, dev)
            if noises is not None:
                inputs["noises"] = noises
            key = graphs.sampler_key(batch, height, width, num_inference_steps,
                                     guidance_scale, sampler)
            images = self.graphs(key, self._graph_guard(), lambda s: self.trajectory(
                s["ids"], s["neg_ids"], s["x"], s.get("guidance"), steps=num_inference_steps,
                sample=sample, noises=s.get("noises")), inputs)
        else:
            images = self.trajectory(ids, neg_ids, x, guidance, steps=num_inference_steps,
                                     sample=sample)
        if not bool(torch.isfinite(images).all()):  # before the clamp turns inf into +-1
            raise FloatingPointError("the decoded images hold non-finite values")
        images = images.clamp(-1.0, 1.0).permute(0, 2, 3, 1)
        if output_type == "float":
            return images.contiguous().cpu().numpy()
        return to_uint8(images).cpu().numpy()

    def trajectory(self, ids: torch.Tensor, neg_ids: torch.Tensor, x: torch.Tensor,
                   guidance: Optional[torch.Tensor], *, steps: int, sample,
                   noises: Optional[torch.Tensor] = None) -> torch.Tensor:
        """CLIP encode -> `sample` over the UNet (CFG-doubled, batch order
        [negative, positive], when `guidance` is given) -> VAE decode:
        float NCHW images, not clamped.  `noises` goes to a sampler that
        draws noise (DDPM)."""
        hidden = self._encode(ids)
        if guidance is not None:
            ctx = torch.cat([self._encode(neg_ids), hidden], dim=0)

            def model_fn(x, t):
                out = self.unet(torch.cat([x, x]), torch.cat([t, t]), ctx)
                uncond, cond = out.chunk(2)
                # The difference in the model dtype, the rest in fp32 (JAX's
                # promotion of bf16 against a float32 guidance scalar).
                return uncond.float() + guidance * (cond - uncond).float()
        else:
            def model_fn(x, t):
                return self.unet(x, t, hidden)

        kwargs = {} if noises is None else {"noises": noises}
        z = sample(model_fn, self.schedule, x, steps, **kwargs)
        return self.vae.decode(z / self.spec.vae.scaling_factor).float()

    @torch.inference_mode()
    def compute_null_embedding(self, prompt: str = "") -> np.ndarray:
        """Encoder output of `prompt` (default empty: the null embedding)."""
        ids = torch.from_numpy(self.encode_prompts([prompt])).to(self.device)
        hidden, _ = self.text_encoder(ids)
        return hidden[0].float().cpu().numpy()
