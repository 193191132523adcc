"""The TextBoost train step.

Counterpart of textboost_tpu/train/step.py (step.py:195-280 and `loss_fn`
:100-193), PyTorch on the port's modules: VAE encode -> noise ->
text encode (null-patched; with `use_attention_mask` through the padded
CLIP mask) -> UNet prediction (frozen, or with its cross-attention LoRA
training) -> MSE (+ the image prior's class half) + knowledge-preservation
loss -> backward -> gradient surgery -> AdamW (two groups) -> pin original
rows -> renorm added rows.  A batch that carries a `mask` [B, h, w, 1]
(latent resolution) takes the masked mean of the JAX step (step.py:159-167).
With `with_image_prior` the batch holds the instance samples, then as many
class samples (TextBoostDataset.collate); the prediction splits in two and
`image_ppl_weight` times the class half's MSE joins the loss.  The JAX
step's min-SNR weighting is off in every config and not ported.

The random draws (posterior epsilon, noise, timesteps) come in as an
argument, made by `sample_draws` from a `torch.Generator`, so that a test
can hand the step the very numbers the JAX step drew from its threefry key.
`TrainStep.body` is the device work, with no host sync and a Python
structure fixed by the config, so that a CUDA graph can hold it
(train/graph.py: the counterpart of the JAX package's compiled step);
`TrainStep.finish` is the host's part (the learning-rate schedule, the
micro-step count).
Accumulation follows optax's MultiSteps: gradients of `accumulate_steps`
micro-batches are averaged, clipped once, and applied on the last one.
The sum lives in buffers made once (`TrainState.accumulated`), so that
each micro-step's position (`micro_step_position`: first, middle, last)
has a body of fixed addresses that a graph can hold: the first copies its
gradients in, a middle one adds them, the last adds, averages, clips and
updates; the eager step runs the same code.
Data parallel, `reduce` (parallel/mesh.py::GradReducer) averages each
micro-step's trainable gradients and loss scalars over the ranks right
after the backward: every rank then reports the global batch's metrics
and applies the same update.  With the image prior each rank holds its
own [instance, class] rows, so the mean over the ranks is the JAX step's
loss on the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..lora.partition import (
    added_embedding_norm,
    apply_mixing_mask,
    clip_encoder_grads,
    encoder_grad_norm,
    lora_parameters,
    pin_original_rows,
    renorm_added_embeddings,
    zero_original_vocab_rows,
)
from ..models.clip import pad_attention_mask
from ..models.textboost import apply_null_embedding_patch
from ..ops.schedule import NoiseSchedule, sample_timesteps

Draws = Dict[str, torch.Tensor]
Reduce = Callable[[torch.Tensor, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The static configuration of the step (textboost_tpu/train/step.py::
    StepConfig, with accumulation and the clip of the JAX optimizer chain)."""

    prediction_type: str = "epsilon"
    vae_scaling: float = 0.18215
    kpl_weight: float = 0.1
    kpl_type: str = "cos"  # "cos" | "mse"
    first_added_token_id: int = 49408
    mixing: bool = False
    augment_ops: str = "object"
    weighted_timesteps: bool = False
    eos_token_id: int = 49407
    fixed_special: bool = True
    accumulate_steps: int = 1
    max_grad_norm: Optional[float] = None
    with_image_prior: bool = False
    image_ppl_weight: float = 1.0
    use_attention_mask: bool = False  # --text_encoder_use_attention_mask


@dataclasses.dataclass
class TrainState:
    """What the step reads and updates.  The text encoder trains in place;
    `frozen_text_encoder` is the encoder captured before token surgery."""

    text_encoder: nn.Module
    frozen_text_encoder: nn.Module
    unet: nn.Module
    vae: nn.Module
    optimizer: torch.optim.Optimizer
    lr_scheduler: torch.optim.lr_scheduler.LRScheduler
    schedule: NoiseSchedule
    null_embedding: Optional[torch.Tensor]  # fp32 [77, hidden]
    target_norm: torch.Tensor  # fp32 scalar: the mean pre-training embedding norm
    original_rows: torch.Tensor  # the embedding's original-vocab rows, pinned
    # The UNet's cross-attention LoRA weights when they train (in the
    # optimizer's LoRA group), else empty.
    unet_lora: List[nn.Parameter] = dataclasses.field(default_factory=list)
    step: int = 0  # micro-steps taken
    # The gradient sum of an accumulation, one buffer per trainable tensor,
    # made at the first micro-step and kept (graphs read it in place).
    accumulated: Optional[List[torch.Tensor]] = None


def micro_step_position(step: int, accumulate_steps: int) -> str:
    """Where micro-step `step` (0-based, counted from the run's start) falls
    in its accumulation: "only" without one, else "first", "middle" or
    "last" (which applies the update)."""
    if accumulate_steps <= 1:
        return "only"
    i = step % accumulate_steps
    return "first" if i == 0 else "last" if i == accumulate_steps - 1 else "middle"


def sample_draws(
    generator: torch.Generator,
    *,
    batch_size: int,
    latent_shape,  # (channels, height, width)
    schedule: NoiseSchedule,
    weighted_timesteps: bool = False,
) -> Draws:
    """The step's random numbers, on the generator's device: `vae_eps` and
    `noise` fp32 [B, C, h, w], `timesteps` int64 [B]."""
    dev = generator.device
    shape = (batch_size, *latent_shape)
    return {
        "vae_eps": torch.randn(shape, generator=generator, device=dev),
        "noise": torch.randn(shape, generator=generator, device=dev),
        "timesteps": sample_timesteps(generator, schedule, batch_size, weighted_timesteps),
    }


def encode_text(text_encoder: nn.Module, input_ids: torch.Tensor,
                null_embedding: Optional[torch.Tensor], config: StepConfig,
                use_lora: bool = True) -> torch.Tensor:
    mask = (pad_attention_mask(input_ids, config.eos_token_id)
            if config.use_attention_mask else None)
    hidden, _ = text_encoder(input_ids, use_lora=use_lora, attention_mask=mask)
    return apply_null_embedding_patch(hidden, input_ids, null_embedding,
                                      config.eos_token_id, config.fixed_special)


def _loss(state: TrainState, config: StepConfig, batch, noisy, noise, latents,
          timesteps):
    """(loss, aux) of `loss_fn` (textboost_tpu/train/step.py:117-193)."""
    te, schedule = state.text_encoder, state.schedule
    hidden = encode_text(te, batch["input_ids"], state.null_embedding, config)
    model_pred = state.unet(noisy, timesteps, hidden)
    target = (noise if config.prediction_type == "epsilon"
              else schedule.velocity(latents, noise, timesteps))
    prior_loss = torch.zeros((), device=noisy.device)
    if config.with_image_prior:  # instance samples first, then the class samples
        model_pred, pred_prior = model_pred.chunk(2)
        target, target_prior = target.chunk(2)
        prior_loss = (pred_prior.float() - target_prior.float()).square().mean()
    sq = (model_pred.float() - target.float()).square()
    if "mask" in batch:
        # Per-sample masked mean over the latent (the instance half), then
        # the batch mean.
        mask = batch["mask"].float().permute(0, 3, 1, 2)[: sq.shape[0]]
        loss = ((sq * mask).sum(dim=(1, 2, 3))
                / torch.clamp(mask.sum(dim=(1, 2, 3)), min=1e-6)).mean()
    else:
        loss = sq.mean()
    if config.with_image_prior:
        loss = loss + config.image_ppl_weight * prior_loss

    kpl = torch.zeros((), device=noisy.device)
    if config.kpl_weight > 0.0:
        prior_ids = batch["prior_input_ids"]
        tuned = encode_text(te, prior_ids, state.null_embedding, config).float()
        with torch.no_grad():
            ref = encode_text(state.frozen_text_encoder, prior_ids, state.null_embedding,
                              config, use_lora=False).float()
        if config.kpl_type == "cos":
            cos = (tuned * ref).sum(-1) / torch.clamp(
                torch.linalg.vector_norm(tuned, dim=-1) * torch.linalg.vector_norm(ref, dim=-1),
                min=1e-8)
            kpl = (1.0 - cos).mean()
        else:
            kpl = (tuned - ref).square().mean()
        loss = loss + config.kpl_weight * kpl
    # den_loss is the total loss, as the JAX step reports it (its aux dict
    # is built after the KPL term is added); prior_loss is 0 without the
    # image prior.
    return loss, {"den_loss": loss.detach(), "kpl": kpl.detach(),
                  "prior_loss": prior_loss.detach()}


def forward_backward(state: TrainState, config: StepConfig, batch: Dict,
                     draws: Draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Steps 1-8 of the step: normalize the uint8 pixels, VAE-encode under
    no_grad and draw the latents, add noise, compute the loss and run the
    backward into the trainable parameters' `.grad` (set to None first).
    Returns (loss, aux)."""
    pixels = batch["pixel_values"]
    if pixels.dtype == torch.uint8:
        # Normalized on the device: uint8 ships 4x fewer bytes to it.
        pixels = pixels.float() / 127.5 - 1.0
    with torch.no_grad():
        mean, logvar = state.vae.encode_moments(pixels.permute(0, 3, 1, 2).contiguous())
        latents = mean + torch.exp(0.5 * logvar) * draws["vae_eps"].to(mean.dtype)
        latents = (latents * config.vae_scaling).float()
    noise, timesteps = draws["noise"], draws["timesteps"]
    noisy = state.schedule.add_noise(latents, noise, timesteps)
    te = state.text_encoder
    for p in [te.token_embedding.weight] + lora_parameters(te) + state.unet_lora:
        p.grad = None
    loss, aux = _loss(state, config, batch, noisy, noise, latents, timesteps)
    loss.backward()
    return loss.detach(), aux


class TrainStep:
    """The step fn(state, batch, draws) -> metrics (0-dim tensors, not
    synchronised).  `batch` holds `pixel_values` (uint8 or float NHWC),
    `input_ids`, `prior_input_ids` and optionally `mask`, on the device
    (with the image prior, `pixel_values`, `input_ids` and `mask` hold the
    class samples after the instance ones).  `reduce(loss, aux) -> (loss,
    aux)`, when given, runs right after the backward (data parallel).

    A call is `body` then `finish`: `body` is the device work, with a
    Python structure fixed by the config and the micro-step's position
    (`micro_step_position`) and no host sync, which a CUDA graph can hold
    (train/graph.py: one graph per position); `finish` is
    what stays on the host: the learning-rate schedule after an update and
    the micro-step count."""

    def __init__(self, config: StepConfig, reduce: Optional[Reduce] = None):
        self.config = config
        self.reduce = reduce

    def updates(self, state: TrainState) -> bool:
        """Whether this micro-step applies the update (the last of an
        accumulation)."""
        return micro_step_position(state.step, self.config.accumulate_steps) in ("only", "last")

    def prepare_capture(self) -> None:
        """Before a graph captures `body`: what the capture needs to exist
        already (the reduce's communicator)."""
        if self.reduce is not None and hasattr(self.reduce, "prepare_capture"):
            self.reduce.prepare_capture()

    def body(self, state: TrainState, batch: Dict, draws: Draws) -> Dict[str, torch.Tensor]:
        config, first_added = self.config, self.config.first_added_token_id
        te = state.text_encoder
        emb = te.token_embedding.weight
        lora = lora_parameters(te)
        trainable = [emb] + lora + state.unet_lora
        loss, aux = forward_backward(state, config, batch, draws)
        if self.reduce is not None:
            loss, aux = self.reduce(loss, aux)

        # Gradient surgery (train_textboost.py:1109-1126).
        zero_original_vocab_rows(emb.grad, first_added)
        if config.mixing:
            apply_mixing_mask(te, config.augment_ops)
            if state.unet_lora:  # the JAX step masks every lora_b
                apply_mixing_mask(state.unet, config.augment_ops)
        grad_norm = encoder_grad_norm(lora)  # pre-clip, for the metrics

        position = micro_step_position(state.step, config.accumulate_steps)
        if position != "only":
            _accumulate(state, trainable, position, config.accumulate_steps)
        if position in ("only", "last"):
            if config.max_grad_norm is not None:
                clip_encoder_grads(lora, config.max_grad_norm)
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            # Decoupled decay shrinks zero-gradient rows too: pin them.
            pin_original_rows(emb.data, state.original_rows)
        renorm_added_embeddings(emb.data, first_added, state.target_norm)
        return {
            "loss": loss,
            "grad_norm": grad_norm,
            "added_embedding_norm": added_embedding_norm(emb.data, first_added),
            **aux,
        }

    def finish(self, state: TrainState) -> None:
        """The schedule moves after an update (it sets the next update's
        rate); the micro-step count moves every call."""
        if self.updates(state):
            state.lr_scheduler.step()
        state.step += 1

    def __call__(self, state: TrainState, batch: Dict, draws: Draws) -> Dict[str, torch.Tensor]:
        metrics = self.body(state, batch, draws)
        self.finish(state)
        return metrics


@torch.no_grad()
def _accumulate(state: TrainState, trainable: List[nn.Parameter], position: str,
                accumulate_steps: int) -> None:
    """Gather a micro-step's gradients into `state.accumulated` (made at the
    first micro-step of the run): the first copies them, the others add
    them; the last leaves the mean in `.grad` (the buffers themselves), the
    others no `.grad`."""
    if state.accumulated is None:
        state.accumulated = [torch.zeros_like(p.grad) for p in trainable]
    for acc, p in zip(state.accumulated, trainable):
        if position == "first":
            acc.copy_(p.grad)
        else:
            acc.add_(p.grad)
    for p, acc in zip(trainable, state.accumulated):
        p.grad = acc.div_(accumulate_steps) if position == "last" else None


def make_train_step(config: StepConfig, reduce: Optional[Reduce] = None) -> TrainStep:
    """The train step of `config` (`TrainStep`)."""
    return TrainStep(config, reduce)
