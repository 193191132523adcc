"""Trainer: set-up, the loop, checkpoints, validation and the final export.

Counterpart of textboost_tpu/train/trainer.py (`_setup` :184-814 without
the AOT, mesh, relay and warm-up machinery; the loop :853-1026; `save`
:1032-1075; `save_final` :1076-1115; validation :1157-1321): tokenizer ->
token surgery (placeholders, and with --augment_inversion the bank of
augmentation tokens) -> models -> frozen text encoder captured before
surgery -> embedding growth and norm stats -> null embedding -> schedule ->
optimizer -> class-prior images (generated when the class dir is short)
-> paired augmentation and loaders -> resume; then one eager
train step per (micro-)batch, metrics every 10 steps to `metrics.jsonl`, a
compact checkpoint every --checkpointing_steps and a validation grid every
--validation_steps (both written on writer threads, joined at the end),
and at the end the PEFT `text_encoder/` adapter (and `unet/`, with
`--unet_params_to_train crossattn_kv`) and `{token}.bin` files that
`textboost_torch.inference` and the JAX `load_textboost_pipeline` load.
`--gradient_checkpointing` recomputes the UNet's blocks in the backward;
`--text_encoder_use_attention_mask` threads the padded CLIP mask into the
step's text encodes.

Flags the port does not serve yet raise NotImplementedError here
(train/config.py::unsupported_flags).
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import json
import logging
import os
import re
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..data.augment import PairedAugmentation
from ..data.datasets import InstructPix2PixDataset, PriorDataset, TextBoostDataset
from ..data.loader import PrefetchLoader
from ..data.sharding import process_shard_info
from ..data.tokenizer import HashTokenizer, load_tokenizer
from ..device import resolve_device
from ..lora.partition import (
    count_params,
    lora_parameters,
    lr_schedule,
    make_optimizer,
    set_trainable,
)
from ..lora.peft_io import export_lora_adapter, export_token_embeddings, export_unet_lora_adapter
from ..models.layers import set_impl
from ..models.pretrained import load_models
from ..models.textboost import load_null_embedding_asset
from ..ops.schedule import NoiseSchedule
from ..pipelines.text_to_image import TextToImagePipeline
from ..tokens.surgery import OBJECT_AUGMENTATIONS, STYLE_AUGMENTATIONS, plan_token_addition
from ..utils.profiling import StepTimer, device_memory_stats
from ..utils.trackers import Trackers
from . import checkpoint
from .config import TrainConfig, unsupported_flags
from .prior_generation import generate_prior_images
from .step import StepConfig, TrainState, make_train_step, sample_draws

logger = logging.getLogger("textboost_torch")

ATTENTION_IMPLS = {"auto": "auto", "xla": "math"}  # --attention_impl -> the port's impl
WRITER_TIMEOUT_S = 600.0


def _join_writers(threads: List[threading.Thread], kind: str) -> None:
    """Join writer threads; a thread's kept exception is raised here, so a
    failed write fails the run (as the reference's synchronous save would)."""
    for t in threads:
        t.join(WRITER_TIMEOUT_S)
        if t.is_alive():
            raise RuntimeError(f"{kind} writer {t.name} did not finish within "
                               f"{WRITER_TIMEOUT_S:.0f} s")
        if t.exception is not None:
            raise RuntimeError(f"{kind} writer {t.name} failed") from t.exception


@dataclasses.dataclass
class TokenPlan:
    """The tokens a run adds, registered with the tokenizer in id order."""

    token_to_id: Dict[str, int]  # every added token -> its id
    concept_tokens: Dict[str, str]  # instance/placeholder token -> its joined sub-tokens
    caption_map: Optional[Dict[str, str]]  # augmentation placeholder -> its joined sub-tokens
    aug_tokens: List[str]  # the augmentation sub-tokens ([1, hidden] bins at export)
    init_row_ids: List[int]  # the initializer rows the added rows copy
    new_row_ids: List[int]  # the added rows


def plan_tokens(tokenizer, concepts: List[Dict], initializer_token: str, *,
                augment_inversion: bool = False, augment_ops: str = "object") -> TokenPlan:
    """Tokenizer side of the token surgery (textboost_tpu/train/trainer.py:
    213-275): each concept's placeholder, then with `augment_inversion` the
    bank of augmentation tokens (OBJECT_AUGMENTATIONS or STYLE_AUGMENTATIONS
    by `augment_ops`), each expanded to one token per initializer
    sub-token.  Prompts use the sub-tokens joined by spaces."""
    plan = TokenPlan({}, {}, None, [], [], [])
    for concept in concepts:
        placeholder = concept.get("placeholder_token") or concept["instance_token"]
        initializer = concept.get("initializer_token") or initializer_token
        toks, pids, iids = plan_token_addition(tokenizer, placeholder, initializer)
        plan.init_row_ids += iids
        plan.new_row_ids += pids
        plan.token_to_id.update(zip(toks, pids))
        plan.concept_tokens[concept["instance_token"]] = " ".join(toks)
        plan.concept_tokens[placeholder] = " ".join(toks)
    if augment_inversion:
        bank = OBJECT_AUGMENTATIONS if augment_ops == "object" else STYLE_AUGMENTATIONS
        plan.caption_map = {}
        for placeholder, initializer in bank.items():
            toks, pids, iids = plan_token_addition(tokenizer, placeholder, initializer)
            plan.init_row_ids += iids
            plan.new_row_ids += pids
            plan.token_to_id.update(zip(toks, pids))
            plan.aug_tokens += toks
            plan.caption_map[placeholder] = " ".join(toks)
    return plan


class Trainer:
    def __init__(self, config: TrainConfig, device: Union[str, torch.device] = "cuda"):
        problems = unsupported_flags(config)
        if config.attention_impl not in ATTENTION_IMPLS:
            problems.append(f"--attention_impl {config.attention_impl}: the port takes "
                            f"{sorted(ATTENTION_IMPLS)} (flash is chosen per call by 'auto')")
        if problems:
            raise NotImplementedError("not served by textboost_torch yet: " + "; ".join(problems))
        self.config = config
        self.device = resolve_device(device)
        os.makedirs(config.output_dir, exist_ok=True)
        self._setup_logging()
        self._setup()

    # ------------------------------------------------------------------
    def _setup_logging(self):
        # One trainer file handler at a time (sequential trainers in one process).
        for h in list(logger.handlers):
            if isinstance(h, logging.FileHandler) and getattr(h, "_textboost_trainer", False):
                logger.removeHandler(h)
                h.close()
        handler = logging.FileHandler(os.path.join(self.config.output_dir, "training.log"))
        handler._textboost_trainer = True
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        self._metrics_file = open(os.path.join(self.config.output_dir, "metrics.jsonl"), "a")
        self._trackers = Trackers(
            self.config.report_to,
            os.path.join(self.config.output_dir, self.config.logging_dir),
            config=dataclasses.asdict(self.config),
        )

    def _log_metrics(self, step: int, scalars: Dict[str, float]):
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self._metrics_file.write(json.dumps(rec) + "\n")
        self._metrics_file.flush()
        self._trackers.log({k: v for k, v in rec.items() if k != "step"}, step)

    # ------------------------------------------------------------------
    def _setup(self):
        cfg, dev = self.config, self.device
        dtype = {None: torch.float32, "no": torch.float32, "fp16": torch.bfloat16,
                 "bf16": torch.bfloat16}[cfg.mixed_precision]
        if cfg.allow_tf32:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        t_setup = time.perf_counter()

        def mark(what):
            logger.info("setup: %s at +%.1fs", what, time.perf_counter() - t_setup)

        # ---- tokenizer + token planning (train_textboost.py:665-688) ----
        self.tokenizer = load_tokenizer(cfg.tokenizer_name or cfg.pretrained_model_name_or_path)
        if isinstance(self.tokenizer, HashTokenizer):
            logger.warning(
                "No CLIP tokenizer files found — using the deterministic HashTokenizer "
                "fallback. Embeddings trained this way are NOT transferable to real CLIP "
                "vocab; point --tokenizer_name/--pretrained_model_name_or_path at a "
                "converted snapshot for real runs."
            )
        self.concepts = cfg.resolve_concepts()
        first_added_id = len(self.tokenizer)
        plan = plan_tokens(self.tokenizer, self.concepts, cfg.initializer_token,
                           augment_inversion=cfg.augment_inversion,
                           augment_ops=cfg.augment_ops)
        self.token_to_id, self.concept_tokens = plan.token_to_id, plan.concept_tokens
        self.caption_map, self.aug_tokens = plan.caption_map, plan.aug_tokens
        init_row_ids, new_row_ids = plan.init_row_ids, plan.new_row_ids
        assert new_row_ids == list(range(first_added_id, first_added_id + len(new_row_ids))), (
            f"non-sequential added token ids: {new_row_ids}")
        if init_row_ids and max(init_row_ids) >= first_added_id:
            raise ValueError(
                "initializer_token resolves to a placeholder token added in this run — "
                "chained placeholder initializers are unsupported; use a regular "
                "vocabulary word as the initializer"
            )
        self.first_added_id = first_added_id

        # ---- models (train_textboost.py:630-654, UNet LoRA :712-721) ----
        self.train_unet = cfg.unet_params_to_train == "crossattn_kv"
        self.bundle = load_models(
            cfg.pretrained_model_name_or_path, preset=cfg.model_preset,
            lora_rank=cfg.lora_rank, unet_lora_rank=cfg.lora_rank if self.train_unet else 0,
            dtype=dtype, vae_dtype=torch.float32 if cfg.vae_fp32 else None, device=dev,
            seed=cfg.seed,
        )
        spec = self.bundle.spec
        te, unet, vae = self.bundle.text_encoder, self.bundle.unet, self.bundle.vae
        for mod in (te, unet, vae):
            mod.requires_grad_(False)
            set_impl(mod, ATTENTION_IMPLS[cfg.attention_impl])
        unet.gradient_checkpointing = cfg.gradient_checkpointing
        mark("models loaded")

        # Frozen reference encoder, captured BEFORE token surgery (:650).
        self.frozen_te = copy.deepcopy(te)

        # ---- embedding growth, norm stats, null embedding ----
        with torch.no_grad():
            e = te.token_embedding.weight
            src = torch.as_tensor(init_row_ids, dtype=torch.long, device=dev)
            grown = torch.cat([e.float(), e[src].float()], dim=0)
            norms = torch.linalg.vector_norm(grown, dim=-1)
            max_norm = float(norms[: max(first_added_id - 2, 1)].max())
            self.mean_norm = float(norms.mean())
        logger.info("Max norm: %s  Mean norm: %s", max_norm, self.mean_norm)
        te.set_token_embedding(grown, dtype=torch.float32)  # trains in fp32, cast at use
        trainable = set_trainable(te, unet if self.train_unet else None)
        self.text_encoder = te
        if cfg.null_embedding_path:
            null = load_null_embedding_asset(
                cfg.null_embedding_path,
                (spec.text_encoder.max_position_embeddings, spec.text_encoder.hidden_size))
            self.null_embedding = torch.from_numpy(null).to(dev)
        else:
            null_ids = np.asarray(self.tokenizer("", padding="max_length", max_length=77,
                                                 return_tensors="np")["input_ids"], np.int64)
            with torch.no_grad():
                hidden, _ = self.frozen_te(torch.from_numpy(null_ids).to(dev), use_lora=False)
            self.null_embedding = hidden[0].float()
        mark("token surgery and null embedding done")

        # ---- schedule, optimizer (:829-854, :911-916) ----
        self.schedule = NoiseSchedule.create(
            num_train_timesteps=spec.scheduler.num_train_timesteps,
            beta_start=spec.scheduler.beta_start, beta_end=spec.scheduler.beta_end,
            beta_schedule=spec.scheduler.beta_schedule,
            prediction_type=spec.scheduler.prediction_type,
        )
        lr, emb_lr = cfg.learning_rate, cfg.emb_learning_rate
        if cfg.scale_lr:
            scale = cfg.gradient_accumulation_steps * cfg.train_batch_size
            lr, emb_lr = lr * scale, emb_lr * scale
        optimizer = make_optimizer(te, lr, emb_lr, unet=unet if self.train_unet else None,
                                   beta1=cfg.adam_beta1, beta2=cfg.adam_beta2,
                                   weight_decay=cfg.adam_weight_decay, eps=cfg.adam_epsilon)
        scheduler = lr_schedule(optimizer, cfg.lr_scheduler, cfg.lr_warmup_steps,
                                cfg.max_train_steps)
        n_train = count_params(trainable)
        logger.info("Trainable params: %.3fM", n_train / 1e6)
        print(f"Trainable params: {n_train / 1e6:.3f}M "
              f"(LoRA r={cfg.lora_rank} + {len(self.token_to_id)} token embeddings)")

        # ---- class-prior images (utils.py:50-114), from the base modules ----
        # (`--prior_generation_precision` is accepted and unused, as in JAX.)
        if cfg.with_image_prior:
            made = generate_prior_images(
                TextToImagePipeline(spec, self.tokenizer, self.frozen_te, unet, vae,
                                    device=dev, freeze=False),
                cfg.class_data_dir, cfg.class_token, cfg.num_prior_images,
                sample_batch_size=cfg.sample_batch_size, seed=cfg.seed)
            if made:
                logger.info("Generated %d class prior images", made)
            mark("class prior images ready")

        # ---- data (:857-909) ----
        augment_pipe = None
        if cfg.augment.lower() in ("pda", "paug"):
            augment_pipe = PairedAugmentation(
                # hflip joins the geometric bank under inversion, so that the
                # <hflip> token trains (train_textboost.py:857-870).
                hflip="inversion" if cfg.augment_inversion else "false",
                inversion=cfg.augment_inversion, p=cfg.augment_p,
                augment_prompt=bool(cfg.augment_prompt), ops=cfg.augment_ops,
                caption_map=self.caption_map, seed=cfg.seed,
            )
        elif cfg.augment.lower() not in ("none", ""):
            raise ValueError(f"Unknown augment mode: {cfg.augment}")
        concepts_for_ds = [{**c, "instance_token": self.concept_tokens[c["instance_token"]]}
                           for c in self.concepts]
        shard_id, num_shards = process_shard_info()
        dataset = TextBoostDataset(
            concepts_for_ds, self.tokenizer, num_instance=cfg.num_samples,
            template=cfg.template,
            prior_data_root=cfg.class_data_dir if cfg.with_image_prior else None,
            class_token=cfg.class_token,
            num_prior=cfg.num_prior_images if cfg.with_image_prior else None,
            size=cfg.resolution, center_crop=cfg.center_crop,
            augment_pipe=augment_pipe, seed=cfg.seed,
        )
        cpus = os.cpu_count() or 1
        self.train_loader = PrefetchLoader(
            dataset, batch_size=cfg.train_batch_size,
            collate=functools.partial(TextBoostDataset.collate,
                                      with_prior_preservation=cfg.with_image_prior),
            shard_id=shard_id, num_shards=num_shards, seed=cfg.seed,
            num_workers=min(max(cfg.dataloader_num_workers, 1) * 2, 4 * cpus),
        )
        prior_ds = PriorDataset(
            InstructPix2PixDataset(cfg.human_prompts_path), self.tokenizer,
            additional_template=cfg.template,
            additional_category=[c.get("class_token") or cfg.initializer_token
                                 for c in self.concepts],
            null_prob=cfg.null_prob, seed=cfg.seed + 1,
        )
        self.prior_loader = PrefetchLoader(
            prior_ds, batch_size=cfg.train_batch_size, collate=PriorDataset.collate,
            shard_id=shard_id, num_shards=num_shards, seed=cfg.seed + 1,
            num_workers=min(max(cfg.dataloader_num_workers, 1) * 2, 2 * cpus),
        )

        # ---- step + state ----
        self.step_config = StepConfig(
            prediction_type=spec.scheduler.prediction_type,
            vae_scaling=spec.vae.scaling_factor,
            kpl_weight=cfg.kpl_weight,
            kpl_type=cfg.kpl_type,
            first_added_token_id=first_added_id,
            mixing=cfg.mixing,
            augment_ops=cfg.augment_ops,
            weighted_timesteps=not cfg.disable_weighted_sample,
            eos_token_id=spec.text_encoder.eos_token_id,
            accumulate_steps=max(cfg.gradient_accumulation_steps, 1),
            max_grad_norm=cfg.max_grad_norm,
            with_image_prior=cfg.with_image_prior,
            image_ppl_weight=cfg.image_ppl_weight,
            use_attention_mask=cfg.text_encoder_use_attention_mask,
        )
        self.train_step = make_train_step(self.step_config)
        self.state = TrainState(
            text_encoder=te, frozen_text_encoder=self.frozen_te, unet=unet, vae=vae,
            optimizer=optimizer, lr_scheduler=scheduler, schedule=self.schedule,
            null_embedding=self.null_embedding,
            target_norm=torch.tensor(self.mean_norm, dtype=torch.float32, device=dev),
            original_rows=grown[:first_added_id].clone(),
            unet_lora=lora_parameters(unet) if self.train_unet else [],
        )
        self.generator = torch.Generator(dev).manual_seed(cfg.seed)
        self.latent_shape = (spec.vae.latent_channels, cfg.resolution // 8, cfg.resolution // 8)
        mark("step + state built")

        self._ckpt_threads: List[threading.Thread] = []
        self._val_threads: List[threading.Thread] = []
        self._val_pipe: Optional[TextToImagePipeline] = None
        # Seconds of each checkpoint (snapshot on the loop, write on its
        # thread) and validation round (sampling, on the loop).
        self.timings: Dict[str, List[float]] = collections.defaultdict(list)
        self.augmentation_counts: collections.Counter = collections.Counter()

        # ---- resume (:759-781) ----
        self.start_step = 0
        if cfg.resume_from_checkpoint:
            path = (cfg.output_dir if cfg.resume_from_checkpoint == "latest"
                    else cfg.resume_from_checkpoint)
            ckpt = checkpoint.resolve_checkpoint(path)
            if ckpt is None:
                logger.info("No checkpoint found at %s; starting fresh", path)
            else:
                restored = checkpoint.restore_checkpoint(
                    ckpt, te, optimizer, scheduler, self.generator, first_added_id,
                    unet=unet if self.train_unet else None)
                self.start_step = restored["step"]
                self.state.step = restored["micro_step"]
                # Carry on the data stream instead of replaying batch 0 (the
                # loaders count micro-batches).
                accum = max(cfg.gradient_accumulation_steps, 1)
                self.train_loader.set_start_step(self.start_step * accum)
                self.prior_loader.set_start_step(self.start_step * accum)
                logger.info("Resumed from %s at step %d", ckpt, self.start_step)

    # ------------------------------------------------------------------
    def _device_batch(self, batch: Dict, prior_batch: Dict) -> Dict[str, torch.Tensor]:
        """Host numpy batch -> tensors on the device (pinned, non_blocking
        copies on the card)."""
        arrays = {
            "pixel_values": batch["pixel_values"],
            "input_ids": batch["input_ids"].astype(np.int64),
            "prior_input_ids": prior_batch["input_ids"].astype(np.int64),
        }
        if "mask" in batch:
            arrays["mask"] = batch["mask"]
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory() if cuda else t).to(self.device, non_blocking=cuda)
        return out

    def _draws(self) -> Dict[str, torch.Tensor]:
        # The image prior's class samples follow the instance ones in the batch.
        batch = self.config.train_batch_size * (2 if self.config.with_image_prior else 1)
        return sample_draws(self.generator, batch_size=batch,
                            latent_shape=self.latent_shape, schedule=self.schedule,
                            weighted_timesteps=self.step_config.weighted_timesteps)

    def _count_augmentations(self, prompts: List[str]) -> None:
        """Count the samples whose caption carries each augmentation token."""
        self.augmentation_counts["samples"] += len(prompts)
        for prompt in prompts:
            found = [p for p, toks in (self.caption_map or {}).items() if toks in prompt]
            self.augmentation_counts.update(found)
            self.augmentation_counts["augmented"] += bool(found)

    def train(self) -> Dict[str, float]:
        try:
            return self._train()
        finally:
            self.train_loader.stop()
            self.prior_loader.stop()

    def _train(self) -> Dict[str, float]:
        cfg = self.config
        train_iter, prior_iter = iter(self.train_loader), iter(self.prior_loader)
        self._log_metrics(0, {"max_norm": 0.0, "mean_norm": self.mean_norm})
        step = self.start_step
        start_time = time.perf_counter()
        timer = StepTimer()
        last_metrics: Dict[str, float] = {}
        accum = max(cfg.gradient_accumulation_steps, 1)
        loop_t = {"dispatch_ms": 0.0, "host_wait_ms": 0.0, "h2d_ms": 0.0}
        window_start = step
        profiler = None
        t0 = time.perf_counter()
        host = (next(train_iter), next(prior_iter))
        # The wait for each step's host batches, the first (before the loop:
        # the producers' start) apart.
        host_waits = [(time.perf_counter() - t0) * 1000]
        next_batch, next_prompts = self._device_batch(*host), host[0]["prompt"]
        while step < cfg.max_train_steps:
            if cfg.profile_dir and step - self.start_step == 5:  # trace steps [5, 15) of the run
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                profiler.start()
            for _ in range(accum):
                batch = next_batch
                self._count_augmentations(next_prompts)
                t0 = time.perf_counter()
                metrics = self.train_step(self.state, batch, self._draws())
                t1 = time.perf_counter()
                host = (next(train_iter), next(prior_iter))
                t2 = time.perf_counter()
                next_batch, next_prompts = self._device_batch(*host), host[0]["prompt"]
                t3 = time.perf_counter()
                loop_t["dispatch_ms"] += (t1 - t0) * 1000
                loop_t["host_wait_ms"] += (t2 - t1) * 1000
                host_waits.append((t2 - t1) * 1000)
                loop_t["h2d_ms"] += (t3 - t2) * 1000
            step += 1
            if profiler is not None and step - self.start_step == 15:
                profiler.stop()
                os.makedirs(cfg.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))
                profiler = None

            timing = timer.tick()
            if step % 10 == 0 or step == cfg.max_train_steps:
                keys = sorted(metrics)  # one device->host fetch for all scalars
                vals = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
                last_metrics = dict(zip(keys, vals))
                last_metrics.update(timing)
                n = max(step - window_start, 1)
                last_metrics.update({k: v / n for k, v in loop_t.items()})
                loop_t = dict.fromkeys(loop_t, 0.0)
                window_start = step
                if step % 100 == 0:
                    last_metrics.update(device_memory_stats(self.device))
                self._log_metrics(step, last_metrics)
            if cfg.checkpointing_steps and step % cfg.checkpointing_steps == 0:
                self.save(step)
            if (cfg.validation_prompts and cfg.validation_steps
                    and step % cfg.validation_steps == 0):
                self.run_validation(step)
        if profiler is not None:
            profiler.stop()

        wall = time.perf_counter() - start_time
        logger.info("Training took %.1f seconds.", wall)
        print(f"Training took {wall:.1f} seconds.")
        # The writers' time overlapped the loop; they land before the run
        # is declared done (:1016-1022).
        self.join_checkpoint_writers()
        self.join_validation_writers()
        if self.caption_map:
            logger.info("Augmentation tokens in the captions: %s", dict(self.augmentation_counts))
        self.save_final()
        self._trackers.finish()
        self._metrics_file.close()
        result = {"wall_time_s": wall, "steps": step, **last_metrics,
                  "host_wait_ms_by_step": host_waits}
        result.update({f"{key}_ms": 1e3 * sum(values) / len(values)
                       for key, values in self.timings.items() if values})
        result.update({f"aug:{k}": float(n) for k, n in self.augmentation_counts.items()})
        return result

    # ------------------------------------------------------------------
    def save(self, step: int) -> str:
        """Compact checkpoint `checkpoint-{step}/` (train/checkpoint.py): the
        snapshot is copied to the host here, the files are written on a
        writer thread.  The previous writer is joined first, before the
        pruning can remove a dir it is writing."""
        self.join_checkpoint_writers()
        cfg = self.config
        t0 = time.perf_counter()
        payload = checkpoint.snapshot(
            self.text_encoder, self.state.optimizer, self.state.lr_scheduler, self.generator,
            step=step, micro_step=self.state.step, first_added_id=self.first_added_id,
            unet=self.bundle.unet if self.train_unet else None)
        self.timings["checkpoint_snapshot"].append(time.perf_counter() - t0)
        path, thread = checkpoint.save_checkpoint(
            cfg.output_dir, step, payload, total_limit=cfg.checkpoints_total_limit,
            first_added_id=self.first_added_id,
            token_to_id=self.token_to_id, aug_tokens=self.aug_tokens,
            lora_rank=cfg.lora_rank,
            base_model_name=cfg.pretrained_model_name_or_path or self.bundle.spec.name)
        self._ckpt_threads.append(thread)
        logger.info("Saving state to %s", path)
        return path

    def join_checkpoint_writers(self) -> None:
        """Wait for the checkpoint writers; raise if one failed."""
        threads, self._ckpt_threads = self._ckpt_threads, []
        _join_writers(threads, "checkpoint")
        self.timings["checkpoint_write"] += [t.seconds for t in threads]

    # ------------------------------------------------------------------
    def validation_prompt_list(self) -> List[str]:
        """Validation prompts with `<{i}>` replaced by concept i's tokens
        (train_textboost.py:503-505) and the `<i>` alias by the first
        concept's, each repeated num_validation_images times (:508-512)."""
        cfg = self.config
        first = self.concept_tokens[self.concepts[0]["instance_token"]]
        subs = []
        for prompt in cfg.validation_prompts or []:
            for i, concept in enumerate(self.concepts):
                prompt = prompt.replace(f"<{i}>", self.concept_tokens[concept["instance_token"]])
            prompt = prompt.replace("<i>", first)
            leftover = re.findall(r"<\d+>", prompt)
            if leftover:
                logger.warning(
                    "validation prompt %r keeps unresolved placeholder(s) %s — only indices "
                    "0..%d are defined (use <0>..<%d> or the <i> alias for the first concept)",
                    prompt, leftover, len(self.concepts) - 1, len(self.concepts) - 1)
            subs.append(prompt)
        if not subs:
            subs = [f"a photo of {first}"]
        n = max(cfg.num_validation_images, 1)
        return [p for p in subs for _ in range(n)]

    def _validation_pipe(self) -> TextToImagePipeline:
        """The sampling pipeline over the LIVE text encoder, UNet and VAE
        (no copy of the weights; the grown embedding is read as it is now),
        built once and kept across rounds."""
        if self._val_pipe is None:
            self._val_pipe = TextToImagePipeline(
                self.bundle.spec, self.tokenizer, self.text_encoder, self.bundle.unet,
                self.bundle.vae, null_embedding=self.null_embedding, fixed_special=True,
                device=self.device, freeze=False)
        return self._val_pipe

    def join_validation_writers(self) -> None:
        """Wait for the validation writers; raise if one failed."""
        threads, self._val_threads = self._val_threads, []
        _join_writers(threads, "validation")

    def run_validation(self, step: int) -> str:
        """log_validation counterpart (train_textboost.py:453-531): sample
        num_validation_images per substituted prompt from the live weights
        (25 DPM-Solver++ steps, CFG 7.5, latents from a generator of its own
        seeded with --seed, in eval mode, then the modules' modes back) and
        write a (prompts x images) grid to validation_{step}.jpg.  The grid
        and the trackers' images are written on a writer thread, joined
        before the next round and at the end of train()."""
        cfg = self.config
        self.join_validation_writers()
        pipe = self._validation_pipe()
        prompts = self.validation_prompt_list()
        logger.info("Running validation with prompts: %s", prompts)
        modules = (self.text_encoder, self.bundle.unet, self.bundle.vae)
        modes = [m.training for m in modules]
        t0 = time.perf_counter()
        try:
            for m in modules:
                m.eval()
            images = pipe(prompts, num_inference_steps=25, guidance_scale=7.5,
                          generator=torch.Generator(self.device).manual_seed(cfg.seed))
        finally:
            for m, mode in zip(modules, modes):
                m.train(mode)
        self.timings["validation"].append(time.perf_counter() - t0)
        path = os.path.join(cfg.output_dir, f"validation_{step}.jpg")
        n = max(cfg.num_validation_images, 1)

        def run():
            from PIL import Image

            try:
                rows = [np.concatenate(list(images[r:r + n]), axis=1)
                        for r in range(0, len(prompts), n)]
                grid = np.concatenate(rows, axis=0)
                Image.fromarray(grid).save(path)
                self._trackers.log_images("validation", [grid], step, captions=prompts[:1])
                logger.info("Wrote validation grid %s", path)
            except BaseException as e:  # noqa: BLE001 — re-raised at the join
                thread.exception = e

        thread = threading.Thread(target=run, daemon=True, name=f"val-writer-{step}")
        thread.exception = None
        self._val_threads.append(thread)
        thread.start()
        return path

    # ------------------------------------------------------------------
    def save_final(self):
        """Final layout (train_textboost.py:1234-1266): the `text_encoder/`
        PEFT adapter dir (and `unet/` when the UNet's LoRA trained,
        textboost_tpu/train/trainer.py:1078-1095) and the token bins at the
        output root."""
        cfg = self.config
        base = cfg.pretrained_model_name_or_path or self.bundle.spec.name
        if self.train_unet:
            export_unet_lora_adapter(self.bundle.unet, os.path.join(cfg.output_dir, "unet"),
                                     rank=cfg.lora_rank, base_model_name=base)
        if not cfg.skip_save_text_encoder and cfg.lora_rank > 0:
            export_lora_adapter(self.text_encoder, os.path.join(cfg.output_dir, "text_encoder"),
                                rank=cfg.lora_rank, base_model_name=base)
        # Only the learned rows leave the device.
        tokens = list(self.token_to_id)
        ids = torch.as_tensor([self.token_to_id[t] for t in tokens], device=self.device)
        rows = self.text_encoder.token_embedding.weight.detach()[ids]
        export_token_embeddings(rows, {t: i for i, t in enumerate(tokens)}, cfg.output_dir,
                                aug_tokens=self.aug_tokens)
