"""Trainer: set-up, the loop, and the final export.

Counterpart of textboost_tpu/train/trainer.py (`_setup` :184-814 without
the AOT, mesh, relay and warm-up machinery; the loop :853-1026;
`save_final` :1076-1115): tokenizer -> token surgery -> models -> frozen
text encoder captured before surgery -> embedding growth and norm stats ->
null embedding -> schedule -> optimizer -> loaders; then one eager train
step per (micro-)batch, metrics every 10 steps to `metrics.jsonl`, and at
the end the PEFT `text_encoder/` adapter and `{token}.bin` files that
`textboost_torch.inference` and the JAX `load_textboost_pipeline` load.

Flags the port does not serve yet raise NotImplementedError here
(train/config.py::unsupported_flags).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Union

import numpy as np
import torch

from ..data.datasets import InstructPix2PixDataset, PriorDataset, TextBoostDataset
from ..data.loader import PrefetchLoader
from ..data.sharding import process_shard_info
from ..data.tokenizer import HashTokenizer, load_tokenizer
from ..device import resolve_device
from ..lora.partition import count_params, lr_schedule, make_optimizer, set_trainable
from ..lora.peft_io import export_lora_adapter, export_token_embeddings
from ..models.layers import set_impl
from ..models.pretrained import load_models
from ..models.textboost import load_null_embedding_asset
from ..ops.schedule import NoiseSchedule
from ..tokens.surgery import plan_token_addition
from ..utils.profiling import StepTimer, device_memory_stats
from ..utils.trackers import Trackers
from .config import TrainConfig, unsupported_flags
from .step import StepConfig, TrainState, make_train_step, sample_draws

logger = logging.getLogger("textboost_torch")

ATTENTION_IMPLS = {"auto": "auto", "xla": "math"}  # --attention_impl -> the port's impl


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
        self.token_to_id: Dict[str, int] = {}
        self.concept_tokens: Dict[str, str] = {}
        init_row_ids: List[int] = []
        new_row_ids: List[int] = []
        for concept in self.concepts:
            placeholder = concept.get("placeholder_token") or concept["instance_token"]
            initializer = concept.get("initializer_token") or cfg.initializer_token
            toks, pids, iids = plan_token_addition(self.tokenizer, placeholder, initializer)
            init_row_ids += iids
            new_row_ids += pids
            for tok, tid in zip(toks, pids):
                self.token_to_id[tok] = tid
            joined = " ".join(toks)  # multi-vector prompts use the expanded identifier
            self.concept_tokens[concept["instance_token"]] = joined
            self.concept_tokens[placeholder] = joined
        assert new_row_ids == list(range(first_added_id, first_added_id + len(new_row_ids))), (
            f"non-sequential added token ids: {new_row_ids}")
        if init_row_ids and max(init_row_ids) >= first_added_id:
            raise ValueError(
                "initializer_token resolves to a placeholder token added in this run — "
                "chained placeholder initializers are unsupported; use a regular "
                "vocabulary word as the initializer"
            )
        self.first_added_id = first_added_id

        # ---- models (train_textboost.py:630-654) ----
        self.bundle = load_models(
            cfg.pretrained_model_name_or_path, preset=cfg.model_preset,
            lora_rank=cfg.lora_rank, dtype=dtype,
            vae_dtype=torch.float32 if cfg.vae_fp32 else None, device=dev, seed=cfg.seed,
        )
        spec = self.bundle.spec
        te, unet, vae = self.bundle.text_encoder, self.bundle.unet, self.bundle.vae
        for mod in (te, unet, vae):
            mod.requires_grad_(False)
            set_impl(mod, ATTENTION_IMPLS[cfg.attention_impl])
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
        trainable = set_trainable(te)
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
        optimizer = make_optimizer(te, lr, emb_lr, beta1=cfg.adam_beta1, beta2=cfg.adam_beta2,
                                   weight_decay=cfg.adam_weight_decay, eps=cfg.adam_epsilon)
        scheduler = lr_schedule(optimizer, cfg.lr_scheduler, cfg.lr_warmup_steps,
                                cfg.max_train_steps)
        n_train = count_params(trainable)
        logger.info("Trainable params: %.3fM", n_train / 1e6)
        print(f"Trainable params: {n_train / 1e6:.3f}M "
              f"(LoRA r={cfg.lora_rank} + {len(self.token_to_id)} token embeddings)")

        # ---- data (:857-909) ----
        concepts_for_ds = [{**c, "instance_token": self.concept_tokens[c["instance_token"]]}
                           for c in self.concepts]
        shard_id, num_shards = process_shard_info()
        dataset = TextBoostDataset(
            concepts_for_ds, self.tokenizer, num_instance=cfg.num_samples,
            template=cfg.template, size=cfg.resolution, center_crop=cfg.center_crop,
            seed=cfg.seed,
        )
        cpus = os.cpu_count() or 1
        self.train_loader = PrefetchLoader(
            dataset, batch_size=cfg.train_batch_size, collate=TextBoostDataset.collate,
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
        )
        self.train_step = make_train_step(self.step_config)
        self.state = TrainState(
            text_encoder=te, frozen_text_encoder=self.frozen_te, unet=unet, vae=vae,
            optimizer=optimizer, lr_scheduler=scheduler, schedule=self.schedule,
            null_embedding=self.null_embedding,
            target_norm=torch.tensor(self.mean_norm, dtype=torch.float32, device=dev),
            original_rows=grown[:first_added_id].clone(),
        )
        self.generator = torch.Generator(dev).manual_seed(cfg.seed)
        self.latent_shape = (spec.vae.latent_channels, cfg.resolution // 8, cfg.resolution // 8)
        mark("step + state built")

    # ------------------------------------------------------------------
    def _device_batch(self, batch: Dict, prior_batch: Dict) -> Dict[str, torch.Tensor]:
        """Host numpy batch -> tensors on the device (pinned, non_blocking
        copies on the card)."""
        arrays = {
            "pixel_values": batch["pixel_values"],
            "input_ids": batch["input_ids"].astype(np.int64),
            "prior_input_ids": prior_batch["input_ids"].astype(np.int64),
        }
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory() if cuda else t).to(self.device, non_blocking=cuda)
        return out

    def _draws(self) -> Dict[str, torch.Tensor]:
        return sample_draws(self.generator, batch_size=self.config.train_batch_size,
                            latent_shape=self.latent_shape, schedule=self.schedule,
                            weighted_timesteps=self.step_config.weighted_timesteps)

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
        step = 0
        start_time = time.perf_counter()
        timer = StepTimer()
        last_metrics: Dict[str, float] = {}
        accum = max(cfg.gradient_accumulation_steps, 1)
        loop_t = {"dispatch_ms": 0.0, "host_wait_ms": 0.0, "h2d_ms": 0.0}
        window_start = 0
        profiler = None
        next_batch = self._device_batch(next(train_iter), next(prior_iter))
        while step < cfg.max_train_steps:
            if cfg.profile_dir and step == 5:  # trace steps [5, 15) of the run
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                profiler.start()
            for _ in range(accum):
                batch = next_batch
                t0 = time.perf_counter()
                metrics = self.train_step(self.state, batch, self._draws())
                t1 = time.perf_counter()
                host = (next(train_iter), next(prior_iter))
                t2 = time.perf_counter()
                next_batch = self._device_batch(*host)
                t3 = time.perf_counter()
                loop_t["dispatch_ms"] += (t1 - t0) * 1000
                loop_t["host_wait_ms"] += (t2 - t1) * 1000
                loop_t["h2d_ms"] += (t3 - t2) * 1000
            step += 1
            if profiler is not None and step == 15:
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
        if profiler is not None:
            profiler.stop()

        wall = time.perf_counter() - start_time
        logger.info("Training took %.1f seconds.", wall)
        print(f"Training took {wall:.1f} seconds.")
        self.save_final()
        self._trackers.finish()
        self._metrics_file.close()
        return {"wall_time_s": wall, "steps": step, **last_metrics}

    # ------------------------------------------------------------------
    def save_final(self):
        """Final layout (train_textboost.py:1234-1266): the `text_encoder/`
        PEFT adapter dir and the token bins at the output root."""
        cfg = self.config
        base = cfg.pretrained_model_name_or_path or self.bundle.spec.name
        if not cfg.skip_save_text_encoder and cfg.lora_rank > 0:
            export_lora_adapter(self.text_encoder, os.path.join(cfg.output_dir, "text_encoder"),
                                rank=cfg.lora_rank, base_model_name=base)
        # Only the learned rows leave the device.
        tokens = list(self.token_to_id)
        ids = torch.as_tensor([self.token_to_id[t] for t in tokens], device=self.device)
        rows = self.text_encoder.token_embedding.weight.detach()[ids]
        export_token_embeddings(rows, {t: i for i, t in enumerate(tokens)}, cfg.output_dir)
