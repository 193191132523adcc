"""Trainer: set-up, the loop, checkpoints, validation and the final export.

Counterpart of textboost_tpu/train/trainer.py (`_setup` :184-814 without
the mesh, relay and warm-up machinery; the loop :853-1026; `save`
:1032-1075; `save_final` :1076-1115; validation :1157-1321): tokenizer ->
token surgery (placeholders, and with --augment_inversion the bank of
augmentation tokens) -> models -> frozen text encoder captured before
surgery -> embedding growth and norm stats -> null embedding -> schedule ->
optimizer -> class-prior images (generated when the class dir is short)
-> paired augmentation and loaders -> resume; then one train step per
(micro-)batch, metrics every 10 steps to `metrics.jsonl`, a
compact checkpoint every --checkpointing_steps and a validation grid every
--validation_steps (both written on writer threads, joined at the end),
and at the end the PEFT `text_encoder/` adapter (and `unet/`, with
`--unet_params_to_train crossattn_kv`) and `{token}.bin` files that
`textboost_torch.inference` and the JAX `load_textboost_pipeline` load.
On a card the step runs as CUDA graphs after its warm-up steps, one per
micro-step position (the counterpart of the JAX trainer's jitted step,
textboost_tpu/train/trainer.py:728, and of aot.py): with the UNet's LoRA,
the image prior, accumulation and under an NCCL launch at world 1 too
(train/graph.py::eager_reason).  It runs eagerly under tensor parallelism,
in more than one process (capture across NCCL ranks waits for a check on
two cards) and over gloo (whose all-reduce goes through a host copy).  The
batch and the draws are made eagerly and copied into the graphs' inputs.
The cross-instance memo keeps a captured step only inside aot.py's own
envelope (train/graph.py::envelope_reason).  The validation rounds'
sampling runs as a graph from the second round when the step is captured
and the run holds enough rounds to pay the capture back
(train/graph.py::validation_eager_reason).  Elsewhere each runs eagerly,
and the result and the log say why.
`--gradient_checkpointing` recomputes the UNet's blocks in the backward;
`--text_encoder_use_attention_mask` threads the padded CLIP mask into the
step's text encodes.  `--augment_device` uploads the instance images once
and executes each batch's augmentation plans on the device
(data/device_augment.py); `--validation_scheduler` picks the validation
rounds' sampler (samplers/solvers.py::get_sampler).

Under a torchrun launch (parallel/mesh.py) each dp index trains on its
rows of the --train_batch_size global batch: its slice of the loaders'
global batch and of the global draws, one all-reduce of the trainable
gradients per micro-step, the same update everywhere.  With --mesh_tp > 1
the frozen UNet and text encoder are split over each tp group
(parallel/tensor.py), whose ranks take the same rows and draws; the
trainable text encoder and the UNet's LoRA stay whole on every rank, so
that checkpoints, export and resume do not change.  The ranks of rank 0's
tp group generate the class-prior images and run the validation rounds
together (the other ranks wait at a barrier, or in the next step's
reduce); rank 0 alone writes the images, the log, metrics, trackers,
profiler trace, checkpoints, validation grids and the export; every rank
restores the same checkpoint on resume.

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
import torch.distributed as dist

from ..data.augment import PairedAugmentation
from ..data.device_augment import augment_batch
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
from ..models.layers import set_attention_impl
from ..models.pretrained import load_models
from ..models.textboost import load_null_embedding_asset
from ..ops.schedule import NoiseSchedule
from ..parallel.mesh import GradReducer, barrier, is_main, make_mesh
from ..parallel.tensor import TensorParallel, shard_, tp_partial_parameters, tp_rule_report
from ..pipelines.text_to_image import TextToImagePipeline
from ..samplers.solvers import get_sampler
from ..tokens.surgery import OBJECT_AUGMENTATIONS, STYLE_AUGMENTATIONS, plan_token_addition
from ..utils.profiling import StepTimer, device_memory_stats
from ..utils.trackers import Trackers
from .. import graphs
from . import checkpoint, graph
from .config import TrainConfig, unsupported_flags
from .prior_generation import generate_prior_images
from .step import StepConfig, TrainState, make_train_step, sample_draws

logger = logging.getLogger("textboost_torch")

ATTENTION_IMPLS = {"auto": "auto", "xla": "math", "flash": "flash"}  # --attention_impl -> impl
WRITER_TIMEOUT_S = 600.0
VALIDATION_GUIDANCE = 7.5  # train_textboost.py's log_validation


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


def local_batch_size(config: TrainConfig, dp: int) -> int:
    """Each dp index's rows of the --train_batch_size global batch.  Raises
    when dp does not divide the batch (textboost_tpu/train/trainer.py:
    574-583), and for --augment_device at dp > 1 (:603)."""
    if dp > 1 and config.augment_device:
        raise ValueError("--augment_device is single-process only")
    if config.train_batch_size % dp:
        raise ValueError(f"train_batch_size ({config.train_batch_size}) must be divisible by "
                         f"the process count ({dp})")
    return config.train_batch_size // dp


class Trainer:
    def __init__(self, config: TrainConfig, device: Union[str, torch.device] = "cuda"):
        self.mesh = make_mesh(config.mesh_dp, config.mesh_tp)
        self.local_batch_size = local_batch_size(config, self.mesh.dp)
        self.is_main = is_main()
        # Rank 0's tp group samples the prior images and validation grids.
        self.in_main_group = self.mesh.dp_index == 0
        self.tp = (TensorParallel(self.mesh.tp_group, self.mesh.tp, self.mesh.tp_index)
                   if self.mesh.tp > 1 else None)
        problems = unsupported_flags(config)
        if config.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"--attention_impl {config.attention_impl!r} not in "
                             f"{sorted(ATTENTION_IMPLS)}")
        if problems:
            raise NotImplementedError("not served by textboost_torch yet: " + "; ".join(problems))
        get_sampler(config.validation_scheduler)  # an unknown name raises here, not at step 1
        self.config = config
        self.device = resolve_device(device)
        self._setup_logging()
        self._memo_key = None
        try:
            self._setup()
        except BaseException:
            if self._memo_key is not None:  # an entry taken or filled, perhaps half bound
                graph.memo_drop(self._memo_key)
            raise

    # ------------------------------------------------------------------
    def _setup_logging(self):
        # Rank 0 alone writes into the output dir; the others' trackers are
        # no-ops.
        self._metrics_file = None
        self._trackers = Trackers(None, self.config.logging_dir)
        if not self.is_main:
            return
        os.makedirs(self.config.output_dir, exist_ok=True)
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
        if self._metrics_file is None:
            return
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
        # A tensor-parallel run splits the frozen modules in place: it
        # neither takes nor fills the preset memo.
        bundle = load_models(
            cfg.pretrained_model_name_or_path, preset=cfg.model_preset,
            lora_rank=cfg.lora_rank, unet_lora_rank=cfg.lora_rank if self.train_unet else 0,
            dtype=dtype, vae_dtype=torch.float32 if cfg.vae_fp32 else None, device=dev,
            seed=cfg.seed, memo=self.tp is None,
        )
        spec = bundle.spec
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.eager_reason = graph.eager_reason(
            cfg, dev, world, backend=dist.get_backend() if dist.is_initialized() else None)
        # The cross-instance memo (train/graph.py): inside aot.py's envelope
        # (`envelope_reason`), keyed as its step memo; taken by this trainer
        # alone.
        self._memo_key = None
        memo = None
        if graph.envelope_reason(cfg, world, dist.is_initialized()) is None:
            self._memo_key = graph._memo_key("step", cfg, spec, dev, dtype,
                                             first_added_id + len(new_row_ids), first_added_id,
                                             self.eager_reason)
            memo = graph.memo_take(self._memo_key)
            if memo is None and self._memo_key in graph._AOT_MEMO:
                self._memo_key = None  # another trainer holds it: this run keeps out
        self._memo = memo
        te, unet, vae = bundle.text_encoder, bundle.unet, bundle.vae
        frozen_te = bundle.frozen_text_encoder
        if memo is not None:
            # This instance's fresh weights into the entry's tensors (nothing
            # to copy where they are the memo's own modules).
            graph.copy_module_(memo.text_encoder, te,
                               skip=("text_model.embeddings.token_embedding.weight",))
            graph.copy_module_(memo.frozen_text_encoder, te if frozen_te is None else frozen_te)
            graph.copy_module_(memo.unet, unet)
            graph.copy_module_(memo.vae, vae)
            table = te.token_embedding.weight  # the base rows the added ones copy
            te, frozen_te, unet, vae = (memo.text_encoder, memo.frozen_text_encoder,
                                        memo.unet, memo.vae)
        else:
            table = te.token_embedding.weight
        self.bundle = dataclasses.replace(bundle, text_encoder=te, unet=unet, vae=vae,
                                          frozen_text_encoder=frozen_te)
        del bundle
        for mod in (te, unet, vae):
            mod.requires_grad_(False)
            set_attention_impl(mod, ATTENTION_IMPLS[cfg.attention_impl])
        unet.gradient_checkpointing = cfg.gradient_checkpointing
        mark("models loaded" if memo is None else "models bound into the memo's entry")

        # Frozen reference encoder, captured BEFORE token surgery (:650): the
        # memo's pristine copy where the bundle came from it.
        self.frozen_te = frozen_te if frozen_te is not None else copy.deepcopy(te)
        self.frozen_te.requires_grad_(False)
        set_attention_impl(self.frozen_te, ATTENTION_IMPLS[cfg.attention_impl])
        if self.tp is not None:
            # The frozen encoder and the UNet split over the tp group; the
            # trainable encoder and the VAE stay whole (:668-676).
            for name, model in (("frozen text encoder", self.frozen_te), ("UNet", unet)):
                counts, whole = tp_rule_report(model, self.mesh.tp)
                shard_(model, self.tp)
                logger.info("tensor parallel over %d ranks (dp %d x tp %d), %s: %d weights "
                            "split (%s), %d left whole: %s", dist.get_world_size(),
                            self.mesh.dp, self.mesh.tp, name, sum(counts.values()),
                            {k: n for k, n in counts.items() if n}, len(whole), sorted(whole))
            mark("frozen models split")

        # ---- embedding growth, norm stats, null embedding ----
        with torch.no_grad():
            src = torch.as_tensor(init_row_ids, dtype=torch.long, device=dev)
            grown = torch.cat([table.float(), table[src].float()], dim=0)
            norms = torch.linalg.vector_norm(grown, dim=-1)
            max_norm = float(norms[: max(first_added_id - 2, 1)].max())
            self.mean_norm = float(norms.mean())
        del table
        logger.info("Max norm: %s  Mean norm: %s", max_norm, self.mean_norm)
        if not (memo is not None and te.fill_token_embedding(grown)):
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
        if memo is not None:
            memo.null_embedding.copy_(self.null_embedding)
            self.null_embedding = memo.null_embedding
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
            # The global batch: the reference's per-card batch times its
            # process count (train_textboost.py:823-826).
            scale = cfg.gradient_accumulation_steps * cfg.train_batch_size
            lr, emb_lr = lr * scale, emb_lr * scale
        if memo is not None:  # the entry's, as a fresh optimizer's first update finds it
            optimizer = memo.optimizer
            graph.reset_optimizer_(optimizer)
        else:
            optimizer = make_optimizer(te, lr, emb_lr, unet=unet if self.train_unet else None,
                                       beta1=cfg.adam_beta1, beta2=cfg.adam_beta2,
                                       weight_decay=cfg.adam_weight_decay, eps=cfg.adam_epsilon)
        # A new schedule over the entry's optimizer starts again: each group's
        # `initial_lr` is the config's rate, which the key holds.
        scheduler = lr_schedule(optimizer, cfg.lr_scheduler, cfg.lr_warmup_steps,
                                cfg.max_train_steps)
        n_train = count_params(trainable)
        logger.info("Trainable params: %.3fM", n_train / 1e6)
        print(f"Trainable params: {n_train / 1e6:.3f}M "
              f"(LoRA r={cfg.lora_rank} + {len(self.token_to_id)} token embeddings)")

        # ---- class-prior images (utils.py:50-114), from the base modules ----
        # (`--prior_generation_precision` is accepted and unused, as in JAX.)
        # Rank 0's tp group samples and rank 0 writes; the others read the
        # dir after the barrier.
        if cfg.with_image_prior and self.in_main_group:
            made = generate_prior_images(
                TextToImagePipeline(spec, self.tokenizer, self.frozen_te, unet, vae,
                                    device=dev, freeze=False),
                cfg.class_data_dir, cfg.class_token, cfg.num_prior_images,
                sample_batch_size=cfg.sample_batch_size, seed=cfg.seed, write=self.is_main)
            if made:
                logger.info("Generated %d class prior images", made)
        if cfg.with_image_prior:
            barrier()
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
        shard_id, num_shards = process_shard_info(tp=self.mesh.tp)
        dataset = TextBoostDataset(
            concepts_for_ds, self.tokenizer, num_instance=cfg.num_samples,
            template=cfg.template,
            prior_data_root=cfg.class_data_dir if cfg.with_image_prior else None,
            class_token=cfg.class_token,
            num_prior=cfg.num_prior_images if cfg.with_image_prior else None,
            size=cfg.resolution, center_crop=cfg.center_crop,
            augment_pipe=augment_pipe, seed=cfg.seed, device_augment=cfg.augment_device,
        )
        self._image_bank: Optional[torch.Tensor] = None
        if cfg.augment_device:
            # The pixels go to the device once; each step sends the ids and
            # one row of plan scalars per sample (:599-616).
            bank, _ = dataset.build_image_bank()
            self._image_bank = torch.from_numpy(bank).to(dev)
            logger.info("device augmentation: %d instance image(s) resident (%.1f MB uploaded "
                        "once)", bank.shape[0], bank.nbytes / 1e6)
        cpus = os.cpu_count() or 1
        self.train_loader = PrefetchLoader(
            dataset, batch_size=self.local_batch_size,
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
            prior_ds, batch_size=self.local_batch_size, collate=PriorDataset.collate,
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
        unet_lora = lora_parameters(unet) if self.train_unet else []
        # One all-reduce per micro-step under a launch (at world 1 too).
        self.reducer = (GradReducer(te.token_embedding.weight, first_added_id,
                                    lora_parameters(te) + unet_lora,
                                    tp_partial=tp_partial_parameters(unet), tp=self.mesh.tp)
                        if dist.is_initialized() else None)
        if self.reducer is not None:
            emb_bytes = te.token_embedding.weight.numel() * 4
            logger.info("data parallel over %d ranks: %d values (%d bytes) all-reduced per "
                        "micro-step, against %d bytes of the embedding's whole gradient",
                        self.mesh.dp, self.reducer.values(), 4 * self.reducer.values(),
                        emb_bytes)
        if memo is not None:
            self.train_step = memo.train_step
            memo.target_norm.fill_(self.mean_norm)
            memo.original_rows.copy_(grown[:first_added_id])
            target_norm, original_rows = memo.target_norm, memo.original_rows
        else:
            step = make_train_step(self.step_config, reduce=self.reducer)
            self.train_step = (step if self.eager_reason is not None else graph.CapturedStep(
                step, dev, accumulate=self.step_config.accumulate_steps))
            target_norm = torch.tensor(self.mean_norm, dtype=torch.float32, device=dev)
            original_rows = grown[:first_added_id].clone()
        captured = isinstance(self.train_step, graph.CapturedStep) and self.train_step.captured
        logger.info("train step: %s", f"eager: {self.eager_reason}" if self.eager_reason else
                    "the memo's CUDA graph, replayed from the first step" if captured else
                    f"a CUDA graph per micro-step position, captured after "
                    f"{graph.WARMUP_STEPS} eager steps")
        self.state = TrainState(
            text_encoder=te, frozen_text_encoder=self.frozen_te, unet=unet, vae=vae,
            optimizer=optimizer, lr_scheduler=scheduler, schedule=self.schedule,
            null_embedding=self.null_embedding, target_norm=target_norm,
            original_rows=original_rows, unet_lora=unet_lora,
        )
        if memo is None and self._memo_key is not None:
            self._memo = graph.MemoEntry(
                text_encoder=te, frozen_text_encoder=self.frozen_te, unet=unet, vae=vae,
                optimizer=optimizer, null_embedding=self.null_embedding,
                target_norm=target_norm, original_rows=original_rows,
                train_step=self.train_step)
            graph.memo_put(self._memo_key, self._memo)
        self.generator = torch.Generator(dev).manual_seed(cfg.seed)
        self.latent_shape = (spec.vae.latent_channels, cfg.resolution // 8, cfg.resolution // 8)
        mark("step + state built")

        self._ckpt_threads: List[threading.Thread] = []
        self._val_threads: List[threading.Thread] = []
        self._val_pipe: Optional[TextToImagePipeline] = None
        self.validation_eager_reason: Optional[str] = None
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
                if isinstance(self.train_step, graph.CapturedStep):
                    # The optimizer's state tensors are the checkpoint's now:
                    # the memo's graph read the old ones.
                    self.train_step.release()
                # Carry on the data stream instead of replaying batch 0 (the
                # loaders count micro-batches).
                accum = max(cfg.gradient_accumulation_steps, 1)
                self.train_loader.set_start_step(self.start_step * accum)
                self.prior_loader.set_start_step(self.start_step * accum)
                logger.info("Resumed from %s at step %d", ckpt, self.start_step)
        # This run's own counts of the step graph: an entry's carries those of
        # the instances before it.
        held = isinstance(self.train_step, graph.CapturedStep)
        self._step_from_memo = held and self.train_step.captured
        self._step_counts = ((self.train_step.eager_steps, self.train_step.replays)
                             if held else (0, 0))

    # ------------------------------------------------------------------
    def _device_batch(self, batch: Dict, prior_batch: Dict) -> Dict[str, torch.Tensor]:
        """Host numpy batch -> tensors on the device (pinned, non_blocking
        copies on the card).  With --augment_device the pixels are made on
        the device from the bank by the batch's plans: uint8 NHWC, as the
        host path ships them, normalised by the step."""
        arrays = {
            "input_ids": batch["input_ids"].astype(np.int64),
            "prior_input_ids": prior_batch["input_ids"].astype(np.int64),
        }
        if self._image_bank is None:
            arrays["pixel_values"] = batch["pixel_values"]
        if "mask" in batch:
            arrays["mask"] = batch["mask"]
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory() if cuda else t).to(self.device, non_blocking=cuda)
        if self._image_bank is not None:
            out["pixel_values"] = augment_batch(self._image_bank, batch["aug"],
                                                self.config.resolution)
        return out

    def _draws(self) -> Dict[str, torch.Tensor]:
        """The global batch's draws, from the generator that is equal on
        every rank, and this dp index d's rows of them (a tp group's ranks
        take the same): instance rows [d*L, (d+1)*L), then with the image
        prior the class rows [B + d*L, B + (d+1)*L) (the class samples
        follow the instance ones)."""
        cfg, local = self.config, self.local_batch_size
        halves = 2 if cfg.with_image_prior else 1
        draws = sample_draws(self.generator, batch_size=cfg.train_batch_size * halves,
                             latent_shape=self.latent_shape, schedule=self.schedule,
                             weighted_timesteps=self.step_config.weighted_timesteps)
        if local == cfg.train_batch_size:
            return draws
        starts = [h * cfg.train_batch_size + self.mesh.dp_index * local for h in range(halves)]
        return {k: torch.cat([v[s:s + local] for s in starts]) for k, v in draws.items()}

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
        except BaseException:
            if self._memo_key is not None:  # its graphs may be half made
                graph.memo_drop(self._memo_key)
                self._memo_key = None
            raise
        finally:
            self.train_loader.stop()
            self.prior_loader.stop()
            self.release_graphs()

    def release_graphs(self) -> None:
        """The run's end: drop the validation rounds' CUDA graphs and their
        memory; hand the memo's entry back with the step's graph (the next
        instance of a --sequential sweep with the same key replays it), or,
        outside the memo, drop the step's graph too."""
        if self._val_pipe is not None:
            self._val_pipe.release_graphs()
        if self._memo_key is not None:
            graph.memo_give_back(self._memo_key, self._memo)
            self._memo_key = None
        elif isinstance(self.train_step, graph.CapturedStep):
            self.train_step.release()

    def run_step(self, batch: Dict[str, torch.Tensor],
                 draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One (micro-)step: the graph's replay or the eager step."""
        return self.train_step(self.state, batch, draws)

    def graph_stats(self) -> Dict[str, object]:
        """`step_graph`: "captured" or "eager: <reason>"; with the graphs'
        number, capture ms and pool bytes, this run's micro-step replays and
        eager micro-steps, and `step_graph_from_memo`: whether an earlier
        instance captured it."""
        out: Dict[str, object] = {}
        if isinstance(self.train_step, graph.CapturedStep):
            if self.train_step.captured:
                stats = self.train_step.stats()
                stats["eager_steps"] -= self._step_counts[0]
                stats["replays"] -= self._step_counts[1]
                out["step_graph"] = "captured"
                out["step_graph_from_memo"] = self._step_from_memo
                out.update({f"step_graph_{k}": v for k, v in stats.items()})
            else:
                out["step_graph"] = (f"eager: the run ended within its "
                                     f"{self.train_step.warmup} warm-up steps")
        else:
            out["step_graph"] = f"eager: {self.eager_reason}"
        if self._val_pipe is not None:
            if self._val_pipe.graphs is None:
                out["validation_graph"] = f"eager: {self.validation_eager_reason}"
            else:
                stats = self._val_pipe.graphs.stats().get(self._validation_key())
                out["validation_graph"] = ("captured" if stats else
                                           "eager: the run ended within its first round")
                out.update({f"validation_graph_{k}": v for k, v in (stats or {}).items()})
        return out

    def _train(self) -> Dict[str, float]:
        cfg = self.config
        train_iter, prior_iter = iter(self.train_loader), iter(self.prior_loader)
        self._log_metrics(0, {"max_norm": 0.0, "mean_norm": self.mean_norm})
        step = self.start_step
        start_time = time.perf_counter()
        timer = StepTimer()
        last_metrics: Dict[str, float] = {}
        losses: List[torch.Tensor] = []  # each step's, fetched at the end
        accum = max(cfg.gradient_accumulation_steps, 1)
        loop_t = {"dispatch_ms": 0.0, "host_wait_ms": 0.0, "h2d_ms": 0.0}
        tp_steps = []  # the tp collectives' call range of each step
        window_start = step
        profiler = None
        t0 = time.perf_counter()
        host = (next(train_iter), next(prior_iter))
        # The wait for each step's host batches, the first (before the loop:
        # the producers' start) apart.
        host_waits = [(time.perf_counter() - t0) * 1000]
        next_batch, next_prompts = self._device_batch(*host), host[0]["prompt"]
        while step < cfg.max_train_steps:
            # Trace steps [5, 15) of the run (rank 0).
            if cfg.profile_dir and self.is_main and step - self.start_step == 5:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                profiler.start()
            tp_first = self.tp.calls if self.tp is not None else 0
            for _ in range(accum):
                batch = next_batch
                self._count_augmentations(next_prompts)
                t0 = time.perf_counter()
                metrics = self.run_step(batch, self._draws())
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
            losses.append(metrics["loss"].clone())  # a replay overwrites the graph's outputs
            if self.tp is not None:
                tp_steps.append((tp_first, self.tp.calls))
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
            if self.is_main and cfg.checkpointing_steps and step % cfg.checkpointing_steps == 0:
                self.save(step)
            if (self.in_main_group and cfg.validation_prompts and cfg.validation_steps
                    and step % cfg.validation_steps == 0):
                self.run_validation(step)
        if profiler is not None:
            profiler.stop()

        wall = time.perf_counter() - start_time
        logger.info("Training took %.1f seconds.", wall)
        print(f"Training took {wall:.1f} seconds.")
        loss_by_step = torch.stack(losses).float().cpu().tolist() if losses else []
        logger.info("Loss by step %d-%d: %s", self.start_step + 1, step, loss_by_step)
        result = {"wall_time_s": wall, "steps": step, **last_metrics,
                  "host_wait_ms_by_step": host_waits, "loss_by_step": loss_by_step,
                  **self.graph_stats()}
        if self.reducer is not None and self.reducer.calls:
            r, ms = self.reducer, self.reducer.milliseconds()
            result.update({"dp_backend": dist.get_backend(), "dp_world": self.mesh.dp,
                           "all_reduce_calls": r.calls, "all_reduce_replayed": r.replayed,
                           "all_reduce_bytes_per_call": r.bytes / r.calls,
                           "all_reduce_ms_by_call": ms})
            logger.info("all-reduce: %d calls, %d bytes each; %d eager, timed: median %.3f ms "
                        "(%.3f-%.3f); %d replayed in the step's CUDA graphs, untimed", r.calls,
                        r.bytes // r.calls, r.calls - r.replayed, float(np.median(ms)), min(ms),
                        max(ms), r.replayed)
        if tp_steps:
            result.update(self._tp_by_step(tp_steps))
        # The writers' time overlapped the loop; they land before the run
        # is declared done (:1016-1022).
        self.join_checkpoint_writers()
        self.join_validation_writers()
        if self.caption_map:
            logger.info("Augmentation tokens in the captions: %s", dict(self.augmentation_counts))
        if self.is_main:
            self.save_final()
            self._metrics_file.close()
        self._trackers.finish()
        result.update({f"{key}_ms": 1e3 * sum(values) / len(values)
                       for key, values in self.timings.items() if values})
        result.update({f"aug:{k}": float(n) for k, n in self.augmentation_counts.items()})
        return result

    def _tp_by_step(self, tp_steps) -> Dict[str, List[float]]:
        """The tp collectives of each step (those of validation rounds and
        set-up apart): calls forward and backward, bytes and ms."""
        tp, ms = self.tp, self.tp.milliseconds()
        out = {key: [] for key in ("tp_fwd_calls_by_step", "tp_bwd_calls_by_step",
                                   "tp_bytes_by_step", "tp_ms_by_step")}
        for a, b in tp_steps:
            out["tp_fwd_calls_by_step"].append(tp.kinds[a:b].count("fwd"))
            out["tp_bwd_calls_by_step"].append(tp.kinds[a:b].count("bwd"))
            out["tp_bytes_by_step"].append(sum(tp.bytes[a:b]))
            out["tp_ms_by_step"].append(sum(ms[a:b]))
        logger.info("tensor-parallel all-reduces a step: %d forward + %d backward, %d bytes, "
                    "median %.3f ms (%.3f-%.3f); %d calls in all", out["tp_fwd_calls_by_step"][-1],
                    out["tp_bwd_calls_by_step"][-1], out["tp_bytes_by_step"][-1],
                    float(np.median(out["tp_ms_by_step"])), min(out["tp_ms_by_step"]),
                    max(out["tp_ms_by_step"]), tp.calls)
        return out

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

    def _validation_key(self) -> tuple:
        """The pipeline's signature of a validation round: the JAX package's
        validation signature and the guidance scale."""
        batch, height, width, steps, _, sampler = graph.validation_signature(
            self.config, self.bundle.spec)
        return graphs.sampler_key(batch, height, width, steps, VALIDATION_GUIDANCE, sampler)

    def _validation_pipe(self) -> TextToImagePipeline:
        """The sampling pipeline over the LIVE text encoder, UNet and VAE
        (no copy of the weights; the grown embedding is read as it is now),
        built once and kept across rounds; its rounds' sampling a CUDA graph
        from the second round where `graph.validation_eager_reason` allows."""
        if self._val_pipe is None:
            self._val_pipe = TextToImagePipeline(
                self.bundle.spec, self.tokenizer, self.text_encoder, self.bundle.unet,
                self.bundle.vae, null_embedding=self.null_embedding, fixed_special=True,
                device=self.device, freeze=False)
            self.validation_eager_reason = graph.validation_eager_reason(
                self.config, self.eager_reason,
                graph.validation_rounds(self.config, self.start_step))
            if self.validation_eager_reason is None:
                self._val_pipe.graphs = graphs.CapturedSampler([self._validation_key()])
            logger.info("validation sampling: %s",
                        f"eager: {self.validation_eager_reason}" if self.validation_eager_reason
                        else "a CUDA graph, captured at the second round")
        return self._val_pipe

    def join_validation_writers(self) -> None:
        """Wait for the validation writers; raise if one failed."""
        threads, self._val_threads = self._val_threads, []
        _join_writers(threads, "validation")

    def run_validation(self, step: int) -> str:
        """log_validation counterpart (train_textboost.py:453-531): sample
        num_validation_images per substituted prompt from the live weights
        (25 steps of --validation_scheduler, CFG 7.5, latents from a generator of its own
        seeded with --seed, in eval mode, then the modules' modes back) and
        write a (prompts x images) grid to validation_{step}.jpg.  The grid
        and the trackers' images are written on a writer thread, joined
        before the next round and at the end of train().  Every rank of
        rank 0's tp group samples (the sharded UNet needs them all); rank 0
        alone writes."""
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
            images = pipe(prompts, num_inference_steps=25, guidance_scale=VALIDATION_GUIDANCE,
                          generator=torch.Generator(self.device).manual_seed(cfg.seed),
                          sampler=cfg.validation_scheduler)
        finally:
            for m, mode in zip(modules, modes):
                m.train(mode)
        self.timings["validation"].append(time.perf_counter() - t0)
        path = os.path.join(cfg.output_dir, f"validation_{step}.jpg")
        if not self.is_main:
            return path
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
