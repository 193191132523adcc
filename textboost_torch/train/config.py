"""Training CLI configuration: a copy of textboost_tpu/train/config.py, so
that `python -m textboost_torch.train` takes the JAX CLI's flags, parsed by
the same `TrainConfig` (flag-for-flag parity with the reference's
`parse_args`, train_textboost.py:49-450, plus the JAX package's extras).

`unsupported_flags` names the flags the port does not serve yet; the
trainer raises NotImplementedError for each at setup, naming the ROADMAP
item, so none is silently ignored.

Reference defaults are preserved, including the quirky ones:
`--disable_weighted_sample` defaults True (the weighted sampler is dead in
every reachable config, train_textboost.py:406-411) — we keep the default
but our flag actually toggles (the reference's store_true-with-default-True
could never be turned off; SURVEY.md §2 "known bugs to not replicate").
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import warnings
from typing import List, Optional


@dataclasses.dataclass
class TrainConfig:
    # -- model -----------------------------------------------------------
    pretrained_model_name_or_path: Optional[str] = None
    revision: Optional[str] = None
    variant: Optional[str] = None
    tokenizer_name: Optional[str] = None
    # -- data ------------------------------------------------------------
    instance_data_dir: Optional[str] = None
    instance: Optional[str] = None
    class_data_dir: Optional[str] = None
    instance_token: Optional[str] = None
    class_token: Optional[str] = None
    concepts_list: Optional[str] = None
    num_samples: Optional[int] = None
    # -- priors ----------------------------------------------------------
    with_image_prior: bool = False
    image_ppl_weight: float = 1.0
    kpl_weight: float = 0.1
    kpl_type: str = "cos"
    num_prior_images: int = 200
    prior_generation_precision: Optional[str] = None
    human_prompts_path: Optional[str] = "data/human-written-prompts.jsonl"
    # -- output ----------------------------------------------------------
    output_dir: str = "dreambooth-model"
    logging_dir: str = "logs"
    report_to: str = "tensorboard"
    # -- core training ---------------------------------------------------
    seed: int = 42
    resolution: int = 512
    center_crop: bool = False
    train_batch_size: int = 1
    sample_batch_size: int = 4
    max_train_steps: int = 500
    checkpointing_steps: int = 100
    checkpoints_total_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = False
    learning_rate: float = 5e-5
    emb_learning_rate: float = 1e-3
    scale_lr: bool = False
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    dataloader_num_workers: int = 2
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    mixed_precision: Optional[str] = None  # no | fp16 | bf16 (fp16 runs as bf16)
    allow_tf32: bool = False
    # -- validation ------------------------------------------------------
    validation_prompts: Optional[List[str]] = None
    num_validation_images: int = 4
    validation_steps: int = 100
    validation_scheduler: str = "DPMSolverMultistepScheduler"
    # -- tokens / LoRA ---------------------------------------------------
    placeholder_token: str = "<dog>"
    initializer_token: str = "dog"
    lora_rank: int = 4
    unet_params_to_train: str = "none"
    mixing: bool = False
    # -- augmentation ----------------------------------------------------
    augment: str = "none"  # none | pda/paug
    augment_ops: str = "object"
    augment_p: float = 0.8
    augment_prompt: int = 1
    augment_inversion: bool = False
    # Execute augmentations ON the accelerator (data/device_augment.py):
    # the instance images upload once, each step ships only token ids +
    # ~60 bytes/sample of augmentation parameters instead of the full
    # pixel batch (6.3 MB at bs8/512px), and the host stops burning its
    # core on PIL resampling.  The host PIL path (default) remains the
    # bit-exact reference-semantics path; the device path is
    # equivalence-tested per op (tests/test_device_augment.py).
    # Single-process, no --with_image_prior.
    augment_device: bool = False
    # -- sampling / misc -------------------------------------------------
    disable_weighted_sample: bool = True
    null_prob: float = 0.1
    template: str = "textboost"
    text_encoder_use_attention_mask: bool = False
    skip_save_text_encoder: bool = False
    no_safe_serialization: bool = False
    class_labels_conditioning: Optional[str] = None
    hub_token: Optional[str] = None
    # -- extras of the JAX package ---------------------------------------
    model_preset: Optional[str] = None  # sd14|sd15|sd21base|sd21|tiny
    # Reference casts the VAE to fp32 (train_textboost.py:936-939); the
    # default keeps it in the compute dtype.  --vae_fp32 restores fp32.
    vae_fp32: bool = False
    mesh_dp: Optional[int] = None
    mesh_tp: int = 1
    attention_impl: str = "auto"  # auto | xla (the port's "math") | flash
    # Depth of the JAX package's device-resident batch ring.  The port has
    # no ring: each host batch is pinned and copied with non_blocking one
    # step ahead, whatever the depth.
    device_prefetch_batches: int = 32
    profile_dir: Optional[str] = None
    null_embedding_path: Optional[str] = None  # reference .pt asset format

    def validate(self):
        if self.with_image_prior:
            if self.class_data_dir is None:
                raise ValueError("You must specify a data directory for class images.")
            if self.class_token is None:
                raise ValueError("You must specify prompt for class images.")
        else:
            if self.class_data_dir is not None:
                warnings.warn("You need not use --class_data_dir without --with_image_prior.")
            if self.class_token is not None:
                warnings.warn("You need not use --class_token without --with_image_prior.")
        if self.augment_inversion and not bool(self.augment_prompt):
            raise ValueError("You need to use --augment_prompt=1 with --augment_inversion.")
        if self.augment_device and self.with_image_prior:
            raise ValueError(
                "--augment_device does not support --with_image_prior "
                "(class prior images stay on the host pixel path)."
            )
        return self

    def resolve_concepts(self) -> List[dict]:
        """CLI args or JSON file -> concepts list
        (train_textboost.py:602-615)."""
        if self.concepts_list is None:
            return [
                {
                    "instance_token": self.instance_token or self.placeholder_token,
                    "class_token": self.class_token,
                    "instance_data_dir": self.instance_data_dir,
                    "class_data_dir": self.class_data_dir,
                    "placeholder_token": self.placeholder_token,
                    "initializer_token": self.initializer_token,
                }
            ]
        with open(self.concepts_list) as f:
            concepts = json.load(f)
        for concept in concepts:
            concept.setdefault("class_token", self.class_token)
            concept.setdefault("class_data_dir", self.class_data_dir)
            concept.setdefault("placeholder_token", self.placeholder_token)
            concept.setdefault("initializer_token", self.initializer_token)
        return concepts


def _add_bool_flag(parser, name, default):
    # BooleanOptionalAction gives every bool a working --no-X form.  The
    # reference's store_true flags make default-True bools unfalsifiable
    # from the CLI (train_textboost.py:406-411, --disable_weighted_sample)
    # — the bug we deliberately do not replicate.
    parser.add_argument(
        f"--{name}",
        action=argparse.BooleanOptionalAction,
        default=default,
        dest=name,
    )


def parse_args(argv: Optional[List[str]] = None) -> TrainConfig:
    cfg = TrainConfig()
    parser = argparse.ArgumentParser(description="TextBoost training")
    for field in dataclasses.fields(TrainConfig):
        name = field.name
        default = getattr(cfg, name)
        if field.type == "bool" or isinstance(default, bool):
            _add_bool_flag(parser, name, default)
        elif name == "validation_prompts":
            parser.add_argument("--validation_prompts", nargs="+", default=None)
        else:
            # Infer the scalar type from the annotation.
            tp = str
            if "int" in str(field.type):
                tp = int
            elif "float" in str(field.type):
                tp = float
            parser.add_argument(f"--{name}", type=tp, default=default)
    ns = parser.parse_args(argv)
    return TrainConfig(**vars(ns)).validate()


def unsupported_flags(cfg: TrainConfig) -> List[str]:
    """Messages for the flags of `cfg` that the port does not serve yet,
    each naming the ROADMAP.md item that brings it (empty when all is
    served)."""
    out = []
    if cfg.augment_device:
        out.append("--augment_device: device-side augmentation (ROADMAP.md queue A9: "
                   "data/device_augment.py)")
    if cfg.unet_params_to_train not in ("none", "crossattn_kv"):
        out.append(f"--unet_params_to_train {cfg.unet_params_to_train}: the port trains "
                   "none or crossattn_kv, as the JAX package does")
    if cfg.validation_prompts and cfg.validation_scheduler not in (
            "dpm++2m", "DPMSolverMultistepScheduler"):
        out.append(f"--validation_scheduler {cfg.validation_scheduler}: the port samples with "
                   "DPM-Solver++ only (ROADMAP.md queue A6: DDIM, DDPM and PNDM samplers)")
    if cfg.mesh_tp > 1 or (cfg.mesh_dp or 1) > 1:
        out.append("--mesh_tp/--mesh_dp > 1: multi-card training (ROADMAP.md queue A8: "
                   "Data parallel and multi-host)")
    return out
