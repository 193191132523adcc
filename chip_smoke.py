#!/usr/bin/env python3
"""Smoke test of the textboost_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from textboost_torch/csrc/ (four: flash-attention
forward and backward, GroupNorm forward and input-gradient backward) and
holds each against its plain PyTorch version at the shapes sd15 gives it,
and the two flash kernels also at shapes that cross their tiles' edges.
Then it drives the port's main paths through their entry points, each
with the launch counts set to 0 just before and read just after:

  * sampling: `textboost_torch.inference.generate` on a model dir written
    by the port's exporters (sd15 at full width with seeded random weights,
    512 px, bf16, DPM-Solver++ 25 steps, CFG 7.5, seeds 0-3);
  * training: `textboost_torch.train.main` for 10 steps (sd15, 512 px,
    batch 8, bf16, LoRA r=4, KPL 0.1, --augment none) on a synthetic
    instance image; its exported model dir then samples through
    `textboost_torch.inference.generate`;
  * the paper's run: `textboost_torch.train.main` with the flags of
    `run_textboost_db.py::build_cmd` at sd21base (512 px, batch 8, bf16,
    LoRA r=4, --augment pda --augment_p 0.5 --augment_inversion,
    imagenet_small, null_prob 0.1, KPL 0.1, the runner's four validation
    prompts, 4 images each), 10 steps with a checkpoint and a validation
    grid every 5; then a second run resumes from a copy of its
    checkpoint-5 to step 10 and must land on the same trajectory.  The
    run records the shape of every kernel call; after it, each kernel is
    held against its plain version at every shape the run gave it (the
    validation rounds' UNet batch 32 and decoder batch 16 among them; the
    GroupNorm calls must also be those derived from the config), and its
    artifacts, the augmentation tokens in its captions, and the native
    image ops against this machine's PIL are checked.  Then the same flags
    at --gradient_accumulation_steps 3 (`accumulation_pair`, through the
    preset memo): 5 steps, the first 3 eager and the rest replays of one
    graph per micro-step position (first, middle, last), the launches
    derived per micro-step, and its resume from checkpoint-3, whose eager
    micro-steps must equal the replays bit for bit;
  * `--attention_impl flash` at sd15 (`flash_impl_phase`): the flash
    launches a train step (31 K1, 29 K2) and a validation round (751 K1)
    derived on the meta device (also with --gradient_checkpointing and at a
    tp rank's local heads); K2 at every form it serves since that flag came
    (the 77 text keys at sd15's three levels and sd21base's level 0, sd15's
    160-wide heads, D = 100, the VAE's 512-wide head, bf16 (wgmma, or mma
    outside its form) and fp32 (register tiles on the CUDA cores), a kv_len
    inside the last tile, packed fp32 and bf16 views) against its plain
    version on the same inputs (fp32 limits against fp64 for fp32 inputs),
    with the variant that served it, a dropped-tile control, bit-identical
    repeats and an untouched canary past N and M, timed beside its bound,
    its plain version and SDPA; K1 likewise at every shape of the fp32 run
    (`FLASH_FWD_FORMS`: the UNet's three levels, self and cross, and the VAE
    encoder's 512-wide head), a head dim of 33, a 16-bit one of 100 and
    packed views, timed beside its bound, plain version and SDPA's forward;
    one sd15 step (batch 2) under flash against
    the same step under auto at bf16 and fp32, with a control; then
    `textboost_torch.train.main --attention_impl flash` at sd15, 512 px,
    batch 8: 4 steps at bf16 with a validation round of one image, and 2
    steps at the CLI's default fp32, whose launches must be those derived;
    every kernel is held at every shape the runs gave it (K3/K4 in fp32 at
    the fp32 run's GroupNorm keys);
  * the snapshot run: a full-width sd21base diffusers snapshot written from
    seeded weights (fp32 text encoder and VAE, fp16 UNet, a 49408-entry BPE
    tokenizer with sd2's pad token) is loaded back by `load_models` (family
    inferred, every tensor its file's value cast as loaded), then
    `textboost_torch.train.main` trains from it with the paper run's flags
    plus the DB runner's remaining ones (the UNet's cross-attention LoRA,
    the image prior with 8 class images generated into an empty dir,
    gradient checkpointing, the padded CLIP mask) for 6 steps, a checkpoint
    at 3 and a validation round at 6, its step a CUDA graph from step 4;
    its launches must be those derived from the config on the meta device,
    the recompute of the checkpointed blocks included (per replay, and in
    the step graph's kernel nodes), and a resume from checkpoint-3, eager
    at steps 4-6, must equal the replays bit for bit (losses, both
    adapters, the added rows); each kernel is held at every shape the run
    gave it (the UNet at batch 16), and `load_textboost_pipeline` serves
    the output over the snapshot (4 seeds; its UNet LoRA the trainer's
    export, bit for bit).  Last, one eager train step at these flags with and without
    checkpointing: step time, peak memory and the launches counted in each
    (those derived, with and without the recompute), and one forward and
    backward in each mode, whose loss and trainable gradients must be
    bit-identical;
  * the DreamBooth benchmark (`benchmark_phase`): `run_textboost_db -m
    sd21base --sequential` trains two instances (dog, clock) for 4 steps in
    this process, the second taking the first's bundle and step graph from
    the cross-instance memos (one step capture in the sweep, no warm-up
    steps for the second; its time to first step beside the same instance
    trained alone with the memos cleared, whose exports must be the
    sweep's to the bit); a scorer-weights dir is written from seeded weights in the
    published torch layouts (CLIP ViT-L/14-336 as a transformers CLIPModel,
    DINOv2 ViT-L/14 in the hub layout, clip-flant5's vision tower, projector
    and a flan-t5-xxl-wide T5 cut to 2 + 2 layers, with a Unigram
    tokenizer.json); `textboost_torch.eval` generates both instances' 25
    prompts for seeds 0 and 1 (25 steps, CFG 7.5, batch 16: chunks of 16 and
    9, the pipeline reused across instances; the eval's capture rule, its
    threshold lowered to the 4 calls it plans for each chunk signature,
    names both, whose graphs the first instance captures and the second
    replays)
    and scores them with CLIP-T,
    CLIP-I, DINO and VQAScore into metric_last.csv.  Every kernel is held at
    every shape the training and the generation called it at (the tail
    chunk's UNet batch 18 and decoder batch 9 among them), the launches and
    GroupNorm calls must be those derived from the config, the images carry
    the reference's names, the CSV its header; the second instance sampled
    again from a fresh load with the memos cleared, eagerly (2 calls a
    signature, below the lowered threshold), must give the same bits; the
    scorers on the card
    must match the port's CPU fp32 math on the same weights; and
    clip-flant5-xxl at full depth, seeded on the card, scores the 100 pairs;
  * sd21 at 768 px (`sd21_phase`): `textboost_torch.train.main` with
    `run_textboost_db.py::build_cmd`'s flags for `-m sd21` (v-prediction,
    768 px, batch 8) plus --augment_device and --validation_scheduler
    PNDMScheduler, on a square and a 1024x768 instance image, 6 steps with a
    checkpoint and a PNDM validation round (UNet batch 32 at 96x96 latents)
    every 3; its launches must be those derived from the config (a PNDM
    round makes 26 UNet calls) and step 2's pixels the dataset's plans
    executed on the card, bit for bit; then its output samples 4 prompts at
    768 px with each of DPM-Solver++, DDIM, DDPM and PNDM, twice each
    (bit-identical, launches as derived); every kernel is held at every shape
    of the run and the sampling (K1 at 9216 tokens with D = 64 and D = 512,
    the VAE decoder's norms over 768x768 spans); and the device augmentation
    is held against the same function on the CPU and against the host PIL
    path, with its launches at batch 8 and 16, its device time and host time
    per batch, and the bytes each path sends to the card per step;
  * data parallel (`dp_phase`): the paper run's flags at sd21base, global
    batch 8, 5 steps with a checkpoint at 3 and a validation round (one
    image a prompt) at step 5, each run launched as a user would: in one process; under `python -m
    torch.distributed.run --nproc_per_node 1` (NCCL at world 1, its step a
    CUDA graph with the all-reduce inside, which counts a call a
    micro-step), which must leave the same bits; with two ranks
    sharing the card over gloo (batch 4 each), whose losses must be equal
    on both ranks and within a stated bf16 bound of the one-process run's,
    rank 0 alone writing; and two ranks resumed from its checkpoint-3.  Each
    rank's launches must be those derived from the config at batch 4, and
    every kernel is held at the ranks' shapes.  The ranks' program is this
    script (`--dp-rank DIR -- FLAGS`: the trainer's `main` under the
    launch counts, its numbers into DIR);
  * tensor parallel (`tp_phase`): the report of the tp rules at sd15 and
    sd21base (parallel/validate.py, on the meta device); then the paper
    run's flags plus the UNet's kv-LoRA at sd21base, global batch 8, 4 steps
    with a checkpoint every 2 and a validation round at step 4: in one
    process (its step captured), with
    `--mesh_tp 2` as two ranks sharing the card over gloo (the frozen UNet
    and text encoder split by heads and FFN columns, both ranks on the same
    batch 8 and in every validation round), and those two ranks resumed
    from checkpoint-2.  The ranks' losses and trainable weights (a digest
    after every step) must be equal, their losses and exports within a
    stated bf16 bound of the one process's, rank 1 must write nothing, each
    rank's launches must be the one process's, its kernel calls those
    derived on the meta device at the ranks' local heads, and its
    collectives a step those counted there; K1/K2 are held at the new
    (8, 1024, 5, 64).  The ranks' program is `--tp-rank DIR -- FLAGS`
    (`--dp-rank` with a digest of the trainable weights after each step);
  * the native formats and data-parallel generation (`native_dp_phase`):
    the snapshot phase's seeded sd21base weights saved by `save_snapshot`
    as the JAX package's native snapshot (spec.json and fp32 flax trees,
    through the port's msgpack codec) and read back bit for bit; 2 train
    steps with the paper's flags from it and from the diffusers snapshot
    (the same losses and exports, bit for bit) and 4 seeds sampled from
    each (the same images); then, as two ranks sharing the card over gloo
    under `python -m torch.distributed.run`, `textboost_torch.inference`
    (seeds 0-3, two a rank) and `textboost_torch.eval` (one instance, one
    seed, --batch-size 16 in sub-chunks of 8, CLIP-T, CLIP-I and DINO read
    from flax trees the port's codec wrote from seeded published
    checkpoints), each rank's images held bit for bit, and the CSV, to one
    process over the same sub-batch (that process's runs are the same rank
    program alone, `--gen-rank DIR -- JOBS`), rank 1 writing nothing;
    against all four seeds in one batch the gap is reported.  Each run's
    launches and GroupNorm calls must be those derived from the config,
    and every kernel is held at every shape the phase gave it.

Before them: one sd15 UNet forward and one sd15 train step (batch 2) with
the kernels and with plain math.  The GroupNorm kernels are held against
their plain versions at every GroupNorm shape of the sd15 paths (derived
from the config by running the models on the meta device, and checked
against the calls the run makes), two calls must be bit-identical, and a
plain version that drops one cluster rank's partial sums must fail the
limits; a table gives each shape's plan, L2-warm and L2-cold times, bytes
moved, bound and `F.group_norm` time, with launch-weighted sums per
generate call and per train step.  It checks the outputs, that each path
launched each kernel exactly as often as the model spec says and that every
flash forward launch went through a wgmma variant, then prints
the card (name and power limit from nvidia-smi), one JSON line of
per-kernel numbers, and as its last line {"ok": true, "device": {...}}.
Any failed phase raises and the script exits non-zero with no result line.
Without CUDA, or without the repo beside it, it fails the same way.

The train step runs as CUDA graphs (textboost_torch/train/graph.py,
textboost_torch/graphs.py) wherever the JAX trainer jits it and one card
can hold and check it, and the sampling trajectory where its caller knows
the signature repeats: the sd15 pipeline here is given graphs and called
three times on the same latents (eager, captured, replayed: the same bits,
each call the derived launches, a traced replay showing each kernel the
derived number of times); the sd15 run, the paper's run and its
accumulation pair, the flash bf16 run, the snapshot run, the benchmark's
trainers, sd21, the dp phase's one process and NCCL world-1 run and the
tp phase's one process capture their step after 3 eager steps (the sd15
run beside 5 eager steps at its flags: the same losses, the peaks side by
side); the paper run's, the accumulation run's and the snapshot run's
resumes, eager where the straight runs replayed, must land on them with
every gap exactly 0.  The paper run's two validation rounds are too few to
pay a sampler capture back, so the script lowers the trainer's threshold
for the straight run: its second round replays the graph, and its grid
must equal the resumed run's (whose one round is eager) bit for bit.  The
dp ranks (two processes over gloo) and the tp ranks (--mesh_tp 2) run
eagerly, their validation rounds too.  A replay makes no Python call: the
launch counts and the recorded kernel shapes add, at each replay, what the
capture recorded.  Each run's peak is given as allocated and as reserved
(the graphs' pools are reserved).  Each phase starts with the memos
released (`release_memos`), so that no earlier phase's bundle or graph
stays resident.

fp32 matmuls and convolutions are held to full fp32 (TF32 off) so that the
plain references are what they say.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Tolerances, bf16 inputs on the card.  Flash o is held to the plain version
# computed in fp32 (not cast), as a relative L2 error over the whole output
# and over the worst (b, n, h) row of D values.  Rounding o to bf16 and P to
# bf16 before P.V (as the tensor-core kernel does) costs ~2.4e-3 overall; a
# wrong kernel that drops one 64-key tile costs > 0.1, scaling o by 5% costs
# 0.05.  Both controls are computed and printed with each case, and the
# dropped-tile control must fail both limits.
FLASH_REL_L2 = 5e-3
FLASH_ROW_REL_L2 = 2e-2
FLASH_LSE_ATOL = 1e-3  # lse: fp32 on both sides
GN_RTOL, GN_ATOL = 2.0**-7, 1e-3  # y: one bf16 ulp where the two fp32 results round apart
GN_STAT_RTOL = 1e-4  # mean/rstd: fp32 sums in another order
UNET_REL_L2 = 5e-2  # sd15 UNet output, kernels vs math, bf16 through ~100 layers
# Flash backward: dq, dk and dv (bf16) against fp32 autograd of plain
# attention, relative L2 overall and over the worst (b, n, h) row.  P and dS
# rounded to bf16 as tensor-core operands cost ~2.4e-3 overall and ~5e-3 in
# the worst row (measured at sd15's shapes on an H100); a wrong kernel that
# skips the first 64-key tile costs 0.13-0.32 overall and ~1 in the worst
# row, and must fail both limits.
FLASH_BWD_REL_L2 = 5e-3
FLASH_BWD_ROW_REL_L2 = 2e-2
# fp32 inputs (K1's and K2's CUDA-core forms under --attention_impl flash):
# against the plain version on the same inputs computed in fp64, relative L2
# overall and over the worst row; lse absolute.  fp32 sums over up to 4096
# keys in another order cost ~1e-6 (sqrt(4096) x 2^-24 x the terms'
# spread); a kernel that drops one 32-key tile costs > 0.05.
FLASH_FP32_REL_L2 = 1e-5
FLASH_FP32_ROW_REL_L2 = 1e-4
FLASH_FP32_LSE_ATOL = 1e-4
# GroupNorm backward: dx in bf16 against the plain version from the same
# inputs: one bf16 ulp where two fp32 results round apart.
GN_BWD_RTOL, GN_BWD_ATOL = 2.0**-7, 1e-3
# One sd15 train step (batch 2), kernels vs math: relative difference of
# the loss and relative L2 of the LoRA and added-embedding gradients, bf16
# through the UNet's forward and backward.  The control, a GroupNorm
# backward that drops the SiLU's derivative, must exceed the bound.
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_STEPS = 10
# The paper's run at sd21base: steps, and the cadence of checkpoints and
# validation rounds (cut from the sweep runner's 250 and 50).
PAPER_STEPS = 10
PAPER_CADENCE = 5
PAPER_PROMPTS = ("photo of a <0>", "a <0> in the jungle", "a <0> in the bucket",
                 "painting of a <0> in the Monet style")  # run_textboost_db.py::build_cmd
PAPER_VALIDATION_IMAGES = 4  # --num_validation_images, the runner leaves the default
# A run resumed from checkpoint-5 against the straight run, at step 10: the
# loss within 1e-2 relative, the exported LoRA and added rows within 1e-2
# relative L2.  cuDNN and cuBLAS may pick other algorithms in a new process,
# so bit-identity is reported, not required (the CPU tests require it).
RESUME_LOSS_REL = 1e-2
# The accumulation pair (in `paper_run_phase`): the paper flags at
# --gradient_accumulation_steps 3 (first, middle and last micro-steps each a
# graph), ACCUM_STEPS steps with a checkpoint every ACCUM_CHECKPOINT and no
# validation; the resume from that checkpoint runs its warm-up eagerly
# where the straight run replays.
ACCUM = 3
ACCUM_STEPS = 5
ACCUM_CHECKPOINT = 3
RESUME_REL_L2 = 1e-2

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (H100 SXM)
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
EX2_PER_SM_CLOCK = 16  # base-2 exponentials an SM retires per clock (NVIDIA's throughput table, cc 9.0)

# The variants of the flash forward that count as the Hopper design.
WGMMA_VARIANTS = {"wgmma", "wgmma_wide"}


def flash_floors_ms(b: int, n: int, m: int, h: int, d: int, *, backward: bool,
                    sm_count: int, sm_clock_hz: float, fp32: bool = False) -> dict:
    """The least times (ms) the card could take for attention over q
    [b, n, h, d], k/v [b, m, h, d] in a 16-bit type (or fp32), one per
    resource: "bytes" (every input read once, every output written once,
    lse fp32), "tensor_cores" (two products forward, five backward, 2
    operations per multiply-add, at the card's dense 16-bit rate; in fp32
    "cuda_cores", at the CUDA cores' fp32 rate) and "exponentials" (one ex2
    per score at 16 per SM and clock)."""
    q_el, kv_el = b * n * h * d, b * m * h * d
    size = 4 if fp32 else 2
    if backward:  # q, o, dO in, dq out; k, v in, dk, dv out; lse
        nbytes = size * (4 * q_el + 4 * kv_el) + 4 * b * h * n
        products = 5
    else:  # q in, o out; k, v in; lse
        nbytes = size * (2 * q_el + 2 * kv_el) + 4 * b * h * n
        products = 2
    ops = products * 2 * b * h * n * m * d
    return {
        "bytes": nbytes / H100_BYTES_PER_S * 1e3,
        ("cuda_cores" if fp32 else "tensor_cores"):
            ops / (H100_FP32_FLOPS if fp32 else H100_BF16_FLOPS) * 1e3,
        "exponentials": b * h * n * m / (EX2_PER_SM_CLOCK * sm_count * sm_clock_hz) * 1e3,
    }


def bound_of(floors: dict) -> dict:
    """bound_ms (the largest floor), bound_by ("bytes" or "operations": the
    tensor cores' and the exponentials' floors are both operations),
    bound_floor (which of the three) and the floors themselves."""
    name = max(floors, key=floors.get)
    return {"bound_ms": floors[name], "bound_by": "bytes" if name == "bytes" else "operations",
            "bound_floor": name, "floors_ms": dict(floors)}


def card_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


SPIN_CYCLES = 400_000_000  # ~0.2 s of GPU clock: longer than the host takes to enqueue a timed loop
# The flash forms' timed loops (a few calls of one kernel, or of the plain
# version's ~100 launches) enqueue in a few ms: ~20 ms of spin covers them
# ten times over, and saves the phase ~0.7 s a form.
FORM_SPIN_CYCLES = 40_000_000


def cuda_ms(fn, iters: int, warmup: int = 2, spin_cycles: int = SPIN_CYCLES) -> float:
    """Device time of one call of `fn`.  The stream is first held by a spin
    kernel while the host enqueues the whole timed loop, so the host's launch
    cost (ctypes, allocation) is not counted as the kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_fp32(q, k, v, scale: float, p_dtype=None, drop_keys: int = 0):
    """fp32 softmax(q k^T * scale) v as [B, N, H, D], one sample at a time,
    with P rounded to `p_dtype` before P.V and the first `drop_keys` keys
    left out: the controls of the flash check."""
    import torch

    out = []
    for i in range(q.shape[0]):
        s = torch.einsum("nhd,mhd->hnm", q[i].float(), k[i, drop_keys:].float()) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        pv = p if p_dtype is None else p.to(p_dtype).float()
        o = torch.einsum("hnm,mhd->nhd", pv, v[i, drop_keys:].float()) / p.sum(-1).T[..., None]
        out.append(o)
        del s, p, pv
    return torch.stack(out)


PLAIN_SCORE_BYTES = 4 * 2**30  # the plain attention's fp32 [c, H, N, M] scores per call


def plain_chunk(b: int, n: int, m: int, h: int, itemsize: int = 4) -> int:
    """Samples per call of the plain attention (forward or backward) whose
    fp32 (or, as a reference, fp64) scores fit in PLAIN_SCORE_BYTES: sd21's
    9216-token attention at batch 32 would need 54 GB of scores in one
    call."""
    return max(1, min(b, PLAIN_SCORE_BYTES // (itemsize * h * n * m)))


def plain_attention(q, k, v, scale: float, backward_of=None):
    """fa.flash_attention_reference (or, given `backward_of` = (o, lse, dO),
    its backward) over the batch in chunks of `plain_chunk` samples."""
    import torch

    from textboost_torch.ops import flash_attention as fa

    b, n, h, _ = q.shape
    c = plain_chunk(b, n, k.shape[1], h, 8 if q.dtype == torch.float64 else 4)
    parts = []
    for i in range(0, b, c):
        sl = slice(i, i + c)
        if backward_of is None:
            parts.append(fa.flash_attention_reference(q[sl], k[sl], v[sl], scale))
        else:
            o, lse, do = backward_of
            parts.append(fa.flash_attention_backward_reference(q[sl], k[sl], v[sl], o[sl],
                                                               lse[sl], do[sl], scale))
    return tuple(torch.cat(t) for t in zip(*parts))


def flash_errors(o, ref):
    """(relative L2 error of o against the fp32 `ref`, worst over rows)."""
    diff = o.float() - ref
    return ((diff.norm() / ref.norm()).item(),
            (diff.norm(dim=-1) / ref.norm(dim=-1)).max().item())


def expected_launches(spec, steps: int):
    """(flash, group norm) launches of one guided sampling call with the
    'auto' rule: per UNet call times steps, plus one VAE decode."""
    import torch

    from textboost_torch.ops.attention import use_flash

    u, v = spec.unet, spec.vae
    levels = len(u.block_out_channels)
    flash = gn_resnets = attns = 0
    for level, ch in enumerate(u.block_out_channels):
        n = (u.sample_size // 2**level) ** 2
        blocks = 2 * u.layers_per_block + 1  # down + up resnets at this level
        gn_resnets += blocks
        if u.cross_attention_levels[level]:
            attns += blocks  # one Transformer2D beside each resnet
            d = ch // u.num_attention_heads[level]
            if use_flash("cuda", n, n, d, torch.bfloat16, False, False):
                flash += blocks * u.transformer_layers_per_block
    gn_unet = 2 * (gn_resnets + 2) + attns + 1 + 1  # resnets (+2 mid), attns (+mid), out
    n_mid = (spec.resolution // 8) ** 2  # the VAE mid block runs at latent resolution
    vae_flash = int(use_flash("cuda", n_mid, n_mid, v.block_out_channels[-1],
                              torch.bfloat16, False, False))
    gn_vae = 2 * (2 + levels * (v.layers_per_block + 1)) + 1 + 1
    return flash * steps + vae_flash, gn_unet * steps + gn_vae


def expected_train_launches(spec):
    """(flash fwd, flash bwd, group norm fwd, group norm bwd) launches of one
    sd15-family train step with the 'auto' rule.  Forward: every UNet GN and
    self-attention the rule sends to flash, and the VAE encoder's (no_grad).
    Backward: all of those downstream of the first cross-attention, i.e. all
    but down-block 0's first resnet (2 GNs) and its first Transformer2D (the
    GN before proj_in and the self-attention before attn2), which do not
    depend on the text."""
    import torch

    from textboost_torch.ops.attention import use_flash

    u, v = spec.unet, spec.vae
    levels = len(u.block_out_channels)
    flash = gn_resnets = attns = 0
    for level, ch in enumerate(u.block_out_channels):
        n = (u.sample_size // 2**level) ** 2
        blocks = 2 * u.layers_per_block + 1  # down + up resnets at this level
        gn_resnets += blocks
        if u.cross_attention_levels[level]:
            attns += blocks
            d = ch // u.num_attention_heads[level]
            if use_flash("cuda", n, n, d, torch.bfloat16, False, False):
                flash += blocks * u.transformer_layers_per_block
    gn_unet = 2 * (gn_resnets + 2) + attns + 1 + 1  # resnets (+2 mid), attns (+mid), out
    n_mid = (spec.resolution // 8) ** 2  # the VAE mid block runs at latent resolution
    vae_flash = int(use_flash("cuda", n_mid, n_mid, v.block_out_channels[-1],
                              torch.bfloat16, False, False))
    gn_encoder = 2 * levels * v.layers_per_block + 2 * 2 + 1 + 1  # resnets, mid, attn, out
    text_free_flash = int(flash > 0 and u.cross_attention_levels[0]
                          and use_flash("cuda", u.sample_size**2, u.sample_size**2,
                                        u.block_out_channels[0] // u.num_attention_heads[0],
                                        torch.bfloat16, False, False))
    text_free_gn = 2 + int(bool(u.cross_attention_levels[0]))
    return (flash + vae_flash, flash - text_free_flash, gn_unet + gn_encoder,
            gn_unet - text_free_gn)


def attention_grads_fp32(q, k, v, do, scale: float, kv_len: int, skip_keys: int = 0):
    """(dq, dk, dv) fp32 of plain softmax attention by autograd, one sample
    at a time, over keys [skip_keys, kv_len) (the others get zero
    gradients): the reference of the flash backward check, and with
    skip_keys=64 its wrong-kernel control."""
    import torch

    dq = torch.zeros(q.shape, device=q.device)
    dk, dv = torch.zeros(k.shape, device=q.device), torch.zeros(v.shape, device=q.device)
    for i in range(q.shape[0]):
        qi = q[i].float().requires_grad_()
        ki = k[i, skip_keys:kv_len].float().requires_grad_()
        vi = v[i, skip_keys:kv_len].float().requires_grad_()
        s = torch.einsum("nhd,mhd->hnm", qi, ki) * scale
        o = torch.einsum("hnm,mhd->nhd", torch.softmax(s, dim=-1), vi)
        o.backward(do[i].float())
        dq[i], dk[i, skip_keys:kv_len], dv[i, skip_keys:kv_len] = qi.grad, ki.grad, vi.grad
        del s, o, qi, ki, vi
    return dq, dk, dv


def grad_errors(g, ref):
    """(relative L2 of g against ref, worst over the rows whose reference is
    not zero)."""
    diff = g.float() - ref
    rn, dn = ref.norm(dim=-1), diff.norm(dim=-1)
    live = rn > 0
    return (diff.norm() / ref.norm()).item(), (dn[live] / rn[live]).max().item()


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def write_instance_image(path: str, seed: int, width: int = 512, height: int = 512) -> None:
    """A width x height RGB PNG: smooth colour ramps plus noise, from a seed."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width] / np.array([[[height - 1]], [[width - 1]]])
    img = np.stack([xx, yy, 1.0 - xx * yy], axis=-1) * 200 + rng.normal(0, 20, (height, width, 3))
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)

CLIP_VOCAB = 49408  # a dense vocab: 512 byte symbols, merges, filler, the two specials
CLIP_MERGES = 3000


def learn_merges(texts, n_merges: int):
    """Byte-level BPE merges learned from `texts` (the port's pre-tokenizer,
    word counts, the most frequent pair first, ties by the pair's text),
    counted incrementally: each merge revisits only the words that hold
    its pair."""
    from textboost_torch.data.tokenizer import bytes_to_unicode, clean_text, pre_tokenize

    byte_map = bytes_to_unicode()
    words = collections.Counter(
        "".join(byte_map[b] for b in word.encode("utf-8"))
        for text in texts for word in pre_tokenize(clean_text(text)))
    seqs = [list(w[:-1]) + [w[-1] + "</w>"] for w in words]
    weight = list(words.values())
    counts, where = collections.Counter(), collections.defaultdict(set)
    for i, s in enumerate(seqs):
        for pair in zip(s, s[1:]):
            counts[pair] += weight[i]
            where[pair].add(i)
    merges = []
    while counts and len(merges) < n_merges:
        best = max(counts.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(best)
        for i in where.pop(best):
            s = seqs[i]
            for pair in zip(s, s[1:]):
                counts[pair] -= weight[i]
                if counts[pair] <= 0:
                    del counts[pair]
                if pair != best:
                    where[pair].discard(i)
            new, j = [], 0
            while j < len(s):
                if j + 1 < len(s) and (s[j], s[j + 1]) == best:
                    new.append(s[j] + s[j + 1])
                    j += 2
                else:
                    new.append(s[j])
                    j += 1
            seqs[i] = new
            for pair in zip(new, new[1:]):
                counts[pair] += weight[i]
                where[pair].add(i)
    return merges


def write_clip_tokenizer(path: str, pad_token: str = "!") -> None:
    """A CLIP tokenizer dir (`vocab.json`, `merges.txt`,
    `special_tokens_map.json`, `tokenizer_config.json`) with a dense
    49408-entry byte-level vocab: the 512 byte symbols in CLIP's order,
    CLIP_MERGES merges learned from the port's caption templates and human
    prompts, filler entries no merge reaches, and <|startoftext|> /
    <|endoftext|> at 49406 / 49407.  `pad_token` "!" (id 0) is sd2's
    special_tokens_map, "<|endoftext|>" sd1's."""
    from textboost_torch.data.human_prompts import EXTENDED_HUMAN_PROMPTS
    from textboost_torch.data.templates import TEMPLATE_BANKS
    from textboost_torch.data.tokenizer import bytes_to_unicode

    texts = list(EXTENDED_HUMAN_PROMPTS) + [
        t.format(word) for bank in TEMPLATE_BANKS.values() for t in bank
        for word in ("dog", "teapot", "cat", "backpack", "sks")]
    merges = learn_merges(texts, CLIP_MERGES)
    symbols = list(bytes_to_unicode().values())
    entries = symbols + [s + "</w>" for s in symbols]
    seen = set(entries)
    for a, b in merges:
        if a + b not in seen:
            seen.add(a + b)
            entries.append(a + b)
    specials = ["<|startoftext|>", "<|endoftext|>"]
    entries += [f"<|filler-{i}|>" for i in range(CLIP_VOCAB - len(specials) - len(entries))]
    vocab = {tok: i for i, tok in enumerate(entries + specials)}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    special = {name: {"content": tok, "lstrip": False, "normalized": True, "rstrip": False,
                      "single_word": False}
               for name, tok in (("bos_token", specials[0]), ("eos_token", specials[1]),
                                 ("unk_token", specials[1]))}
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump({**special, "pad_token": pad_token}, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({**special, "pad_token": "<|endoftext|>", "model_max_length": 77,
                   "do_lower_case": True, "errors": "replace", "add_prefix_space": False,
                   "tokenizer_class": "CLIPTokenizer"}, f)


SNAPSHOT_FILES = {"text_encoder": "model.safetensors", "unet": "diffusion_pytorch_model.safetensors",
                  "vae": "diffusion_pytorch_model.safetensors"}


def write_snapshot(path: str, parts: dict, pad_token: str = "!") -> None:
    """A diffusers snapshot dir (`model_index.json`, `text_encoder/`,
    `unet/`, `vae/` safetensors written by the port's `save_safetensors`,
    `tokenizer/` from `write_clip_tokenizer`) from `parts`: {part: {key:
    numpy array}}, under diffusers' and transformers' keys."""
    from textboost_torch.lora.peft_io import save_safetensors

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model_index.json"), "w") as f:
        json.dump({"_class_name": "StableDiffusionPipeline", "_diffusers_version": "0.21.0",
                   "text_encoder": ["transformers", "CLIPTextModel"],
                   "tokenizer": ["transformers", "CLIPTokenizer"],
                   "unet": ["diffusers", "UNet2DConditionModel"],
                   "vae": ["diffusers", "AutoencoderKL"]}, f)
    for part, name in SNAPSHOT_FILES.items():
        os.makedirs(os.path.join(path, part), exist_ok=True)
        save_safetensors(parts[part], os.path.join(path, part, name))
    write_clip_tokenizer(os.path.join(path, "tokenizer"), pad_token=pad_token)


def train_flags(instance_dir: str, output_dir: str, batch: int, steps: int):
    """CLI flags of the training main path: sd15 at 512 px, bf16, LoRA r=4,
    KPL 0.1 (cos), no augmentation, no checkpoints."""
    return ["--model_preset", "sd15", "--instance_data_dir", instance_dir,
            "--output_dir", output_dir, "--placeholder_token", "<v*>",
            "--initializer_token", "dog", "--resolution", "512",
            "--train_batch_size", str(batch), "--max_train_steps", str(steps),
            "--mixed_precision", "bf16", "--lora_rank", "4", "--kpl_weight", "0.1",
            "--augment", "none", "--checkpointing_steps", "0", "--report_to", "none",
            "--seed", "0"]


def check_flash_backward(gen, shapes=((8, 4096, 8, 40, 4096, 4096), (8, 1024, 8, 80, 1024, 1024),
                                       (2, 1024, 8, 64, 1024, 700))) -> float:
    """K2 against fp32 autograd of plain attention at each (B, N, H, D, M,
    kv_len) of `shapes` (by default sd15's two training shapes and one
    masked KV tail); returns the largest |error|."""
    import torch

    from textboost_torch.ops import flash_attention as fa

    dev, bf16 = gen.device, torch.bfloat16
    worst = 0.0
    for b, n, h, d, m, kv in shapes:
        q, do = (torch.randn(b, n, h, d, generator=gen, device=dev).to(bf16) for _ in range(2))
        k, v = (torch.randn(b, m, h, d, generator=gen, device=dev).to(bf16) for _ in range(2))
        o, lse = fa.flash_attention_forward(q, k, v, scale=d**-0.5, kv_len=kv)
        grads = fa.flash_attention_backward(q, k, v, o, lse, do, scale=d**-0.5, kv_len=kv)
        again = fa.flash_attention_backward(q, k, v, o, lse, do, scale=d**-0.5, kv_len=kv)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            raise AssertionError(f"two calls of the flash backward on the same inputs differ "
                                 f"at {b, n, h, d, m, kv}")
        del again
        ref = attention_grads_fp32(q, k, v, do, d**-0.5, kv)
        control = attention_grads_fp32(q, k, v, do, d**-0.5, kv, skip_keys=64)
        report = []
        for name, g, r, c in zip(("dq", "dk", "dv"), grads, ref, control):
            rel, row = grad_errors(g, r)
            crel, crow = grad_errors(c.to(bf16), r)
            report.append(f"{name} {rel:.3g} / {row:.3g} (control {crel:.3g} / {crow:.3g})")
            if not (crel > FLASH_BWD_REL_L2 and crow > FLASH_BWD_ROW_REL_L2):
                raise AssertionError(f"the flash backward limits would pass a kernel that "
                                     f"skips a key tile ({name} at {b, n, h, d, m, kv})")
            if not (rel <= FLASH_BWD_REL_L2 and row <= FLASH_BWD_ROW_REL_L2):
                raise AssertionError(f"flash backward {name} disagrees with fp32 autograd "
                                     f"at {b, n, h, d, m, kv}")
            worst = max(worst, (g.float() - r).abs().max().item())
        print(f"[flash_bwd] B,N,H,D,M,kv_len={b},{n},{h},{d},{m},{kv}: rel L2 / worst row "
              f"(limits {FLASH_BWD_REL_L2} / {FLASH_BWD_ROW_REL_L2}; control: first 64 keys "
              f"skipped): " + "; ".join(report) + "; two calls bit-identical", flush=True)
        del q, k, v, do, o, lse, grads, ref, control
    return worst


def check_flash_forward(gen, shapes, dtype=None) -> float:
    """K1 against its plain version at each (B, N, H, D, M) of `shapes` in
    `dtype` (bf16 by default): computed in fp32 for a 16-bit type, with the
    P-in-bf16 and dropped-tile controls printed, or in fp64 for fp32 inputs
    (the fp32 limits), with the dropped-tile control; the dropped tile must
    fail the limits.  Returns the largest |o error|."""
    import torch

    from textboost_torch.ops import flash_attention as fa

    dev, bf16 = gen.device, torch.bfloat16
    dtype = dtype or bf16
    fp32 = dtype == torch.float32
    rel_lim, row_lim, lse_lim = ((FLASH_FP32_REL_L2, FLASH_FP32_ROW_REL_L2, FLASH_FP32_LSE_ATOL)
                                 if fp32 else (FLASH_REL_L2, FLASH_ROW_REL_L2, FLASH_LSE_ATOL))
    worst = 0.0
    for b, n, h, d, m in shapes:
        q = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, m, h, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, m, h, d, generator=gen, device=dev).to(dtype)
        o, lse = fa.flash_attention_forward(q, k, v, scale=d**-0.5)
        torch.cuda.synchronize()
        rdt = torch.float64 if fp32 else torch.float32
        ro, rl = plain_attention(q.to(rdt), k.to(rdt), v.to(rdt), d**-0.5)
        eo = (o.to(rdt) - ro).abs().max().item()
        el = (lse.to(rdt) - rl).abs().max().item()
        rel, row = flash_errors(o.to(rdt), ro)
        if fp32:
            p_bf16 = (float("nan"),) * 2
            dropped = flash_errors(plain_attention(q.to(rdt), k[:, 64:].to(rdt), v[:, 64:].to(rdt),
                                                   d**-0.5)[0], ro)
        else:
            p_bf16 = flash_errors(attention_fp32(q, k, v, d**-0.5, p_dtype=bf16).to(bf16), ro)
            dropped = flash_errors(attention_fp32(q, k, v, d**-0.5, drop_keys=64).to(bf16), ro)
        print(f"[flash] B,N,H,D,M={b},{n},{h},{d},{m} {str(dtype)[6:]}: o rel L2 {rel:.3g} "
              f"(limit {rel_lim}), worst row {row:.3g} (limit {row_lim}), max|o err| "
              f"{eo:.3g} of max|o| {ro.abs().max().item():.3g}, max|lse err| {el:.3g}; "
              f"controls rel L2 / worst row: P in bf16 {p_bf16[0]:.3g} / {p_bf16[1]:.3g}, "
              f"first 64 keys dropped {dropped[0]:.3g} / {dropped[1]:.3g}", flush=True)
        if not (dropped[0] > rel_lim and dropped[1] > row_lim):
            raise AssertionError("the flash limits would pass a kernel that drops a key tile")
        if not (rel <= rel_lim and row <= row_lim and el <= lse_lim):
            raise AssertionError(f"flash attention disagrees with its plain version at "
                                 f"{b, n, h, d, m} {dtype}")
        worst = max(worst, eo)
        del q, k, v, o, lse, ro, rl
    return worst


def check_flash_edges() -> None:
    """Both flash kernels across their tiles' edges: a kv_len inside the last
    key tile (128 keys forward, 64 backward) at D = 40, 80 and 128, a query
    length that is no multiple of the 128-row tile, one fp16 case, and one
    batch whose two samples come from different seeds (so that a batch or
    head mix-up shows: each sample must also equal, bit for bit, the
    kernel's result on that sample alone).  Forward against the fp32 plain
    version, backward against fp32 autograd, with the limits of the main
    shapes; dk and dv past kv_len must be zero and two backward calls
    bit-identical."""
    import torch

    from textboost_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    cases = ((2, 1024, 4, 40, 1024, 1000, torch.bfloat16, (1, 1)),
             (2, 1000, 4, 80, 1024, 650, torch.bfloat16, (2, 2)),
             (2, 1024, 2, 128, 1024, 900, torch.bfloat16, (3, 3)),
             (2, 1024, 4, 64, 1024, 1024, torch.float16, (4, 4)),
             (2, 1024, 3, 40, 1024, 1024, torch.bfloat16, (5, 6)))
    for b, n, h, d, m, kv, dtype, seeds in cases:
        parts = []
        for seed in seeds:  # one sample per seed
            g = torch.Generator(dev).manual_seed(seed)
            parts.append([torch.randn(1, rows, h, d, generator=g, device=dev).to(dtype)
                          for rows in (n, m, m, n)])
        q, k, v, do = (torch.cat(t) for t in zip(*parts))
        scale = d**-0.5
        o, lse = fa.flash_attention_forward(q, k, v, scale=scale, kv_len=kv)
        grads = fa.flash_attention_backward(q, k, v, o, lse, do, scale=scale, kv_len=kv)
        again = fa.flash_attention_backward(q, k, v, o, lse, do, scale=scale, kv_len=kv)
        torch.cuda.synchronize()
        ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(), scale, kv)
        rel, row = flash_errors(o, ro)
        el = (lse - rl).abs().max().item()
        if not (rel <= FLASH_REL_L2 and row <= FLASH_ROW_REL_L2 and el <= FLASH_LSE_ATOL):
            raise AssertionError(f"flash forward disagrees with its plain version at the edge "
                                 f"case {b, n, h, d, m, kv, dtype}: {rel:.3g} / {row:.3g} / {el:.3g}")
        report = [f"o {rel:.3g} / {row:.3g}, lse {el:.3g}"]
        for name, got, ref in zip(("dq", "dk", "dv"), grads,
                                  attention_grads_fp32(q, k, v, do, scale, kv)):
            rel, row = grad_errors(got, ref)
            report.append(f"{name} {rel:.3g} / {row:.3g}")
            if not (rel <= FLASH_BWD_REL_L2 and row <= FLASH_BWD_ROW_REL_L2):
                raise AssertionError(f"flash backward {name} disagrees with fp32 autograd at "
                                     f"the edge case {b, n, h, d, m, kv, dtype}")
        if grads[1][:, kv:].any() or grads[2][:, kv:].any():
            raise AssertionError(f"dk or dv past kv_len is not zero at {b, n, h, d, m, kv}")
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            raise AssertionError(f"two backward calls differ at {b, n, h, d, m, kv, dtype}")
        if seeds[0] != seeds[1]:
            for i in range(b):
                one = [t[i:i + 1] for t in (q, k, v, do)]
                oi, li = fa.flash_attention_forward(*one[:3], scale=scale, kv_len=kv)
                gi = fa.flash_attention_backward(*one[:3], oi, li, one[3], scale=scale, kv_len=kv)
                same = (torch.equal(oi, o[i:i + 1]) and torch.equal(li, lse[i:i + 1])
                        and all(torch.equal(x, y[i:i + 1]) for x, y in zip(gi, grads)))
                if not same:
                    raise AssertionError(f"sample {i} of a two-seed batch differs from the same "
                                         f"sample alone at {b, n, h, d, m, kv}")
            report.append("each sample bit-identical to its own call")
        print(f"[flash_edges] B,N,H,D,M,kv_len={b},{n},{h},{d},{m},{kv} {dtype}: rel L2 / worst "
              f"row: " + "; ".join(report), flush=True)


# K2's forms that --attention_impl flash brings: (name, B, N, H, D, M,
# kv_len, dtype name, the variant that must serve it, timed).  The
# sd15 cross-attentions over the 77 text keys at the three levels, sd15's
# 160-wide heads at 16x16 latents (self and cross), sd21base's level-0
# cross-attention, D = 100 (no whole 16-byte chunks), the VAE's single
# 512-wide head, each in bf16 (wgmma, or mma outside its form) and every
# shape of the fp32 run (register tiles on the CUDA cores); then untimed
# edge cases: a kv_len inside the last tile, a query length off the
# 64-row tile, a head dim that is no multiple of 4 (or of 8 in bf16).
FLASH_BWD_FORMS = (
    ("sd15_cross0_8x4096x8x40_m77", 8, 4096, 8, 40, 77, 77, "bfloat16", "wgmma", True),
    ("sd15_cross1_8x1024x8x80_m77", 8, 1024, 8, 80, 77, 77, "bfloat16", "wgmma", True),
    ("sd15_cross2_8x256x8x160_m77", 8, 256, 8, 160, 77, 77, "bfloat16", "mma", True),
    ("sd15_self2_8x256x8x160", 8, 256, 8, 160, 256, 256, "bfloat16", "mma", True),
    ("sd21base_cross0_8x4096x5x64_m77", 8, 4096, 5, 64, 77, 77, "bfloat16", "wgmma", True),
    ("d100_2x1024x4x100", 2, 1024, 4, 100, 1024, 1024, "bfloat16", "mma", True),
    ("vae_2x4096x1x512", 2, 4096, 1, 512, 4096, 4096, "bfloat16", "mma", True),
    ("fp32_sd15_self0_8x4096x8x40", 8, 4096, 8, 40, 4096, 4096, "float32", "cuda_cores", True),
    ("fp32_sd15_cross0_8x4096x8x40_m77", 8, 4096, 8, 40, 77, 77, "float32", "cuda_cores", True),
    ("fp32_sd15_self1_8x1024x8x80", 8, 1024, 8, 80, 1024, 1024, "float32", "cuda_cores", True),
    ("fp32_sd15_cross1_8x1024x8x80_m77", 8, 1024, 8, 80, 77, 77, "float32", "cuda_cores", True),
    ("fp32_sd15_self2_8x256x8x160", 8, 256, 8, 160, 256, 256, "float32", "cuda_cores", True),
    ("fp32_sd15_cross2_8x256x8x160_m77", 8, 256, 8, 160, 77, 77, "float32", "cuda_cores", True),
    ("fp32_d100_2x1024x4x100", 2, 1024, 4, 100, 1024, 1024, "float32", "cuda_cores", True),
    ("fp32_vae_2x4096x1x512", 2, 4096, 1, 512, 4096, 4096, "float32", "cuda_cores", True),
    ("fp32_kv_tail_1x256x2x100_m256_kv200", 1, 256, 2, 100, 256, 200, "float32", "cuda_cores",
     False),
    ("kv_tail_1x256x2x160_m256_kv200", 1, 256, 2, 160, 256, 200, "bfloat16", "mma", False),
    ("ragged_2x300x3x80_m77_kv70", 2, 300, 3, 80, 77, 70, "bfloat16", "wgmma", False),
    ("fp32_odd_1x300x2x33_m130", 1, 300, 2, 33, 130, 130, "float32", "cuda_cores", False),
    ("odd_1x300x2x33_m130", 1, 300, 2, 33, 130, 130, "bfloat16", "mma", False),
)
# The keys a variant's first tile holds, for the dropped-tile controls: K2
# streams 64 keys (wgmma; cuda_cores' dQ kernel) or 32 (mma); K1 128
# (wgmma) or 64 (wgmma_wide, cuda_cores).
K2_TILE_KEYS = {"wgmma": 64, "mma": 32, "cuda_cores": 64}
K1_TILE_KEYS = {"wgmma": 128, "wgmma_wide": 64, "cuda_cores": 64}
CANARY_ROWS = 8  # rows past N (dq) or M (dk, dv) in each output buffer, which no launch may write
CANARY = 7.0


def k2_variant(dtype_name: str, d: int) -> str:
    """The K2 variant that must serve an aligned call in `dtype_name` at head
    dim `d`: wgmma for a 16-bit type at D <= 128 in whole 16-byte chunks,
    mma for the other 16-bit calls, the CUDA cores for fp32."""
    if dtype_name == "float32":
        return "cuda_cores"
    return "wgmma" if d <= 128 and d % 8 == 0 else "mma"


def k1_variant(dtype_name: str, d: int) -> str:
    """The K1 variant that must serve an aligned call in `dtype_name` at head
    dim `d`: wgmma (D <= 128) or wgmma_wide for a 16-bit type whose head dim
    is whole 16-byte chunks, else the CUDA cores."""
    if dtype_name == "float32" or d % 8:
        return "cuda_cores"
    return "wgmma" if d <= 128 else "wgmma_wide"


def check_flash_backward_form(gen, b, n, h, d, m, kv, dtype, variant, q=None, k=None, v=None):
    """K2 at one form against its plain version on the same q, k, v, o, lse
    and dO (computed in fp32 for a 16-bit type, in fp64 for fp32), with the
    variant that served it, a dropped-tile control (the plain version over
    keys past the variant's first key tile, K2_TILE_KEYS),
    two calls bit-identical, zero rows past kv_len and an untouched canary
    past N and M in the output buffers.  q, k, v may be given (views).
    Returns (report, the largest |error|)."""
    import torch

    from textboost_torch.ops import flash_attention as fa

    dev = gen.device
    fp32 = dtype == torch.float32
    rel_lim, row_lim = ((FLASH_FP32_REL_L2, FLASH_FP32_ROW_REL_L2) if fp32
                        else (FLASH_BWD_REL_L2, FLASH_BWD_ROW_REL_L2))
    if q is None:
        q = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, m, h, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, m, h, d, generator=gen, device=dev).to(dtype)
    do = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype)
    scale = d**-0.5
    o, lse = fa.flash_attention_forward(q, k, v, scale=scale, kv_len=kv)
    bufs = [torch.full((b, rows + CANARY_ROWS, h, d), CANARY, dtype=dtype, device=dev)
            for rows in (n, m, m)]
    out = tuple(x[:, :rows] for x, rows in zip(bufs, (n, m, m)))
    fa.bwd_variant_counts.clear()
    grads = fa.flash_attention_backward(q, k, v, o, lse, do, scale=scale, kv_len=kv, out=out)
    again = fa.flash_attention_backward(q, k, v, o, lse, do, scale=scale, kv_len=kv)
    torch.cuda.synchronize()
    where = f"{b, n, h, d, m, kv} {dtype}"
    if dict(fa.bwd_variant_counts) != {variant: 2}:
        raise AssertionError(f"the flash backward at {where} went through "
                             f"{dict(fa.bwd_variant_counts)}, not {variant}")
    if not all(torch.equal(x, y) for x, y in zip(grads, again)):
        raise AssertionError(f"two calls of the flash backward differ at {where}")
    if not all(bool((x[:, rows:] == CANARY).all()) for x, rows in zip(bufs, (n, m, m))):
        raise AssertionError(f"the flash backward wrote past N or M at {where}")
    if grads[1][:, kv:].any() or grads[2][:, kv:].any():
        raise AssertionError(f"dk or dv past kv_len is not zero at {where}")
    rdt = torch.float64 if fp32 else torch.float32
    ins = [t.to(rdt) for t in (q, k[:, :kv], v[:, :kv], o, lse, do)]
    tile = K2_TILE_KEYS[variant]
    pad = (0, 0, 0, 0, 0, m - kv)
    ref = plain_attention(*ins[:3], scale, backward_of=ins[3:])
    ref = (ref[0], *(torch.nn.functional.pad(r, pad) for r in ref[1:]))
    skip = plain_attention(ins[0], ins[1][:, tile:], ins[2][:, tile:], scale,
                           backward_of=ins[3:])
    skip = (skip[0], *(torch.nn.functional.pad(r, (0, 0, 0, 0, tile, m - kv)) for r in skip[1:]))
    report, worst = [], 0.0
    for name, g, r, c in zip(("dq", "dk", "dv"), grads, ref, skip):
        rel, row = grad_errors(g.to(rdt), r)
        crel, crow = grad_errors(c.to(dtype).to(rdt), r)
        report.append(f"{name} {rel:.3g} / {row:.3g} (control {crel:.3g} / {crow:.3g})")
        if not (crel > rel_lim and crow > row_lim):
            raise AssertionError(f"the flash backward limits would pass a kernel that skips a "
                                 f"key tile ({name} at {where})")
        if not (rel <= rel_lim and row <= row_lim):
            raise AssertionError(f"flash backward {name} disagrees with its plain version at "
                                 f"{where}: {rel:.3g} / {row:.3g}")
        worst = max(worst, (g.to(rdt) - r).abs().max().item())
    text = (f"{variant}, rel L2 / worst row (limits {rel_lim} / {row_lim}; control: the first "
            f"{tile} keys skipped): " + "; ".join(report) + "; two calls bit-identical, canary "
            f"past N and M untouched")
    return text, worst


def check_flash_backward_forms(gen, card: dict) -> dict:
    """K2 at every form of FLASH_BWD_FORMS (`check_flash_backward_form`),
    plus packed fp32 and bf16 qkv views read in place; the timed forms' ms,
    plain version's ms, SDPA's forward+backward minus forward, and bound."""
    import torch
    import torch.nn.functional as F

    from textboost_torch.ops import flash_attention as fa

    dev = gen.device
    rows, worst = {}, 0.0
    for name, b, n, h, d, m, kv, dt, variant, timed in FLASH_BWD_FORMS:
        t0 = time.perf_counter()
        dtype = getattr(torch, dt)
        text, err = check_flash_backward_form(gen, b, n, h, d, m, kv, dtype, variant)
        worst = max(worst, err)
        line = f"[flash_bwd forms] {name} B,N,H,D,M,kv_len={b},{n},{h},{d},{m},{kv} {dt}: {text}"
        if timed:
            q, do = (torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype) for _ in range(2))
            k, v = (torch.randn(b, m, h, d, generator=gen, device=dev).to(dtype) for _ in range(2))
            scale = d**-0.5
            o, lse = fa.flash_attention_forward(q, k, v, scale=scale)
            qt, kt, vt = (z.transpose(1, 2).contiguous().requires_grad_() for z in (q, k, v))
            dot = do.transpose(1, 2).contiguous()

            def sdpa_fwd():
                return F.scaled_dot_product_attention(qt, kt, vt)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

            spin = FORM_SPIN_CYCLES
            row = {
                "dtype": dt, "variant": variant, "shape": [b, n, h, d, m],
                "ms": cuda_ms(lambda: fa.flash_attention_backward(q, k, v, o, lse, do,
                                                                  scale=scale), 5, 1, spin),
                "plain_ms": cuda_ms(lambda: plain_attention(q, k, v, scale, (o, lse, do)), 2, 1,
                                    spin),
                "library_ms": (cuda_ms(sdpa_fwd_bwd, 5, 1, spin)
                               - cuda_ms(sdpa_fwd, 5, 1, spin)),
                **bound_of(flash_floors_ms(b, n, m, h, d, backward=True,
                                           fp32=dtype == torch.float32, **card)),
            }
            rows[name] = row
            line += (f"; {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, {row['bound_floor']}; "
                     f"SDPA fwd+bwd minus fwd {row['library_ms']:.4f}; plain {row['plain_ms']:.3f})")
            del q, k, v, do, o, lse, qt, kt, vt, dot
        print(f"{line} [{time.perf_counter() - t0:.1f} s]", flush=True)
        torch.cuda.empty_cache()
    # q, k, v as slices of one packed tensor, read in place: fp32 [1, 1024,
    # 2, 3 * 40 + 1] (strides of 121 elements) by the CUDA cores, bf16 [1,
    # 1024, 2, 3 * 100 + 4] (bases 8 bytes off a 16-byte boundary) by mma.
    for dtype, d, extra, variant in ((torch.float32, 40, 1, "cuda_cores"),
                                     (torch.bfloat16, 100, 4, "mma")):
        width = 3 * d + extra
        packed = torch.randn(1, 1024, 2, width, generator=gen, device=dev).to(dtype)
        q, k, v = (packed[..., extra + d * i:extra + d * (i + 1)] for i in range(3))
        text, err = check_flash_backward_form(gen, 1, 1024, 2, d, 1024, 1024, dtype, variant,
                                              q, k, v)
        worst = max(worst, err)
        print(f"[flash_bwd forms] packed {str(dtype)[6:]} q/k/v views (strides {width} "
              f"elements, base offset {extra}) B,N,H,D=1,1024,2,{d}: {text}", flush=True)
    return {"rows": rows, "max_abs_err": worst}


# K1's forms of the fp32 flash run (every K1 shape `train_step_calls` derives
# for it: sd15's self- and cross-attentions at the three levels and the VAE
# encoder's 512-wide head at batch 8), a head dim that is no multiple of 4
# and a 16-bit one off whole 16-byte chunks, all on the CUDA cores: (name, B,
# N, H, D, M, dtype name, variant, timed).  Then strided views
# (`check_flash_forward_forms`).
FLASH_FWD_FORMS = (
    ("fp32_sd15_self0_8x4096x8x40", 8, 4096, 8, 40, 4096, "float32", "cuda_cores", True),
    ("fp32_sd15_cross0_8x4096x8x40_m77", 8, 4096, 8, 40, 77, "float32", "cuda_cores", True),
    ("fp32_sd15_self1_8x1024x8x80", 8, 1024, 8, 80, 1024, "float32", "cuda_cores", True),
    ("fp32_sd15_cross1_8x1024x8x80_m77", 8, 1024, 8, 80, 77, "float32", "cuda_cores", True),
    ("fp32_sd15_self2_8x256x8x160", 8, 256, 8, 160, 256, "float32", "cuda_cores", True),
    ("fp32_sd15_cross2_8x256x8x160_m77", 8, 256, 8, 160, 77, "float32", "cuda_cores", True),
    ("fp32_vae_8x4096x1x512", 8, 4096, 1, 512, 4096, "float32", "cuda_cores", True),
    ("fp32_odd_1x300x2x33_m130", 1, 300, 2, 33, 130, "float32", "cuda_cores", False),
    ("d100_2x1024x4x100", 2, 1024, 4, 100, 1024, "bfloat16", "cuda_cores", True),
)


def check_flash_forward_form(gen, b, n, h, d, m, dtype, variant, q=None, k=None, v=None):
    """K1 at one form against its plain version on the same q, k, v
    (computed in fp32 for a 16-bit type, in fp64 for fp32), with the variant
    that served it, a dropped-tile control (the plain version over keys past
    the variant's first key tile, K1_TILE_KEYS) that must fail the limits,
    and two calls bit-identical.  q, k, v may be given (views).  Returns
    (report, the largest |o error|)."""
    import torch

    from textboost_torch.ops import flash_attention as fa

    dev = gen.device
    fp32 = dtype == torch.float32
    rel_lim, row_lim, lse_lim = ((FLASH_FP32_REL_L2, FLASH_FP32_ROW_REL_L2, FLASH_FP32_LSE_ATOL)
                                 if fp32 else (FLASH_REL_L2, FLASH_ROW_REL_L2, FLASH_LSE_ATOL))
    if q is None:
        q = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, m, h, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, m, h, d, generator=gen, device=dev).to(dtype)
    scale = d**-0.5
    fa.variant_counts.clear()
    o, lse = fa.flash_attention_forward(q, k, v, scale=scale)
    again = fa.flash_attention_forward(q, k, v, scale=scale)
    torch.cuda.synchronize()
    where = f"{b, n, h, d, m} {dtype}"
    if dict(fa.variant_counts) != {variant: 2}:
        raise AssertionError(f"the flash forward at {where} went through "
                             f"{dict(fa.variant_counts)}, not {variant}")
    if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"two calls of the flash forward differ at {where}")
    rdt = torch.float64 if fp32 else torch.float32
    qr, kr, vr = (t.to(rdt) for t in (q, k, v))
    ro, rl = plain_attention(qr, kr, vr, scale)
    tile = K1_TILE_KEYS[variant]
    dropped = flash_errors(plain_attention(qr, kr[:, tile:], vr[:, tile:], scale)[0].to(dtype)
                           .to(rdt), ro)
    rel, row = flash_errors(o.to(rdt), ro)
    el = (lse.to(rdt) - rl).abs().max().item()
    if not (dropped[0] > rel_lim and dropped[1] > row_lim):
        raise AssertionError(f"the flash limits would pass a kernel that drops a key tile at "
                             f"{where}")
    if not (rel <= rel_lim and row <= row_lim and el <= lse_lim):
        raise AssertionError(f"flash forward disagrees with its plain version at {where}: "
                             f"{rel:.3g} / {row:.3g} / lse {el:.3g}")
    text = (f"{variant}, o rel L2 {rel:.3g} / worst row {row:.3g} (limits {rel_lim} / "
            f"{row_lim}; control: the first {tile} keys dropped {dropped[0]:.3g} / "
            f"{dropped[1]:.3g}), max|lse err| {el:.3g} (limit {lse_lim}); two calls "
            f"bit-identical")
    return text, (o.to(rdt) - ro).abs().max().item()


def check_flash_forward_forms(gen, card: dict) -> dict:
    """K1 at every form of FLASH_FWD_FORMS (`check_flash_forward_form`) and
    at packed views read in place (fp32 strides of 121 elements, bf16 bases
    off a 16-byte boundary); the timed forms' ms, plain version's ms, SDPA's
    (forward, same dtype) and bound."""
    import torch
    import torch.nn.functional as F

    from textboost_torch.ops import flash_attention as fa

    dev = gen.device
    rows, worst = {}, 0.0
    for name, b, n, h, d, m, dt, variant, timed in FLASH_FWD_FORMS:
        t0 = time.perf_counter()
        dtype = getattr(torch, dt)
        text, err = check_flash_forward_form(gen, b, n, h, d, m, dtype, variant)
        worst = max(worst, err)
        line = f"[flash forms] {name} B,N,H,D,M={b},{n},{h},{d},{m} {dt}: {text}"
        if timed:
            q = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(b, m, h, d, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
            scale = d**-0.5
            spin = FORM_SPIN_CYCLES
            row = {
                "dtype": dt, "variant": variant, "shape": [b, n, h, d, m],
                "ms": cuda_ms(lambda: fa.flash_attention_forward(q, k, v, scale=scale), 5, 1,
                              spin),
                "plain_ms": cuda_ms(lambda: plain_attention(q, k, v, scale), 2, 1, spin),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 5, 1,
                                      spin),
                **bound_of(flash_floors_ms(b, n, m, h, d, backward=False,
                                           fp32=dtype == torch.float32, **card)),
            }
            rows[name] = row
            line += (f"; {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, {row['bound_floor']}; "
                     f"SDPA {row['library_ms']:.4f}; plain {row['plain_ms']:.3f})")
            del q, k, v, qt, kt, vt
        print(f"{line} [{time.perf_counter() - t0:.1f} s]", flush=True)
        torch.cuda.empty_cache()
    for dtype, d, extra in ((torch.float32, 40, 1), (torch.bfloat16, 40, 4)):
        width = 3 * d + extra
        packed = torch.randn(1, 1024, 2, width, generator=gen, device=dev).to(dtype)
        q, k, v = (packed[..., extra + d * i:extra + d * (i + 1)] for i in range(3))
        text, err = check_flash_forward_form(gen, 1, 1024, 2, d, 1024, dtype, "cuda_cores",
                                             q, k, v)
        worst = max(worst, err)
        print(f"[flash forms] packed {str(dtype)[6:]} q/k/v views (strides {width} elements, "
              f"base offset {extra}) B,N,H,D=1,1024,2,{d}: {text}", flush=True)
    return {"rows": rows, "max_abs_err": worst}


def flash_forward_times(gen, b: int, n: int, h: int, d: int, card: dict) -> dict:
    """K1 at [b, n, h, d] (self-attention, bf16): its time, its plain
    version's, SDPA's and the bound; raises unless a wgmma variant serves
    the shape."""
    import torch
    import torch.nn.functional as F

    from textboost_torch.ops import flash_attention as fa

    dev, bf16 = gen.device, torch.bfloat16
    q, k, v = (torch.randn(b, n, h, d, generator=gen, device=dev).to(bf16) for _ in range(3))
    qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
    fa.variant_counts.clear()
    fa.flash_attention_forward(q, k, v, scale=d**-0.5)
    if set(fa.variant_counts) - WGMMA_VARIANTS:
        raise AssertionError(f"the main-path shape {b, n, h, d} was served by "
                             f"{dict(fa.variant_counts)}, not by wgmma")
    out = {
        "ms": cuda_ms(lambda: fa.flash_attention_forward(q, k, v, scale=d**-0.5), 10),
        "plain_ms": cuda_ms(lambda: plain_attention(q, k, v, d**-0.5), 3, 1),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10),
        **bound_of(flash_floors_ms(b, n, n, h, d, backward=False, **card)),
    }
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def flash_backward_times(gen, b: int, n: int, h: int, d: int, card: dict) -> dict:
    import torch
    import torch.nn.functional as F

    from textboost_torch.ops import flash_attention as fa

    dev, bf16 = gen.device, torch.bfloat16
    q, k, v, do = (torch.randn(b, n, h, d, generator=gen, device=dev).to(bf16) for _ in range(4))
    o, lse = fa.flash_attention_forward(q, k, v, scale=d**-0.5)
    qt, kt, vt = (z.transpose(1, 2).contiguous().requires_grad_() for z in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

    out = {
        "ms": cuda_ms(lambda: fa.flash_attention_backward(q, k, v, o, lse, do, scale=d**-0.5), 10),
        "plain_ms": cuda_ms(lambda: plain_attention(q, k, v, d**-0.5, (o, lse, do)), 2, 1),
        "library_ms": cuda_ms(sdpa_fwd_bwd, 10) - cuda_ms(sdpa_fwd, 10),
        **bound_of(flash_floors_ms(b, n, n, h, d, backward=True, **card)),
    }
    del q, k, v, do, o, lse, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return out


def train_step_parity(gen, instance_dir: str, output_dir: str):
    """One sd15 train step at batch 2 from one state, batch and draws, with
    the kernels ('auto') and with plain math, and the control.  Returns
    (numbers, the (shape without batch, groups, eps, silu) of every UNet
    GroupNorm the backward runs through)."""
    import torch

    from textboost_torch.lora.partition import lora_parameters
    from textboost_torch.models.layers import GroupNorm, set_impl
    from textboost_torch.ops import group_norm as gn
    from textboost_torch.train.config import parse_args
    from textboost_torch.train.step import forward_backward
    from textboost_torch.train.trainer import Trainer

    trainer = Trainer(parse_args(train_flags(instance_dir, output_dir, 2, 1)), device="cuda")
    state, te = trainer.state, trainer.text_encoder
    lora = lora_parameters(te)
    with torch.no_grad():
        for p in lora[1::2]:  # lora_B: nonzero, so that lora_A has gradients too
            p.normal_(0.0, 0.01, generator=gen)
    try:
        batch = trainer._device_batch(next(iter(trainer.train_loader)),
                                      next(iter(trainer.prior_loader)))
    finally:
        trainer.train_loader.stop()
        trainer.prior_loader.stop()
    draws = trainer._draws()
    shapes = set()

    def record(mod, args):
        if torch.is_grad_enabled() and args[0].requires_grad:
            shapes.add((tuple(args[0].shape[1:]), mod.num_groups, mod.eps, mod.silu))

    hooks = [m.register_forward_pre_hook(record) for m in state.unet.modules()
             if isinstance(m, GroupNorm)]

    def run(impl):
        set_impl(state.unet, impl)
        set_impl(state.vae, impl)
        loss, _ = forward_backward(state, trainer.step_config, batch, draws)
        lora_grad = torch.cat([p.grad.float().flatten() for p in lora])
        emb_grad = te.token_embedding.weight.grad[trainer.first_added_id:].float().clone()
        return loss.item(), lora_grad, emb_grad

    kernels = run("auto")
    for hk in hooks:
        hk.remove()
    math = run("math")
    real_bwd = gn.group_norm_backward
    # Control: a GroupNorm backward that forgets the SiLU's derivative.
    gn.group_norm_backward = lambda x, ga, be, mu, rs, dy, g, eps, silu: (
        gn.group_norm_backward_reference(x, ga, be, mu, rs, dy, g, eps, False))
    try:
        control = run("auto")
    finally:
        gn.group_norm_backward = real_bwd
    set_impl(state.unet, "auto")
    set_impl(state.vae, "auto")
    out = {
        "loss_rel_diff": abs(kernels[0] - math[0]) / abs(math[0]),
        "lora_grad_rel_l2": rel_l2(kernels[1], math[1]),
        "emb_grad_rel_l2": rel_l2(kernels[2], math[2]),
        "control_lora_grad_rel_l2": rel_l2(control[1], math[1]),
        "control_emb_grad_rel_l2": rel_l2(control[2], math[2]),
    }
    print(f"[train_step] sd15 batch 2, kernels vs math: loss {kernels[0]:.6g} vs {math[0]:.6g} "
          f"(rel {out['loss_rel_diff']:.3g}, bound {TRAIN_LOSS_REL}); rel L2 of the LoRA grads "
          f"{out['lora_grad_rel_l2']:.3g}, of the added-embedding grad "
          f"{out['emb_grad_rel_l2']:.3g} (bound {TRAIN_GRAD_REL_L2}); control (GN backward "
          f"without the SiLU derivative) {out['control_lora_grad_rel_l2']:.3g} / "
          f"{out['control_emb_grad_rel_l2']:.3g}", flush=True)
    if not (out["control_lora_grad_rel_l2"] > TRAIN_GRAD_REL_L2
            and out["control_emb_grad_rel_l2"] > TRAIN_GRAD_REL_L2):
        raise AssertionError("the train-step bound would pass a GroupNorm backward without "
                             "the SiLU derivative")
    if not (out["loss_rel_diff"] <= TRAIN_LOSS_REL and out["lora_grad_rel_l2"] <= TRAIN_GRAD_REL_L2
            and out["emb_grad_rel_l2"] <= TRAIN_GRAD_REL_L2):
        raise AssertionError("the sd15 train step with kernels disagrees with plain math")
    del trainer, state, te, lora, batch, draws, kernels, math, control
    return out, shapes


# --attention_impl flash at sd15 (`flash_impl_phase`): the training main
# path at bf16 (FLASH_BF16_STEPS steps, then one validation round of one
# image of FLASH_PROMPT) and at the CLI's default fp32 (FLASH_FP32_STEPS).
FLASH_BF16_STEPS = 4
FLASH_FP32_STEPS = 2
FLASH_PROMPT = "photo of a <v*> dog"
# One sd15 train step (batch 2) under --attention_impl flash against the
# same step under auto (one state, batch and draws): relative difference of
# the loss and relative L2 of the LoRA and added-embedding gradients.  bf16:
# flash sends the cross-attentions and the 256-token level to the kernels,
# auto to plain math, and the two round at other places, as the kernels and
# math do in `train_step_parity`: its bounds.  fp32: both sum in
# fp32 in another order (~1e-6 an attention) through the UNet's forward and
# backward.  The control, a flash backward that leaves out the first 32
# keys' dk and dv, must exceed the bound.
FLASH_LOSS_REL = {"bf16": TRAIN_LOSS_REL, "fp32": 1e-4}
FLASH_GRAD_REL_L2 = {"bf16": TRAIN_GRAD_REL_L2, "fp32": 1e-3}
GN_FP32_TOL = 1e-5  # K3/K4 in fp32 against their plain versions (atol and rtol)


def flash_flags(instance_dir: str, output_dir: str, batch: int, steps: int, bf16: bool, *extra):
    """The sd15 training main path's flags with --attention_impl flash, at
    bf16 or at the CLI's default fp32 (no --mixed_precision)."""
    flags = train_flags(instance_dir, output_dir, batch, steps)
    if not bf16:
        i = flags.index("--mixed_precision")
        del flags[i:i + 2]
    return flags + ["--attention_impl", "flash", *extra]


def flash_step_parity(gen, instance_dir: str, output_dir: str, bf16: bool) -> dict:
    """One sd15 train step at batch 2 from one state, batch and draws under
    'flash' and under 'auto', and the control (module note above)."""
    import torch

    from textboost_torch.lora.partition import lora_parameters
    from textboost_torch.models.layers import set_attention_impl
    from textboost_torch.ops import flash_attention as fa
    from textboost_torch.train.config import parse_args
    from textboost_torch.train.step import forward_backward
    from textboost_torch.train.trainer import Trainer

    prec = "bf16" if bf16 else "fp32"
    trainer = Trainer(parse_args(flash_flags(instance_dir, output_dir, 2, 1, bf16)), device="cuda")
    state, te = trainer.state, trainer.text_encoder
    lora = lora_parameters(te)
    with torch.no_grad():
        for p in lora[1::2]:  # lora_B: nonzero, so that lora_A has gradients too
            p.normal_(0.0, 0.01, generator=gen)
    try:
        batch = trainer._device_batch(next(iter(trainer.train_loader)),
                                      next(iter(trainer.prior_loader)))
    finally:
        trainer.train_loader.stop()
        trainer.prior_loader.stop()
    draws = trainer._draws()

    def run(impl):
        for mod in (state.unet, state.vae):
            set_attention_impl(mod, impl)
        fa.launches = fa.bwd_launches = 0
        loss, _ = forward_backward(state, trainer.step_config, batch, draws)
        lora_grad = torch.cat([p.grad.float().flatten() for p in lora])
        emb_grad = te.token_embedding.weight.grad[trainer.first_added_id:].float().clone()
        return loss.item(), lora_grad, emb_grad, (fa.launches, fa.bwd_launches)

    flash = run("flash")
    auto = run("auto")
    real_bwd = fa.flash_attention_backward

    def skipping(*args, **kwargs):
        dq, dk, dv = real_bwd(*args, **kwargs)
        dk[:, :32] = 0
        dv[:, :32] = 0
        return dq, dk, dv

    fa.flash_attention_backward = skipping
    try:
        control = run("flash")
    finally:
        fa.flash_attention_backward = real_bwd
    out = {
        "loss_rel_diff": abs(flash[0] - auto[0]) / abs(auto[0]),
        "lora_grad_rel_l2": rel_l2(flash[1], auto[1]),
        "emb_grad_rel_l2": rel_l2(flash[2], auto[2]),
        "control_lora_grad_rel_l2": rel_l2(control[1], auto[1]),
        "control_emb_grad_rel_l2": rel_l2(control[2], auto[2]),
        "launches_flash": flash[3], "launches_auto": auto[3],
    }
    loss_lim, grad_lim = FLASH_LOSS_REL[prec], FLASH_GRAD_REL_L2[prec]
    print(f"[flash parity] sd15 {prec} batch 2, one step under flash vs auto: loss "
          f"{flash[0]:.7g} vs {auto[0]:.7g} (rel {out['loss_rel_diff']:.3g}, bound {loss_lim}); "
          f"rel L2 of the LoRA grads {out['lora_grad_rel_l2']:.3g}, of the added-embedding grad "
          f"{out['emb_grad_rel_l2']:.3g} (bound {grad_lim}); control (dk, dv of the first 32 "
          f"keys left out) {out['control_lora_grad_rel_l2']:.3g} / "
          f"{out['control_emb_grad_rel_l2']:.3g}; K1 / K2 launches flash {flash[3]}, auto "
          f"{auto[3]}", flush=True)
    if not (out["control_lora_grad_rel_l2"] > grad_lim and out["control_emb_grad_rel_l2"] > grad_lim):
        raise AssertionError(f"the {prec} flash-vs-auto bound would pass a backward that drops "
                             f"a key tile")
    if not (out["loss_rel_diff"] <= loss_lim and out["lora_grad_rel_l2"] <= grad_lim
            and out["emb_grad_rel_l2"] <= grad_lim):
        raise AssertionError(f"the sd15 {prec} step under flash disagrees with the step under auto")
    del trainer, state, te, lora, batch, draws
    return out


def check_group_norm_fp32(gen, fwd_keys, bwd_keys) -> float:
    """K3 and K4 in fp32 at each (shape, groups, eps, silu) key against their
    plain versions (GN_FP32_TOL; mean and rstd GN_STAT_RTOL).  Returns the
    largest |error|."""
    import torch

    from textboost_torch.ops import group_norm as gn

    dev, worst = gen.device, 0.0
    for keys, backward in ((fwd_keys, False), (bwd_keys, True)):
        for shape, groups, eps, silu in sorted(keys):
            c = shape[1]
            x = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
            gamma = torch.rand(c, generator=gen, device=dev) + 0.5
            beta = torch.randn(c, generator=gen, device=dev)
            y, mean, rstd = gn.group_norm_forward(x, gamma, beta, groups, eps=eps, silu=silu)
            ry, rmean, rrstd = gn.group_norm_reference(x, gamma, beta, groups, eps, silu)
            torch.testing.assert_close(mean, rmean, atol=1e-6, rtol=GN_STAT_RTOL)
            torch.testing.assert_close(rstd, rrstd, atol=0, rtol=GN_STAT_RTOL)
            got, ref = y, ry
            if backward:
                dy = torch.randn(shape, generator=gen, device=dev)
                got = gn.group_norm_backward(x, gamma, beta, mean, rstd, dy, groups, eps, silu)
                ref = gn.group_norm_backward_reference(x, gamma, beta, mean, rstd, dy, groups,
                                                       eps, silu)
            torch.testing.assert_close(got, ref, atol=GN_FP32_TOL, rtol=GN_FP32_TOL,
                                       msg=lambda m: f"fp32 GroupNorm {shape} {silu}: {m}")
            worst = max(worst, (got - ref).abs().max().item())
            del x, y, mean, rstd, ry, rmean, rrstd, got, ref
    return worst


def flash_impl_phase(gen, card: dict, work: str, smi: str, held: dict) -> dict:
    """`--attention_impl flash` at sd15 (see the module docstring): the
    launches derived on the meta device; K2 and K1 at their forms; one step
    under flash against the same step under auto at bf16 and fp32; the
    training main path at bf16 with a validation round and at fp32 (K1
    all wgmma and K2 wgmma + mma in bf16, both all CUDA cores in fp32);
    every kernel held at every shape the runs gave it."""
    import torch

    from textboost_torch.models.configs import get_spec

    t_phase = time.perf_counter()
    spec = get_spec("sd15")

    # a. the launches, derived on the meta device -----------------------------
    def totals(calls):
        return {k: sum(c.values()) for k, c in calls.items()}

    per_step = train_step_calls("sd15", 8, 8, checkpointing=False, cross_lora_rank=0,
                                impl="flash")
    n_step = totals(per_step)
    val = sampling_flash_calls("sd15", 2, 1)
    round_k1 = 25 * sum(val["unet"].values()) + sum(val["decode"].values())
    round_gn = expected_launches(spec, 25)[1]
    if (n_step["flash"], n_step["flash_bwd"], round_k1) != (31, 29, 751):
        raise AssertionError(f"the flash launches derived from the config {n_step}, a round "
                             f"{round_k1}, are not 31 / 29 a step and 751 a round")
    auto_step = totals(train_step_calls("sd15", 8, 8, checkpointing=False, cross_lora_rank=0))
    ckpt_step = totals(train_step_calls("sd15", 8, 8, checkpointing=True, cross_lora_rank=0,
                                        impl="flash"))
    tp_calls = train_step_calls("sd15", 8, 8, checkpointing=False, cross_lora_rank=0,
                                impl="flash", tp=2)
    print(f"[flash derivation] sd15 batch 8 a train step under flash {n_step} (auto "
          f"{auto_step}); with --gradient_checkpointing {ckpt_step}; a tp rank of 2 "
          f"{totals(tp_calls)} at local heads {sorted(tp_calls['flash'])}; a validation round "
          f"(one image of one prompt, CFG): K1 {round_k1} (30 a UNet call x 25, 1 decode), "
          f"K3 {round_gn}", flush=True)

    # b. K2 and K1 at their forms ----------------------------------------------
    t_part = time.perf_counter()
    forms = check_flash_backward_forms(gen, card)
    fwd_forms = check_flash_forward_forms(gen, card)
    gc.collect()
    torch.cuda.empty_cache()
    part_s = {"forms": time.perf_counter() - t_part}

    # c. one step under flash against the same step under auto ----------------
    instance_dir = os.path.join(work, "instance")
    os.makedirs(instance_dir)
    write_instance_image(os.path.join(instance_dir, "dog.png"), seed=0)
    parity = {}
    t_part = time.perf_counter()
    for prec in ("bf16", "fp32"):
        parity[prec] = flash_step_parity(gen, instance_dir, os.path.join(work, f"parity_{prec}"),
                                         prec == "bf16")
        gc.collect()
        torch.cuda.empty_cache()
    part_s["parity"] = time.perf_counter() - t_part

    # d. the main path: bf16 with a validation round, then fp32 ----------------
    t_part = time.perf_counter()
    runs = {}
    for prec, steps in (("bf16", FLASH_BF16_STEPS), ("fp32", FLASH_FP32_STEPS)):
        out = os.path.join(work, f"run_{prec}")
        extra = (["--validation_steps", str(steps), "--validation_prompts", FLASH_PROMPT,
                  "--num_validation_images", "1"] if prec == "bf16" else [])
        # Every bf16 K1 call of the run is wgmma or wgmma_wide; fp32 takes the CUDA cores.
        run = instrumented_train(flash_flags(instance_dir, out, 8, steps, prec == "bf16", *extra),
                                 trace_call=steps - 1,
                                 variants=WGMMA_VARIANTS if prec == "bf16" else {"cuda_cores"})
        dt = "bfloat16" if prec == "bf16" else "float32"
        want_bwd = collections.Counter()
        for key, c in per_step["flash_bwd"].items():
            want_bwd[k2_variant(dt, key[3])] += steps * c
        rounds = 1 if prec == "bf16" else 0
        want = {"flash": steps * n_step["flash"] + rounds * round_k1,
                "flash_bwd": steps * n_step["flash_bwd"],
                "gn": steps * n_step["gn"] + rounds * round_gn,
                "gn_bwd": steps * n_step["gn_bwd"]}
        m = run["metrics"]
        ev = run["events"]
        step_ms = [ev[i - 1].elapsed_time(ev[i]) for i in range(1, len(ev))]
        busy = sum(run["kernel_ms"].values())
        port_ms = {name: sum(ms for key, ms in run["kernel_ms"].items()
                             if any(tag in key for tag in tags))
                   for name, tags in (("flash_attention_fwd", ("flash_fwd",)),
                                      ("flash_attention_bwd", ("flash_bwd", "dq_kernel",
                                                               "dkdv_kernel")),
                                      ("group_norm", ("group_norm",)))}
        print(f"[flash run] sd15 512 px batch 8 {prec} --attention_impl flash, {steps} steps"
              f"{', a validation round of one image at step ' + str(steps) if rounds else ''} in "
              f"{run['run_s']:.1f} s (model init, validation and export included): loss "
              f"{m['loss']:.6g}, kpl {m['kpl']:.3g}, grad_norm {m['grad_norm']:.3g}; steps 2.. "
              f"{[round(x, 1) for x in step_ms]} ms (CUDA events); traced step {steps}: "
              f"{run['traced_wall_ms']:.1f} ms wall, {busy:.1f} ms of kernels (idle "
              f"{1 - busy / run['traced_wall_ms']:.3f}), flash fwd "
              f"{port_ms['flash_attention_fwd']:.1f} ms, flash bwd "
              f"{port_ms['flash_attention_bwd']:.1f} ms; launches {run['launches']} (expected "
              f"{want}); K1 by variant {run['variants']}, K2 {run['bwd_variants']}; {smi}",
              flush=True)
        for name, ms in run["kernel_ms"].most_common(6):
            print(f"[flash run]   {ms:8.2f} ms  {name[:100]}", flush=True)
        if run["launches"] != want:
            raise AssertionError(f"the {prec} flash run launched {run['launches']}, "
                                 f"expected {want}")
        if run["bwd_variants"] != dict(want_bwd):
            raise AssertionError(f"the {prec} flash run's K2 launches went through "
                                 f"{run['bwd_variants']}, expected {dict(want_bwd)}")
        if m["steps"] != steps or not all(math.isfinite(m[key]) for key in (
                "loss", "kpl", "grad_norm", "added_embedding_norm")):
            raise AssertionError(f"the {prec} flash run returned {m}")
        names = ["text_encoder/adapter_model.safetensors", "text_encoder/adapter_config.json",
                 "v*.bin", "training.log"] + ([f"validation_{steps}.jpg"] if rounds else [])
        for name in names:
            if not os.path.isfile(os.path.join(out, name)):
                raise AssertionError(f"the {prec} flash run wrote no {name}")
        runs[prec] = {"launches": run["launches"], "variants": run["variants"],
                      "bwd_variants": run["bwd_variants"], "run_s": run["run_s"],
                      "steps_ms": step_ms, "traced_step_wall_ms": run["traced_wall_ms"],
                      "traced_step_kernel_ms": busy, "traced_port_kernel_ms": port_ms,
                      "final_loss": m["loss"], "shapes": run["shapes"]}
        shutil.rmtree(out)
        gc.collect()
        torch.cuda.empty_cache()

    # e. every kernel at every shape the runs gave it ---------------------------
    part_s["runs"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    form_keys = {(b, n, h, d, mm, dt) for _, b, n, h, d, mm, kv, dt, _, _ in FLASH_BWD_FORMS
                 if kv == mm}
    fwd_form_keys = {(b, n, h, d, mm, dt) for _, b, n, h, d, mm, dt, _, _ in FLASH_FWD_FORMS}
    k1_err = k2_err = 0.0
    held_now = {"k1": [], "k2": []}
    for prec, dt in (("bf16", "bfloat16"), ("fp32", "float32")):
        dtype = getattr(torch, dt)
        shapes = runs[prec].pop("shapes")
        k1_new = sorted(k for k in set(shapes["flash"]) - (held["flash"] if prec == "bf16" else set())
                        if (*k, dt) not in fwd_form_keys)
        k1_err = max(k1_err, check_flash_forward(gen, k1_new, dtype) if k1_new else 0.0)
        held_now["k1"] += [(*k, dt) for k in k1_new]
        bwd = sorted(k for k in set(shapes["flash_bwd"])
                     if (*k, dt) not in form_keys
                     and not (prec == "bf16" and k in held["flash_bwd"]))
        for b, n, h, d, mm in bwd:
            text, err = check_flash_backward_form(gen, b, n, h, d, mm, mm, dtype,
                                                  k2_variant(dt, d))
            k2_err = max(k2_err, err)
            print(f"[flash_bwd] the {prec} run's B,N,H,D,M={b},{n},{h},{d},{mm}: {text}",
                  flush=True)
        held_now["k2"] += [(*k, dt) for k in bwd]
        runs[prec]["k2_per_step"] = {str(k): c / (FLASH_BF16_STEPS if prec == "bf16"
                                                  else FLASH_FP32_STEPS)
                                     for k, c in shapes["flash_bwd"].items()}
        if prec == "fp32":
            gn_err = check_group_norm_fp32(gen, set(shapes["gn"]), set(shapes["gn_bwd"]))
            print(f"[flash kernels] K3 / K4 in fp32 at the fp32 run's {len(shapes['gn'])} / "
                  f"{len(shapes['gn_bwd'])} GroupNorm keys against their plain versions "
                  f"(atol = rtol = {GN_FP32_TOL}): max|err| {gn_err:.3g}", flush=True)
        torch.cuda.empty_cache()
    part_s["held"] = time.perf_counter() - t_part
    phase_s = time.perf_counter() - t_phase
    print(f"[flash kernels] held now: K1 at {held_now['k1']}, K2 at {held_now['k2']} (and the "
          f"{len(FLASH_FWD_FORMS)} K1 and {len(FLASH_BWD_FORMS)} K2 forms above); K2 launches a "
          f"step by shape, bf16 "
          f"{runs['bf16']['k2_per_step']}, fp32 {runs['fp32']['k2_per_step']}", flush=True)
    print(f"[flash] the whole phase in {phase_s:.1f} s (forms {part_s['forms']:.1f}, parity "
          f"{part_s['parity']:.1f}, runs {part_s['runs']:.1f}, the runs' shapes "
          f"{part_s['held']:.1f}); {smi}", flush=True)
    return {"launches": {prec: r["launches"] for prec, r in runs.items()},
            "derived_per_step": n_step, "derived_round_k1": round_k1,
            "k2_forms": forms["rows"], "k1_forms": fwd_forms["rows"],
            "k1_max_abs_err": max(k1_err, fwd_forms["max_abs_err"]),
            "k2_max_abs_err": max(k2_err, forms["max_abs_err"]), "gn_fp32_max_abs_err": gn_err,
            "parity": parity, "runs": runs, "phase_s": phase_s, "part_s": part_s}


def group_norm_calls(model: str, unet_batch: int = 8, decode_batch: int = 4,
                     encode_batch: int = 8):
    """The GroupNorm calls of the port's main paths at `model`'s full width,
    found by running its UNet and VAE on the meta device (shapes only: no
    memory, no arithmetic), at the main paths' batches: by default the UNet
    at 8 (four seeds under CFG; the train step), the VAE decoder at 4, the
    encoder at 8; a validation round of the paper's run samples at other
    batches (`paper_validation_batches`).  Returns {"unet": one UNet forward, "unet_backward": the UNet norms a
    train step's backward runs through (those downstream of the text, the
    trainable input), "decode": one VAE decode, "encode": one VAE encode},
    each a Counter of (shape, groups, eps, silu) -> calls."""
    import torch

    from textboost_torch.models.configs import get_spec
    from textboost_torch.models.layers import GroupNorm, set_impl
    from textboost_torch.models.unet import UNet2DCondition
    from textboost_torch.models.vae import AutoencoderKL

    spec = get_spec(model)
    with torch.device("meta"):
        unet, vae = UNet2DCondition(spec.unet), AutoencoderKL(spec.vae)
    calls = {name: collections.Counter() for name in ("unet", "unet_backward", "decode", "encode")}
    part = ["unet"]

    def record(mod, args):
        key = (tuple(args[0].shape), mod.num_groups, mod.eps, mod.silu)
        calls[part[0]][key] += 1
        if args[0].requires_grad:
            calls["unet_backward"][key] += 1

    for net in (unet, vae):
        net.requires_grad_(False)
        set_impl(net, "math")  # the kernels take no meta tensors
        for m in net.modules():
            if isinstance(m, GroupNorm):
                m.register_forward_pre_hook(record)
    s, r, meta = spec.unet.sample_size, spec.resolution, torch.device("meta")
    ctx = torch.empty(unet_batch, 77, spec.unet.cross_attention_dim, device=meta,
                      requires_grad=True)
    unet(torch.empty(unet_batch, spec.unet.in_channels, s, s, device=meta),
         torch.zeros(unet_batch, dtype=torch.long, device=meta), ctx)
    with torch.no_grad():
        part[0] = "decode"
        vae.decode(torch.empty(decode_batch, spec.vae.latent_channels, s, s, device=meta))
        part[0] = "encode"
        vae.encode_moments(torch.empty(encode_batch, 3, r, r, device=meta))
    return calls


def flash_key(mod, args, impl: str):
    """The flash kernels' key (B, N, H, D, M) of an attention layer's call
    (a forward pre-hook's module and args) under `impl` ("auto", in bf16, or
    "flash", which serves every dtype), or None where the call takes the
    math path."""
    import torch

    from textboost_torch.models.layers import VAEAttention
    from textboost_torch.ops.attention import use_flash
    from textboost_torch.ops.flash_attention import supports_flash

    x = args[0]
    if isinstance(mod, VAEAttention):
        b, c, h, w = x.shape
        n, heads, d, m = h * w, 1, c, h * w
    else:  # CrossAttention: self-attention, or cross-attention over args[1]
        b, n, _ = x.shape
        heads, d = mod.heads, mod.to_q.out_features // mod.heads
        m = args[1].shape[1] if len(args) > 1 and args[1] is not None else n
    serves = (supports_flash(n, m, d) if impl == "flash"
              else use_flash("cuda", n, m, d, torch.bfloat16, False, False))
    return (b, n, heads, d, m) if serves else None


def sampling_flash_calls(model: str, unet_batch: int, decode_batch: int) -> dict:
    """The flash forward's calls of one UNet forward (a sampling step under
    CFG) and one VAE decode at `model`'s full width under
    `--attention_impl flash`, found on the meta device: {"unet", "decode"},
    Counters of (B, N, H, D, M)."""
    import torch

    from textboost_torch.models.configs import get_spec
    from textboost_torch.models.layers import CrossAttention, VAEAttention, set_impl
    from textboost_torch.models.unet import UNet2DCondition
    from textboost_torch.models.vae import AutoencoderKL

    spec = get_spec(model)
    with torch.device("meta"):
        unet, vae = UNet2DCondition(spec.unet), AutoencoderKL(spec.vae)
    calls = {"unet": collections.Counter(), "decode": collections.Counter()}
    part = ["unet"]

    def hook(mod, args):
        key = flash_key(mod, args, "flash")
        if key is not None:
            calls[part[0]][key] += 1

    for net in (unet, vae):
        set_impl(net, "math")  # the kernels take no meta tensors
        for m in net.modules():
            if isinstance(m, (CrossAttention, VAEAttention)):
                m.register_forward_pre_hook(hook)
    s, meta = spec.unet.sample_size, torch.device("meta")
    with torch.no_grad():
        unet(torch.empty(unet_batch, spec.unet.in_channels, s, s, device=meta),
             torch.zeros(unet_batch, dtype=torch.long, device=meta),
             torch.empty(unet_batch, 77, spec.unet.cross_attention_dim, device=meta))
        part[0] = "decode"
        vae.decode(torch.empty(decode_batch, spec.vae.latent_channels, s, s, device=meta))
    return calls


def train_step_calls(model: str, unet_batch: int, encode_batch: int, *,
                     checkpointing: bool, cross_lora_rank: int, tp: int = 1,
                     impl: str = "auto") -> dict:
    """The kernel calls of one train step at `model`'s full width, found by
    running its UNet forward and backward (the text and the UNet's LoRA
    trainable, `gradient_checkpointing` as given) and its VAE encoder on the
    meta device: {"flash", "flash_bwd", "gn", "gn_bwd"}, each a Counter of
    the kernel wrappers' keys (flash (B, N, H, D, M); GroupNorm (shape,
    groups, eps, silu)); at `tp` > 1 the UNet is rank 0's shard of a tp
    group (its attentions at their local heads).  The forward kernels count the forward's calls and
    those the checkpointed blocks' recompute makes in the backward (torch
    runs it for the blocks that saved something: not for one whose inputs
    and parameters need no gradient); the backward kernels count the
    forward calls whose input needs a gradient.  `impl` is the attention
    layers' ("auto", counted in bf16, or "flash": `--attention_impl flash`,
    the cross-attention over the text included)."""
    import torch

    from textboost_torch.models.configs import get_spec
    from textboost_torch.models.layers import CrossAttention, GroupNorm, VAEAttention, set_impl
    from textboost_torch.models.unet import UNet2DCondition
    from textboost_torch.models.vae import AutoencoderKL
    from textboost_torch.parallel.tensor import TensorParallel, shard_

    spec = get_spec(model)
    with torch.device("meta"):
        unet = UNet2DCondition(spec.unet, cross_lora_rank=cross_lora_rank)
        vae = AutoencoderKL(spec.vae)
    if tp > 1:
        shard_(unet, TensorParallel(None, tp, 0))
    calls = {name: collections.Counter() for name in ("flash", "flash_bwd", "gn", "gn_bwd")}
    forward = [True]

    def record(kind, key, x):
        calls[kind][key] += 1
        if forward[0] and x.requires_grad:
            calls[kind + "_bwd"][key] += 1

    def gn_hook(mod, args):
        record("gn", (tuple(args[0].shape), mod.num_groups, mod.eps, mod.silu), args[0])

    def attn_hook(mod, args):
        key = flash_key(mod, args, impl)
        if key is not None:
            # A call needs a gradient where its queries do, or (cross-attention)
            # its keys from the trainable text do.
            grad = args[0] if len(args) == 1 or args[1] is None else (
                args[0] if args[0].requires_grad else args[1])
            record("flash", key, grad)

    for net in (unet, vae):
        net.requires_grad_(False)
        set_impl(net, "math")  # the kernels take no meta tensors
        for m in net.modules():
            if isinstance(m, GroupNorm):
                m.register_forward_pre_hook(gn_hook)
            elif isinstance(m, (CrossAttention, VAEAttention)):
                m.register_forward_pre_hook(attn_hook)
    for name, p in unet.named_parameters():
        p.requires_grad_(".lora_" in name)
    unet.gradient_checkpointing = checkpointing
    s, r, meta = spec.unet.sample_size, spec.resolution, torch.device("meta")
    ctx = torch.empty(unet_batch, 77, spec.unet.cross_attention_dim, device=meta,
                      requires_grad=True)
    out = unet(torch.empty(unet_batch, spec.unet.in_channels, s, s, device=meta),
               torch.zeros(unet_batch, dtype=torch.long, device=meta), ctx)
    with torch.no_grad():
        vae.encode_moments(torch.empty(encode_batch, 3, r, r, device=meta))
    forward[0] = False
    out.float().sum().backward()
    return calls


def paper_validation_batches() -> dict:
    """The batches of a validation round of the paper's run: the UNet
    samples every image of every prompt under CFG (2 x prompts x images),
    the VAE decodes them all at once."""
    images = len(PAPER_PROMPTS) * PAPER_VALIDATION_IMAGES
    return {"unet_batch": 2 * images, "decode_batch": images}


def drop_last_rank(t, plan, groups: int):
    """`t` [B, C, *spatial] with the last cluster rank's chunk of every
    (sample, group) span set to 0, and that chunk's first element.  Given
    x so changed (or, backward, dy), the plain GroupNorm sums only what a
    kernel that leaves out the last rank's partial sums adds up; before
    that element its output is that kernel's output."""
    start = (plan.cluster - 1) * plan.chunk
    spans = t.reshape(t.shape[0], groups, -1).clone()
    spans[..., start:] = 0
    return spans.reshape(t.shape), start


def group_norm_bound(shape, groups: int, backward: bool) -> dict:
    """The bound of one GroupNorm launch over a bf16 `shape`: x (and dy) read
    once, y (or dx) written once, gamma and beta read, mean and rstd written
    (or read); about 8 fp32 operations per element forward, 20 backward."""
    b, c = shape[:2]
    numel = math.prod(shape)
    nbytes = (3 if backward else 2) * numel * 2 + 2 * c * 4 + 2 * b * groups * 4
    floors = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
              "operations": (20 if backward else 8) * numel / H100_FP32_FLOPS * 1e3}
    name = max(floors, key=floors.get)
    return {"bytes": nbytes, "bound_ms": floors[name], "bound_by": name}


L2_ROTATE_BYTES = 100 * 2**20  # inputs rotated over twice the 50 MB L2 for the L2-cold times


def group_norm_table(gen, keys, launches: dict, backward: bool, timed: bool = True):
    """K3 (or K4, `backward`) at each (shape, groups, eps, silu) of `keys`,
    bf16: against its plain version under the GroupNorm limits, two calls
    bit-identical; its plan; its time L2-warm (the same inputs again) and
    L2-cold (inputs rotated over more than the L2); where the plan holds the
    chunk in registers, also the L2-warm time of the plan that holds it in
    shared memory instead (checked against the plain version too); the
    library's time (`F.group_norm`; backward:
    `aten.native_group_norm_backward`, the input gradient F.group_norm's
    autograd runs; neither has the SiLU); its bound; for a streamed plan the
    bytes it reads twice by design.  `launches[key]` is {path: launches}.
    Without `timed` the kernel is held (both plans where there are two) and
    no time is taken (the rows' times are None).
    Returns ({key: row}, max |error|)."""
    import itertools

    import torch
    import torch.nn.functional as F

    from textboost_torch.ops import group_norm as gn

    dev, bf16 = gen.device, torch.bfloat16
    tag = "group_norm_bwd" if backward else "group_norm"
    library = "native_group_norm_backward" if backward else "F.group_norm"
    k_max = gn.max_cluster_of(gn.BWD_SOURCE if backward else gn.SOURCE)
    planner = gn.plan_group_norm
    rows, worst = {}, 0.0
    for key in sorted(keys):
        shape, groups, eps, silu = key
        b, c = shape[:2]
        hw = math.prod(shape[2:])
        plan = planner(b, c, groups, hw, bf16, backward, k_max)
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(bf16)
        ga = torch.randn(c, generator=gen, device=dev) * 0.2 + 1
        be = torch.randn(c, generator=gen, device=dev) * 0.1
        if backward:
            dy = torch.randn(shape, generator=gen, device=dev).to(bf16)
            _, mu, rs = gn.group_norm_forward(x, ga, be, groups, eps=eps, silu=silu)
            ref = gn.group_norm_backward_reference(x, ga, be, mu, rs, dy, groups, eps, silu).float()

            def kernel(xx, dd):
                return gn.group_norm_backward(xx, ga, be, mu, rs, dd, groups, eps, silu)

            def check(out):
                err = (out.float() - ref).abs()
                return err, bool((err <= GN_BWD_ATOL + GN_BWD_RTOL * ref.abs()).all())

            inputs = (x, dy)
            # The library's input gradient: the op F.group_norm's autograd runs.
            ga16, be16 = ga.to(bf16), be.to(bf16)
            _, lmu, lrs = torch.ops.aten.native_group_norm(x, ga16, be16, b, c, hw, groups, eps)
            library_ms = cuda_ms(lambda: torch.ops.aten.native_group_norm_backward(
                dy, x, lmu, lrs, ga16, b, c, hw, groups, [True, False, False]), 10) \
                if timed else None
            del lmu, lrs
        else:
            ry, rmu, rrs = gn.group_norm_reference(x, ga, be, groups, eps, silu)
            ry = ry.float()

            def kernel(xx):
                return gn.group_norm_forward(xx, ga, be, groups, eps=eps, silu=silu)

            def check(out):
                err = (out[0].float() - ry).abs()
                ok = bool((err <= GN_ATOL + GN_RTOL * ry.abs()).all())
                ok &= bool(((out[1] - rmu).abs() <= GN_STAT_RTOL * rmu.abs() + 1e-6).all())
                ok &= bool(((out[2] - rrs).abs() <= GN_STAT_RTOL * rrs).all())
                return err, ok

            inputs = (x,)
            ga16, be16 = ga.to(bf16), be.to(bf16)
            library_ms = cuda_ms(lambda: F.group_norm(x, groups, ga16, be16, eps), 10) \
                if timed else None
        out, again = kernel(*inputs), kernel(*inputs)
        torch.cuda.synchronize()
        pairs = zip(out, again) if isinstance(out, tuple) else [(out, again)]
        same = all(torch.equal(u, v) for u, v in pairs)
        err, ok = check(out)
        if not ok:
            raise AssertionError(f"{tag} disagrees with its plain version at {key}")
        if not same:
            raise AssertionError(f"two calls of {tag} on the same inputs differ at {key}")
        worst = max(worst, err.max().item())
        del out, again, err
        warm = cuda_ms(lambda: kernel(*inputs), 10) if timed else None
        shared_ms = None
        if plan.regs:
            shared = gn.split_span(plan.span, plan.elem_bytes, plan.tensors, plan.vector,
                                   plan.cluster, registers=False)
            gn.plan_group_norm = lambda *args, **kwargs: shared
            try:
                if not check(kernel(*inputs))[1]:
                    raise AssertionError(f"{tag} in shared memory disagrees with its plain "
                                         f"version at {key}")
                if timed:
                    shared_ms = cuda_ms(lambda: kernel(*inputs), 10)
            finally:
                gn.plan_group_norm = planner
        cold = None
        if timed:
            in_bytes = sum(t.numel() * t.element_size() for t in inputs)
            copies = [tuple(t.clone() for t in inputs)
                      for _ in range(max(2, -(-L2_ROTATE_BYTES // in_bytes)))]
            rotation = itertools.cycle(copies)
            cold = cuda_ms(lambda: kernel(*next(rotation)), max(10, len(copies)))
            del copies, rotation
        rows[key] = {"plan": plan, "ms": warm, "cold_ms": cold, "shared_memory_ms": shared_ms,
                     "library_ms": library_ms, **group_norm_bound(shape, groups, backward),
                     "launches": launches[key]}
        shared_note = "" if shared_ms is None else f" (in shared memory {shared_ms:.4f})"
        times = (f"ms {warm:.4f} warm{shared_note} {cold:.4f} cold; " if timed else
                 "held (both plans where there are two), not timed; ")
        print(f"[{tag}] {'x'.join(map(str, shape))} G={groups} eps={eps:g} silu={int(silu)}: "
              f"k={plan.cluster} {holds(plan)} {plan.threads} thr; {times}bound_ms "
              f"{rows[key]['bound_ms']:.4f} ({rows[key]['bytes']} bytes); "
              + (f"{library} {library_ms:.4f}; " if timed else "")
              + f"launches {launches[key]}", flush=True)
        if plan.streamed:
            print(f"[{tag} plan] {'x'.join(map(str, shape))}: streamed, re-reads "
                  f"{plan.reread_bytes(b, groups)} bytes by design (the plan's arithmetic, "
                  f"not measured)", flush=True)
        del x, inputs
        torch.cuda.empty_cache()
    return rows, worst


def register_sums(rows: dict, path: str) -> dict:
    """Launch-weighted ms per `path` of the shapes whose plan holds the chunk
    in registers, with registers and with the same plan in shared memory."""
    held = [r for r in rows.values() if r["shared_memory_ms"] is not None]
    return {"launches": sum(r["launches"].get(path, 0) for r in held),
            "registers_ms": sum(r["launches"].get(path, 0) * r["ms"] for r in held),
            "shared_memory_ms": sum(r["launches"].get(path, 0) * r["shared_memory_ms"]
                                    for r in held)}


def holds(plan) -> str:
    """Where a GroupNorm plan keeps its chunk between the sums and the output."""
    if plan.regs:
        return f"registers x{plan.regs}"
    return "streamed" if plan.streamed else "shared memory"


def group_norm_json(row: dict) -> dict:
    """The numbers of one row of `group_norm_table` for the kernels line."""
    plan = row["plan"]
    return {"ms": row["ms"], "cold_ms": row["cold_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "cluster": plan.cluster, "holds": holds(plan)}


HOST_CALLS = 3000


def group_norm_host_us(gen) -> dict:
    """Host microseconds per call of the GroupNorm launch plan, built anew
    (`plan_group_norm.__wrapped__`) and from its cache, and of the forward
    wrapper with each, at the UNet's 8x1280x8x8 (its kernel, a few us,
    keeps up with the host, so the loop's time on the host's clock is the
    host's): two rounds, in the order new, cached, cached, new."""
    import torch

    from textboost_torch.ops import group_norm as gn

    cached = gn.plan_group_norm
    built = {"new": cached.__wrapped__, "cached": cached}
    args = (8, 1280, 32, 64, torch.bfloat16, False, gn.max_cluster_of(gn.SOURCE))
    x = torch.randn(8, 1280, 8, 8, generator=gen, device=gen.device).to(torch.bfloat16)
    ga, be = torch.ones(1280, device=gen.device), torch.zeros(1280, device=gen.device)
    out = {f"{what}_{name}": [] for what in ("plan", "forward") for name in built}
    try:
        for name in ("new", "cached", "cached", "new"):
            plan = built[name]
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                plan(*args)
            out[f"plan_{name}"].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            gn.plan_group_norm = plan
            with torch.no_grad():
                for _ in range(100):
                    gn.group_norm_forward(x, ga, be, 32)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    gn.group_norm_forward(x, ga, be, 32)
                out[f"forward_{name}"].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
                torch.cuda.synchronize()
    finally:
        gn.plan_group_norm = cached
    return {key: sum(v) / len(v) for key, v in out.items()}


def group_norm_control(gen, key, backward: bool) -> None:
    """The GroupNorm limits must fail a kernel that leaves out one cluster
    rank's partial sums, at `key`'s shape: the plain version given x (or,
    backward, dy) with that rank's chunks set to 0 (`drop_last_rank`),
    compared where its output is that kernel's."""
    import torch

    from textboost_torch.ops import group_norm as gn

    dev, bf16 = gen.device, torch.bfloat16
    shape, groups, eps, silu = key
    b, c = shape[:2]
    plan = gn.plan_group_norm(b, c, groups, math.prod(shape[2:]), bf16, backward,
                              gn.max_cluster_of(gn.BWD_SOURCE if backward else gn.SOURCE))
    if plan.cluster < 2:
        raise AssertionError(f"the control needs a split span; the plan at {key} has one CTA")
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(bf16)
    ga = torch.randn(c, generator=gen, device=dev) * 0.2 + 1
    be = torch.randn(c, generator=gen, device=dev) * 0.1
    if backward:
        dy = torch.randn(shape, generator=gen, device=dev).to(bf16)
        _, mu, rs = gn.group_norm_reference(x, ga, be, groups, eps, silu)
        ref = gn.group_norm_backward_reference(x, ga, be, mu, rs, dy, groups, eps, silu)
        dropped, start = drop_last_rank(dy, plan, groups)
        got = gn.group_norm_backward_reference(x, ga, be, mu, rs, dropped, groups, eps, silu)
        atol, rtol = GN_BWD_ATOL, GN_BWD_RTOL
    else:
        ref = gn.group_norm_reference(x, ga, be, groups, eps, silu)[0]
        dropped, start = drop_last_rank(x, plan, groups)
        got = gn.group_norm_reference(dropped, ga, be, groups, eps, silu)[0]
        atol, rtol = GN_ATOL, GN_RTOL
    ref, got = (t.float().reshape(b, groups, -1)[..., :start] for t in (ref, got))
    passes = bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())
    print(f"[{'group_norm_bwd' if backward else 'group_norm'}] control at {key}: rank "
          f"{plan.cluster - 1} of {plan.cluster} dropped, max|err| "
          f"{(got - ref).abs().max().item():.3g}; fails the limits: {not passes}", flush=True)
    if passes:
        raise AssertionError(f"the GroupNorm limits would pass a kernel that drops a cluster "
                             f"rank's partial sums at {key}")


def graph_kernel_names(raw_graph: int) -> collections.Counter:
    """{function name: kernel nodes} of a captured cudaGraph_t (the one
    `torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()` returns), read
    through libcuda's graph calls (cuGraphGetNodes, cuFuncGetName): what
    every replay of the graph launches."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] + [
            (f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x", "block_y",
                                         "block_z", "shared_mem")] + [
            ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
            ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUresult {rc}")

    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
              "cuGraphKernelNodeGetParams_v2")
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
                  "cuKernelGetName")
        names[name.value.decode()] += 1
    return names


def tagged_counts(names: collections.Counter) -> dict:
    """{wrapper: {kernel name tag: count}} of kernel names (TRACE_TAGS)."""
    return {wrapper: {tag: sum(n for name, n in names.items() if tag in name) for tag in tags}
            for wrapper, tags in TRACE_TAGS.items()}


@contextlib.contextmanager
def kernel_calls(what: str, variants=WGMMA_VARIANTS, graph_nodes: bool = False):
    """Record the shape of every call of the four kernel wrappers, with the
    launch counts set to 0 on entry.  Yields a dict that holds, on exit,
    "shapes" (flash (B, N, H, D, M); GroupNorm (shape, groups, eps, silu),
    the keys of the checks), "launches", "variants" (the flash forward's,
    all of which must be in `variants`: by default the wgmma ones),
    "bwd_variants" (the flash backward's) and "graphs" (the CUDA graphs
    captured: kind, replays; with `graph_nodes`, the kernel nodes each
    holds by TRACE_TAGS, read from the graph itself: `graph_kernel_names`);
    calls must equal launches.  A CUDA graph's
    replay makes no Python call: the calls its capture recorded are taken
    back when it ends (it launched nothing) and added at each replay, as
    the graph does with the launch counts (textboost_torch/graphs.py)."""
    import torch

    from textboost_torch.ops import flash_attention as fa
    from textboost_torch.ops import group_norm as gn
    from textboost_torch import graphs as graph_mod

    shapes = {name: collections.Counter() for name in ("flash", "flash_bwd", "gn", "gn_bwd")}
    wrappers = {"flash": (fa, "flash_attention_forward"),
                "flash_bwd": (fa, "flash_attention_backward"),
                "gn": (gn, "group_norm_forward"), "gn_bwd": (gn, "group_norm_backward")}
    real = {name: getattr(mod, attr) for name, (mod, attr) in wrappers.items()}

    def recording(name):
        def call(*args, **kwargs):
            if name.startswith("flash"):
                q, k = args[:2]
                key = (*q.shape, k.shape[1])
            elif name == "gn":
                key = (tuple(args[0].shape), args[3], kwargs["eps"], kwargs["silu"])
            else:
                key = (tuple(args[0].shape), *args[6:9])
            shapes[name][key] += 1
            return real[name](*args, **kwargs)
        return call

    real_capture, real_replay = graph_mod.Graph.capture, graph_mod.Graph.replay
    real_cuda_graph = torch.cuda.CUDAGraph
    graphs = []

    def capture(self, fn):
        before = {name: collections.Counter(c) for name, c in shapes.items()}
        try:
            out = real_capture(self, fn)
            if graph_nodes:
                self.graph.instantiate()
                self.nodes = tagged_counts(graph_kernel_names(self.graph.raw_cuda_graph()))
            return out
        finally:
            self.calls = {name: shapes[name] - before[name] for name in shapes}
            for name, c in shapes.items():
                c.clear()
                c.update(before[name])
            graphs.append(self)

    def replay(self):
        out = real_replay(self)
        for name, c in self.calls.items():
            shapes[name].update(c)
        return out

    for name, (mod, attr) in wrappers.items():
        setattr(mod, attr, recording(name))
    graph_mod.Graph.capture, graph_mod.Graph.replay = capture, replay
    if graph_nodes:  # the captured cudaGraph_t kept, so that its nodes can be read
        torch.cuda.CUDAGraph = lambda: real_cuda_graph(keep_graph=True)
    fa.launches = fa.bwd_launches = gn.launches = gn.bwd_launches = 0
    fa.variant_counts.clear()
    fa.bwd_variant_counts.clear()
    out = {"shapes": shapes}
    try:
        yield out
    finally:
        for name, (mod, attr) in wrappers.items():
            setattr(mod, attr, real[name])
        graph_mod.Graph.capture, graph_mod.Graph.replay = real_capture, real_replay
        torch.cuda.CUDAGraph = real_cuda_graph
    torch.cuda.synchronize()
    out["graphs"] = [{"calls": {k: sum(c.values()) for k, c in g.calls.items()},
                      **({"kernel_nodes": g.nodes} if graph_nodes else {}), **g.stats()}
                     for g in graphs]
    out["launches"] = {"flash": fa.launches, "flash_bwd": fa.bwd_launches, "gn": gn.launches,
                       "gn_bwd": gn.bwd_launches}
    out["variants"] = dict(fa.variant_counts)
    out["bwd_variants"] = dict(fa.bwd_variant_counts)
    if set(out["variants"]) - set(variants) or sum(out["variants"].values()) != fa.launches:
        raise AssertionError(f"{what}'s flash forward launches went through {out['variants']}, "
                             f"not all through {sorted(variants)}")
    if {name: sum(c.values()) for name, c in shapes.items()} != out["launches"]:
        raise AssertionError(f"{what} called the kernel wrappers other than it launched: "
                             f"{out['launches']}")


# What `launches` and `launches_by_path` count in the kernels line.
REPLAYS_COUNTED = ("each wrapper call that launched its kernel, and at each CUDA graph replay "
                   "the launches its capture recorded (the step and the sampling run as graphs, "
                   "textboost_torch/graphs.py)")

# The kernels' names in a torch.profiler trace, by wrapper: K2 launches two
# kernels a call (dQ, then dK and dV).
TRACE_TAGS = {"flash": ("flash_fwd",), "flash_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"),
              "gn": ("group_norm_fwd_kernel",), "gn_bwd": ("group_norm_bwd_kernel",)}


def traced_counts(prof) -> dict:
    """{wrapper: {kernel name tag: launches}} in a torch.profiler trace."""
    import torch

    counts = {name: collections.Counter() for name in TRACE_TAGS}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name, tags in TRACE_TAGS.items():
                for tag in tags:
                    if tag in e.key:
                        counts[name][tag] += e.count
    return {name: dict(c) for name, c in counts.items()}


def check_traced_counts(counts: dict, want: dict, what: str) -> None:
    """Each kernel name `want[wrapper]` times in a trace (K2's two kernels
    each as often as K2 is called)."""
    for name, n in want.items():
        got = {tag: counts[name].get(tag, 0) for tag in TRACE_TAGS[name]}
        if any(v != n for v in got.values()):
            raise AssertionError(f"{what}: {name}'s kernels {got} times, derived {n}")


def instrumented_train(argv, trace_call=None, capture_call=None, on_step=None, run=None,
                       variants=WGMMA_VARIANTS, graph_nodes=False):
    """`run(argv)` (default `textboost_torch.train.main`) with the launch
    counts set to 0 just before and read just after, every kernel call's
    shape recorded (`kernel_calls`, the flash forward's variants in
    `variants`).  The hooks sit around the trainer's per-step call
    (`Trainer.run_step`: the CUDA graph's replay, or the eager step): a
    CUDA event is recorded after each step call; call `trace_call`
    (0-based) is traced with torch.profiler after the queue has drained
    (the kernels' names counted: `traced_counts`); with `graph_nodes`, each
    CUDA graph's kernel nodes are counted too (`kernel_calls`); call `capture_call` has
    its batch and draws copied to the host; `on_step(call, state, batch,
    metrics)` runs after each step call.  Returns the peak allocated and
    reserved bytes too."""
    import torch
    import torch.profiler

    from textboost_torch import train as train_pkg
    from textboost_torch.train import trainer as trainer_mod

    events, traced, captured = [], {}, {}
    real_step = trainer_mod.Trainer.run_step

    def timed_step(self, batch, draws):
        if len(events) == capture_call:
            captured.update({name: {k: v.detach().cpu().clone() for k, v in d.items()}
                             for name, d in (("batch", batch), ("draws", draws))})
        if len(events) == trace_call:
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = real_step(self, batch, draws)
                torch.cuda.synchronize()
                traced["wall_ms"] = (time.perf_counter() - t0) * 1e3
            traced["prof"] = prof
        else:
            out = real_step(self, batch, draws)
        if on_step is not None:
            on_step(len(events), self.state, batch, out)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return out

    trainer_mod.Trainer.run_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    try:
        with kernel_calls("training", variants, graph_nodes) as rec:
            torch.cuda.synchronize()
            t0 = time.time()
            metrics = (run or train_pkg.main)(argv)
            torch.cuda.synchronize()
            run_s = time.time() - t0
    finally:
        trainer_mod.Trainer.run_step = real_step
    kernel_ms = collections.Counter()
    if "prof" in traced:
        for e in traced["prof"].key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernel_ms[e.key] += e.self_device_time_total / 1e3
    return {"metrics": metrics, "launches": rec["launches"], "variants": rec["variants"],
            "bwd_variants": rec["bwd_variants"],
            "run_s": run_s, "events": events, "traced_wall_ms": traced.get("wall_ms"),
            "kernel_ms": kernel_ms, "captured": captured, "shapes": rec["shapes"],
            "traced_counts": traced_counts(traced["prof"]) if "prof" in traced else None,
            "graphs": rec["graphs"], "peak_bytes": torch.cuda.max_memory_allocated(),
            "reserved_bytes": torch.cuda.max_memory_reserved()}


def step_graph_check(m: dict, steps: int, what: str, start: int = 0, accumulate: int = 1) -> str:
    """The trainer's result for a run of `steps` steps from step `start`
    inside the capture envelope: WARMUP_STEPS whole steps eager (WARMUP_STEPS
    x `accumulate` micro-steps), then one graph per micro-step position
    (one without accumulation; first, (middle,) last with it), a replay a
    micro-step.  Returns a line of the graphs' numbers."""
    from textboost_torch.train.graph import WARMUP_STEPS

    eager = WARMUP_STEPS * accumulate
    replays = (steps - start - WARMUP_STEPS) * accumulate
    n_graphs = min(accumulate, 3)
    if (m["step_graph"] != "captured" or m["step_graph_eager_steps"] != eager
            or m["step_graph_replays"] != replays or m["step_graph_graphs"] != n_graphs):
        raise AssertionError(f"{what}: the step ran {m['step_graph']}, "
                             f"{m.get('step_graph_eager_steps')} eager micro-steps, "
                             f"{m.get('step_graph_graphs')} graphs and "
                             f"{m.get('step_graph_replays')} replays, not captured after "
                             f"{eager} in {n_graphs} with {replays}")
    return (f"step graph{'s' if n_graphs > 1 else ''} ({n_graphs}) captured after {eager} eager "
            f"micro-steps in {m['step_graph_capture_ms']:.1f} ms, pool "
            f"{m['step_graph_pool_bytes'] / 2**30:.2f} GiB, {replays} replays")


def train_main_path(instance_dir: str, output_dir: str):
    """The sd15 training main path: TRAIN_STEPS steps at batch 8, steps 1-3
    eager, step 4 the capture and its replay, then replays; the warm step
    averages the replays of steps 5-9 (`warm_step_ms`) and the eager steps
    2-3 (`eager_step_ms`); the last step (a replay) is traced."""
    tr = instrumented_train(train_flags(instance_dir, output_dir, 8, TRAIN_STEPS),
                            trace_call=TRAIN_STEPS - 1)
    events = tr.pop("events")
    # Step s runs between events s-2 and s-1.
    tr["warm_step_ms"] = events[3].elapsed_time(events[TRAIN_STEPS - 2]) / (TRAIN_STEPS - 5)
    tr["eager_step_ms"] = events[0].elapsed_time(events[2]) / 2
    tr["capture_step_ms"] = events[2].elapsed_time(events[3])
    return tr


def paper_flags(instance_dir: str, output_dir: str, *extra):
    """The flags `run_textboost_db.py::build_cmd` passes with the runner's
    defaults (sd21base, 512 px, batch 8, LoRA r=4, lr 1e-4, embedding lr
    1e-3, --augment pda --augment_p 0.5 --augment_inversion, imagenet_small,
    null_prob 0.1, KPL 0.1, bf16, its four validation prompts), cut from 250
    steps and a cadence of 50 to PAPER_STEPS steps and a cadence of
    PAPER_CADENCE; no tracker."""
    return [
        "--model_preset=sd21base", f"--instance_data_dir={instance_dir}",
        f"--output_dir={output_dir}", "--class_token=teapot", "--instance_token=<0>",
        f"--validation_steps={PAPER_CADENCE}", "--placeholder_token=<teapot>",
        "--initializer_token=brown teapot", "--validation_prompts", *PAPER_PROMPTS,
        "--resolution=512", "--lora_rank=4", "--learning_rate=0.0001",
        "--emb_learning_rate=0.001", "--train_batch_size=8", f"--max_train_steps={PAPER_STEPS}",
        f"--checkpointing_steps={PAPER_CADENCE}", "--gradient_accumulation_steps=1",
        "--unet_params_to_train=none", "--augment=pda", "--augment_p=0.5", "--null_prob=0.1",
        "--kpl_weight=0.1", "--template=imagenet_small", "--mixed_precision=bf16",
        "--mesh_tp=1", "--num_samples=1", "--augment_inversion", "--report_to=none",
        "--seed=0", *extra]


def check_native_image_ops(existed_before_run: bool) -> dict:
    """The native bicubic op (built from textboost_torch/csrc/image_ops.cpp,
    at first use, by the paper run's loader unless it was there before) against this machine's PIL: the 25 seeded cases of the CPU
    tests, and adjust_scale at 512 px against its PIL plain version.
    Bit-exact."""
    import numpy as np
    import PIL
    from PIL import Image

    from textboost_torch.data import augment, native

    path = native.library_path()
    if not path.exists():
        raise AssertionError("the paper run's augmentation left no native image library")
    built = not existed_before_run
    native.get_lib()
    rng = np.random.default_rng(3)
    cases = 0
    for _ in range(25):
        w, h = int(rng.integers(8, 90)), int(rng.integers(8, 90))
        src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        inv = 1.0 / rng.uniform(0.3, 2.0)
        pad_w, pad_h = int(rng.integers(0, 25)), int(rng.integers(0, 25))
        pw, ph = w + 2 * pad_w, h + 2 * pad_h
        m2 = inv * (-pw * 0.5) + pw * 0.5 + rng.uniform(-3, 3)
        m5 = inv * (-ph * 0.5) + ph * 0.5 + rng.uniform(-3, 3)
        out_w, out_h = int(rng.integers(4, w + 8)), int(rng.integers(4, h + 8))
        padded = np.pad(src, ((pad_h, pad_h), (pad_w, pad_w), (0, 0)), mode="edge")
        pil = np.asarray(Image.fromarray(padded).transform(
            (out_w, out_h), Image.AFFINE, (inv, 0, m2, 0, inv, m5), resample=Image.BICUBIC))
        got = native.affine_scale_bicubic(src, pad_w, pad_h, out_w, out_h, inv, m2, inv, m5)
        if not np.array_equal(got, pil):
            raise AssertionError(f"the native bicubic op differs from PIL {PIL.__version__}")
        cases += 1
    image = Image.fromarray(rng.integers(0, 256, (512, 512, 3), dtype=np.uint8))
    for trial in range(4):
        plan, _ = augment.plan_adjust_scale(image.size, "x", False,
                                            np.random.default_rng((21, trial)), {})
        if not np.array_equal(np.asarray(augment.exec_adjust_scale(image, plan)),
                              np.asarray(augment.exec_adjust_scale_pil(image, plan))):
            raise AssertionError(f"adjust_scale at 512 px differs from PIL at {plan}")
        cases += 1
    print(f"[native] {path.name} built by the run's workers: {built}; bicubic bit-exact with PIL "
          f"{PIL.__version__} in {cases} seeded cases (25 of the CPU tests, 4 zooms at 512 px)",
          flush=True)
    return {"library": str(path.relative_to(Path(__file__).resolve().parent)),
            "built_by_run": built, "pil": PIL.__version__, "cases": cases}


def loader_host_ms(instance_dir: str, captured: dict) -> float:
    """Host time of one augmented batch (8 samples, one thread) of the paper
    run's dataset, built here as the trainer builds it; its batch 5 must be
    the batch that step 6 of the run trained on."""
    import numpy as np

    from textboost_torch.data.augment import PairedAugmentation
    from textboost_torch.data.datasets import TextBoostDataset
    from textboost_torch.data.tokenizer import load_tokenizer
    from textboost_torch.train.trainer import plan_tokens

    tok = load_tokenizer(None)
    plan = plan_tokens(tok, [{"instance_token": "<0>", "placeholder_token": "<teapot>",
                              "initializer_token": "brown teapot"}], "dog",
                       augment_inversion=True)
    ds = TextBoostDataset(
        [{"instance_data_dir": instance_dir, "instance_token": plan.concept_tokens["<0>"]}],
        tok, num_instance=1, template="imagenet_small", size=512,
        augment_pipe=PairedAugmentation(hflip="inversion", inversion=True, p=0.5,
                                        caption_map=plan.caption_map, seed=0),
        seed=0)
    t0 = time.perf_counter()
    batches = [TextBoostDataset.collate([ds.__getitem__(0, rng=np.random.default_rng((0, step, i)))
                                         for i in range(8)]) for step in range(PAPER_STEPS)]
    ms = (time.perf_counter() - t0) * 1e3 / PAPER_STEPS
    for key in ("pixel_values", "input_ids"):
        if not np.array_equal(batches[5][key].astype(np.int64),
                              captured["batch"][key].numpy().astype(np.int64)):
            raise AssertionError(f"step 6 of the paper run did not train on its dataset's "
                                 f"batch 5 ({key})")
    return ms


def paper_run_phase(gen, card: dict, work: str, gn_rows: dict, gn_bwd_rows: dict) -> dict:
    """The paper's one-shot run at sd21base (see the module docstring): the
    kernels timed at its D = 64 attention shapes, the run, every kernel held
    against its plain version at every shape the run called it at (the
    GroupNorm shapes also derived from the config; `gn_rows` and
    `gn_bwd_rows`, the sd15 tables, are the shapes already held), its
    artifacts, the augmentation, the native image ops, and a resume from
    checkpoint-5."""
    import numpy as np
    import torch
    from PIL import Image

    from textboost_torch.data.tokenizer import load_tokenizer
    from textboost_torch.lora.peft_io import import_token_embeddings, load_safetensors
    from textboost_torch.models.configs import get_spec
    from textboost_torch.train.trainer import plan_tokens

    spec = get_spec("sd21base")
    per_step = expected_train_launches(spec)
    val_launches = expected_launches(spec, 25)
    if per_step != (11, 9, 83, 58) or val_launches != (251, 1555):
        raise AssertionError(f"sd21base spec-derived launch counts {per_step} per train step, "
                             f"{val_launches} per validation round")

    # a. K1 and K2 timed at the run's 64-wide heads ---------------------------
    shapes = {"unet_level0_8x4096x5x64": (8, 4096, 5, 64), "unet_level1_8x1024x10x64": (8, 1024, 10, 64)}
    fwd_t = {name: flash_forward_times(gen, *shp, card) for name, shp in shapes.items()}
    bwd_t = {name: flash_backward_times(gen, *shp, card) for name, shp in shapes.items()}
    for name in shapes:
        f, b = fwd_t[name], bwd_t[name]
        print(f"[paper flash] {name}: forward {f['ms']:.4f} ms (bound {f['bound_ms']:.4f}, "
              f"{f['bound_floor']}; SDPA {f['library_ms']:.4f}; plain {f['plain_ms']:.3f}); "
              f"backward {b['ms']:.4f} ms (bound {b['bound_ms']:.4f}, {b['bound_floor']}; SDPA "
              f"{b['library_ms']:.4f}; plain {b['plain_ms']:.3f})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # b. the run -------------------------------------------------------------
    from textboost_torch.data import native

    native_existed = native.library_path().exists()
    instance_dir = os.path.join(work, "instance")
    os.makedirs(instance_dir)
    write_instance_image(os.path.join(instance_dir, "teapot.png"), seed=1)
    out = os.path.join(work, "run")
    rounds = PAPER_STEPS // PAPER_CADENCE
    # Its two validation rounds are too few for the trainer to capture
    # their sampling; the straight run lowers the threshold so that its
    # second round replays the graph (checked against the resume's eager
    # round below).
    from textboost_torch import graphs as graph_mod

    threshold = graph_mod.VALIDATION_CAPTURE_ROUNDS
    graph_mod.VALIDATION_CAPTURE_ROUNDS = rounds
    try:
        run = instrumented_train(paper_flags(instance_dir, out), trace_call=PAPER_STEPS - 1,
                                 capture_call=PAPER_CADENCE)
    finally:
        graph_mod.VALIDATION_CAPTURE_ROUNDS = threshold
    m = run["metrics"]
    want = {"flash": PAPER_STEPS * per_step[0] + rounds * val_launches[0],
            "flash_bwd": PAPER_STEPS * per_step[1],
            "gn": PAPER_STEPS * per_step[2] + rounds * val_launches[1],
            "gn_bwd": PAPER_STEPS * per_step[3]}
    ev = run["events"]
    # Step s runs between events s-2 and s-1; steps 1-3 run eagerly, step 4
    # captures the graph and replays it, the rest replay; step 6 also holds
    # the checkpoint and the validation round of step 5, step 10 is traced.
    warm = [ev[s - 2].elapsed_time(ev[s - 1]) for s in (5, 7, 8, 9)]
    eager_warm = [ev[s - 2].elapsed_time(ev[s - 1]) for s in (2, 3)]
    capture_step = ev[2].elapsed_time(ev[3])
    graph_line = step_graph_check(m, PAPER_STEPS, "the paper run")
    if m.get("validation_graph") != "captured" or m.get("validation_graph_replays") != rounds - 1:
        raise AssertionError(f"the paper run's validation rounds ran {m.get('validation_graph')} "
                             f"and replayed {m.get('validation_graph_replays')} times, not "
                             f"{rounds - 1}")
    check_traced_counts(run["traced_counts"], dict(zip(("flash", "flash_bwd", "gn", "gn_bwd"),
                                                       per_step)),
                        "the paper run's traced step 10 (a replay)")
    busy = sum(run["kernel_ms"].values())
    port_ms = {name: sum(ms for key, ms in run["kernel_ms"].items() if tag in key)
               for name, tag in (("flash_attention_fwd", "flash_fwd"),
                                 ("flash_attention_bwd", "flash_bwd_"),
                                 ("group_norm_fwd", "group_norm_fwd_kernel"),
                                 ("group_norm_bwd", "group_norm_bwd_kernel"))}
    print(f"[paper] {PAPER_STEPS} steps sd21base 512 px batch 8 bf16, --augment pda "
          f"--augment_inversion, checkpoint and validation every {PAPER_CADENCE}, in "
          f"{run['run_s']:.1f} s (model init, validation and export included): loss "
          f"{m['loss']:.5g}, kpl {m['kpl']:.3g}; warm step captured {np.mean(warm):.1f} ms "
          f"(replays, steps 5, 7-9, CUDA events; each {[round(w, 1) for w in warm]}), eager "
          f"{np.mean(eager_warm):.1f} ms (steps 2-3), step 4 (capture and replay) "
          f"{capture_step:.1f} ms; {graph_line}; validation round 2 replayed the sampler graph "
          f"(capture {m['validation_graph_capture_ms']:.1f} ms, pool "
          f"{m['validation_graph_pool_bytes'] / 2**30:.2f} GiB); peak "
          f"{run['peak_bytes'] / 2**30:.2f} GiB allocated, {run['reserved_bytes'] / 2**30:.2f} "
          f"reserved; launches {run['launches']} (expected {want}, "
          f"replays counted); flash forward by variant {run['variants']}; the traced replay's "
          f"kernels {run['traced_counts']}", flush=True)
    print(f"[paper breakdown] traced step {PAPER_STEPS}: {run['traced_wall_ms']:.1f} ms wall, {busy:.1f} ms "
          f"of kernels (idle {1 - busy / run['traced_wall_ms']:.3f}); " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in port_ms.items()), flush=True)
    for name, ms in run["kernel_ms"].most_common(8):
        print(f"[paper breakdown]   {ms:8.2f} ms  {name[:100]}", flush=True)
    print(f"[paper] checkpoint: snapshot {m['checkpoint_snapshot_ms']:.1f} ms on the loop, write "
          f"{m['checkpoint_write_ms']:.1f} ms on its thread; validation round "
          f"{m['validation_ms']:.1f} ms (16 images, 25 steps, CFG 7.5)", flush=True)
    waits = m["host_wait_ms_by_step"]
    print(f"[paper loader] the loop's wait for host batches: {waits[0]:.1f} ms before step 1 "
          f"(the producers' start), {waits[1]:.2f} ms after step 1, then mean "
          f"{np.mean(waits[2:]):.2f} ms, max {max(waits[2:]):.2f} ms per step "
          f"(each {[round(w, 2) for w in waits[1:]]})", flush=True)
    if run["launches"] != want:
        raise AssertionError(f"the paper run launched {run['launches']}, expected {want}")
    if m["steps"] != PAPER_STEPS or not all(
            math.isfinite(m[k]) for k in ("loss", "kpl", "grad_norm", "added_embedding_norm")):
        raise AssertionError(f"the paper run returned {m}")

    # c. every kernel against its plain version at every shape the run gave it.
    # The GroupNorm calls, derived from the config at the train step's and
    # the validation round's batches, must be the run's.
    gc.collect()
    torch.cuda.empty_cache()
    train_calls = group_norm_calls("sd21base")
    val_calls = group_norm_calls("sd21base", **paper_validation_batches())
    derived = collections.Counter()
    for part, n in (("unet", PAPER_STEPS), ("encode", PAPER_STEPS)):
        derived.update({key: n * c for key, c in train_calls[part].items()})
    for part, n in (("unet", rounds * 25), ("decode", rounds)):
        derived.update({key: n * c for key, c in val_calls[part].items()})
    derived_bwd = collections.Counter(
        {key: PAPER_STEPS * c for key, c in train_calls["unet_backward"].items()})
    seen = run["shapes"]
    if seen["gn"] != derived or seen["gn_bwd"] != derived_bwd:
        raise AssertionError(f"the paper run's GroupNorm calls differ from those derived from "
                             f"the config: forward {dict(seen['gn'] - derived)} / "
                             f"{dict(derived - seen['gn'])}, backward "
                             f"{dict(seen['gn_bwd'] - derived_bwd)} / "
                             f"{dict(derived_bwd - seen['gn_bwd'])}")
    new_rows, gn_err = group_norm_table(gen, set(derived) - set(gn_rows),
                                        {key: {"paper": n} for key, n in derived.items()},
                                        backward=False)
    new_bwd_rows, gn_bwd_err = group_norm_table(
        gen, set(derived_bwd) - set(gn_bwd_rows),
        {key: {"paper": n} for key, n in derived_bwd.items()}, backward=True)
    gn_paper = {}
    for name, calls, rows in (("group_norm_fwd", derived, {**gn_rows, **new_rows}),
                              ("group_norm_bwd", derived_bwd, {**gn_bwd_rows, **new_bwd_rows})):
        gn_paper[name] = {field: sum(n * rows[key][field] for key, n in calls.items())
                          for field in ("ms", "cold_ms", "bound_ms", "library_ms")}
        gn_paper[name]["launches"] = sum(calls.values())
    print(f"[paper group_norm] the run's {len(derived)} forward and {len(derived_bwd)} backward "
          f"(shape, groups, eps, silu) are those derived from the config at batch 8 and at the "
          f"validation batches {paper_validation_batches()}; {len(new_rows)} forward and "
          f"{len(new_bwd_rows)} backward not among the sd15 shapes held above now agree too; "
          f"launch-weighted over the run: " + "; ".join(
              f"{name} {v['launches']} launches {v['ms']:.2f} ms warm, {v['cold_ms']:.2f} cold, "
              f"bound {v['bound_ms']:.2f}, library {v['library_ms']:.2f}"
              for name, v in gn_paper.items()), flush=True)
    k1_err = check_flash_forward(gen, sorted(seen["flash"]))
    k2_err = check_flash_backward(gen, [(b, n, h, d, m, m) for b, n, h, d, m in
                                        sorted(seen["flash_bwd"])])
    timed = {(*shp, shp[1]) for shp in shapes.values()}
    if not timed <= set(seen["flash_bwd"]) <= set(seen["flash"]):
        raise AssertionError(f"the paper run's attention shapes {dict(seen['flash'])} / "
                             f"{dict(seen['flash_bwd'])} do not hold the timed ones")
    print(f"[paper flash] K1 held at each of the run's {len(seen['flash'])} forward shapes "
          f"(B,N,H,D,M: launches) {dict(seen['flash'])}, K2 at its {len(seen['flash_bwd'])} "
          f"backward shapes {dict(seen['flash_bwd'])}", flush=True)

    # d. what the run leaves -------------------------------------------------
    plan = plan_tokens(load_tokenizer(None), [{"instance_token": "<0>",
                                               "placeholder_token": "<teapot>",
                                               "initializer_token": "brown teapot"}], "dog",
                       augment_inversion=True)
    bins = [t.strip("<>") + ".bin" for t in plan.token_to_id]
    adapter = ["text_encoder/adapter_model.safetensors", "text_encoder/adapter_config.json"]
    for step in range(PAPER_CADENCE, PAPER_STEPS + 1, PAPER_CADENCE):
        for name in adapter + bins + ["state.pt", "meta.json"]:
            if not os.path.isfile(os.path.join(out, f"checkpoint-{step}", name)):
                raise AssertionError(f"checkpoint-{step} holds no {name}")
        size = Image.open(os.path.join(out, f"validation_{step}.jpg")).size
        if size != (4 * 512, 4 * 512):
            raise AssertionError(f"validation_{step}.jpg is {size}, not 4 x 4 images of 512 px")
    for name in adapter + bins:
        if not os.path.isfile(os.path.join(out, name)):
            raise AssertionError(f"the run exported no {name}")
    for tok in plan.token_to_id:
        row = torch.load(os.path.join(out, tok.strip("<>") + ".bin"), weights_only=True)[tok]
        shape = (1, 1024) if tok in plan.aug_tokens else (1024,)
        if tuple(row.shape) != shape or not torch.isfinite(row).all():
            raise AssertionError(f"{tok}.bin holds {tuple(row.shape)}, expected {shape}")
    aug = {k[4:]: int(v) for k, v in m.items() if k.startswith("aug:")}
    print(f"[paper] artifacts: checkpoint-5/ and checkpoint-10/ (state, text_encoder/, "
          f"{len(bins)} token bins each), validation_5.jpg and validation_10.jpg 2048x2048, the "
          f"final text_encoder/ and {len(bins)} bins ({len(plan.aug_tokens)} augmentation "
          f"sub-tokens [1, 1024]); captions with augmentation tokens, by op: {aug}", flush=True)
    if aug.get("samples") != 8 * PAPER_STEPS or not aug.get("augmented"):
        raise AssertionError(f"the run's captions carry no augmentation tokens: {aug}")

    # e. the native image ops and the augmented loader's host time ------------
    native_ops = check_native_image_ops(native_existed)
    host_ms = loader_host_ms(instance_dir, run["captured"])
    print(f"[paper] augmented batch on the host: {host_ms:.1f} ms per batch of 8 (one thread); "
          f"its batch 5 is the one step 6 trained on", flush=True)

    # f. resume from checkpoint-5 onto the same trajectory --------------------
    resumed = os.path.join(work, "resumed")
    shutil.copytree(os.path.join(out, f"checkpoint-{PAPER_CADENCE}"),
                    os.path.join(resumed, f"checkpoint-{PAPER_CADENCE}"))
    res = instrumented_train(paper_flags(instance_dir, resumed, "--resume_from_checkpoint=latest"),
                             capture_call=0)
    rest = PAPER_STEPS - PAPER_CADENCE
    # Its steps 6-8 run eagerly where the straight run's replayed.
    res_graph_line = step_graph_check(res["metrics"], PAPER_STEPS, "the resumed run",
                                      start=PAPER_CADENCE)
    want_res = {"flash": rest * per_step[0] + val_launches[0], "flash_bwd": rest * per_step[1],
                "gn": rest * per_step[2] + val_launches[1], "gn_bwd": rest * per_step[3]}
    if res["launches"] != want_res:
        raise AssertionError(f"the resumed run launched {res['launches']}, expected {want_res}")
    first, again = run["captured"], res["captured"]
    same_batch = all(torch.equal(first["batch"][k], again["batch"][k]) for k in first["batch"])
    same_draws = all(torch.equal(first["draws"][k], again["draws"][k]) for k in first["draws"])
    loss_gap = abs(res["metrics"]["loss"] - m["loss"]) / abs(m["loss"])
    lora = [load_safetensors(os.path.join(d, "text_encoder", "adapter_model.safetensors"))
            for d in (out, resumed)]
    rows = [import_token_embeddings([os.path.join(d, b) for b in bins]) for d in (out, resumed)]
    lora_gap = rel_l2(*(torch.cat([torch.from_numpy(t[k]).flatten() for k in sorted(t)])
                        for t in reversed(lora)))
    rows_gap = rel_l2(*(torch.from_numpy(np.stack([r[t] for t in sorted(r)]))
                        for r in reversed(rows)))
    # The step-10 grid: the straight run's replayed sampler graph against the
    # resumed run's eager round, on the same weights.
    grids = [np.asarray(Image.open(os.path.join(d, f"validation_{PAPER_STEPS}.jpg")))
             for d in (out, resumed)]
    same_grid = bool(np.array_equal(*grids))
    res_val = res["metrics"].get("validation_graph", "")
    print(f"[paper resume] step-{PAPER_STEPS} validation grid, the straight run's replay against "
          f"the resume's eager round ({res_val}): "
          f"{'bit-equal' if same_grid else 'DIFFERENT'}", flush=True)
    if not same_grid or not res_val.startswith("eager: "):
        raise AssertionError(f"the validation graph's replay and the eager round differ "
                             f"(the resume's round ran {res_val!r})")
    print(f"[paper resume] from checkpoint-{PAPER_CADENCE} to step {PAPER_STEPS}: step 6's batch "
          f"{'the same bytes' if same_batch else 'DIFFERS'}, its draws (noise, VAE eps, "
          f"timesteps) {'the same bits' if same_draws else 'DIFFER'}; step-10 loss "
          f"{res['metrics']['loss']:.6g} vs {m['loss']:.6g}: relative gap {loss_gap:.3g}; rel L2 "
          f"gap of the exported LoRA {lora_gap:.3g}, of the added rows {rows_gap:.3g}: must all "
          f"be zero (its steps 6-8 eager, the straight run's replays; "
          f"{res_graph_line})", flush=True)
    if not (same_batch and same_draws and loss_gap == lora_gap == rows_gap == 0):
        raise AssertionError("the resumed run left the straight run's trajectory: the eager "
                             "steps and the graph's replays differ")

    # g. gradient accumulation: one graph per micro-step position, and a
    # resume whose eager warm-up holds the replays bit for bit ------------------
    accum = accumulation_pair(instance_dir, work, per_step, set(seen["flash"]),
                              set(seen["flash_bwd"]))
    return {
        "accumulation": accum,
        "launches": run["launches"], "resumed_launches": res["launches"],
        "variants": run["variants"], "run_s": run["run_s"], "resumed_run_s": res["run_s"],
        "warm_step_ms": float(np.mean(warm)), "warm_steps_ms": warm,
        "eager_step_ms": float(np.mean(eager_warm)), "capture_step_ms": capture_step,
        "step_graph": {k: m[k] for k in m if k.startswith(("step_graph", "validation_graph"))},
        "peak_bytes": run["peak_bytes"], "reserved_bytes": run["reserved_bytes"],
        "traced_counts": run["traced_counts"],
        "traced_step_wall_ms": run["traced_wall_ms"], "traced_step_kernel_ms": busy,
        "traced_port_kernel_ms": port_ms, "idle_share": 1 - busy / run["traced_wall_ms"],
        "final_loss": m["loss"], "checkpoint_snapshot_ms": m["checkpoint_snapshot_ms"],
        "checkpoint_write_ms": m["checkpoint_write_ms"], "validation_ms": m["validation_ms"],
        "host_wait_ms_by_step": waits, "loader_host_ms_per_batch": host_ms,
        "group_norm": gn_paper, "gn_max_abs_err": gn_err, "gn_bwd_max_abs_err": gn_bwd_err,
        "augmentation": aug, "native": native_ops,
        "resume": {"same_batch": same_batch, "same_draws": same_draws, "loss_gap": loss_gap,
                   "lora_gap": lora_gap, "rows_gap": rows_gap},
        "k1": fwd_t, "k2": bwd_t, "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_err,
        # What this phase held, for the next one (not printed).
        "held": {"gn_rows": new_rows, "gn_bwd_rows": new_bwd_rows, "flash": set(seen["flash"]),
                 "flash_bwd": set(seen["flash_bwd"])},
    }


def accumulation_pair(instance_dir: str, work: str, per_step, flash_shapes: set,
                      flash_bwd_shapes: set) -> dict:
    """The paper flags at --gradient_accumulation_steps ACCUM (through the
    preset memo the paper run left): a straight run of ACCUM_STEPS steps,
    WARMUP_STEPS of them eager and the rest replays of the first, middle and
    last micro-steps' graphs, with the launches derived per micro-step
    (`per_step`, the paper run's) at the attention shapes the paper run held;
    then its resume from checkpoint-ACCUM_CHECKPOINT, whose micro-steps are
    its eager warm-up, held bit for bit against the replays (losses, the
    exported adapter and rows)."""
    import numpy as np

    from textboost_torch.train.graph import WARMUP_STEPS

    t0 = time.perf_counter()
    out, resumed = os.path.join(work, "accumulation"), os.path.join(work, "accumulation_resumed")

    def flags(output_dir, *extra):
        return paper_flags(instance_dir, output_dir, f"--gradient_accumulation_steps={ACCUM}",
                           f"--max_train_steps={ACCUM_STEPS}",
                           f"--checkpointing_steps={ACCUM_CHECKPOINT}", "--validation_steps=0",
                           *extra)

    run = instrumented_train(flags(out))
    m = run["metrics"]
    line = step_graph_check(m, ACCUM_STEPS, "the accumulation run", accumulate=ACCUM)
    micro = ACCUM_STEPS * ACCUM
    want = dict(zip(("flash", "flash_bwd", "gn", "gn_bwd"), (micro * n for n in per_step)))
    shutil.copytree(os.path.join(out, f"checkpoint-{ACCUM_CHECKPOINT}"),
                    os.path.join(resumed, f"checkpoint-{ACCUM_CHECKPOINT}"))
    res = instrumented_train(flags(resumed, "--resume_from_checkpoint=latest"))
    rm = res["metrics"]
    rest = (ACCUM_STEPS - ACCUM_CHECKPOINT) * ACCUM
    want_res = dict(zip(("flash", "flash_bwd", "gn", "gn_bwd"), (rest * n for n in per_step)))
    gaps = exact_gaps(out, resumed, m["loss_by_step"][ACCUM_CHECKPOINT:], rm["loss_by_step"])
    shapes = (set(run["shapes"]["flash"]) | set(res["shapes"]["flash"]),
              set(run["shapes"]["flash_bwd"]) | set(res["shapes"]["flash_bwd"]))
    pair_s = time.perf_counter() - t0
    # Micro-step k (1-based) ends at event k-1: whole steps 2-3 eager, steps
    # 5-6 replays (step 4 holds the three captures).
    ev = run["events"]
    step_ms = {s: ev[(s - 1) * ACCUM - 1].elapsed_time(ev[s * ACCUM - 1])
               for s in range(2, ACCUM_STEPS + 1)}
    eager_ms = [step_ms[s] for s in range(2, WARMUP_STEPS + 1)]
    replay_ms = [step_ms[s] for s in range(WARMUP_STEPS + 2, ACCUM_STEPS + 1)]
    print(f"[paper accumulation] --gradient_accumulation_steps {ACCUM}, {ACCUM_STEPS} steps "
          f"({micro} micro-steps of batch 8) in {run['run_s']:.1f} s: {line}; a whole step "
          f"replayed {np.mean(replay_ms):.1f} ms (steps {WARMUP_STEPS + 2}-{ACCUM_STEPS}, each "
          f"{[round(x, 1) for x in replay_ms]}), eager {np.mean(eager_ms):.1f} ms (steps "
          f"2-{WARMUP_STEPS}, each {[round(x, 1) for x in eager_ms]}), CUDA events; "
          f"{m['step_graph_graphs']} graphs (first, middle, last); losses by step "
          f"{m['loss_by_step']}; launches {run['launches']} (expected {want}: {per_step} a "
          f"micro-step, replays counted); the resume from checkpoint-{ACCUM_CHECKPOINT} "
          f"({rest} eager micro-steps, {rm['step_graph']!r}) in {res['run_s']:.1f} s: losses "
          f"{rm['loss_by_step']}, largest gaps {gaps} (must all be 0: bit for bit), launches "
          f"{res['launches']} (expected {want_res}); attention shapes {sorted(shapes[0])} "
          f"(held by the paper run); the pair {pair_s:.1f} s", flush=True)
    bits = gaps.pop("bit_equal")
    if not (run["launches"] == want and res["launches"] == want_res and bits
            and not any(gaps.values()) and rm["step_graph"].startswith("eager: the run ended")
            and shapes[0] <= flash_shapes and shapes[1] <= flash_bwd_shapes
            and m["steps"] == ACCUM_STEPS and all(math.isfinite(x) for x in m["loss_by_step"])):
        raise AssertionError("the accumulation pair: the launches, the resume's bits or the "
                             "attention shapes are not as derived")
    return {"launches": run["launches"], "resumed_launches": res["launches"],
            "step_graph": {k: m[k] for k in m if k.startswith("step_graph")},
            "warmup_micro_steps": WARMUP_STEPS * ACCUM, "loss_by_step": m["loss_by_step"],
            "step_ms": step_ms, "replay_step_ms": float(np.mean(replay_ms)),
            "eager_step_ms": float(np.mean(eager_ms)),
            "resume_gaps": gaps, "run_s": run["run_s"], "resumed_run_s": res["run_s"],
            "pair_s": pair_s}


SNAPSHOT_STEPS = 6
SNAPSHOT_CHECKPOINT = 3
SNAPSHOT_PRIOR_IMAGES = 8
SNAPSHOT_SAMPLE_BATCH = 4
SNAPSHOT_SEED = 11  # the seeded weights the snapshot is written from


def snapshot_flags(snapshot: str, instance_dir: str, class_dir: str, output_dir: str, *extra):
    """The paper run's flags (`paper_flags`) over a diffusers snapshot dir,
    with the DB runner's remaining flags: the UNet's cross-attention LoRA,
    the image prior (SNAPSHOT_PRIOR_IMAGES class images generated in batches
    of SNAPSHOT_SAMPLE_BATCH), gradient checkpointing and the padded CLIP
    mask; SNAPSHOT_STEPS steps (cut from 250), a checkpoint every
    SNAPSHOT_CHECKPOINT and one validation round at the end."""
    return paper_flags(
        instance_dir, output_dir, f"--pretrained_model_name_or_path={snapshot}",
        "--unet_params_to_train=crossattn_kv", "--with_image_prior",
        f"--class_data_dir={class_dir}", f"--num_prior_images={SNAPSHOT_PRIOR_IMAGES}",
        f"--sample_batch_size={SNAPSHOT_SAMPLE_BATCH}", "--gradient_checkpointing",
        "--text_encoder_use_attention_mask", f"--max_train_steps={SNAPSHOT_STEPS}",
        f"--checkpointing_steps={SNAPSHOT_CHECKPOINT}", f"--validation_steps={SNAPSHOT_STEPS}",
        *extra)


def checkpointing_costs(flags) -> dict:
    """One train step at `flags` with and without gradient checkpointing,
    through a Trainer of those flags with capture off (its steps switch
    checkpointing between calls, which one graph cannot).  After one step (which takes every
    LoRA B off zero), one forward and backward from the same weights, batch
    and draws in turns (plain, checkpointed, plain): the loss and the
    gradient of every trainable tensor (the text encoder's and the UNet's
    LoRA, the added embedding rows) must be bit-identical in all three,
    which holds the recompute's K1 and K3 outputs to those of the first
    forward.  Then whole steps in turns (off, on, on, off; warm, the
    modes having run once already), with the launch counts set to
    0 just before each and read just after: CUDA-event time, peak allocated
    memory and the launches of each, the launches equal in every step of a
    mode."""
    import torch

    from textboost_torch.lora.partition import lora_parameters
    from textboost_torch.ops import flash_attention as fa
    from textboost_torch.ops import group_norm as gn
    from textboost_torch.train.config import parse_args
    from textboost_torch.train.step import forward_backward
    from textboost_torch.train.trainer import Trainer

    from textboost_torch.graphs import set_capture

    t0 = time.perf_counter()
    set_capture(False)  # eager: the steps below switch checkpointing between calls
    try:
        trainer = Trainer(parse_args(flags), device="cuda")
    finally:
        set_capture(True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    try:
        state = trainer.state
        batch = trainer._device_batch(next(iter(trainer.train_loader)),
                                      next(iter(trainer.prior_loader)))
        draws = trainer._draws()
        unet = trainer.bundle.unet
        emb = state.text_encoder.token_embedding.weight
        te_lora = lora_parameters(state.text_encoder)
        first_added = trainer.step_config.first_added_token_id
        trainer.train_step(state, batch, draws)  # LoRA B off zero, so every A has a gradient
        results = []
        for mode in (False, True, False):
            unet.gradient_checkpointing = mode
            loss = forward_backward(state, trainer.step_config, batch, draws)[0]
            results.append({"loss": [loss.float().clone()],
                            "text_encoder_lora": [p.grad.clone() for p in te_lora],
                            "unet_lora": [p.grad.clone() for p in state.unet_lora],
                            "added_rows": [emb.grad[first_added:].clone()]})
        grad_gap, equal = {}, True
        for name in results[0]:
            for pair, (a, b) in (("checkpointed_vs_plain", (results[1], results[0])),
                                 ("plain_vs_plain", (results[2], results[0]))):
                grad_gap[f"{name}_{pair}"] = max(
                    float((x.float() - y.float()).abs().max()) for x, y in zip(a[name], b[name]))
                equal &= all(torch.equal(x, y) for x, y in zip(a[name], b[name]))
        if not all(any(int(torch.count_nonzero(g)) for g in grads)
                   for name, grads in results[0].items()):
            raise AssertionError("the text encoder's LoRA, the UNet's LoRA or the added rows "
                                 "got no gradient")
        losses = {False: float(results[0]["loss"][0]), True: float(results[1]["loss"][0])}
        del results
        ms, peak = {False: [], True: []}, {False: [], True: []}
        launches = {False: [], True: []}
        for mode in (False, True, True, False):
            unet.gradient_checkpointing = mode
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.launches = fa.bwd_launches = gn.launches = gn.bwd_launches = 0
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step(state, batch, draws)
            end.record()
            torch.cuda.synchronize()
            launches[mode].append({"flash": fa.launches, "flash_bwd": fa.bwd_launches,
                                   "gn": gn.launches, "gn_bwd": gn.bwd_launches})
            ms[mode].append(start.elapsed_time(end))
            peak[mode].append(torch.cuda.max_memory_allocated())
    finally:
        trainer.train_loader.stop()
        trainer.prior_loader.stop()
        trainer._metrics_file.close()
    if not equal:
        raise AssertionError(f"the checkpointed or the repeated plain forward and backward "
                             f"differ from the plain one: largest gaps {grad_gap}")
    for mode, counts in launches.items():
        if any(c != counts[0] for c in counts):
            raise AssertionError(f"the steps with checkpointing={mode} launched {counts}")
    return {"setup_s": setup_s, "loss": losses, "grad_gap": grad_gap,
            "launches": {mode: counts[0] for mode, counts in launches.items()},
            "step_ms": ms, "peak_bytes": peak}


def exact_gaps(a: str, b: str, losses_a, losses_b) -> dict:
    """The largest absolute gaps of run dir b to run dir a: each step's loss
    (`losses_a` against `losses_b`), the exported adapters' tensors
    (text_encoder/, and unet/ where a exported one) and the added rows (the
    token bins); `bit_equal` whether every one of them has the same bytes."""
    import numpy as np

    from textboost_torch.lora.peft_io import import_token_embeddings, load_safetensors

    pairs = [("loss", np.asarray(losses_a, np.float32), np.asarray(losses_b, np.float32))]
    for part in ("text_encoder", "unet"):
        path = os.path.join(part, "adapter_model.safetensors")
        if os.path.isfile(os.path.join(a, path)):
            ta, tb = (load_safetensors(os.path.join(d, path)) for d in (a, b))
            if ta.keys() != tb.keys():
                raise AssertionError(f"{b}'s {part} adapter holds other tensors than {a}'s")
            pairs += [(part, ta[k], tb[k]) for k in sorted(ta)]
    bins = sorted(f for f in os.listdir(a) if f.endswith(".bin"))
    ra, rb = (import_token_embeddings([os.path.join(d, f) for f in bins]) for d in (a, b))
    pairs += [("rows", np.asarray(ra[t]), np.asarray(rb[t])) for t in sorted(ra)]
    gaps, same = {}, True
    for name, x, y in pairs:
        if x.shape != y.shape:
            raise AssertionError(f"{name}: {x.shape} against {y.shape}")
        gap = float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max()) if x.size else 0.0
        gaps[name] = max(gaps.get(name, 0.0), gap)
        same &= x.dtype == y.dtype and x.tobytes() == y.tobytes()
    return {**gaps, "bit_equal": same}


def snapshot_run_phase(gen, card: dict, work: str, smi: str, held: dict) -> dict:
    """The snapshot run at sd21base (see the module docstring): write a
    full-width diffusers snapshot from seeded weights, load it back bit for
    bit, train through `snapshot_flags` with the launches derived from the
    config (the recompute included) and every kernel held at every shape the
    run called it at (`held`: the GroupNorm rows and flash shapes the earlier
    phases held), serve the output, and measure checkpointing's cost."""
    import numpy as np
    import torch

    from textboost_torch.data.tokenizer import CLIPTokenizer, load_tokenizer
    from textboost_torch.lora.peft_io import load_safetensors, unet_lora_tensors
    from textboost_torch.models.configs import get_spec
    from textboost_torch.models.pretrained import PARTS, load_models
    from textboost_torch.ops import flash_attention as fa
    from textboost_torch.ops import group_norm as gn
    from textboost_torch.pipelines.loading import load_textboost_pipeline
    from textboost_torch.train.trainer import plan_tokens

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    spec = get_spec("sd21base")

    # a. write the snapshot: fp32 text encoder and VAE, fp16 UNet ------------
    seeded = load_models("sd21base", dtype=torch.float32, device=dev, seed=SNAPSHOT_SEED)
    parts = {name: {k: v.detach().to(torch.float16 if name == "unet" else torch.float32)
                    .cpu().numpy() for k, v in getattr(seeded, name).state_dict().items()}
             for name in PARTS}
    del seeded
    torch.cuda.empty_cache()
    snap = os.path.join(work, "sd21base_snapshot")
    t0 = time.perf_counter()
    write_snapshot(snap, parts)
    write_s = time.perf_counter() - t0
    del parts
    snap_bytes = sum(f.stat().st_size for f in Path(snap).rglob("*") if f.is_file())

    # b. load it back: the family from the text encoder's width, every tensor
    # the file's value cast to the module's dtype, bit for bit -------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = load_models(snap, lora_rank=4, unet_lora_rank=4, dtype=bf16, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if bundle.spec.name != "sd21base":
        raise AssertionError(f"the snapshot loaded as {bundle.spec.name}, not sd21base")
    compared = 0
    for name in PARTS:
        state = getattr(bundle, name).state_dict()
        stored = load_safetensors(os.path.join(snap, name, SNAPSHOT_FILES[name]))
        if {k for k in state if ".lora_" not in k} != set(stored):
            raise AssertionError(f"the loaded {name} holds other keys than its file")
        for key, arr in stored.items():
            if not torch.equal(state[key], torch.from_numpy(arr).to(dev, state[key].dtype)):
                raise AssertionError(f"{name} {key} is not its file's value cast to "
                                     f"{state[key].dtype}")
            compared += 1
    del bundle, stored, state
    torch.cuda.empty_cache()
    tok = load_tokenizer(snap)
    if not (isinstance(tok, CLIPTokenizer) and len(tok) == CLIP_VOCAB and tok.pad_token_id == 0):
        raise AssertionError("the snapshot's tokenizer is not the port's BPE with sd2's pad")
    print(f"[snapshot] {snap_bytes / 1e9:.3f} GB written in {write_s:.2f} s (fp32 text encoder "
          f"and VAE, fp16 UNet, a {len(tok)}-entry BPE tokenizer with {len(tok.bpe_ranks)} merges); "
          f"load_models inferred sd21base and loaded it in {load_s:.2f} s; {compared} tensors "
          f"equal to their files' values cast as loaded; {smi}", flush=True)

    # c. K1 and K2 at the run's batch-16 shapes -------------------------------
    shapes = {"unet_level0_16x4096x5x64": (16, 4096, 5, 64),
              "unet_level1_16x1024x10x64": (16, 1024, 10, 64)}
    fwd_t = {name: flash_forward_times(gen, *shp, card) for name, shp in shapes.items()}
    bwd_t = {name: flash_backward_times(gen, *shp, card) for name, shp in shapes.items()}
    for name in shapes:
        f, b = fwd_t[name], bwd_t[name]
        print(f"[snapshot flash] {name}: forward {f['ms']:.4f} ms (bound {f['bound_ms']:.4f}, "
              f"{f['bound_floor']}; SDPA {f['library_ms']:.4f}; plain {f['plain_ms']:.3f}); "
              f"backward {b['ms']:.4f} ms (bound {b['bound_ms']:.4f}, {b['bound_floor']}; SDPA "
              f"{b['library_ms']:.4f}; plain {b['plain_ms']:.3f})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # d. the run ----------------------------------------------------------------
    instance_dir, class_dir = os.path.join(work, "instance"), os.path.join(work, "class")
    os.makedirs(instance_dir)
    write_instance_image(os.path.join(instance_dir, "teapot.png"), seed=1)
    out = os.path.join(work, "snapshot_run")
    seen_steps = {"unet_batch": [], "prior_loss": [], "zero_lora_b_after_step_1": None}

    def on_step(call, state, batch, metrics):
        seen_steps["unet_batch"].append(int(batch["pixel_values"].shape[0]))
        seen_steps["prior_loss"].append(metrics["prior_loss"].detach())
        if call == 0:
            seen_steps["zero_lora_b_after_step_1"] = sum(
                int(torch.count_nonzero(b) == 0) for b in state.unet_lora[1::2])

    run = instrumented_train(snapshot_flags(snap, instance_dir, class_dir, out),
                             trace_call=SNAPSHOT_STEPS - 1, on_step=on_step, graph_nodes=True)
    m = run["metrics"]
    # kv-LoRA, the image prior and checkpointing: captured as the JAX trainer
    # jits them (step 4 the capture, steps 4-6 replays).
    graph_line = step_graph_check(m, SNAPSHOT_STEPS, "the snapshot run")
    prior_losses = [float(x) for x in seen_steps["prior_loss"]]
    per_step = train_step_calls("sd21base", 16, 16, checkpointing=True, cross_lora_rank=4)
    per_step_n = {k: sum(c.values()) for k, c in per_step.items()}
    plain_n = {k: sum(c.values()) for k, c in train_step_calls(
        "sd21base", 16, 16, checkpointing=False, cross_lora_rank=4).items()}
    calls_per_generate = expected_launches(spec, 25)
    generates = 1 + -(-SNAPSHOT_PRIOR_IMAGES // SNAPSHOT_SAMPLE_BATCH)  # a round, prior batches
    want = {"flash": SNAPSHOT_STEPS * per_step_n["flash"] + generates * calls_per_generate[0],
            "flash_bwd": SNAPSHOT_STEPS * per_step_n["flash_bwd"],
            "gn": SNAPSHOT_STEPS * per_step_n["gn"] + generates * calls_per_generate[1],
            "gn_bwd": SNAPSHOT_STEPS * per_step_n["gn_bwd"]}
    # What each replay launches, read from the step's graph itself (its
    # kernel nodes); the traced replay shows no more (a profiler trace of
    # this step has lost one GroupNorm forward's record in some processes).
    if len(run["graphs"]) != 1:
        raise AssertionError(f"the snapshot run captured {len(run['graphs'])} graphs, not its step")
    nodes = run["graphs"][0]["kernel_nodes"]
    check_traced_counts(nodes, per_step_n, "the snapshot run's step graph (its kernel nodes)")
    traced = run["traced_counts"]
    lost = {tag: nodes[name][tag] - traced[name].get(tag, 0)
            for name in TRACE_TAGS for tag in TRACE_TAGS[name]}
    if any(n < 0 for n in lost.values()):
        raise AssertionError(f"the snapshot run's traced replay shows {traced}, more than its "
                             f"graph's kernel nodes {nodes}")
    ev = run["events"]
    # Step s runs between events s-2 and s-1: steps 2-3 eager and warm, step
    # 4 carries checkpoint-3's snapshot, the capture and its replay, step 5
    # is a replay, step 6 the traced replay.
    eager_warm = [ev[s - 2].elapsed_time(ev[s - 1]) for s in (2, 3)]
    capture_step = ev[2].elapsed_time(ev[3])
    replay_ms = ev[3].elapsed_time(ev[4])
    busy = sum(run["kernel_ms"].values())
    print(f"[snapshot run] {SNAPSHOT_STEPS} steps sd21base from the snapshot, 512 px, batch 8 "
          f"+ 8 class images, kv-LoRA, gradient checkpointing, padded CLIP mask, in "
          f"{run['run_s']:.1f} s (load, {SNAPSHOT_PRIOR_IMAGES} prior images, a validation round "
          f"and export included): loss {m['loss']:.5g}, prior_loss by step "
          f"{[round(x, 5) for x in prior_losses]}; warm step captured {replay_ms:.1f} ms (the "
          f"replay of step 5, CUDA events), eager {np.mean(eager_warm):.1f} ms (steps 2-3, each "
          f"{[round(w, 1) for w in eager_warm]}), step 4 (checkpoint-3, the capture and its "
          f"replay) {capture_step:.1f} ms; {graph_line}; traced replay (step {SNAPSHOT_STEPS}): "
          f"{run['traced_wall_ms']:.1f} ms wall, {busy:.1f} ms of kernels (idle "
          f"{1 - busy / run['traced_wall_ms']:.3f}), its kernels {traced} (records the profiler "
          f"lost: {({k: n for k, n in lost.items() if n} or 'none')}); the step graph's kernel "
          f"nodes {nodes}; peak "
          f"{run['peak_bytes'] / 2**30:.2f} GiB allocated, {run['reserved_bytes'] / 2**30:.2f} "
          f"reserved; launches {run['launches']} (expected {want}, replays counted: "
          f"per step {per_step_n} with the recompute, {plain_n} without; {generates} sampling "
          f"calls of {calls_per_generate}); {smi}", flush=True)
    names = sorted(os.listdir(class_dir))
    if len(names) != SNAPSHOT_PRIOR_IMAGES or not all(
            n.split("-")[0] == str(i) and len(n.split("-")[1]) == 40
            and n.endswith("-a_photo_of_teapot.jpg") for i, n in enumerate(
                sorted(names, key=lambda n: int(n.split("-")[0])))):
        raise AssertionError(f"the class dir holds {names}")
    if set(seen_steps["unet_batch"]) != {16}:
        raise AssertionError(f"the UNet batches were {seen_steps['unet_batch']}, not 16")
    if not all(math.isfinite(x) and x > 0 for x in prior_losses):
        raise AssertionError(f"prior_loss by step {prior_losses}")
    if seen_steps["zero_lora_b_after_step_1"] != 0:
        raise AssertionError(f"{seen_steps['zero_lora_b_after_step_1']} UNet LoRA B still zero "
                             "after step 1")
    if run["launches"] != want:
        raise AssertionError(f"the snapshot run launched {run['launches']}, expected {want}")
    for path in (f"checkpoint-{SNAPSHOT_CHECKPOINT}/unet/adapter_model.safetensors",
                 f"checkpoint-{SNAPSHOT_CHECKPOINT}/text_encoder/adapter_model.safetensors",
                 "unet/adapter_model.safetensors", "unet/adapter_config.json",
                 "text_encoder/adapter_model.safetensors", f"validation_{SNAPSHOT_STEPS}.jpg"):
        if not os.path.isfile(os.path.join(out, path)):
            raise AssertionError(f"the snapshot run left no {path}")

    # d2. resume from checkpoint-3: its steps 4-6 are its warm-up, eager,
    # where the straight run replayed its graph; bit for bit.  The class
    # images exist (it generates none); no validation round.
    resumed = os.path.join(work, "snapshot_resumed")
    shutil.copytree(os.path.join(out, f"checkpoint-{SNAPSHOT_CHECKPOINT}"),
                    os.path.join(resumed, f"checkpoint-{SNAPSHOT_CHECKPOINT}"))
    res = instrumented_train(snapshot_flags(snap, instance_dir, class_dir, resumed,
                                            "--validation_steps=0",
                                            "--resume_from_checkpoint=latest"))
    rm = res["metrics"]
    rest = SNAPSHOT_STEPS - SNAPSHOT_CHECKPOINT
    want_res = {k: rest * n for k, n in per_step_n.items()}
    res_gaps = exact_gaps(out, resumed, m["loss_by_step"][SNAPSHOT_CHECKPOINT:],
                          rm["loss_by_step"])
    print(f"[snapshot resume] from checkpoint-{SNAPSHOT_CHECKPOINT} to step {SNAPSHOT_STEPS} "
          f"in {res['run_s']:.1f} s: its steps ran {rm['step_graph']!r} against the straight "
          f"run's replays; losses {rm['loss_by_step']} against "
          f"{m['loss_by_step'][SNAPSHOT_CHECKPOINT:]}; largest gaps {res_gaps} (must all be 0, "
          f"bit for bit: losses, the unet/ and text_encoder/ adapters, the added rows); "
          f"launches {res['launches']} (expected {want_res}: no prior image generated); "
          f"class dir {len(os.listdir(class_dir))} images", flush=True)
    if not (rm["step_graph"].startswith("eager: the run ended within its")
            and res["launches"] == want_res and res_gaps.pop("bit_equal")
            and not any(res_gaps.values()) and len(os.listdir(class_dir)) == SNAPSHOT_PRIOR_IMAGES):
        raise AssertionError("the snapshot run's resume left the straight run's trajectory: "
                             "its eager steps and the graph's replays differ")

    # e. every kernel at every shape the run called it at ---------------------
    gc.collect()
    torch.cuda.empty_cache()
    seen = run["shapes"]
    val_calls = group_norm_calls("sd21base", **paper_validation_batches())
    prior_calls = group_norm_calls("sd21base", unet_batch=2 * SNAPSHOT_SAMPLE_BATCH,
                                   decode_batch=SNAPSHOT_SAMPLE_BATCH)
    derived = collections.Counter({key: SNAPSHOT_STEPS * n for key, n in per_step["gn"].items()})
    for calls, n in ((val_calls, 1), (prior_calls, generates - 1)):
        derived.update({key: n * 25 * c for key, c in calls["unet"].items()})
        derived.update({key: n * c for key, c in calls["decode"].items()})
    derived_bwd = collections.Counter({key: SNAPSHOT_STEPS * n
                                       for key, n in per_step["gn_bwd"].items()})
    if seen["gn"] != derived or seen["gn_bwd"] != derived_bwd:
        raise AssertionError(f"the snapshot run's GroupNorm calls differ from those derived "
                             f"from the config: forward {dict(seen['gn'] - derived)} / "
                             f"{dict(derived - seen['gn'])}, backward "
                             f"{dict(seen['gn_bwd'] - derived_bwd)} / "
                             f"{dict(derived_bwd - seen['gn_bwd'])}")
    train_flash = collections.Counter({k: SNAPSHOT_STEPS * n for k, n in per_step["flash"].items()})
    if not train_flash <= seen["flash"] or seen["flash_bwd"] != collections.Counter(
            {k: SNAPSHOT_STEPS * n for k, n in per_step["flash_bwd"].items()}):
        raise AssertionError(f"the snapshot run's flash calls {dict(seen['flash'])} / "
                             f"{dict(seen['flash_bwd'])} do not hold those derived for training")
    new_rows, gn_err = group_norm_table(gen, set(derived) - set(held["gn_rows"]),
                                        {key: {"snapshot": n} for key, n in derived.items()},
                                        backward=False)
    new_bwd_rows, gn_bwd_err = group_norm_table(
        gen, set(derived_bwd) - set(held["gn_bwd_rows"]),
        {key: {"snapshot": n} for key, n in derived_bwd.items()}, backward=True)
    gn_sums = {}
    for name, calls, rows in (("group_norm_fwd", derived, {**held["gn_rows"], **new_rows}),
                              ("group_norm_bwd", derived_bwd,
                               {**held["gn_bwd_rows"], **new_bwd_rows})):
        gn_sums[name] = {field: sum(n * rows[key][field] for key, n in calls.items())
                         for field in ("ms", "cold_ms", "bound_ms", "library_ms")}
        gn_sums[name]["launches"] = sum(calls.values())
    k1_err = check_flash_forward(gen, sorted(set(seen["flash"]) - held["flash"]))
    k2_err = check_flash_backward(gen, [(b, n, h, d, mm, mm) for b, n, h, d, mm in
                                        sorted(set(seen["flash_bwd"]) - held["flash_bwd"])])
    print(f"[snapshot kernels] K1 at the run's {len(seen['flash'])} shapes {dict(seen['flash'])} "
          f"({len(set(seen['flash']) - held['flash'])} new, held now), K2 at "
          f"{dict(seen['flash_bwd'])}; the {len(derived)} forward and {len(derived_bwd)} backward "
          f"GroupNorm keys are those derived from the config with the recompute, "
          f"{len(new_rows)} + {len(new_bwd_rows)} new ones held now; launch-weighted over the "
          f"run: " + "; ".join(f"{name} {v['launches']} launches {v['ms']:.2f} ms warm, bound "
                               f"{v['bound_ms']:.2f}, library {v['library_ms']:.2f}"
                               for name, v in gn_sums.items()), flush=True)

    # f. serve the output over the snapshot -----------------------------------
    plan = plan_tokens(load_tokenizer(snap), [{"instance_token": "<0>",
                                                "placeholder_token": "<teapot>",
                                                "initializer_token": "brown teapot"}], "dog",
                       augment_inversion=True)
    prompt = f"photo of a {plan.concept_tokens['<0>']}"
    fa.launches = fa.bwd_launches = gn.launches = gn.bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = load_textboost_pipeline(out, base_model=snap, device=dev)
    latents = torch.cat([torch.randn((1, 64, 64, 4), generator=torch.Generator(dev).manual_seed(s),
                                     device=dev) for s in range(4)])
    images = pipe([prompt] * 4, num_inference_steps=25, guidance_scale=7.5, latents=latents)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = (fa.launches, gn.launches)
    if serve_launches != calls_per_generate or fa.bwd_launches or gn.bwd_launches:
        raise AssertionError(f"serving launched {serve_launches}, expected {calls_per_generate}")
    if images.dtype != np.uint8 or images.shape != (4, 512, 512, 3):
        raise AssertionError(f"serving gave {images.dtype} {images.shape}")
    exported = load_safetensors(os.path.join(out, "unet", "adapter_model.safetensors"))
    held_lora = unet_lora_tensors(pipe.unet)
    if exported.keys() != held_lora.keys() or not all(
            np.array_equal(exported[k], held_lora[k]) for k in exported):
        raise AssertionError("the served UNet's LoRA differs from the trainer's export")
    del pipe
    print(f"[snapshot serve] load_textboost_pipeline(run, base_model=snapshot) and 4 seeds of "
          f"{prompt!r} in {serve_s:.2f} s: {images.shape}, launches {serve_launches}; its "
          f"{len(held_lora)} UNet LoRA tensors equal the trainer's unet/ export bit for bit",
          flush=True)

    # g. gradient checkpointing's cost ----------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    cost = checkpointing_costs(snapshot_flags(snap, instance_dir, class_dir,
                                              os.path.join(work, "cost")))
    measured = {"with": cost["launches"][True], "without": cost["launches"][False]}
    print(f"[snapshot checkpointing] one train step at these flags (batch 8 + 8 class), warm, "
          f"CUDA events: without {[round(x, 1) for x in cost['step_ms'][False]]} ms, peak "
          f"{max(cost['peak_bytes'][False]) / 2**30:.2f} GiB, launches {measured['without']}; "
          f"with {[round(x, 1) for x in cost['step_ms'][True]]} ms, peak "
          f"{max(cost['peak_bytes'][True]) / 2**30:.2f} GiB, launches {measured['with']}; one "
          f"forward and backward plain, checkpointed, plain: loss and every trainable gradient "
          f"bit-identical (largest gaps {cost['grad_gap']}); trainer set-up from the snapshot "
          f"{cost['setup_s']:.2f} s; {smi}", flush=True)
    if measured["with"] != per_step_n or measured["without"] != plain_n:
        raise AssertionError(f"one train step launched {measured}, expected {per_step_n} with "
                             f"checkpointing and {plain_n} without")
    return {
        "launches": run["launches"],
        "launches_per_run_step": {k: run["launches"][k] / SNAPSHOT_STEPS
                                  for k in ("flash_bwd", "gn_bwd")},
        "launches_per_step": measured["with"],
        "launches_per_step_without_checkpointing": measured["without"], "run_s": run["run_s"],
        "warm_step_ms": replay_ms, "eager_step_ms": float(np.mean(eager_warm)),
        "eager_steps_ms": eager_warm, "capture_step_ms": capture_step,
        "step_graph": {k: m[k] for k in m if k.startswith(("step_graph", "validation_graph"))},
        "resume": res_gaps, "resumed_run_s": res["run_s"], "resumed_launches": res["launches"],
        "peak_bytes": run["peak_bytes"], "reserved_bytes": run["reserved_bytes"],
        "traced_counts": traced, "graph_kernel_nodes": nodes,
        "traced_step_wall_ms": run["traced_wall_ms"], "traced_step_kernel_ms": busy,
        "idle_share": 1 - busy / run["traced_wall_ms"], "final_loss": m["loss"],
        "prior_loss_by_step": prior_losses, "snapshot_bytes": snap_bytes,
        "snapshot_write_s": write_s, "snapshot_load_s": load_s, "tensors_compared": compared,
        "serve_s": serve_s, "serve_launches": serve_launches, "group_norm": gn_sums,
        "checkpointing": {"step_ms_without": cost["step_ms"][False],
                          "step_ms_with": cost["step_ms"][True],
                          "peak_bytes_without": max(cost["peak_bytes"][False]),
                          "peak_bytes_with": max(cost["peak_bytes"][True]),
                          "loss_without": cost["loss"][False], "loss_with": cost["loss"][True],
                          "grad_gap": cost["grad_gap"], "trainer_setup_s": cost["setup_s"]},
        "k1": fwd_t, "k2": bwd_t, "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_err,
        "gn_max_abs_err": gn_err, "gn_bwd_max_abs_err": gn_bwd_err,
    }


# The DreamBooth benchmark at sd21base: the sweep runner's training, the
# eval's generation at the protocol's numbers, and its four scorers at their
# published widths from seeded weights (cut from 30 instances x 4 seeds and
# 250 steps to 2 x 2 and 4).
BENCH_INSTANCES = ("dog", "clock")
BENCH_STEPS = 4
BENCH_SEEDS = (0, 1)
BENCH_BATCH = 16  # the eval's --batch-size: 25 prompts in chunks of 16 + 9
SCORER_SEED = 21  # the seeded scorer weights
# The scorers on the card against the port's CPU fp32 math on the same
# weights and images: CLIP and DINO features in fp32 (TF32 off), relative
# L2; the 2 + 2-layer clip-flant5 in bf16 on the card: P(yes) absolutely and
# the first decoder step's logits as relative L2 (bf16 through the 23-layer
# vision tower and 2 + 2 T5 layers, as UNET_REL_L2 holds the bf16 UNet), and
# log P(yes) absolutely: 0.3 is what the logits limit allows at the seeded
# head's logit std (T5_LOGIT_STD), 5e-2 x 3 on the yes logit and as much on
# the log-normaliser.  The full-depth model is held to the same limits
# against its own fp32 weights on the card.  The P(yes) checks compare
# something only where P(yes) is not ~0: the reference's mean must reach
# VQA_P_FLOOR.
SCORER_REL_L2 = 1e-3
VQA_P_ATOL = 2e-2
VQA_LOGITS_REL_L2 = 5e-2
VQA_LOGP_ATOL = 0.3
VQA_P_FLOOR = 1e-2
T5_YES_ID = 2163  # "Yes" in flan-t5's vocabulary, and here
# The untied head is drawn at std T5_LOGIT_STD / sqrt(d_model), so that the
# first answer's logits have a std of ~3.  transformers' init (std 1) gives
# them a std of sqrt(d_model) = 64: the softmax is one-hot and P(yes) is 0
# or 1, which no tolerance can compare.
T5_LOGIT_STD = 3.0
def write_t5_tokenizer(path: str) -> None:
    """A flan-t5 layout `tokenizer.json`: a Unigram of 32000 pieces (the
    specials, "▁", the words of every question the benchmark asks and their
    characters, "▁Yes" at T5_YES_ID, filler) with seeded scores and the 100
    <extra_id_*> added tokens; a Precompiled charsmap (a few full-width and
    ligature forms) and the " {2,}" replace; Metaspace; the </s> template."""
    import base64

    import numpy as np

    from textboost_torch.eval.dreambooth_bench import INSTANCES, prompts_for
    from textboost_torch.eval.t5_tokenizer import build_charsmap
    from textboost_torch.eval.vqa import QUESTION_TEMPLATE

    questions = [QUESTION_TEMPLATE.format(p.format(cls)) for inst, cls in INSTANCES.items()
                 for p in prompts_for(inst)]
    words = sorted({w for q in questions for w in q.split()})
    chars = sorted({c for q in questions for c in q} - {" "})
    pieces = ["<pad>", "</s>", "<unk>", "▁"] + ["▁" + w for w in words] + chars
    pieces += [f"▁filler{i}" for i in range(T5_YES_ID - len(pieces))] + ["▁Yes"]
    pieces += [f"▁filler{i}" for i in range(len(pieces), 32000)]
    rng = np.random.default_rng(0)
    vocab = [[p, 0.0 if i < 3 else float(-rng.uniform(2, 14))] for i, p in enumerate(pieces)]
    extra = [f"<extra_id_{i}>" for i in range(99, -1, -1)]
    vocab += [[e, 0.0] for e in extra]
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True}
             for i, c in [(0, "<pad>"), (1, "</s>"), (2, "<unk>")]
             + [(32000 + j, e) for j, e in enumerate(extra)]]
    charsmap = build_charsmap({"Ａ": "A", "ﬁ": "fi", "　": " ", " ": " "})
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "Precompiled",
                 "precompiled_charsmap": base64.b64encode(charsmap).decode()},
                {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
            "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True},
            "post_processor": {
                "type": "TemplateProcessing",
                "single": [{"Sequence": {"id": "A", "type_id": 0}},
                           {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                         {"SpecialToken": {"id": "</s>", "type_id": 0}},
                         {"Sequence": {"id": "B", "type_id": 0}},
                         {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                "special_tokens": {"</s>": {"id": "</s>", "ids": [1], "tokens": ["</s>"]}}},
            "decoder": None,
            "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab, "byte_fallback": False}}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)


def seeded(module_fn, dev, dtype, seed: int):
    """A scorer module built on `dev` in `dtype` with the scorers' seeded
    random init (`eval/clip_scorer.py::init_random_`), a T5 inside with T5's
    own (`T5ForConditionalGeneration.init_weights_`; with the generic
    normal(0.02), flan-t5-xxl's unscaled scores have a std of ~13, and the
    softmax turns bf16's rounding into a different answer) and its untied
    head scaled to T5_LOGIT_STD."""
    import torch

    from textboost_torch.eval.clip_scorer import build, init_random_
    from textboost_torch.eval.t5 import T5ForConditionalGeneration

    module = build(module_fn, dev, dtype)
    init_random_(module, seed)
    for mod in module.modules():
        if isinstance(mod, T5ForConditionalGeneration):
            mod.init_weights_(torch.Generator(dev).manual_seed(seed))
            if not mod.config.tie_word_embeddings:
                mod.lm_head.weight.mul_(T5_LOGIT_STD * mod.config.d_model ** -0.5)
    return module


def vqa_logits(scorer, images, prompts):
    """The first answer token's fp32 logits [N, V] on the CPU, from
    `scorer.model` in its own dtype."""
    import numpy as np
    import torch

    from textboost_torch.eval.clip_scorer import normalize_images

    model = scorer.model
    px = torch.from_numpy(normalize_images(np.stack(images), model.vision_config.image_size))
    ids, mask = scorer.encode_questions(prompts)
    with torch.no_grad():
        return model.yes_logits(
            px.permute(0, 3, 1, 2).to(scorer.device, next(model.parameters()).dtype),
            torch.from_numpy(ids.astype(np.int64)).to(scorer.device),
            torch.from_numpy(mask).to(scorer.device)).cpu()


def favour_yes_(scorer, lm_head, images=None, prompts=None) -> int:
    """Swap `lm_head`'s rows at T5_YES_ID and at the token that `scorer`'s
    seeded model gives the most mean log-probability as the first answer to
    the given pairs (by default four probe pairs: seeded noise images, the
    dog's first four questions): a relabelling of a random head, after
    which "▁Yes" carries real mass on such pairs.  Returns the token
    swapped in."""
    import numpy as np
    import torch

    from textboost_torch.eval.dreambooth_bench import prompts_for

    if images is None:
        images = list(np.random.default_rng(SCORER_SEED).integers(
            0, 256, (4, 512, 512, 3), dtype=np.uint8))
        prompts = [p.format("dog") for p in prompts_for("dog")[:4]]
    token = int(torch.log_softmax(vqa_logits(scorer, images, prompts), -1).mean(0).argmax())
    with torch.no_grad():
        lm_head[[T5_YES_ID, token]] = lm_head[[token, T5_YES_ID]].clone()
    return token


def vqa_gaps(logits, reference, yes_id: int) -> dict:
    """First-answer logits [N, V] against the reference's: rel L2, and
    P(yes) and log P(yes) absolutely, each beside its limit; `ok` when all
    hold and the reference's mean P(yes) reaches VQA_P_FLOOR."""
    import torch

    logp, ref = torch.log_softmax(logits, -1)[:, yes_id], torch.log_softmax(reference, -1)[:, yes_id]
    out = {"logits_rel_l2": rel_l2(logits, reference),
           "p_gap": float((logp.exp() - ref.exp()).abs().max()),
           "logp_gap": float((logp - ref).abs().max()),
           "p_yes": logp.exp().tolist(), "p_yes_reference": ref.exp().tolist()}
    out["ok"] = (out["logits_rel_l2"] <= VQA_LOGITS_REL_L2 and out["p_gap"] <= VQA_P_ATOL
                 and out["logp_gap"] <= VQA_LOGP_ATOL
                 and float(ref.exp().mean()) >= VQA_P_FLOOR)
    out["text"] = (f"P(yes) {[round(p, 4) for p in out['p_yes']]} vs "
                   f"{[round(p, 4) for p in out['p_yes_reference']]} (mean at least "
                   f"{VQA_P_FLOOR}), max gap {out['p_gap']:.3g} (limit {VQA_P_ATOL}), log P(yes) "
                   f"max gap {out['logp_gap']:.3g} (limit {VQA_LOGP_ATOL}), logits rel L2 "
                   f"{out['logits_rel_l2']:.3g} (limit {VQA_LOGITS_REL_L2})")
    return out


def write_scorer_weights(root: str, dev, clip_cfg=None, vit_cfg=None, t5_cfg=None,
                         vqa: bool = True) -> dict:
    """A scorer-weights dir in the published torch layouts, from seeded
    weights, by default at the published widths: `clip/` a transformers
    CLIPModel dir (ViT-L/14-336: fp32 model.safetensors with the
    position_ids buffers and logit_scale, config.json, the CLIP BPE files),
    `dino` a DINOv2 ViT-L/14 hub checkpoint (a torch pickle with
    mask_token), and `vqa/`: `vision/` (a CLIPVisionModel dir, every layer
    and the post-LN), `projector.bin` (LLaVA's mm_projector keys), `t5/`
    (flan-t5-xxl widths and vocabulary, 2 + 2 layers, bf16, two shards and
    model.safetensors.index.json; the untied head's rows relabelled by
    `favour_yes_`, read back through the port's scorer), `tokenizer.json` and
    `config.json` (yes_token_id and the geometry that differs from
    clip-flant5-xxl's); without `vqa`, `clip` and `dino` alone.
    Returns the bytes written per part."""
    import torch

    from textboost_torch.eval.clip_scorer import CLIPConfig, CLIPModel, CLIPVisionModel
    from textboost_torch.eval.dino import ViTConfig, ViTFeatures
    from textboost_torch.eval.t5 import T5Config, T5ForConditionalGeneration
    from textboost_torch.eval.vqa import NativeVQAScorer
    from textboost_torch.lora.peft_io import save_safetensors

    clip_cfg, vit_cfg = clip_cfg or CLIPConfig(), vit_cfg or ViTConfig()
    t5_cfg = t5_cfg or T5Config(num_layers=2, num_decoder_layers=2)
    vis = clip_cfg.vision
    f32, n_pos = torch.float32, (vis.image_size // vis.patch_size) ** 2 + 1
    clip = seeded(lambda: CLIPModel(clip_cfg), dev, f32, SCORER_SEED)
    state = {k: v.cpu() for k, v in clip.state_dict().items()}
    del clip
    state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    state["vision_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
    state["logit_scale"] = torch.tensor(4.6052)
    os.makedirs(os.path.join(root, "clip"))
    save_safetensors(state, os.path.join(root, "clip", "model.safetensors"))
    with open(os.path.join(root, "clip", "config.json"), "w") as f:
        json.dump({"architectures": ["CLIPModel"], "projection_dim": clip_cfg.projection_dim}, f)
    write_clip_tokenizer(os.path.join(root, "clip"), pad_token="<|endoftext|>")

    dino = seeded(lambda: ViTFeatures(vit_cfg), dev, f32, SCORER_SEED + 1)
    state = {k: v.cpu() for k, v in dino.state_dict().items()}
    del dino
    state["mask_token"] = torch.zeros(1, vit_cfg.hidden_size)
    torch.save(state, os.path.join(root, "dino"))
    parts = ("clip", "dino") + (("vqa",) if vqa else ())
    if not vqa:
        return _part_bytes(root, parts)

    vqa = os.path.join(root, "vqa")
    vision = seeded(lambda: CLIPVisionModel(vis), dev, f32, SCORER_SEED + 2)
    state = {f"vision_model.{k}": v.cpu() for k, v in vision.state_dict().items()}
    del vision
    state["vision_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
    os.makedirs(os.path.join(vqa, "vision"))
    save_safetensors(state, os.path.join(vqa, "vision", "model.safetensors"))
    d = t5_cfg.d_model
    projector = seeded(lambda: torch.nn.Sequential(
        torch.nn.Linear(vis.hidden_size, d), torch.nn.GELU(), torch.nn.Linear(d, d)),
        dev, f32, SCORER_SEED + 3)
    torch.save({f"model.mm_projector.{k}": v.cpu() for k, v in projector.state_dict().items()},
               os.path.join(vqa, "projector.bin"))
    del projector
    t5 = seeded(lambda: T5ForConditionalGeneration(t5_cfg), dev, torch.bfloat16, SCORER_SEED + 4)
    state = {k: v.cpu() for k, v in t5.state_dict().items()}
    del t5
    keys = sorted(state)
    shards = {f"model-0000{i + 1}-of-00002.safetensors": keys[i::2] for i in range(2)}
    os.makedirs(os.path.join(vqa, "t5"))

    def write_shards():
        for name, part in shards.items():
            save_safetensors({k: state[k] for k in part}, os.path.join(vqa, "t5", name))

    write_shards()
    with open(os.path.join(vqa, "t5", "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": sum(v.numel() * 2 for v in state.values())},
                   "weight_map": {k: name for name, part in shards.items() for k in part}}, f)
    write_t5_tokenizer(os.path.join(vqa, "tokenizer.json"))
    geometry = {"yes_token_id": T5_YES_ID}
    for key, cfg, default in (("t5", t5_cfg, T5Config()), ("vision", vis, CLIPConfig().vision)):
        changed = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                   if getattr(cfg, f.name) != getattr(default, f.name)}
        if changed:
            geometry[key] = changed
    with open(os.path.join(vqa, "config.json"), "w") as f:
        json.dump(geometry, f)
    if not t5_cfg.tie_word_embeddings:  # the favoured answer becomes "▁Yes", on disk too
        favour_yes_(NativeVQAScorer(vqa, device=dev), state["lm_head.weight"])
        write_shards()
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return _part_bytes(root, parts)


def _part_bytes(root: str, parts) -> dict:
    """{part: bytes on disk} of files or dirs under `root`."""
    return {part: sum(p.stat().st_size for p in Path(root, part).rglob("*") if p.is_file())
            if Path(root, part).is_dir() else Path(root, part).stat().st_size
            for part in parts}


def release_memos() -> None:
    """Drop the port's cross-instance memos (the step's and its graph,
    train/graph.py; the preset bundle, models/pretrained.py) and free the
    card memory they held: each phase starts with nothing of an earlier one
    resident."""
    import torch

    from textboost_torch.models import pretrained
    from textboost_torch.train import graph as train_graph

    train_graph.release_memo()
    pretrained._PRESET_MEMO.clear()
    gc.collect()
    torch.cuda.empty_cache()


def benchmark_phase(gen, card: dict, work: str, smi: str, held: dict) -> dict:
    """The DreamBooth benchmark at sd21base, through the port's entry points:
    `run_textboost_db` trains two instances in-process (`--sequential`), a
    scorer-weights dir is written from seeded weights, and
    `textboost_torch.eval` generates the instances' 25 prompts for two seeds
    at the protocol's numbers (25 steps, CFG 7.5, batch 16) and scores them
    with CLIP-T, CLIP-I, DINO (seen and unseen) and VQAScore into
    metric_last.csv; every kernel call of the training and the generation is
    recorded and each kernel held at every shape it ran at (`held`: what the
    earlier phases held), the launches must be those derived from the
    config; the second instance takes the first's bundle and step graph
    from the memos (one capture in the sweep, no warm-up steps for it) and
    exports the bits it exports trained alone with the memos cleared; the
    eval's rule names its chunk signatures (threshold lowered to its calls)
    and the reused pipeline keeps their graphs across the instances; then
    the instance bound with reuse= again from a fresh load, eager
    (bit-identical images), the scorers on the card against the CPU, and
    clip-flant5-xxl at full depth from a seed, in bf16 held to its own fp32
    weights."""
    import numpy as np
    import torch
    from PIL import Image

    from textboost_torch import run_textboost_db
    from textboost_torch.eval import __main__ as eval_cli
    from textboost_torch.eval import dreambooth_bench, scorer_weights
    from textboost_torch.eval.clip_scorer import CLIPConfig, CLIPScorer
    from textboost_torch.eval.dino import DINOScorer, ViTConfig
    from textboost_torch.eval.t5_tokenizer import T5Tokenizer
    from textboost_torch.eval.vqa import CLIPT5Model, NativeVQAScorer
    from textboost_torch import graphs as graph_mod
    from textboost_torch.models import pretrained
    from textboost_torch.models.configs import get_spec
    from textboost_torch.pipelines import loading
    from textboost_torch.pipelines.text_to_image import TextToImagePipeline
    from textboost_torch.train import graph as train_graph
    from textboost_torch.utils import sweep

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    spec = get_spec("sd21base")
    per_step, per_call = expected_train_launches(spec), expected_launches(spec, 25)
    prompts_n = len(dreambooth_bench.OBJ_PROMPTS)
    chunks = -(-prompts_n // BENCH_BATCH)
    calls = len(BENCH_INSTANCES) * len(BENCH_SEEDS) * chunks

    # a. the sweep runner trains both instances in this process ---------------
    data, val, models = (os.path.join(work, d) for d in ("data", "val", "tb-sd21base-n1"))
    for k, name in enumerate(BENCH_INSTANCES):
        for root, seed in ((data, 100 + k), (val, 200 + k)):
            os.makedirs(os.path.join(root, name))
            write_instance_image(os.path.join(root, name, "0.png"), seed=seed)
    # Each job's seconds, time to its first step (set-up and the step, the
    # queue drained) and peak reserved bytes; what its first step read.
    jobs = []
    real_job = sweep.run_job

    def timed_job(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        jobs.append({"t0": time.perf_counter()})
        real_job(*a, **k)
        torch.cuda.synchronize()
        jobs[-1].update(s=time.perf_counter() - jobs[-1]["t0"],
                        reserved=torch.cuda.max_memory_reserved())

    def first_step(call, state, batch, metrics):
        if state.step == 1:  # an instance's first step has run
            torch.cuda.synchronize()
            jobs[-1].update(first_step_s=time.perf_counter() - jobs[-1]["t0"], read={
                "table": state.text_encoder.token_embedding.weight.data_ptr(),
                "frozen": state.frozen_text_encoder, "unet": state.unet,
                "exp_avg": [v["exp_avg"].data_ptr() for v in state.optimizer.state.values()]})

    def sweep_run(instances, outdir):
        sweep.run_job = timed_job
        try:
            return instrumented_train(
                ["-m", "sd21base", "--instances", *instances, "--total-steps", str(BENCH_STEPS),
                 "--sequential", "--data-dir", data, "--outdir", outdir],
                run=lambda argv: run_textboost_db.main(run_textboost_db.parse_args(argv)),
                on_step=first_step)
        finally:
            sweep.run_job = real_job

    release_memos()
    tr = sweep_run(BENCH_INSTANCES, models)
    job_s = [j["s"] for j in jobs]
    steps = len(BENCH_INSTANCES) * BENCH_STEPS
    want_train = {"flash": steps * per_step[0], "flash_bwd": steps * per_step[1],
                  "gn": steps * per_step[2], "gn_bwd": steps * per_step[3]}
    print(f"[bench train] run_textboost_db -m sd21base --instances {' '.join(BENCH_INSTANCES)} "
          f"--total-steps {BENCH_STEPS} --sequential: {len(job_s)} runs in "
          f"{[round(s, 2) for s in job_s]} s (set-up, {BENCH_STEPS} steps at batch 8 and export "
          f"each); launches {tr['launches']} (expected {want_train}); {smi}", flush=True)
    if tr["launches"] != want_train or len(tr["events"]) != steps:
        raise AssertionError(f"the sweep launched {tr['launches']} in {len(tr['events'])} steps, "
                             f"expected {want_train} in {steps}")
    # The second instance took the first's bundle (the memo's pristine
    # encoder as its frozen one, the shared UNet) and its memo entry (the
    # same table and AdamW state): the sweep captured the step once, and the
    # second instance replayed from its first step.
    first, second = (j.pop("read") for j in jobs)
    step_graphs = tr["graphs"]
    replays = steps - train_graph.WARMUP_STEPS
    memo_entries = list(train_graph._AOT_MEMO.values())
    pristine = pretrained._PRESET_MEMO["bundle"].text_encoder
    pristine_bytes = pretrained.memo_bytes()
    took = (second["frozen"] is first["frozen"] is pristine and second["unet"] is first["unet"]
            and second["table"] == first["table"] and second["exp_avg"] == first["exp_avg"])
    ttfs = [j["first_step_s"] for j in jobs]
    print(f"[bench memo] {BENCH_INSTANCES[1]} took {BENCH_INSTANCES[0]}'s bundle and memo "
          f"entry: {took}; step graphs captured in the sweep {len(step_graphs)} (replays "
          f"{[g['replays'] for g in step_graphs]}, expected 1 with {replays}: "
          f"{train_graph.WARMUP_STEPS} warm-up steps, all of them {BENCH_INSTANCES[0]}'s); time "
          f"to first step {[round(t, 3) for t in ttfs]} s; the pristine text encoder "
          f"{pristine_bytes / 1e9:.3f} GB; peak reserved by job "
          f"{[round(j['reserved'] / 2**30, 3) for j in jobs]} GiB; {smi}", flush=True)
    if not (took and len(step_graphs) == 1 and step_graphs[0]["replays"] == replays
            and len(memo_entries) == 1 and not memo_entries[0].busy):
        raise AssertionError(f"the sweep's second instance did not replay the first's step "
                             f"graph from the memo: took {took}, graphs {step_graphs}")
    # The second instance alone, the memos cleared: the same exports to the
    # bit, and one instance's peak.
    del memo_entries, pristine, first, second, step_graphs
    release_memos()
    alone_dir = os.path.join(work, "alone")
    sweep_jobs = list(jobs)
    jobs.clear()
    alone = sweep_run(BENCH_INSTANCES[1:], alone_dir)
    alone_job = jobs[0]
    alone_job.pop("read")
    jobs[:] = sweep_jobs
    name = BENCH_INSTANCES[1]
    got, want = (os.path.join(d, name) for d in (models, alone_dir))
    exported = ["text_encoder/adapter_model.safetensors"] + sorted(
        f for f in os.listdir(want) if f.endswith(".bin"))
    same_exports = all(open(os.path.join(got, f), "rb").read()
                       == open(os.path.join(want, f), "rb").read() for f in exported)
    want_alone = {k: v // len(BENCH_INSTANCES) for k, v in want_train.items()}
    print(f"[bench memo] {name} alone, the memos cleared: time to first step "
          f"{alone_job['first_step_s']:.3f} s against {ttfs[1]:.3f} through the memo; its "
          f"{len(exported)} exported files {'bit-equal to' if same_exports else 'DIFFERENT from'} "
          f"the sweep's; launches {alone['launches']} (expected {want_alone}); peak reserved "
          f"{alone_job['reserved'] / 2**30:.3f} GiB alone against the sweep's "
          f"{[round(j['reserved'] / 2**30, 3) for j in jobs]}; {smi}", flush=True)
    if not same_exports or alone["launches"] != want_alone or len(alone["graphs"]) != 1:
        raise AssertionError(f"{name} through the memo exports other bits than {name} alone")
    release_memos()
    memo = {"took": took, "time_to_first_step_s": ttfs,
            "alone_time_to_first_step_s": alone_job["first_step_s"],
            "pristine_bytes": pristine_bytes, "reserved_bytes_by_job": [j["reserved"] for j in jobs],
            "alone_reserved_bytes": alone_job["reserved"], "same_exports": same_exports}
    for name in BENCH_INSTANCES:
        run_dir = os.path.join(models, name)
        files = os.listdir(run_dir)
        with open(os.path.join(run_dir, "cmd.txt")) as f:
            cmd = f.read().splitlines()
        if not (os.path.isfile(os.path.join(run_dir, "text_encoder", "adapter_model.safetensors"))
                and eval_cli.detect_num_vectors(files, name) == 2
                and cmd[0] == "python -m textboost_torch.train" and cmd[-1] == "--device=cuda"):
            raise AssertionError(f"the sweep's {name} dir holds {sorted(files)}, cmd.txt {cmd[:1]}")

    # b. the scorer weights ---------------------------------------------------
    weights = os.path.join(work, "scorer_weights")
    t0 = time.perf_counter()
    written = write_scorer_weights(weights, dev)
    write_s = time.perf_counter() - t0
    print(f"[bench scorers] seeded weights written in {write_s:.2f} s: "
          + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in written.items()) + f"; {smi}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # c. the eval: generation with reuse=, then the metrics -------------------
    argv = [models, "--model", "sd21base", "--instances", *BENCH_INSTANCES,
            "--seeds", *map(str, BENCH_SEEDS), "--batch-size", str(BENCH_BATCH), "--steps", "25",
            "--metric", "clip-t", "clip-i", "dino", "vqa", "--scorer-weights", weights,
            "--vqa-weights", os.path.join(weights, "vqa"), "--train-dir", data, "--val-dir", val,
            "--outdir", os.path.join(work, "benchmarks")]
    loads, sampled, scorers = [], [], {}
    real_load, real_call = loading.load_textboost_pipeline, TextToImagePipeline.__call__
    real_build = eval_cli.build_scorers
    # The eval's plan: both instances add as many rows (one run, which the
    # reused pipeline's graphs serve), each chunk signature called once per
    # (instance, seed).  Those calls are too few to pay a capture back; the
    # eval's rule (eval_cli.sampler_signatures) is run with its threshold
    # lowered to them, so that it names both signatures, the first instance
    # captures their graphs and the second replays them, while the fresh
    # load below, with half the calls, samples eagerly.
    order = {k: v for k, v in dreambooth_bench.INSTANCES.items() if k in BENCH_INSTANCES}
    plan = eval_cli.planned_runs(eval_cli.parse_args(argv), order, spec.resolution // 8)
    per_sig = len(BENCH_INSTANCES) * len(BENCH_SEEDS)
    sig_keys = [graph_mod.sampler_key(b, spec.resolution, spec.resolution, 25,
                                      eval_cli.GUIDANCE, eval_cli.SAMPLER)
                for b in (BENCH_BATCH, prompts_n - (chunks - 1) * BENCH_BATCH)]
    if plan != [(list(order), {key: per_sig for key in sig_keys})]:
        raise AssertionError(f"the eval plans {plan}, not one run of {list(order)} with "
                             f"{per_sig} calls of each of {sig_keys}")
    threshold = graph_mod.VALIDATION_CAPTURE_ROUNDS

    def timed_load(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = real_load(*a, **k)
        torch.cuda.synchronize()
        loads.append(((time.perf_counter() - t0) * 1e3, k.get("reuse") is not None, pipe))
        return pipe

    def timed_call(self, prompts, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = real_call(self, prompts, **k)
        sampled.append((len(prompts), time.perf_counter() - t0))
        return images

    def timed_build(*a, **k):
        t0 = time.perf_counter()
        built = real_build(*a, **k)
        torch.cuda.synchronize()
        scorers.update(load_s=time.perf_counter() - t0, built=built)
        return built

    def eval_run(args_list):
        loading.load_textboost_pipeline, TextToImagePipeline.__call__ = timed_load, timed_call
        graph_mod.VALIDATION_CAPTURE_ROUNDS = per_sig
        try:
            with kernel_calls("the eval") as rec:
                out = eval_cli.generate(eval_cli.parse_args(args_list))
        finally:
            loading.load_textboost_pipeline, TextToImagePipeline.__call__ = real_load, real_call
            graph_mod.VALIDATION_CAPTURE_ROUNDS = threshold
        return out, rec

    t0 = time.perf_counter()
    outdir, ev = eval_run(argv)
    gen_s = time.perf_counter() - t0
    reuse_loads = [(ms, reused) for ms, reused, _ in loads]
    first, second = loads[0][2], loads[1][2]
    shared = second is first and all(a.data_ptr() == b.data_ptr() for a, b in zip(
        first.unet.parameters(), second.unet.parameters()))
    sampler_graphs = first.graphs.stats()
    first.release_graphs()
    del first, second
    loads.clear()
    # Each signature: the first instance's seed 0 eager (the warm-up), its
    # seed 1 captured and replayed, the second instance's replayed.
    full_calls = [s for b, s in sampled if b == BENCH_BATCH]
    replays = per_sig - 1  # the capture replays once too
    print(f"[bench eval graph] the eval's rule at a threshold of {per_sig} calls named "
          f"{sig_keys}; on the reused pipeline: "
          f"{[(g['replays'], round(g['capture_ms'], 1), round(g['pool_bytes'] / 2**30, 3)) for g in sampler_graphs.values()]} "
          f"(replays, capture ms, pool GiB), expected {replays} replays each; the batch-16 "
          f"calls eager / capturing / replayed {[round(x, 3) for x in full_calls]} s; graphs "
          f"the eval's kernel counts saw {[g['replays'] for g in ev['graphs']]}; {smi}",
          flush=True)
    if (sorted(sampler_graphs) != sorted(sig_keys) or len(ev["graphs"]) != len(sig_keys)
            or any(g["replays"] != replays for g in sampler_graphs.values())):
        raise AssertionError(f"the reused pipeline's sampler graphs ran {sampler_graphs}, not "
                             f"one capture and {replays} replays of each of {sig_keys} across "
                             f"the instances")
    want_eval = {"flash": calls * per_call[0], "flash_bwd": 0, "gn": calls * per_call[1],
                 "gn_bwd": 0}
    full = [s for b, s in sampled if b == BENCH_BATCH]
    load_report = [(round(ms, 1), "reuse" if r else "fresh") for ms, r in reuse_loads]
    print(f"[bench eval] generate: {len(sampled)} sampling calls (batches "
          f"{[b for b, _ in sampled]}) in {gen_s:.1f} s; each {[round(s, 2) for _, s in sampled]} "
          f"s; at batch {BENCH_BATCH}: {BENCH_BATCH / np.mean(full):.3f} images/s (mean of "
          f"{len(full)}); pipeline loads {load_report} ms; launches {ev['launches']} (expected {want_eval}); {smi}", flush=True)
    if ev["launches"] != want_eval or not shared or [r for _, r in reuse_loads] != [False, True]:
        raise AssertionError(f"the eval launched {ev['launches']} (expected {want_eval}); the "
                             f"second instance's pipeline shares the first's UNet: {shared}")
    for seed in BENCH_SEEDS:
        for name in BENCH_INSTANCES:
            cls = dreambooth_bench.INSTANCES[name]
            want_names = sorted(f"{p.format(cls).replace(' ', '_')}.png"
                                for p in dreambooth_bench.prompts_for(name))
            got = sorted(os.listdir(os.path.join(outdir, f"seed{seed}", name)))
            if got != want_names:
                raise AssertionError(f"seed{seed}/{name} holds {got[:3]}..., not the reference's "
                                     f"{len(want_names)} names")
    sampled.clear()

    eval_cli.build_scorers = timed_build
    try:
        t0 = time.perf_counter()
        csv_path = eval_cli.compute_metrics(eval_cli.parse_args(argv), outdir)
        metrics_s = time.perf_counter() - t0
    finally:
        eval_cli.build_scorers = real_build
    with open(csv_path) as f:
        csv_rows = [line.rstrip("\n").split(",") for line in f]
    values = [dict(zip(csv_rows[0][1:], map(float, r[1:]))) for r in csv_rows[1:]]
    print(f"[bench metrics] {csv_path} in {metrics_s:.1f} s (scorer load "
          f"{scorers['load_s']:.1f} s): {csv_rows}; {smi}", flush=True)
    if csv_rows[0] != eval_cli.REFERENCE_CSV_HEADER or [r[0] for r in csv_rows[1:]] != [
            str(s) for s in BENCH_SEEDS] or not all(
            -1 <= x <= 1 for v in values for x in v.values()) or not all(
            0 <= v["vqa_score"] <= 1 for v in values):
        raise AssertionError(f"metric_last.csv holds {csv_rows}")

    # d. scoring times per image, on one instance's 25 images ------------------
    clip, dino, vqa, tokenizer = scorers.pop("built")
    images, prompts = eval_cli.load_dir_images(os.path.join(outdir, "seed0", BENCH_INSTANCES[0]))
    images = np.stack(images)
    per_image = {}
    for name, fn in (("clip_t", lambda: clip.clip_t(tokenizer, images, prompts)),
                     ("clip_i", lambda: clip.image_features(images)),
                     ("dino", lambda: dino.features(images)),
                     ("vqa_2+2", lambda: vqa.score_pairs(list(images), prompts))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        per_image[name] = (time.perf_counter() - t0) * 1e3 / len(images)

    # e. the scorers on the card against the port's CPU fp32 math --------------
    four = images[:4]
    cpu = {"clip": CLIPScorer(CLIPConfig(), device="cpu", weights=scorer_weights.clip_weights(
               os.path.join(weights, "clip"))),
           "dino": DINOScorer(ViTConfig(), device="cpu", weights=scorer_weights.dino_weights(
               os.path.join(weights, "dino")))}
    gaps = {"clip_image": rel_l2(torch.from_numpy(clip.image_features(four)),
                                 torch.from_numpy(cpu["clip"].image_features(four))),
            "clip_text": rel_l2(torch.from_numpy(clip.text_features(tokenizer, prompts[:4])),
                                torch.from_numpy(cpu["clip"].text_features(tokenizer,
                                                                           prompts[:4]))),
            "dino": rel_l2(torch.from_numpy(dino.features(four)),
                           torch.from_numpy(cpu["dino"].features(four)))}
    del cpu
    vqa_cpu = NativeVQAScorer(os.path.join(weights, "vqa"), device="cpu")
    two, two_prompts = list(images[:2]), prompts[:2]
    vqa_gap = vqa_gaps(vqa_logits(vqa, two, two_prompts), vqa_logits(vqa_cpu, two, two_prompts),
                       vqa.yes_token_id)
    del vqa_cpu
    print(f"[bench scorers] ms per image on the card: " + ", ".join(
              f"{k} {v:.2f}" for k, v in per_image.items()) + f"; card vs CPU on the same "
          f"weights: CLIP image / text features rel L2 {gaps['clip_image']:.3g} / "
          f"{gaps['clip_text']:.3g}, DINO {gaps['dino']:.3g} (limit {SCORER_REL_L2}, fp32, TF32 "
          f"off); 2 + 2-layer clip-flant5 bf16 vs fp32: {vqa_gap['text']}; {smi}", flush=True)
    if not (max(gaps.values()) <= SCORER_REL_L2 and vqa_gap["ok"]):
        raise AssertionError("a scorer on the card disagrees with its CPU math")
    del clip, dino, vqa
    gc.collect()
    torch.cuda.empty_cache()

    # f. the second instance from a fresh load (the memos cleared; its 2 calls
    # a signature below the rule's threshold: eager): the same bits as its
    # images from the reused pipeline's graphs --------------------------------
    second_name = list(order)[1]  # the eval's order: the instance bound with reuse=
    release_memos()
    fresh_dir, fresh = eval_run(argv + ["--instances", second_name,
                                        "--outdir", os.path.join(work, "fresh")])
    fresh_ms = loads[0][0]
    loads.clear()
    release_memos()
    if fresh["graphs"]:
        raise AssertionError("the fresh load's sampling was captured: its calls are too few")

    def pixels(root, seed, f):
        return np.asarray(Image.open(os.path.join(root, f"seed{seed}", second_name, f)))

    same = all(np.array_equal(pixels(outdir, seed, f), pixels(fresh_dir, seed, f))
               for seed in BENCH_SEEDS
               for f in os.listdir(os.path.join(outdir, f"seed{seed}", second_name)))
    want_fresh = {k: v // len(BENCH_INSTANCES) for k, v in want_eval.items()}
    print(f"[bench reuse] {second_name} again from a fresh load ({fresh_ms:.1f} ms), eager: "
          f"{2 * prompts_n} images {'bit-identical to' if same else 'DIFFERENT from'} those "
          f"sampled with reuse= ({reuse_loads[1][0]:.1f} ms), its chunks replayed from the "
          f"graphs the first instance captured; launches {fresh['launches']}; "
          f"{smi}", flush=True)
    if not same or fresh["launches"] != want_fresh:
        raise AssertionError("the reused pipeline's images differ from a fresh load's")
    sampled.clear()

    # g. every kernel at every shape the sweep and the eval called it at -------
    seen = {k: tr["shapes"][k] + ev["shapes"][k] for k in ev["shapes"]}
    train_calls = group_norm_calls("sd21base")
    derived = collections.Counter()
    for part in ("unet", "encode"):
        derived.update({key: steps * c for key, c in train_calls[part].items()})
    pairs = len(BENCH_INSTANCES) * len(BENCH_SEEDS)  # (instance, seed): chunks of 16 and 9
    tail = prompts_n - (chunks - 1) * BENCH_BATCH
    for batch, n in ((BENCH_BATCH, pairs * (chunks - 1)), (tail, pairs)):
        c = group_norm_calls("sd21base", unet_batch=2 * batch, decode_batch=batch)
        derived.update({key: n * 25 * m for key, m in c["unet"].items()})
        derived.update({key: n * m for key, m in c["decode"].items()})
    derived_bwd = collections.Counter(
        {key: steps * c for key, c in train_calls["unet_backward"].items()})
    if seen["gn"] != derived or seen["gn_bwd"] != derived_bwd:
        raise AssertionError(f"the benchmark's GroupNorm calls differ from those derived from "
                             f"the config: forward {dict(seen['gn'] - derived)} / "
                             f"{dict(derived - seen['gn'])}, backward "
                             f"{dict(seen['gn_bwd'] - derived_bwd)} / "
                             f"{dict(derived_bwd - seen['gn_bwd'])}")
    new_rows, gn_err = group_norm_table(gen, set(derived) - set(held["gn_rows"]),
                                        {key: {"benchmark": n} for key, n in derived.items()},
                                        backward=False)
    new_bwd_rows, gn_bwd_err = group_norm_table(
        gen, set(derived_bwd) - set(held["gn_bwd_rows"]),
        {key: {"benchmark": n} for key, n in derived_bwd.items()}, backward=True)
    gn_sums = {}
    for name, counts, table in (("group_norm_fwd", derived, {**held["gn_rows"], **new_rows}),
                                ("group_norm_bwd", derived_bwd,
                                 {**held["gn_bwd_rows"], **new_bwd_rows})):
        gn_sums[name] = {f: sum(n * table[key][f] for key, n in counts.items())
                         for f in ("ms", "cold_ms", "bound_ms", "library_ms")}
        gn_sums[name]["launches"] = sum(counts.values())
    new_flash = sorted(set(seen["flash"]) - held["flash"])
    new_flash_bwd = sorted(set(seen["flash_bwd"]) - held["flash_bwd"])
    k1_err = check_flash_forward(gen, new_flash)
    k2_err = check_flash_backward(gen, [(b, n, h, d, m, m) for b, n, h, d, m in new_flash_bwd])
    k1 = {"eval_unet_level0_32x4096x5x64": flash_forward_times(gen, 32, 4096, 5, 64, card),
          "eval_tail_unet_level0_18x4096x5x64": flash_forward_times(gen, 18, 4096, 5, 64, card)}
    print(f"[bench kernels] K1 at the benchmark's {len(seen['flash'])} shapes "
          f"{dict(seen['flash'])} ({len(new_flash)} new, held now: {new_flash}), K2 at "
          f"{dict(seen['flash_bwd'])} ({len(new_flash_bwd)} new); the {len(derived)} forward and "
          f"{len(derived_bwd)} backward GroupNorm keys are those derived from the config, "
          f"{len(new_rows)} + {len(new_bwd_rows)} new ones held now; launch-weighted over the "
          f"run: " + "; ".join(
              f"{k} {v['ms']:.2f} ms warm, bound {v['bound_ms']:.2f}, library "
              f"{v['library_ms']:.2f}" for k, v in gn_sums.items()) + "; K1 at the eval's "
          "batch: " + "; ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, SDPA "
                                f"{v['library_ms']:.4f}, plain {v['plain_ms']:.3f})"
                                for k, v in k1.items()) + f"; {smi}", flush=True)

    # h. clip-flant5-xxl at full depth from a seed ------------------------------
    # Seeded in fp32 (TF32 off), run on four pairs as the witness, then cast to
    # bf16 in place, which scores every pair and is held to the witness.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xxl = seeded(lambda: CLIPT5Model(), dev, torch.float32, SCORER_SEED + 5)
    torch.cuda.synchronize()
    xxl_init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in xxl.parameters())
    scorer = NativeVQAScorer(device=dev, model=xxl, yes_token_id=T5_YES_ID)
    scorer._tokenizer = T5Tokenizer.from_file(os.path.join(weights, "vqa", "tokenizer.json"))
    pairs_images, pairs_prompts = [], []
    for seed in BENCH_SEEDS:
        for name in BENCH_INSTANCES:
            imgs, ps = eval_cli.load_dir_images(os.path.join(outdir, f"seed{seed}", name))
            pairs_images += imgs
            pairs_prompts += ps
    witness = (pairs_images[:4], pairs_prompts[:4])
    favour_yes_(scorer, xxl.t5.lm_head.weight, *witness)
    witness_fp32 = vqa_logits(scorer, *witness)
    fp32_peak = torch.cuda.max_memory_allocated() / 2**30
    xxl.to(torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    xxl_gap = vqa_gaps(vqa_logits(scorer, *witness), witness_fp32, T5_YES_ID)
    scorer.score_pairs(pairs_images[:prompts_n], pairs_prompts[:prompts_n])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_xxl = np.concatenate([scorer.score_pairs(pairs_images[i:i + prompts_n],
                                               pairs_prompts[i:i + prompts_n])
                            for i in range(0, len(pairs_images), prompts_n)])
    torch.cuda.synchronize()
    xxl_ms = (time.perf_counter() - t0) * 1e3 / len(pairs_images)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[bench vqa-xxl] clip-flant5-xxl at full depth (24 + 24 T5 layers, {n_params / 1e9:.2f} "
          f"B params) seeded in fp32 on the card in {xxl_init_s:.1f} s (peak {fp32_peak:.2f} GiB "
          f"with the 4-pair witness), then bf16: {len(p_xxl)} pairs in batches of {prompts_n}: "
          f"{xxl_ms:.2f} ms per pair, peak {peak:.2f} GiB allocated; P(yes) in "
          f"[{p_xxl.min():.3g}, {p_xxl.max():.3g}]; bf16 vs its fp32 witness: {xxl_gap['text']}; "
          f"{smi}", flush=True)
    if len(p_xxl) != len(BENCH_INSTANCES) * len(BENCH_SEEDS) * prompts_n or not (
            np.isfinite(p_xxl).all() and (p_xxl >= 0).all() and (p_xxl <= 1).all()
            and xxl_gap["ok"]):
        raise AssertionError(f"the full-depth VQAScore gave {p_xxl}, against its fp32 witness "
                             f"{xxl_gap['text']}")
    del xxl, scorer
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[bench] the whole phase in {phase_s:.1f} s; {smi}", flush=True)
    return {
        "launches": {k: tr["launches"][k] + ev["launches"][k] for k in ev["launches"]},
        "train_launches": tr["launches"], "eval_launches": ev["launches"],
        "fresh_eval_launches": fresh["launches"], "runner_s_per_instance": job_s,
        "generate_s": gen_s, "images_per_s_batch16": BENCH_BATCH / float(np.mean(full)),
        "memo": memo, "eval_batch16_calls_s": full_calls, "eval_sampler_graph": {
            str(k): v for k, v in sampler_graphs.items()},
        "pipeline_load_ms_fresh": [reuse_loads[0][0], fresh_ms],
        "pipeline_load_ms_reuse": reuse_loads[1][0], "scorer_write_s": write_s,
        "scorer_bytes": written, "scorer_load_s": scorers["load_s"], "metrics_s": metrics_s,
        "scoring_ms_per_image": per_image, "csv": csv_rows, "card_vs_cpu": {
            **gaps, "vqa": {k: v for k, v in vqa_gap.items() if k != "text"}},
        "vqa_xxl": {"params": n_params, "init_s": xxl_init_s, "ms_per_pair": xxl_ms,
                    "peak_gib": peak, "fp32_witness_peak_gib": fp32_peak,
                    "p_yes_range": [float(p_xxl.min()), float(p_xxl.max())],
                    "bf16_vs_fp32": {k: v for k, v in xxl_gap.items() if k != "text"}},
        "group_norm": gn_sums, "k1": k1, "phase_s": phase_s,
        "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_err, "gn_max_abs_err": gn_err,
        "gn_bwd_max_abs_err": gn_bwd_err,
    }


# sd21 at 768 px (v-prediction): the DB runner's flags for `-m sd21` with the
# plans executed on the card and PNDM validation rounds, cut from 250 steps
# and a cadence of 50 to SD21_STEPS and SD21_CADENCE; then sampling from its
# output with every sampler.
SD21_STEPS = 6
SD21_CADENCE = 3
SD21_SAMPLERS = ("dpm++2m", "ddim", "ddpm", "pndm")
SD21_SEEDS = (0, 1, 2, 3)  # one latent per prompt
AUG_SWEEP = 24  # seeded full plans in the device augmentation's checks
AUG_EXACT_MIN = 8  # of them pixel-identical to the host path (as tests/test_device_augment.py)
# The device augmentation, card against the same function on the CPU and
# against the host PIL path, in uint8 levels: the gathers exact, the
# resamplings as tests/test_device_augment.py holds them.
AUG_CPU_LIMITS = {"identity": 0, "base_hflip": 0, "hflip": 0, "translate": 0, "grayscale": 0,
                  "zoom": 1, "crop": 1, "collage2": 1, "collage3": 1, "plans": 1}
AUG_HOST_LIMITS = {"identity": 0, "base_hflip": 0, "hflip": 0, "translate": 0, "grayscale": 0,
                   "zoom": 1, "crop": 2, "collage2": 3, "collage3": 3, "plans": 3}


def sd21_flags(instance_dir: str, output_dir: str):
    """`paper_flags` as `run_textboost_db.py::build_cmd` gives them for `-m sd21`
    (--model_preset=sd21 --resolution=768), plus --augment_device and
    --validation_scheduler PNDMScheduler; SD21_STEPS steps with a checkpoint
    and a validation round every SD21_CADENCE; --num_samples=2, so that both
    instance images train (the runner's 1 takes the first)."""
    swap = {"--model_preset": "sd21", "--resolution": "768",
            "--max_train_steps": str(SD21_STEPS), "--checkpointing_steps": str(SD21_CADENCE),
            "--validation_steps": str(SD21_CADENCE), "--num_samples": "2"}
    flags = [f"{f.split('=')[0]}={swap[f.split('=')[0]]}" if f.split("=")[0] in swap else f
             for f in paper_flags(instance_dir, output_dir)]
    return flags + ["--augment_device", "--validation_scheduler=PNDMScheduler"]


def unet_calls(sampler: str, steps: int) -> int:
    """UNet calls of one sampling call: PNDM's warm-up evaluates the second
    grid point twice."""
    from textboost_torch.ops.schedule import NoiseSchedule
    from textboost_torch.samplers import solvers

    if solvers.get_sampler(sampler) is solvers.pndm_sample:
        return len(solvers._pndm_coeffs(NoiseSchedule.create(), steps).timesteps)
    return steps


def cuda_kernel_counts(fns: dict, repeat: int = 6) -> dict:
    """{key: [Counter of device operations (kernels and copies) by name]}:
    one call of each of `fns` ({key: fn}) counted by torch.profiler in
    `repeat` sessions, the keys taken in turn, after a warm call of each.
    Late in this script a session may read other than a call's usual
    count (an H100 saw 488 in most sessions of a call, at times 517 or
    504, once 15), so `usual_count` takes the count most sessions read."""
    import torch
    import torch.profiler

    for fn in fns.values():
        fn()
    counts = {key: [] for key in fns}
    for _ in range(repeat):
        for key, fn in fns.items():
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            counts[key].append(collections.Counter(
                {e.key: e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}))
    return counts


def usual_count(totals) -> int:
    """The count that most profiler sessions of one call read (the first
    such on a tie)."""
    return collections.Counter(totals).most_common(1)[0][0]


def aug_cases(size: int):
    """{case: [(steps, img_idx, top, left)]} reaching every op of the device
    augmentation: each op alone on the square image 0 (and, for some, on
    the wide image 1 at a column offset), then AUG_SWEEP seeded full plans
    of the paper's augmentation (`--augment pda --augment_inversion`, p 0.5)
    on image 0; the planners' draws are seeded."""
    import numpy as np

    from textboost_torch.data import augment as aug

    captions = aug.REFERENCE_CAPTION_MAP
    cases = {"identity": [([], 0, 0, 0), ([], 1, 0, 256)],
             "base_hflip": [([{"op": "base_hflip"}], 0, 0, 0), ([{"op": "base_hflip"}], 1, 0, 17)],
             "hflip": [([{"op": "hflip"}], 0, 0, 0)],
             "grayscale": [([{"op": "grayscale"}], 0, 0, 0), ([{"op": "grayscale"}], 1, 0, 99)],
             "collage2": [([{"op": "collage", "axis": 2}], 0, 0, 0)],
             "collage3": [([{"op": "collage", "axis": 3}], 0, 0, 0)]}
    for name, planner in (("translate", aug.plan_horizontal_translate),
                          ("zoom", aug.plan_adjust_scale), ("crop", aug.plan_crop)):
        cases[name] = [([planner((size, size), "p", True, np.random.default_rng((4, seed)),
                                 captions)[0]], 0, 0, 0) for seed in range(3)]
    pipe = aug.PairedAugmentation(hflip="inversion", inversion=True, p=0.5, ops="object", seed=0)
    cases["plans"] = [(pipe.plan((size, size), "a <x>", np.random.default_rng((99, trial)))[0],
                       0, 0, 0) for trial in range(AUG_SWEEP)]
    return cases


def device_augment_checks(bank_np, size: int, square_path: str) -> dict:
    """The device augmentation on the card at the phase's bank: against the
    same function on the CPU, against the host PIL path on the square image
    (image 0 of the bank), its launches at batch 8 and 16, its device time."""
    import numpy as np
    import torch

    from textboost_torch.data import augment as aug
    from textboost_torch.data import device_augment as da
    from textboost_torch.data.datasets import load_rgb, resize_shorter_side

    cases = aug_cases(size)
    rows = [(name, i) for name, items in cases.items() for i in range(len(items))]
    params = da.stack_aug_params([da.encode_plan(cases[n][i][0], size, *cases[n][i][1:])
                                  for n, i in rows])
    bank = torch.from_numpy(bank_np).cuda()
    card = da.augment_batch(bank, params, size).cpu().numpy().astype(np.int32)
    cpu = da.augment_batch(torch.from_numpy(bank_np), params, size).numpy().astype(np.int32)
    image = load_rgb(square_path)
    host = np.stack([np.asarray(resize_shorter_side(aug.execute_plan_pil(image.copy(), steps),
                                                    size)).astype(np.int32)
                     if img == 0 else card[k] for k, (steps, img, _, _) in enumerate(
                         cases[n][i] for n, i in rows)])
    vs_cpu, vs_host, exact = {}, {}, 0
    for name in cases:
        idx = [k for k, (n, _) in enumerate(rows) if n == name]
        vs_cpu[name] = int(np.abs(card[idx] - cpu[idx]).max())
        on_square = [k for k in idx if cases[name][rows[k][1]][1] == 0]
        vs_host[name] = int(np.abs(card[on_square] - host[on_square]).max())
        if name == "plans":
            exact = sum(bool(np.array_equal(card[k], host[k])) for k in on_square)
    bad = {n: (vs_cpu[n], vs_host[n]) for n in cases
           if vs_cpu[n] > AUG_CPU_LIMITS[n] or vs_host[n] > AUG_HOST_LIMITS[n]}
    # Launches at batch 8 and 16: the first 8 sweep plans, then the same twice.
    plans8 = [da.encode_plan(steps, size, img, top, left)
              for steps, img, top, left in cases["plans"][:8]]
    batches = {b: da.stack_aug_params(plans8 * (b // 8)) for b in (8, 16)}
    counted = cuda_kernel_counts({b: (lambda p=p: da.augment_batch(bank, p, size))
                                  for b, p in batches.items()})
    each = {b: [sum(c.values()) for c in counts] for b, counts in counted.items()}
    launches = {b: usual_count(n) for b, n in each.items()}
    if launches[8] != launches[16]:
        usual = {b: counted[b][each[b].index(n)] for b, n in launches.items()}
        print(f"[sd21 augment] device operations by session {each}; by name at 16 but not at 8 "
              f"{dict(usual[16] - usual[8])}, at 8 but not at 16 {dict(usual[8] - usual[16])}",
              flush=True)
    card_ms = {b: cuda_ms(lambda: da.augment_batch(bank, p, size), 10)
               for b, p in batches.items()}
    ops = sorted({k for steps, *_ in cases["plans"][:8] for k in (s["op"] for s in steps)})
    print(f"[sd21 augment] {len(rows)} plans at {size} px on the card: against the same function "
          f"on the CPU, max |diff| by case {vs_cpu} (limits {AUG_CPU_LIMITS}); against the host "
          f"PIL path on the square image {vs_host} (limits {AUG_HOST_LIMITS}), {exact} of "
          f"{AUG_SWEEP} full plans pixel-identical (at least {AUG_EXACT_MIN}); device operations "
          f"per batch {launches[8]} at batch 8, {launches[16]} at 16 (each session {each}; ops "
          f"{ops}); device time "
          f"per batch {card_ms[8]:.3f} ms at 8, {card_ms[16]:.3f} ms at 16", flush=True)
    if bad or exact < AUG_EXACT_MIN:
        raise AssertionError(f"the device augmentation disagrees: {bad}, {exact} exact plans")
    if launches[8] != launches[16]:
        raise AssertionError(f"the device augmentation's launches grew with the batch: {launches}")
    del bank
    return {"plans": len(rows), "max_diff_vs_cpu": vs_cpu, "max_diff_vs_host": vs_host,
            "exact_plans": exact, "launches_per_batch": launches, "launches_by_session": each,
            "card_ms_per_batch": card_ms}


def dataset_host_ms(instance_dir: str, size: int, device_augment: bool, steps: int = 4):
    """Host ms per batch of 8 (one thread) of the sd21 run's dataset, as the
    trainer's loader builds it (the same shuffled indices and per-sample
    draws): plans only (`device_augment`), or the host PIL path's pixels.
    Returns (ms, the dataset, its first `steps` batches)."""
    import numpy as np

    from textboost_torch.data import device_augment as da
    from textboost_torch.data import native
    from textboost_torch.data.sharding import ShardedIndexIterator
    from textboost_torch.data.augment import PairedAugmentation
    from textboost_torch.data.datasets import TextBoostDataset
    from textboost_torch.data.tokenizer import load_tokenizer
    from textboost_torch.train.trainer import plan_tokens

    tok = load_tokenizer(None)
    plan = plan_tokens(tok, [{"instance_token": "<0>", "placeholder_token": "<teapot>",
                              "initializer_token": "brown teapot"}], "dog",
                       augment_inversion=True)
    ds = TextBoostDataset(
        [{"instance_data_dir": instance_dir, "instance_token": plan.concept_tokens["<0>"]}],
        tok, num_instance=2, template="imagenet_small", size=size,
        augment_pipe=PairedAugmentation(hflip="inversion", inversion=True, p=0.5,
                                        caption_map=plan.caption_map, seed=0),
        seed=0, device_augment=device_augment)
    if device_augment:
        ds.build_image_bank()
    else:  # warm: the native zoom library loaded, both images decoded (the run's steady state)
        native.get_lib()
        for i in range(2):
            ds.__getitem__(i, rng=np.random.default_rng((1, 0, i)))
    indices = iter(ShardedIndexIterator(len(ds), seed=0))
    t0 = time.perf_counter()
    batches = []
    for step in range(steps):
        batch = TextBoostDataset.collate([ds.__getitem__(next(indices), rng=np.random.default_rng(
            (0, step, i))) for i in range(8)])
        if device_augment:
            da.pack_params(batch["aug"])
        batches.append(batch)
    return (time.perf_counter() - t0) * 1e3 / steps, ds, batches


def sd21_phase(gen, card: dict, work: str, smi: str, held: dict) -> dict:
    """sd21 at 768 px through the port's entry points: `textboost_torch.train`
    with `sd21_flags` (the plans executed on the card, PNDM validation), every
    kernel call's shape recorded and the launches those derived from the
    config (PNDM's 26 UNet calls a round among them); then its output served
    by each sampler twice (bit-identical, finite, launches as derived); each
    kernel held at every shape of both; the step's batch rebuilt from the
    dataset's plans; and the device augmentation against the CPU and the host
    path.  `held`: what the earlier phases held."""
    import numpy as np
    import torch
    from PIL import Image

    from textboost_torch.data import device_augment as da
    from textboost_torch.data.tokenizer import load_tokenizer
    from textboost_torch.models.configs import get_spec
    from textboost_torch.ops import flash_attention as fa
    from textboost_torch.ops import group_norm as gn
    from textboost_torch.pipelines.loading import load_textboost_pipeline
    from textboost_torch.train import trainer as trainer_mod
    from textboost_torch.train.trainer import plan_tokens

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    spec = get_spec("sd21")
    size = spec.resolution

    # a. the launches, derived from the config ---------------------------------
    per_step = train_step_calls("sd21", 8, 8, checkpointing=False, cross_lora_rank=0)
    per_step_n = {k: sum(c.values()) for k, c in per_step.items()}
    if tuple(per_step_n[k] for k in ("flash", "flash_bwd", "gn", "gn_bwd")) != \
            expected_train_launches(spec):
        raise AssertionError(f"sd21's train step: {per_step_n} on the meta device, "
                             f"{expected_train_launches(spec)} from the spec")
    calls = {name: unet_calls(name, 25) for name in SD21_SAMPLERS}
    per_call = {name: expected_launches(spec, n) for name, n in calls.items()}
    rounds = SD21_STEPS // SD21_CADENCE
    val = per_call["pndm"]
    want = {"flash": SD21_STEPS * per_step_n["flash"] + rounds * val[0],
            "flash_bwd": SD21_STEPS * per_step_n["flash_bwd"],
            "gn": SD21_STEPS * per_step_n["gn"] + rounds * val[1],
            "gn_bwd": SD21_STEPS * per_step_n["gn_bwd"]}
    print(f"[sd21] derived: per train step at batch 8 {per_step_n}; UNet calls per sampling call "
          f"{calls}; launches (flash, group norm) per sampling call {per_call}; the run "
          f"({SD21_STEPS} steps, {rounds} PNDM validation rounds) {want}", flush=True)

    # b. the run: a square and a wide instance image, the plans on the card ----
    instance_dir = os.path.join(work, "instance")
    os.makedirs(instance_dir)
    square = os.path.join(instance_dir, "a.png")
    write_instance_image(square, seed=2, width=size, height=size)
    write_instance_image(os.path.join(instance_dir, "b.png"), seed=3, width=1024, height=size)
    out = os.path.join(work, "run")
    peaks = {"train": [], "validation": [], "train_reserved": [], "validation_reserved": []}
    real_validation = trainer_mod.Trainer.run_validation

    def measured_validation(self, step):
        torch.cuda.synchronize()
        peaks["train"].append(torch.cuda.max_memory_allocated())
        peaks["train_reserved"].append(torch.cuda.max_memory_reserved())
        torch.cuda.reset_peak_memory_stats()
        try:
            return real_validation(self, step)
        finally:
            torch.cuda.synchronize()
            peaks["validation"].append(torch.cuda.max_memory_allocated())
            peaks["validation_reserved"].append(torch.cuda.max_memory_reserved())
            torch.cuda.reset_peak_memory_stats()

    trainer_mod.Trainer.run_validation = measured_validation
    torch.cuda.reset_peak_memory_stats()
    try:
        run = instrumented_train(sd21_flags(instance_dir, out), trace_call=SD21_STEPS - 1,
                                 capture_call=1)
    finally:
        trainer_mod.Trainer.run_validation = real_validation
    m = run["metrics"]
    ev = run["events"]
    warm = [ev[s - 2].elapsed_time(ev[s - 1]) for s in range(3, SD21_STEPS)
            if (s - 1) % SD21_CADENCE]
    busy = sum(run["kernel_ms"].values())
    print(f"[sd21] {SD21_STEPS} steps sd21 768 px batch 8 bf16, --augment_device, PNDM "
          f"validation every {SD21_CADENCE}, in {run['run_s']:.1f} s (model init, validation and "
          f"export included): loss {m['loss']:.5g}, kpl {m['kpl']:.3g}; warm step "
          f"{np.mean(warm):.1f} ms (step 3 eager, step 5 a replay: "
          f"{[round(w, 1) for w in warm]}); {step_graph_check(m, SD21_STEPS, 'the sd21 run')}; "
          f"traced step "
          f"{SD21_STEPS}: {run['traced_wall_ms']:.1f} ms wall, {busy:.1f} ms of kernels (idle "
          f"{1 - busy / run['traced_wall_ms']:.3f}); validation round {m['validation_ms']:.0f} ms "
          f"(16 images, PNDM 25 steps); peak memory {max(peaks['train']) / 2**30:.2f} GiB "
          f"training, {max(peaks['validation']) / 2**30:.2f} GiB in a validation round (UNet "
          f"batch 32 at 96x96 latents, the step's state alive), reserved "
          f"{max(peaks['train_reserved'] + [run['reserved_bytes']]) / 2**30:.2f} and "
          f"{max(peaks['validation_reserved']) / 2**30:.2f} GiB ({m['validation_graph']}); "
          f"launches {run['launches']} "
          f"(expected {want}); {smi}", flush=True)
    if run["launches"] != want:
        raise AssertionError(f"the sd21 run launched {run['launches']}, expected {want}")
    if m["steps"] != SD21_STEPS or not all(
            math.isfinite(m[k]) for k in ("loss", "kpl", "grad_norm", "added_embedding_norm")):
        raise AssertionError(f"the sd21 run returned {m}")
    for step in range(SD21_CADENCE, SD21_STEPS + 1, SD21_CADENCE):
        for name in ("state.pt", "text_encoder/adapter_model.safetensors"):
            if not os.path.isfile(os.path.join(out, f"checkpoint-{step}", name)):
                raise AssertionError(f"checkpoint-{step} holds no {name}")
        grid = Image.open(os.path.join(out, f"validation_{step}.jpg")).size
        if grid != (4 * size, 4 * size):
            raise AssertionError(f"validation_{step}.jpg is {grid}, not 4 x 4 images of {size} px")
    plan = plan_tokens(load_tokenizer(None), [{"instance_token": "<0>",
                                               "placeholder_token": "<teapot>",
                                               "initializer_token": "brown teapot"}], "dog",
                       augment_inversion=True)
    for name in ["text_encoder/adapter_model.safetensors"] + [
            t.strip("<>") + ".bin" for t in plan.token_to_id]:
        if not os.path.isfile(os.path.join(out, name)):
            raise AssertionError(f"the sd21 run exported no {name}")

    # c. step 2's batch is the dataset's plans executed on the card -----------
    dev_host_ms, ds, plan_batches = dataset_host_ms(instance_dir, size, True)
    host_ms, _, _ = dataset_host_ms(instance_dir, size, False)
    bank_np = ds.build_image_bank()[0]
    bank = torch.from_numpy(bank_np).to(dev)
    captured = run["captured"]["batch"]
    rebuilt = da.augment_batch(bank, plan_batches[1]["aug"], size).cpu()
    if not (torch.equal(rebuilt, captured["pixel_values"]) and np.array_equal(
            plan_batches[1]["input_ids"].astype(np.int64), captured["input_ids"].numpy())):
        raise AssertionError("step 2 of the sd21 run did not train on its dataset's plans "
                             "executed on the card")
    ids_bytes = sum(captured[k].numel() * captured[k].element_size()
                    for k in ("input_ids", "prior_input_ids"))
    h2d = {"device_path": ids_bytes + da.h2d_bytes(8),
           "host_path": ids_bytes + captured["pixel_values"].numel()}
    offsets = sorted({int(v) for b in plan_batches for v in b["aug"]["left"][
        b["aug"]["img_idx"] == 1]})
    print(f"[sd21 data] bank {tuple(bank_np.shape)} uint8 ({bank_np.nbytes / 1e6:.2f} MB, "
          f"uploaded once); step 2's pixels are the dataset's plans executed on the card, bit "
          f"for bit; the wide image's column offsets in 4 batches {offsets}; host ms per batch "
          f"of 8 (one thread): plans {dev_host_ms:.2f}, the host PIL path {host_ms:.1f}; bytes "
          f"to the card per step {h2d['device_path']} (ids and plan rows), "
          f"{h2d['host_path']} on the host path", flush=True)
    del bank
    augment = device_augment_checks(bank_np, size, square)

    # d. serving its output with every sampler, twice ---------------------------
    gc.collect()
    torch.cuda.empty_cache()
    prompts = [p.replace("<0>", plan.concept_tokens["<0>"]) for p in PAPER_PROMPTS]
    latents = torch.cat([torch.randn((1, size // 8, size // 8, 4), device=dev,
                                     generator=torch.Generator(dev).manual_seed(s))
                         for s in SD21_SEEDS])
    sampling, serve = {}, {}
    with kernel_calls("sd21 sampling") as srec:
        t0 = time.perf_counter()
        pipe = load_textboost_pipeline(out, "sd21", device=dev)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        for name in SD21_SAMPLERS:
            images, seconds, launches = [], [], []
            for _ in range(2):
                before = (fa.launches, gn.launches, fa.bwd_launches + gn.bwd_launches)
                t0 = time.perf_counter()
                images.append(pipe(prompts, num_inference_steps=25, guidance_scale=7.5,
                                   latents=latents, sampler=name))
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                launches.append((fa.launches - before[0], gn.launches - before[1],
                                 fa.bwd_launches + gn.bwd_launches - before[2]))
            same = bool(np.array_equal(*images))
            sampling[name] = {"s": seconds, "images_per_s": len(prompts) / seconds[1],
                              "launches_per_call": launches[0][:2], "bit_identical": same}
            print(f"[sd21 sample] {name}: {len(prompts)} prompts at {size} px, 25 steps "
                  f"({calls[name]} UNet calls), CFG 7.5: {seconds[0]:.2f} / {seconds[1]:.2f} s, "
                  f"{len(prompts) / seconds[1]:.3f} images/s; launches (flash, group norm) per "
                  f"call {launches} (expected {per_call[name]}); two calls bit-identical: "
                  f"{same}", flush=True)
            if images[0].dtype != np.uint8 or images[0].shape != (len(prompts), size, size, 3):
                raise AssertionError(f"{name} gave {images[0].dtype} {images[0].shape}")
            if not same or any(n[:2] != per_call[name] or n[2] for n in launches):
                raise AssertionError(f"{name}: launches {launches}, expected {per_call[name]}; "
                                     f"bit-identical {same}")
            serve[name] = images[0]
        del pipe
    if len({im.tobytes() for im in serve.values()}) != len(SD21_SAMPLERS):
        raise AssertionError("two samplers gave the same images")

    # e. every kernel at every shape of the run and of the sampling -------------
    gc.collect()
    torch.cuda.empty_cache()
    seen, sseen = run["shapes"], srec["shapes"]
    train_gn = group_norm_calls("sd21")  # UNet and encoder at 8, the decoder at 4
    val_gn = group_norm_calls("sd21", unet_batch=32, decode_batch=16)
    derived, derived_sampling = collections.Counter(), collections.Counter()
    derived.update({key: SD21_STEPS * n for key, n in per_step["gn"].items()})
    derived.update({key: rounds * calls["pndm"] * n for key, n in val_gn["unet"].items()})
    derived.update({key: rounds * n for key, n in val_gn["decode"].items()})
    for name in SD21_SAMPLERS:
        derived_sampling.update({key: 2 * calls[name] * n for key, n in train_gn["unet"].items()})
        derived_sampling.update({key: 2 * n for key, n in train_gn["decode"].items()})
    derived_bwd = collections.Counter({key: SD21_STEPS * n for key, n in per_step["gn_bwd"].items()})
    if seen["gn"] != derived or seen["gn_bwd"] != derived_bwd or sseen["gn"] != derived_sampling:
        raise AssertionError(f"the sd21 GroupNorm calls differ from those derived from the "
                             f"config: run {dict(seen['gn'] - derived)} / "
                             f"{dict(derived - seen['gn'])}, backward "
                             f"{dict(seen['gn_bwd'] - derived_bwd)} / "
                             f"{dict(derived_bwd - seen['gn_bwd'])}, sampling "
                             f"{dict(sseen['gn'] - derived_sampling)} / "
                             f"{dict(derived_sampling - sseen['gn'])}")
    if seen["flash_bwd"] != collections.Counter(
            {k: SD21_STEPS * n for k, n in per_step["flash_bwd"].items()}):
        raise AssertionError(f"the sd21 run's flash backward calls {dict(seen['flash_bwd'])}")
    fwd_calls = seen["gn"] + sseen["gn"]
    new_rows, gn_err = group_norm_table(gen, set(fwd_calls) - set(held["gn_rows"]),
                                        {key: {"sd21": n} for key, n in fwd_calls.items()},
                                        backward=False)
    new_bwd_rows, gn_bwd_err = group_norm_table(
        gen, set(derived_bwd) - set(held["gn_bwd_rows"]),
        {key: {"sd21": n} for key, n in derived_bwd.items()}, backward=True)
    gn_sums = {}
    for name, counts, table in (("group_norm_fwd", fwd_calls, {**held["gn_rows"], **new_rows}),
                                ("group_norm_bwd", derived_bwd,
                                 {**held["gn_bwd_rows"], **new_bwd_rows})):
        gn_sums[name] = {field: sum(n * table[key][field] for key, n in counts.items())
                         for field in ("ms", "cold_ms", "bound_ms", "library_ms")}
        gn_sums[name]["launches"] = sum(counts.values())
    flash_calls = seen["flash"] + sseen["flash"]
    k1_err = check_flash_forward(gen, sorted(set(flash_calls) - held["flash"]))
    k2_err = check_flash_backward(gen, [(b, n, h, d, mm, mm) for b, n, h, d, mm in
                                        sorted(set(seen["flash_bwd"]) - held["flash_bwd"])])
    k1 = {f"sd21_{b}x{n}x{h}x{d}": dict(flash_forward_times(gen, b, n, h, d, card),
                                         launches=flash_calls[(b, n, h, d, mm)])
          for b, n, h, d, mm in sorted(flash_calls)}
    k2 = {f"sd21_{b}x{n}x{h}x{d}": dict(flash_backward_times(gen, b, n, h, d, card),
                                         launches=seen["flash_bwd"][(b, n, h, d, mm)])
          for b, n, h, d, mm in sorted(seen["flash_bwd"])}
    for tag, times in (("K1", k1), ("K2", k2)):
        for name, t in times.items():
            print(f"[sd21 flash] {tag} {name}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, "
                  f"{t['bound_floor']}; SDPA {t['library_ms']:.4f}; plain {t['plain_ms']:.3f}); "
                  f"launches {t['launches']}; {smi}", flush=True)
    main_key = ((8, 320, 96, 96), 32, 1e-6, False)  # Transformer2D norm, UNet level 0 at 768
    x = torch.randn(main_key[0], generator=gen, device=dev).to(torch.bfloat16)
    ga = torch.randn(320, generator=gen, device=dev) * 0.2 + 1
    be = torch.randn(320, generator=gen, device=dev) * 0.1
    _, mu, rs = gn.group_norm_forward(x, ga, be, 32, eps=1e-6, silu=False)
    dy = torch.randn(main_key[0], generator=gen, device=dev).to(torch.bfloat16)
    gn_plain = {"fwd": cuda_ms(lambda: gn.group_norm_reference(x, ga, be, 32, 1e-6, False), 10),
                "bwd": cuda_ms(lambda: gn.group_norm_backward_reference(
                    x, ga, be, mu, rs, dy, 32, 1e-6, False), 10)}
    del x, dy, mu, rs
    print(f"[sd21 kernels] K1 at the {len(flash_calls)} shapes of the run and the sampling "
          f"{dict(flash_calls)}, K2 at {dict(seen['flash_bwd'])}; the GroupNorm keys of the "
          f"run and the sampling are those derived from the config, {len(new_rows)} forward and "
          f"{len(new_bwd_rows)} backward new ones held now; launch-weighted over the phase: " +
          "; ".join(f"{name} {v['launches']} launches {v['ms']:.2f} ms warm, bound "
                    f"{v['bound_ms']:.2f}, library {v['library_ms']:.2f}"
                    for name, v in gn_sums.items()) + f"; {smi}", flush=True)

    phase_s = time.perf_counter() - t_phase
    launches = {k: run["launches"][k] + srec["launches"][k] for k in run["launches"]}
    print(f"[sd21] the whole phase in {phase_s:.1f} s; warm step {np.mean(warm):.1f} ms; peak "
          f"{max(peaks['train']) / 2**30:.2f} GiB training, {max(peaks['validation']) / 2**30:.2f} "
          f"GiB in a validation round; images/s " + ", ".join(
              f"{name} {v['images_per_s']:.3f}" for name, v in sampling.items()) +
          f"; launches {launches}; {smi}", flush=True)
    return {
        "launches": launches, "train_launches": run["launches"],
        "sampling_launches": srec["launches"], "variants": run["variants"],
        "run_s": run["run_s"], "warm_step_ms": float(np.mean(warm)), "warm_steps_ms": warm,
        "traced_step_wall_ms": run["traced_wall_ms"], "traced_step_kernel_ms": busy,
        "idle_share": 1 - busy / run["traced_wall_ms"], "final_loss": m["loss"],
        "validation_ms": m["validation_ms"], "peak_gib": {
            k: max(v) / 2**30 for k, v in peaks.items()},
        "sampling": sampling, "pipeline_load_ms": load_ms, "h2d_bytes_per_step": h2d,
        "host_ms_per_batch": {"device_path_plans": dev_host_ms, "host_path": host_ms},
        "device_augment": augment, "group_norm": gn_sums, "phase_s": phase_s,
        "k1": k1, "k2": k2, "gn_main": {
            "fwd": {**group_norm_json(new_rows[main_key]), "plain_ms": gn_plain["fwd"],
                    "launches": fwd_calls[main_key]},
            "bwd": {**group_norm_json(new_bwd_rows[main_key]), "plain_ms": gn_plain["bwd"],
                    "launches": derived_bwd[main_key]}},
        "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_err, "gn_max_abs_err": gn_err,
        "gn_bwd_max_abs_err": gn_bwd_err,
    }


# Data parallel at sd21base (`dp_phase`): the paper run's flags at global
# batch 8, DP_STEPS steps with a checkpoint every DP_CADENCE and a
# validation round every DP_VALIDATION, each run a process of its own (or
# two) launched as a user would.  Few steps, so that the script keeps its
# time limit: 3 eager, the capture and a clean replay where the step is
# captured; a resume from checkpoint-3 still crosses a round.
DP_STEPS = 5
DP_CADENCE = 3
DP_VALIDATION = 5
# One image a validation prompt (the runner's default is 4): a round's UNet
# at batch 8, so that the phase's four rounds cost a second or so each.
DP_VALIDATION_IMAGES = 1
DP_RANKS = 2  # sharing the one card: gloo (NCCL refuses two ranks on one device)
# Eager in every run (step 4 carries checkpoint-3 and, in one process, the
# capture); step 5 a replay in one process and under NCCL at world 1.
DP_WARM_STEPS = (2, 3)
DP_REPLAY_STEP = 5
DP_LAUNCH_TIMEOUT_S = 300
# The 2-rank run against the one-process run at batch 8, bf16: the same
# samples and draws, but each rank's UNet runs at batch 4, where cuBLAS and
# cuDNN may pick other algorithms (a bf16 ulp is 3.9e-3), and the ranks'
# losses and gradients are averaged in fp32.  On an NVIDIA H100 80GB HBM3
# (700 W) the gaps were 1.9e-5-2.3e-4 a step's loss, 2.7e-5 for the
# exported LoRA and 3.4e-3 for the added rows (embedding lr 1e-3, near-sign
# AdamW steps); the bounds are ~6-9x those, and below a bf16 ulp for the loss.
DP_LOSS_REL = 2e-3  # each step's loss
DP_REL_L2 = 2e-2  # the exported LoRA and added rows after DP_STEPS AdamW steps
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def run_launch(argv, what: str, timeout_s: float = DP_LAUNCH_TIMEOUT_S) -> str:
    """Run `argv` (a python process, or a torchrun launch and its ranks)
    from the repo root in a session of its own; returns its output (stdout
    and stderr).  Raises on a nonzero exit; past `timeout_s` the whole
    session is killed and it raises."""
    import signal

    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO_DIR if not path else f"{REPO_DIR}{os.pathsep}{path}")
    proc = subprocess.Popen(argv, cwd=REPO_DIR, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{what} did not finish within {timeout_s} s")
    if proc.returncode:
        print(out[-6000:], flush=True)
        raise AssertionError(f"{what} exited {proc.returncode}")
    return out


def record_writes(root: str) -> list:
    """From now on, every path under `root` (relative to it) that this
    process opens for writing, makes, renames or removes, seen by an audit
    hook, is appended to the list returned."""
    writes = []
    write_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT

    def audit(event, args):
        if event == "open":
            path, mode, flags = args
            writing = ((isinstance(mode, str) and any(c in mode for c in "wax+"))
                       or (isinstance(flags, int) and flags & write_flags))
        elif event in ("os.mkdir", "os.rename", "os.remove", "shutil.rmtree"):
            path, writing = args[0], True
        else:
            return
        if writing and isinstance(path, (str, bytes, os.PathLike)):
            full = os.path.abspath(os.fsdecode(path))
            if full == root or full.startswith(root + os.sep):
                writes.append(os.path.relpath(full, root))

    sys.addaudithook(audit)
    return writes


def dp_rank(json_dir: str, argv, digest: bool = False) -> int:
    """The program of each process `dp_phase` and `tp_phase` launch
    (`python chip_smoke.py --dp-rank DIR -- FLAGS`, alone or under python -m
    torch.distributed.run; `--tp-rank` sets `digest`):
    `textboost_torch.train.main(FLAGS)` through `instrumented_train`, then
    this rank's numbers into DIR/rank{RANK}.json: its launches and kernel
    shapes, the losses by step, the all-reduce's numbers, the tensor-parallel
    collectives by step, the step times, the peak memory, and every file and
    dir it opened for writing or made under --output_dir (an audit hook sees
    each); with `digest`, a sha1 of the trainable weights (the added rows,
    the text encoder's and the UNet's LoRA) after each step (a copy to the
    host that waits for the step)."""
    import hashlib

    import numpy as np
    import torch

    from textboost_torch.lora.partition import lora_parameters

    rank = int(os.environ.get("RANK", "0"))
    output_dir = os.path.abspath(next(a.split("=", 1)[1] for a in argv
                                      if a.startswith("--output_dir=")))
    digests = []

    def weights_digest(call, state, batch, metrics):
        te = state.text_encoder
        parts = ([te.token_embedding.weight[state.original_rows.shape[0]:]]
                 + lora_parameters(te) + state.unet_lora)
        flat = torch.cat([p.detach().reshape(-1).float() for p in parts]).cpu().numpy()
        digests.append(hashlib.sha1(flat.tobytes()).hexdigest())

    writes = record_writes(output_dir)
    tr = instrumented_train(argv, on_step=weights_digest if digest else None)
    ev = tr["events"]
    step_ms = [ev[s - 2].elapsed_time(ev[s - 1]) for s in range(2, len(ev) + 1)]
    m = tr["metrics"]
    out = {"rank": rank, "launches": tr["launches"], "run_s": tr["run_s"],
           "shapes": {k: [[repr(key), n] for key, n in c.items()] for k, c in tr["shapes"].items()},
           "loss_by_step": m["loss_by_step"], "steps_ms": dict(zip(range(2, len(ev) + 1), step_ms)),
           "warm_step_ms": float(np.mean([step_ms[s - 2] for s in DP_WARM_STEPS if s - 2 < len(step_ms)])),
           "peak_bytes": torch.cuda.max_memory_allocated(), "writes": sorted(set(writes)),
           "dp": {k: m[k] for k in ("dp_backend", "dp_world", "all_reduce_calls",
                                    "all_reduce_replayed", "all_reduce_bytes_per_call",
                                    "all_reduce_ms_by_call") if k in m},
           "tp": {k: m[k] for k in m if k.startswith("tp_")}, "digests": digests,
           "step_graph": {k: m[k] for k in m if k.startswith(("step_graph", "validation_graph"))}}
    with open(os.path.join(json_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def launch_rank_program(work: str, name: str, nproc: int, flags, program: str = "--dp-rank"):
    """Launch this script's rank program (`program` DIR -- FLAGS) under
    `python -m torch.distributed.run --standalone --nproc_per_node nproc`,
    or alone when nproc is 0; returns (output, [each rank's numbers]), the
    command's wall time in each as "wall_s"."""
    import ast

    json_dir = os.path.join(work, f"{name}_json")
    os.makedirs(json_dir)
    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 f"--nproc_per_node={nproc}"] if nproc else [sys.executable])
    t0 = time.perf_counter()
    out = run_launch([*launcher, os.path.join(REPO_DIR, "chip_smoke.py"), program, json_dir,
                      "--", *flags], f"the {name} run")
    wall = time.perf_counter() - t0
    res = []
    for r in range(nproc or 1):
        with open(os.path.join(json_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
        res[-1]["wall_s"] = wall
        res[-1]["shapes"] = {k: collections.Counter({ast.literal_eval(key): n for key, n in v})
                             for k, v in res[-1]["shapes"].items()}
    return out, res


def dp_tree(run_dir: str) -> dict:
    """{relative path: bytes} of the files a run left, but its log (whose
    lines carry times)."""
    out = {}
    for d, _, files in os.walk(run_dir):
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), run_dir)
            if rel != "training.log":
                with open(os.path.join(d, name), "rb") as f:
                    out[rel] = f.read()
    return out


def same_state(a, b) -> bool:
    """Whether two loaded checkpoint states (nested dicts, lists, tensors
    and scalars) hold the same values, bit for bit (torch.save's files
    differ from save to save: each carries a serialization id)."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(same_state, a, b))
    return a == b


def dp_export_gaps(a: str, b: str) -> dict:
    """Relative L2 gaps of run b's exported LoRA (and the UNet's, where run
    a exported one) and added rows to run a's."""
    import numpy as np
    import torch

    from textboost_torch.lora.peft_io import import_token_embeddings, load_safetensors

    def flat(d, part):
        t = load_safetensors(os.path.join(d, part, "adapter_model.safetensors"))
        return torch.cat([torch.from_numpy(t[k]).float().flatten() for k in sorted(t)])

    bins = sorted(f for f in os.listdir(a) if f.endswith(".bin"))
    rows = [import_token_embeddings([os.path.join(d, f) for f in bins]) for d in (b, a)]
    out = {"lora": rel_l2(flat(b, "text_encoder"), flat(a, "text_encoder")),
           "rows": rel_l2(*(torch.from_numpy(np.stack([r[t] for t in sorted(r)])).float()
                            for r in rows))}
    if os.path.isdir(os.path.join(a, "unet")):
        out["unet_lora"] = rel_l2(flat(b, "unet"), flat(a, "unet"))
    return out


def dp_phase(gen, card: dict, work: str, smi: str, held: dict) -> dict:
    """Data parallel over torch.distributed at sd21base (see the module
    docstring): the one-process run, NCCL at world 1, two ranks over gloo
    on the one card and their resume, each a process launched as a user
    would; every kernel held at the ranks' batch-4 shapes."""
    import numpy as np
    import torch

    from textboost_torch.models.configs import get_spec

    t_phase = time.perf_counter()
    spec = get_spec("sd21base")
    per_step, per_round = expected_train_launches(spec), expected_launches(spec, 25)
    rounds = DP_STEPS // DP_VALIDATION
    instance_dir = os.path.join(work, "instance")
    os.makedirs(instance_dir)
    write_instance_image(os.path.join(instance_dir, "teapot.png"), seed=1)
    dirs = {name: os.path.join(work, name) for name in ("one", "nccl", "two", "resumed")}

    def flags(name, *extra):
        return paper_flags(instance_dir, dirs[name], f"--max_train_steps={DP_STEPS}",
                           f"--checkpointing_steps={DP_CADENCE}",
                           f"--validation_steps={DP_VALIDATION}",
                           f"--num_validation_images={DP_VALIDATION_IMAGES}", *extra)

    def ranks(name, nproc, *extra):
        return launch_rank_program(work, name, nproc, flags(name, *extra))

    def log_line(name, pattern):
        with open(os.path.join(dirs[name], "training.log")) as f:
            found = re.findall(pattern, f.read())
        if len(found) != 1:
            raise AssertionError(f"the {name} run's training.log holds {len(found)} lines "
                                 f"matching {pattern!r}")
        return found[0]

    # a. one process, no launcher; then NCCL at world 1: each step a CUDA
    # graph from step 4, the NCCL run's all-reduce inside it ------------------
    from textboost_torch.train.graph import WARMUP_STEPS

    _, (one,) = ranks("one", 0)
    step_graph_check(one["step_graph"], DP_STEPS, "the dp phase's one process")
    nccl_out, (nccl,) = ranks("nccl", 1)
    nccl_s = nccl["wall_s"]
    nccl_graph = step_graph_check(nccl["step_graph"], DP_STEPS, "the NCCL world-1 run")
    backend_nccl = re.findall(r"torch\.distributed: rank 0 of 1 .*backend (\w+)", nccl_out)
    nccl_losses = json.loads(log_line("nccl", r"Loss by step 1-\d+: (\[.*\])"))
    nccl_reduce = log_line("nccl", r"all-reduce: (\d+) calls, (\d+) bytes each; (\d+) eager, "
                                   r"timed: median ([\d.]+) ms .*?; (\d+) replayed")
    tree_one, tree_nccl = dp_tree(dirs["one"]), dp_tree(dirs["nccl"])
    same_tree = sorted(tree_one) == sorted(tree_nccl)
    # metrics.jsonl holds times: its losses are compared; the files
    # torch.save wrote (a checkpoint's state.pt, the token bins), their values.
    saved = [k for k in tree_one if k.endswith((".pt", ".bin"))]
    differ = sorted(k for k in tree_one if tree_nccl.get(k) != tree_one[k]
                    and k != "metrics.jsonl" and k not in saved)
    differ += [k for k in saved if not same_state(*(
        torch.load(os.path.join(dirs[name], k), map_location="cpu", weights_only=True)
        for name in ("one", "nccl")))]
    records = {name: [json.loads(line) for line in open(os.path.join(dirs[name], "metrics.jsonl"))]
               for name in ("one", "nccl")}
    keys = ("loss", "den_loss", "kpl", "grad_norm", "added_embedding_norm")
    same_records = [[r.get(k) for k in keys] for r in records["one"]] == [
        [r.get(k) for k in keys] for r in records["nccl"]]
    nccl_calls, nccl_replayed = int(nccl_reduce[0]), int(nccl_reduce[4])
    one_replay, nccl_replay = (r["steps_ms"][str(DP_REPLAY_STEP)] for r in (one, nccl))
    print(f"[dp nccl] python -m torch.distributed.run --standalone --nproc_per_node 1, "
          f"textboost_torch.train.main, {DP_STEPS} steps sd21base batch 8 bf16 (a checkpoint "
          f"every {DP_CADENCE}, a validation round every {DP_VALIDATION}), against the same run "
          f"without a launcher: backend {backend_nccl}; {nccl_graph}, the all-reduce inside "
          f"the graph; all-reduce {nccl_calls} calls of {nccl_reduce[1]} bytes ({nccl_reduce[2]} "
          f"eager, median {nccl_reduce[3]} ms, CUDA events; {nccl_replayed} replayed, untimed); "
          f"step {DP_REPLAY_STEP} (a replay) {nccl_replay:.1f} ms against {one_replay:.1f} in "
          f"one process, eager steps {DP_WARM_STEPS} {nccl['warm_step_ms']:.1f} ms against "
          f"{one['warm_step_ms']:.1f} (CUDA events); losses by step "
          f"{'the same bits' if nccl_losses == one['loss_by_step'] else 'DIFFER'} "
          f"({one['loss_by_step']}); {len(tree_one)} files (checkpoints, validation grids, "
          f"export) {'byte-identical' if same_tree and not differ else f'DIFFER: {differ}'}; "
          f"{nccl_s:.1f} s; {smi}", flush=True)
    if not (backend_nccl == ["nccl"] and nccl_losses == one["loss_by_step"] and same_tree
            and not differ and same_records and nccl_calls == DP_STEPS
            and nccl_replayed == DP_STEPS - WARMUP_STEPS == nccl["dp"]["all_reduce_replayed"]
            and nccl["dp"]["all_reduce_calls"] == nccl_calls):
        raise AssertionError("NCCL at world 1 is not the run without a launcher")

    # b. two ranks on the card over gloo; their resume ---------------------------
    two_out, two = ranks("two", DP_RANKS)
    if any(not r["step_graph"]["step_graph"].startswith(f"eager: {DP_RANKS} processes")
           for r in two):
        raise AssertionError(f"the dp ranks' steps ran {[r['step_graph'] for r in two]}")
    backends = [(r["rank"], r["dp"].get("dp_backend"), r["dp"].get("dp_world")) for r in two]
    # Each rank's all-reduce at the warm steps (rank 1's at step 4 waits for
    # rank 0's checkpoint).
    reduce_ms = [float(np.median([r["dp"]["all_reduce_ms_by_call"][s - 1]
                                  for s in DP_WARM_STEPS])) for r in two]
    shutil.copytree(os.path.join(dirs["two"], f"checkpoint-{DP_CADENCE}"),
                    os.path.join(dirs["resumed"], f"checkpoint-{DP_CADENCE}"))
    _, resumed = ranks("resumed", DP_RANKS, "--resume_from_checkpoint=latest")
    reduce_line = log_line("two", r"data parallel over 2 ranks: (\d+) values \((\d+) bytes\) "
                                  r"all-reduced per micro-step, against (\d+) bytes")
    want_one = {"flash": DP_STEPS * per_step[0] + rounds * per_round[0],
                "flash_bwd": DP_STEPS * per_step[1],
                "gn": DP_STEPS * per_step[2] + rounds * per_round[1],
                "gn_bwd": DP_STEPS * per_step[3]}
    want_rank1 = dict(zip(("flash", "flash_bwd", "gn", "gn_bwd"),
                          (DP_STEPS * n for n in per_step)))
    rest = DP_STEPS - DP_CADENCE
    want_resumed = [{"flash": rest * per_step[0] + per_round[0], "flash_bwd": rest * per_step[1],
                     "gn": rest * per_step[2] + per_round[1], "gn_bwd": rest * per_step[3]},
                    dict(zip(("flash", "flash_bwd", "gn", "gn_bwd"), (rest * n for n in per_step)))]
    losses = [r["loss_by_step"] for r in two]
    files_two = sorted(dp_tree(dirs["two"]))
    with open(os.path.join(dirs["two"], "metrics.jsonl")) as f:
        steps_logged = [json.loads(line)["step"] for line in f]
    print(f"[dp gloo] {DP_RANKS} ranks on the one card, python -m torch.distributed.run "
          f"--standalone --nproc_per_node {DP_RANKS}: (rank, backend, world) {backends}; "
          f"{[line for line in two_out.splitlines() if 'torch.distributed: rank' in line]}; "
          f"global batch 8 "
          f"(4 a rank), {DP_STEPS} steps in {two[0]['wall_s']:.1f} s (launch, set-up and export "
          f"included); losses by step rank 0 {losses[0]}, rank 1 "
          f"{'the same' if losses[0] == losses[1] else losses[1]}; all-reduce per step "
          f"{reduce_line[1]} bytes ({reduce_line[0]} values: LoRA, added rows, 4 loss scalars) "
          f"against {reduce_line[2]} bytes of the embedding's whole gradient, "
          f"{reduce_ms[0]:.3f} / {reduce_ms[1]:.3f} ms a warm step on rank 0 / 1, each call "
          f"{[[round(x, 3) for x in r['dp']['all_reduce_ms_by_call']] for r in two]} (CUDA "
          f"events: the copy to the host, gloo, the copy back, the wait for the other rank); "
          f"warm step {two[0]['warm_step_ms']:.1f} / {two[1]['warm_step_ms']:.1f} ms "
          f"against {one['warm_step_ms']:.1f} ms in one process (steps {DP_WARM_STEPS}, CUDA "
          f"events); peak {two[0]['peak_bytes'] / 2**30:.2f} / {two[1]['peak_bytes'] / 2**30:.2f} "
          f"GiB against {one['peak_bytes'] / 2**30:.2f}; launches {two[0]['launches']} / "
          f"{two[1]['launches']}, one process {one['launches']}; rank 0 wrote "
          f"{len(two[0]['writes'])} paths, rank 1 {two[1]['writes']}; {smi}", flush=True)
    if not (backends == [(0, "gloo", 2), (1, "gloo", 2)] and losses[0] == losses[1]
            and len(losses[0]) == DP_STEPS and all(math.isfinite(x) for x in losses[0])):
        raise AssertionError("the two ranks disagree on the losses or the backend")
    if two[1]["writes"] or not two[0]["writes"] or resumed[1]["writes"]:
        raise AssertionError(f"rank 1 wrote into --output_dir: {two[1]['writes']} "
                             f"{resumed[1]['writes']}")
    if files_two != sorted(tree_one) or steps_logged != [0, DP_STEPS]:
        raise AssertionError(f"the 2-rank run left {files_two} and metrics at {steps_logged}, "
                             f"the one-process run {sorted(tree_one)}")
    launches = [r["launches"] for r in two] + [one["launches"], nccl["launches"]]
    if launches != [want_one, want_rank1, want_one, want_one] or \
            [r["launches"] for r in resumed] != want_resumed:
        raise AssertionError(f"launches {launches} / resumed {[r['launches'] for r in resumed]}, "
                             f"expected {[want_one, want_rank1, want_one, want_one]} / "
                             f"{want_resumed}")

    res_losses = resumed[0]["loss_by_step"]
    res_gap = max(abs(a - b) / abs(b) for a, b in zip(res_losses, losses[0][DP_CADENCE:]))
    res_exports = dp_export_gaps(dirs["two"], dirs["resumed"])
    one_gap = [abs(a - b) / abs(b) for a, b in zip(losses[0], one["loss_by_step"])]
    one_exports = dp_export_gaps(dirs["one"], dirs["two"])
    print(f"[dp resume] 2 ranks from checkpoint-{DP_CADENCE} to step {DP_STEPS}: losses "
          f"{res_losses} against {losses[0][DP_CADENCE:]}, largest relative gap {res_gap:.3g} "
          f"(limit {RESUME_LOSS_REL}); exported LoRA rel L2 {res_exports['lora']:.3g}, added rows "
          f"{res_exports['rows']:.3g} (limit {RESUME_REL_L2}); rank 1 wrote "
          f"{resumed[1]['writes']}", flush=True)
    print(f"[dp vs one process] the 2-rank run against the one-process run at batch 8: loss gap "
          f"by step {[float(f'{g:.3g}') for g in one_gap]} (limit {DP_LOSS_REL}); exported LoRA "
          f"rel L2 {one_exports['lora']:.3g}, added rows {one_exports['rows']:.3g} (limit "
          f"{DP_REL_L2})", flush=True)
    if not (res_gap <= RESUME_LOSS_REL and max(res_exports.values()) <= RESUME_REL_L2):
        raise AssertionError("the 2-rank resume left the straight 2-rank run's trajectory")
    if not (max(one_gap) <= DP_LOSS_REL and max(one_exports.values()) <= DP_REL_L2):
        raise AssertionError("the 2-rank run left the one-process run's trajectory")

    # c. every kernel at every shape the ranks gave it ----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    local = 8 // DP_RANKS
    step_calls = train_step_calls("sd21base", unet_batch=local, encode_batch=local,
                                  checkpointing=False, cross_lora_rank=0)
    images = len(PAPER_PROMPTS) * DP_VALIDATION_IMAGES
    val_calls = group_norm_calls("sd21base", unet_batch=2 * images, decode_batch=images)
    derived_rank1 = {k: collections.Counter({key: DP_STEPS * n for key, n in c.items()})
                     for k, c in step_calls.items()}
    derived_gn0 = collections.Counter(derived_rank1["gn"])
    for part, n in (("unet", rounds * 25), ("decode", rounds)):
        derived_gn0.update({key: n * c for key, c in val_calls[part].items()})
    seen = [r["shapes"] for r in two]
    if seen[1] != derived_rank1 or seen[0]["gn"] != derived_gn0 or seen[0]["gn_bwd"] != \
            derived_rank1["gn_bwd"] or not derived_rank1["flash"] <= seen[0]["flash"]:
        raise AssertionError("the ranks' kernel calls differ from those derived from the config "
                             "at batch 4")
    flash = set(seen[0]["flash"]) | set(seen[1]["flash"])
    k1_err = check_flash_forward(gen, sorted(flash - held["flash"]))
    k2_err = check_flash_backward(gen, [(b, n, h, d, mm, mm) for b, n, h, d, mm in
                                        sorted(set(seen[1]["flash_bwd"]) - held["flash_bwd"])])
    per_rank_step = {k: {key: n // DP_STEPS for key, n in c.items()}
                     for k, c in derived_rank1.items()}
    new_rows, gn_err = group_norm_table(gen, set(derived_gn0) - set(held["gn_rows"]),
                                        {key: {"dp_rank_step": per_rank_step["gn"].get(key, 0)}
                                         for key in derived_gn0}, backward=False)
    new_bwd_rows, gn_bwd_err = group_norm_table(
        gen, set(per_rank_step["gn_bwd"]) - set(held["gn_bwd_rows"]),
        {key: {"dp_rank_step": n} for key, n in per_rank_step["gn_bwd"].items()}, backward=True)
    gn_sums = {}
    for name, calls, table in (("group_norm_fwd", per_rank_step["gn"], {**held["gn_rows"], **new_rows}),
                               ("group_norm_bwd", per_rank_step["gn_bwd"],
                                {**held["gn_bwd_rows"], **new_bwd_rows})):
        gn_sums[name] = {field: sum(n * table[key][field] for key, n in calls.items())
                         for field in ("ms", "cold_ms", "bound_ms", "library_ms")}
        gn_sums[name]["launches"] = sum(calls.values())
    shapes = {"unet_level0_4x4096x5x64": (local, 4096, 5, 64),
              "unet_level1_4x1024x10x64": (local, 1024, 10, 64)}
    k1 = {name: flash_forward_times(gen, *shp, card) for name, shp in shapes.items()}
    k2 = {name: flash_backward_times(gen, *shp, card) for name, shp in shapes.items()}
    for name in shapes:
        f, b = k1[name], k2[name]
        print(f"[dp flash] {name}: forward {f['ms']:.4f} ms (bound {f['bound_ms']:.4f}, "
              f"{f['bound_floor']}; SDPA {f['library_ms']:.4f}; plain {f['plain_ms']:.3f}); "
              f"backward {b['ms']:.4f} ms (bound {b['bound_ms']:.4f}, {b['bound_floor']}; SDPA "
              f"{b['library_ms']:.4f}; plain {b['plain_ms']:.3f}); {smi}", flush=True)
    main_key = ((local, 320, 64, 64), 32, 1e-6, False)  # Transformer2D norm, UNet level 0
    table = {**held["gn_rows"], **new_rows}
    bwd_table = {**held["gn_bwd_rows"], **new_bwd_rows}
    print(f"[dp kernels] K1 at the ranks' {len(flash)} shapes ({len(flash - held['flash'])} new, "
          f"held now), K2 at {dict(seen[1]['flash_bwd'])}; the ranks' GroupNorm keys are those "
          f"derived from the config at batch 4 (and the validation batches on rank 0), "
          f"{len(new_rows)} forward and {len(new_bwd_rows)} backward new ones held now; at "
          f"{main_key[0]}: forward {table[main_key]['ms']:.4f} ms (bound "
          f"{table[main_key]['bound_ms']:.4f}, F.group_norm {table[main_key]['library_ms']:.4f}), "
          f"backward {bwd_table[main_key]['ms']:.4f} ms (bound {bwd_table[main_key]['bound_ms']:.4f}, "
          f"library {bwd_table[main_key]['library_ms']:.4f}); launch-weighted per rank step: " +
          "; ".join(f"{name} {v['launches']} launches {v['ms']:.3f} ms warm, bound "
                    f"{v['bound_ms']:.3f}, library {v['library_ms']:.3f}"
                    for name, v in gn_sums.items()) + f"; {smi}", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[dp] the whole phase in {phase_s:.1f} s; {smi}", flush=True)
    return {
        "launches": {f"rank{r['rank']}": r["launches"] for r in two},
        "launches_one_process": one["launches"],
        "resumed_launches": {f"rank{r['rank']}": r["launches"] for r in resumed},
        "launches_per_rank_step": dict(zip(("flash", "flash_bwd", "gn", "gn_bwd"), per_step)),
        "backends": {"world_1": backend_nccl[0], "two_ranks": [b for _, b, _ in backends]},
        "all_reduce_values": int(reduce_line[0]), "all_reduce_bytes": int(reduce_line[1]),
        "embedding_grad_bytes": int(reduce_line[2]),
        "world_1_nccl": {"step_graph": nccl["step_graph"], "all_reduce_calls": nccl_calls,
                         "all_reduce_replayed": nccl_replayed,
                         "warm_step_ms": nccl["warm_step_ms"],
                         "replay_step_ms": nccl_replay, "one_process_replay_step_ms": one_replay,
                         "launches": nccl["launches"]},
        "all_reduce_ms_per_warm_step": {"world_1_nccl_median": float(nccl_reduce[3]),
                                        "rank0_gloo": reduce_ms[0], "rank1_gloo": reduce_ms[1]},
        "warm_step_ms": {"one_process": one["warm_step_ms"],
                         **{f"rank{r['rank']}": r["warm_step_ms"] for r in two}},
        "peak_gib": {"one_process": one["peak_bytes"] / 2**30,
                     **{f"rank{r['rank']}": r["peak_bytes"] / 2**30 for r in two}},
        "loss_by_step": {"one_process": one["loss_by_step"], "two_ranks": losses[0],
                         "resumed": res_losses},
        "gap_to_one_process": {"loss": max(one_gap), **one_exports},
        "resume_gap": {"loss": res_gap, **res_exports},
        "run_s": {"one_process": one["wall_s"], "world_1_nccl": nccl_s,
                  "two_ranks": two[0]["wall_s"], "resumed": resumed[0]["wall_s"]},
        "group_norm_per_rank_step": gn_sums, "phase_s": phase_s,
        "gn_main": {"fwd": group_norm_json(table[main_key]),
                    "bwd": group_norm_json(bwd_table[main_key])},
        "k1": k1, "k2": k2, "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_err,
        "gn_max_abs_err": gn_err, "gn_bwd_max_abs_err": gn_bwd_err,
    }


# Tensor parallel at sd21base (`tp_phase`): the paper flags cut to TP_STEPS
# steps, a checkpoint every TP_CADENCE and a validation round every
# TP_VALIDATION, plus the UNet's kv-LoRA, in one process (its step captured
# at step 4) and as TP_RANKS ranks of one tp group (eager).
TP_STEPS = 4
TP_CADENCE = 2
TP_VALIDATION = 4
TP_WARM_STEPS = (2, 4)  # step 3 carries step 2's checkpoint
TP_RANKS = 2  # sharing the one card over gloo, as the dp phase's ranks
TP_LEVEL1 = (8, 1024, 5, 64)  # UNet level 1 at tp 2: 10 heads, 5 a rank
# One image per validation prompt (the runner's default is 4): at 4, a
# round's UNet runs at batch 32 and its collectives moved ~1.5 GB a call
# over gloo, ~45 s a round (PERF.md); at 1 the round is the train
# step's batch 8, and both ranks still sample every round together.
TP_VALIDATION_IMAGES = 1
# The 2-rank run against the one-process run, bf16: both run the UNet at
# batch 8 on the same samples and draws, but each row-parallel output is
# the sum of two bf16-rounded halves (the one process rounds the whole sum
# once).  On an NVIDIA H100 80GB HBM3 (700 W) the gaps were 3.2e-5-1.6e-4
# a step's loss, 2.9e-5 / 4.0e-5 for the exported LoRA (text encoder /
# UNet) and 3.0e-3 for the added rows (near-sign AdamW steps at embedding
# lr 1e-3); the bounds are ~6-7x those, as the dp phase's.
TP_LOSS_REL = 1e-3  # each step's loss
TP_REL_L2 = 2e-2  # the exported LoRA (the text encoder's and the UNet's) and added rows


def tp_phase(gen, card: dict, work: str, smi: str, held: dict) -> dict:
    """Tensor parallelism over torch.distributed at sd21base (see the module
    docstring): the rules' report at sd15 and sd21base; the one-process run
    and two tp ranks over gloo on the one card and their resume, each a
    process launched as a user would; K1/K2 at the ranks' new shapes."""
    import numpy as np
    import torch

    from textboost_torch.models.configs import get_spec
    from textboost_torch.parallel.tensor import TP_RULES
    from textboost_torch.parallel.validate import validate_tp_rules_at_shape

    t_phase = time.perf_counter()
    clip_qkv, unet_qkv, embedding = TP_RULES[0][0], TP_RULES[6][0], TP_RULES[11][0]
    reports = {}
    for preset in ("sd15", "sd21base"):
        t0 = time.perf_counter()
        reports[preset] = r = validate_tp_rules_at_shape(preset, TP_RANKS, batch=8)
        m = r["tp_rule_matches"]
        print(f"[tp report] {preset} at tp {TP_RANKS} (meta device, {time.perf_counter() - t0:.1f} "
              f"s): {r['split_weights']} weights split, tiling their wholes; CLIP q/k/v "
              f"{m[clip_qkv]}, UNet q/k/v {m[unet_qkv]}, token embedding {m[embedding]}; by rule "
              f"{list(m.values())}; a train step's all-reduces at batch 8 in bf16 "
              f"{r['collectives']}; {len(r['whole'])} matched and left whole: "
              f"{sorted({re.sub(r'transformer_blocks.*', '', k) for k in r['whole']})}", flush=True)
    whole21 = reports["sd21base"]["whole"]
    level0 = re.compile(r"unet/(down_blocks\.0|up_blocks\.3)\.attentions\.\d\.transformer_blocks"
                        r"\.0\.attn[12]\.to_(q|k|v|out\.0)\.weight")
    m15 = reports["sd15"]["tp_rule_matches"]
    if not ((m15[clip_qkv], m15[unet_qkv], m15[embedding]) == (36, 96, 1)
            and all(m15.values()) and not reports["sd15"]["whole"]
            and len(whole21) == 40 and all(level0.fullmatch(k) for k in whole21)):
        raise AssertionError("the tp rules' reports are not those of the configs")

    spec = get_spec("sd21base")
    per_step, per_round = expected_train_launches(spec), expected_launches(spec, 25)
    rounds = TP_STEPS // TP_VALIDATION
    instance_dir = os.path.join(work, "instance")
    os.makedirs(instance_dir)
    write_instance_image(os.path.join(instance_dir, "teapot.png"), seed=1)
    dirs = {name: os.path.join(work, name) for name in ("one", "two", "resumed")}

    def ranks(name, nproc, *extra):
        flags = paper_flags(instance_dir, dirs[name], f"--max_train_steps={TP_STEPS}",
                            f"--checkpointing_steps={TP_CADENCE}",
                            f"--validation_steps={TP_VALIDATION}",
                            f"--num_validation_images={TP_VALIDATION_IMAGES}",
                            "--unet_params_to_train=crossattn_kv", *extra)
        return launch_rank_program(work, name, nproc, flags,
                                   program="--tp-rank" if nproc else "--dp-rank")

    _, (one,) = ranks("one", 0)
    two_out, two = ranks("two", TP_RANKS, f"--mesh_tp={TP_RANKS}")
    # Warm steps by CUDA events: the ranks' TP_WARM_STEPS (eager); the one
    # process's step 2 (its step 4 holds the capture).
    for r, steps in [(one, (2,))] + [(r, TP_WARM_STEPS) for r in two]:
        r["warm_step_ms"] = float(np.mean([r["steps_ms"][str(st)] for st in steps]))
    # The one process's kv-LoRA step is captured (its one validation round
    # too few to pay a sampler capture back); the tp ranks run eagerly with
    # the --mesh_tp reason first, their rounds too (a tp rank's UNet reduces
    # over the host in its forward).
    one_graph = step_graph_check(one["step_graph"], TP_STEPS, "the tp phase's one process")
    if not one["step_graph"]["validation_graph"].startswith("eager: 1 validation rounds") or any(
            not r["step_graph"]["step_graph"].startswith(f"eager: --mesh_tp {TP_RANKS}")
            or r["step_graph"]["validation_graph"] != r["step_graph"]["step_graph"]
            for r in two):
        raise AssertionError(f"the tp phase's steps and rounds ran "
                             f"{[r['step_graph'] for r in [one, *two]]}")
    print(f"[tp one process] kv-LoRA at batch 8, {TP_STEPS} steps: {one_graph}; the tp ranks "
          f"{[r['step_graph']['step_graph'] for r in two]}", flush=True)
    shutil.copytree(os.path.join(dirs["two"], f"checkpoint-{TP_CADENCE}"),
                    os.path.join(dirs["resumed"], f"checkpoint-{TP_CADENCE}"))
    _, resumed = ranks("resumed", TP_RANKS, f"--mesh_tp={TP_RANKS}",
                       "--resume_from_checkpoint=latest")
    with open(os.path.join(dirs["two"], "training.log")) as f:
        log = f.read()
    split_lines = re.findall(r"tensor parallel over 2 ranks \(dp 1 x tp 2\), ([\w ]+): (\d+) "
                             r"weights split .*?, (\d+) left whole", log)
    backends = [(r["rank"], r["dp"].get("dp_backend"), r["dp"].get("dp_world")) for r in two]
    losses = [r["loss_by_step"] for r in two]
    files_one, files_two = sorted(dp_tree(dirs["one"])), sorted(dp_tree(dirs["two"]))

    # The collectives a step: counted by each rank, and on the meta device.
    want_tp = reports["sd21base"]["collectives"]
    tp_steps = [r["tp"] for r in two]
    warm = [float(np.median([t["tp_ms_by_step"][s - 1] for s in TP_WARM_STEPS])) for t in tp_steps]
    print(f"[tp gloo] {TP_RANKS} ranks on the one card, python -m torch.distributed.run "
          f"--standalone --nproc_per_node {TP_RANKS} -m textboost_torch.train --mesh_tp "
          f"{TP_RANKS}: (rank, backend, world) {backends}; split {split_lines}; global batch 8 "
          f"on both ranks, {TP_STEPS} steps in {two[0]['wall_s']:.1f} s (launch, set-up, "
          f"{rounds} validation rounds of {len(PAPER_PROMPTS)} x {TP_VALIDATION_IMAGES} images "
          f"on both ranks and export included; one process "
          f"{one['wall_s']:.1f} s); losses by step rank 0 {losses[0]}, rank 1 "
          f"{'the same' if losses[0] == losses[1] else losses[1]}; trainable weights after each "
          f"step {'the same on both ranks' if two[0]['digests'] == two[1]['digests'] else 'DIFFER'}"
          f"; tp all-reduces a step {tp_steps[0]['tp_fwd_calls_by_step'][-1]} forward + "
          f"{tp_steps[0]['tp_bwd_calls_by_step'][-1]} backward, "
          f"{tp_steps[0]['tp_bytes_by_step'][-1]} bytes (meta-device count {want_tp}), "
          f"{warm[0]:.1f} / {warm[1]:.1f} ms a warm step on rank 0 / 1 (CUDA events: the copies "
          f"to and from the host, gloo, the wait for the peer), by step "
          f"{[[round(x, 1) for x in t['tp_ms_by_step']] for t in tp_steps]}; warm step "
          f"{two[0]['warm_step_ms']:.1f} / {two[1]['warm_step_ms']:.1f} ms against "
          f"{one['warm_step_ms']:.1f} ms in one process (steps {TP_WARM_STEPS}, its step 2); peak "
          f"{two[0]['peak_bytes'] / 2**30:.2f} / {two[1]['peak_bytes'] / 2**30:.2f} GiB against "
          f"{one['peak_bytes'] / 2**30:.2f}; launches {two[0]['launches']} / "
          f"{two[1]['launches']}, one process {one['launches']}; rank 0 wrote "
          f"{len(two[0]['writes'])} paths, rank 1 {two[1]['writes']}; {smi}", flush=True)
    if not (backends == [(0, "gloo", 1), (1, "gloo", 1)] and losses[0] == losses[1]
            and len(losses[0]) == TP_STEPS and all(math.isfinite(x) for x in losses[0])
            and len(two[0]["digests"]) == TP_STEPS and two[0]["digests"] == two[1]["digests"]
            and resumed[0]["digests"] == resumed[1]["digests"]):
        raise AssertionError("the two tp ranks disagree on the losses, the trainable weights "
                             "or the backend")
    if not (len(split_lines) == 2 and sum(int(n) for _, n, _ in split_lines)
            == reports["sd21base"]["split_weights"]
            and sum(int(w) for _, _, w in split_lines) == len(whole21)):
        raise AssertionError(f"the trainer split {split_lines}, its report "
                             f"{reports['sd21base']['split_weights']} weights, {len(whole21)} whole")
    if two[1]["writes"] or not two[0]["writes"] or resumed[1]["writes"]:
        raise AssertionError(f"rank 1 wrote into --output_dir: {two[1]['writes']} "
                             f"{resumed[1]['writes']}")
    if files_two != files_one:
        raise AssertionError(f"the 2-rank run left {files_two}, the one-process run {files_one}")
    for t in tp_steps + [r["tp"] for r in resumed]:
        got = set(zip(t["tp_fwd_calls_by_step"], t["tp_bwd_calls_by_step"], t["tp_bytes_by_step"]))
        if got != {(want_tp["fwd"], want_tp["bwd"], want_tp["bytes"])}:
            raise AssertionError(f"the ranks' collectives a step {got}, derived {want_tp}")
    want_one = {"flash": TP_STEPS * per_step[0] + rounds * per_round[0],
                "flash_bwd": TP_STEPS * per_step[1],
                "gn": TP_STEPS * per_step[2] + rounds * per_round[1],
                "gn_bwd": TP_STEPS * per_step[3]}
    rest = TP_STEPS - TP_CADENCE
    want_resumed = {"flash": rest * per_step[0] + per_round[0], "flash_bwd": rest * per_step[1],
                    "gn": rest * per_step[2] + per_round[1], "gn_bwd": rest * per_step[3]}
    launches = [r["launches"] for r in two] + [one["launches"]]
    if launches != [want_one] * 3 or [r["launches"] for r in resumed] != [want_resumed] * 2:
        raise AssertionError(f"launches {launches} / resumed {[r['launches'] for r in resumed]}, "
                             f"expected {want_one} / {want_resumed}")

    res_losses = resumed[0]["loss_by_step"]
    res_gap = max(abs(a - b) / abs(b) for a, b in zip(res_losses, losses[0][TP_CADENCE:]))
    res_exports = dp_export_gaps(dirs["two"], dirs["resumed"])
    one_gap = [abs(a - b) / abs(b) for a, b in zip(losses[0], one["loss_by_step"])]
    one_exports = dp_export_gaps(dirs["one"], dirs["two"])
    print(f"[tp resume] 2 ranks from checkpoint-{TP_CADENCE} to step {TP_STEPS}: losses "
          f"{res_losses} against {losses[0][TP_CADENCE:]}, largest relative gap {res_gap:.3g} "
          f"(limit {RESUME_LOSS_REL}); exports rel L2 {res_exports} (limit {RESUME_REL_L2}); "
          f"rank 1 wrote {resumed[1]['writes']}", flush=True)
    print(f"[tp vs one process] the 2 tp ranks against the one-process run at batch 8: loss "
          f"gap by step {[float(f'{g:.3g}') for g in one_gap]} (limit {TP_LOSS_REL}); exports "
          f"rel L2 {one_exports} (limit {TP_REL_L2})", flush=True)

    # Every kernel at every shape the ranks gave it.
    gc.collect()
    torch.cuda.empty_cache()
    step_calls = train_step_calls("sd21base", unet_batch=8, encode_batch=8, checkpointing=False,
                                  cross_lora_rank=4, tp=TP_RANKS)
    images = len(PAPER_PROMPTS) * TP_VALIDATION_IMAGES
    val_calls = group_norm_calls("sd21base", unet_batch=2 * images, decode_batch=images)
    derived = {k: collections.Counter({key: TP_STEPS * n for key, n in c.items()})
               for k, c in step_calls.items()}
    derived_gn = collections.Counter(derived["gn"])
    for part, n in (("unet", rounds * 25), ("decode", rounds)):
        derived_gn.update({key: n * c for key, c in val_calls[part].items()})
    seen = [r["shapes"] for r in two]
    if seen[0] != seen[1] or seen[0]["gn"] != derived_gn or seen[0]["gn_bwd"] != \
            derived["gn_bwd"] or seen[0]["flash_bwd"] != derived["flash_bwd"] \
            or not derived["flash"] <= seen[0]["flash"]:
        raise AssertionError("the tp ranks' kernel calls differ from each other or from those "
                             "derived from the config at the ranks' local heads")
    if (*TP_LEVEL1, TP_LEVEL1[1]) not in seen[0]["flash"]:
        raise AssertionError(f"no flash call at the ranks' UNet level 1, {TP_LEVEL1}")
    new_fwd = sorted(set(seen[0]["flash"]) - held["flash"])
    new_bwd = sorted(set(seen[0]["flash_bwd"]) - held["flash_bwd"])
    k1_err = check_flash_forward(gen, new_fwd)
    k2_err = check_flash_backward(gen, [(b, n, h, d, mm, mm) for b, n, h, d, mm in new_bwd])
    name = "unet_level1_8x1024x5x64"
    k1 = {name: flash_forward_times(gen, *TP_LEVEL1, card)}
    k2 = {name: flash_backward_times(gen, *TP_LEVEL1, card)}
    f, b = k1[name], k2[name]
    print(f"[tp flash] the ranks' {name}: forward {f['ms']:.4f} ms (bound {f['bound_ms']:.4f}, "
          f"{f['bound_floor']}; SDPA {f['library_ms']:.4f}; plain {f['plain_ms']:.3f}); backward "
          f"{b['ms']:.4f} ms (bound {b['bound_ms']:.4f}, {b['bound_floor']}; SDPA "
          f"{b['library_ms']:.4f}; plain {b['plain_ms']:.3f}); K1 held now at {new_fwd}, K2 at "
          f"{new_bwd}; the ranks' GroupNorm calls those derived (all held earlier); {smi}",
          flush=True)
    if not (res_gap <= RESUME_LOSS_REL and max(res_exports.values()) <= RESUME_REL_L2):
        raise AssertionError("the 2-rank resume left the straight 2-rank run's trajectory")
    if not (max(one_gap) <= TP_LOSS_REL and max(one_exports.values()) <= TP_REL_L2):
        raise AssertionError("the 2 tp ranks left the one-process run's trajectory")
    phase_s = time.perf_counter() - t_phase
    print(f"[tp] the whole phase in {phase_s:.1f} s; {smi}", flush=True)
    return {
        "report": {p: {"tp_rule_matches": list(r["tp_rule_matches"].values()),
                       "whole": len(r["whole"])} for p, r in reports.items()},
        "launches": {f"rank{r['rank']}": r["launches"] for r in two},
        "launches_one_process": one["launches"],
        "resumed_launches": {f"rank{r['rank']}": r["launches"] for r in resumed},
        "collectives_per_step": {**want_tp, "ms_warm_rank0": warm[0], "ms_warm_rank1": warm[1]},
        "warm_step_ms": {"one_process": one["warm_step_ms"],
                         **{f"rank{r['rank']}": r["warm_step_ms"] for r in two}},
        "peak_gib": {"one_process": one["peak_bytes"] / 2**30,
                     **{f"rank{r['rank']}": r["peak_bytes"] / 2**30 for r in two}},
        "loss_by_step": {"one_process": one["loss_by_step"], "two_ranks": losses[0],
                         "resumed": res_losses},
        "gap_to_one_process": {"loss": max(one_gap), **one_exports},
        "resume_gap": {"loss": res_gap, **res_exports},
        "run_s": {"one_process": one["wall_s"], "two_ranks": two[0]["wall_s"],
                  "resumed": resumed[0]["wall_s"]},
        "phase_s": phase_s, "k1": k1, "k2": k2, "k1_max_abs_err": k1_err,
        "k2_max_abs_err": k2_err,
    }


# The native snapshot and data-parallel generation at sd21base
# (`native_dp_phase`): the snapshot phase's seeded diffusers snapshot saved as
# the JAX package's native layout and served from it; then inference and the
# eval over two ranks sharing the card (gloo), each held to one-process runs
# over the same sub-batch.
NATIVE_STEPS = 2  # train steps from each snapshot dir
GEN_SEEDS = (0, 1, 2, 3)
GEN_RANKS = 2  # sharing the one card over gloo, as the dp phase's ranks
GEN_BATCH = 16  # the eval's --batch-size: sub-chunks of 8 a rank
GEN_INSTANCE = "teapot"  # the instance the eval samples (one seed, 25 prompts)


def gen_rank(json_dir: str, jobs_path: str) -> int:
    """The program of each process `native_dp_phase` launches (`python
    chip_smoke.py --gen-rank DIR -- JOBS`, alone or under python -m
    torch.distributed.run): joins the launch's process group when there is
    one, then runs each job of the JSON file JOBS ({"watch": dir, "jobs":
    [[entry, argv], ...]}, entry `inference` or `eval`) through the entry
    point's `main` under the launch counts (`kernel_calls`), and writes this
    rank's numbers into DIR/rank{RANK}.json: per job its launches, the
    prompts of each sampling call and its seconds; the kernel shapes; every
    path it opened for writing or made under `watch` (an audit hook).  An
    inference job's images (rank 0's, gathered) go to DIR/rank0_job{i}.npy."""
    import numpy as np
    import torch

    from textboost_torch import inference
    from textboost_torch.eval import __main__ as eval_cli
    from textboost_torch.parallel import mesh
    from textboost_torch.pipelines.text_to_image import TextToImagePipeline

    with open(jobs_path) as f:
        spec = json.load(f)
    writes = record_writes(os.path.abspath(spec["watch"]))
    images, batches = [], []
    real_generate, real_call = inference.generate, TextToImagePipeline.__call__

    def generate(args):
        images.append(real_generate(args))
        return images[-1]

    def call(self, prompts, *args, **kwargs):
        batches.append(len(prompts))
        return real_call(self, prompts, *args, **kwargs)

    inference.generate, TextToImagePipeline.__call__ = generate, call
    shapes = {name: collections.Counter() for name in ("flash", "flash_bwd", "gn", "gn_bwd")}
    jobs = []
    with mesh.distributed("cuda"):
        rank = mesh.rank()
        for i, (entry, argv) in enumerate(spec["jobs"]):
            images.clear()
            batches.clear()
            with kernel_calls(f"the {entry} job") as rec:
                t0 = time.perf_counter()
                if entry == "inference":
                    inference.main(inference.parse_args(argv))
                else:
                    eval_cli.main(argv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            for name, c in rec["shapes"].items():
                shapes[name].update(c)
            jobs.append({"entry": entry, "launches": rec["launches"], "batches": list(batches),
                         "s": seconds})
            if images and images[0] is not None:
                np.save(os.path.join(json_dir, f"rank{rank}_job{i}.npy"), images[0])
        mesh.barrier()
    out = {"rank": rank, "jobs": jobs, "writes": sorted(set(writes)),
           "shapes": {k: [[repr(key), n] for key, n in c.items()] for k, c in shapes.items()},
           "peak_bytes": torch.cuda.max_memory_allocated()}
    with open(os.path.join(json_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def joined_ranks(out: str) -> list:
    """[(rank, world, backend)] of each "torch.distributed: rank ..." message
    in a launch's output.  The ranks share one pipe and, with Python's
    stdout unbuffered, a message and its newline are two writes: another
    rank's message may land between them, so each message is matched alone
    and not up to its line's end."""
    return re.findall(r"torch\.distributed: rank (\d+) of (\d+) \(local \d+ of \d+\), "
                      r"backend (\w+)", out)


def generation_calls(batches) -> dict:
    """The kernel launches and GroupNorm calls derived from the config at
    sd21base for sampling calls of `batches` prompts (25 steps, CFG)."""
    from textboost_torch.models.configs import get_spec

    flash, gn = expected_launches(get_spec("sd21base"), 25)
    calls = collections.Counter()
    for n in batches:
        c = group_norm_calls("sd21base", unet_batch=2 * n, decode_batch=n)
        calls.update({key: 25 * m for key, m in c["unet"].items()})
        calls.update(c["decode"])
    return {"launches": {"flash": flash * len(batches), "flash_bwd": 0,
                         "gn": gn * len(batches), "gn_bwd": 0}, "gn": calls}


def native_dp_phase(gen, card: dict, work: str, smi: str, held: dict, snap: str) -> dict:
    """The JAX package's native formats and data-parallel generation at
    sd21base (see the module docstring): the seeded diffusers snapshot
    `snap` saved as a native snapshot and read back bit for bit; training
    and sampling from it against the diffusers dir; inference and the eval
    over two ranks sharing the card against one-process runs over the same
    sub-batch, the eval's CLIP and DINO read from flax trees the port wrote;
    every kernel held at every shape the phase gave it."""
    import numpy as np
    import torch
    from PIL import Image

    from textboost_torch.eval import scorer_weights
    from textboost_torch.models.configs import get_spec
    from textboost_torch.models.pretrained import PARTS, load_models, save_snapshot
    from textboost_torch.utils import msgpack

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    per_step = dict(zip(("flash", "flash_bwd", "gn", "gn_bwd"),
                        expected_train_launches(get_spec("sd21base"))))
    part_s = {}

    # a. the native snapshot: saved, then read back bit for bit ------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    source = load_models(snap, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    load_diffusers_s = time.perf_counter() - t0
    native = os.path.join(work, "native_sd21base")
    t0 = time.perf_counter()
    save_snapshot(source, native)
    save_s = time.perf_counter() - t0
    shutil.copytree(os.path.join(snap, "tokenizer"), os.path.join(native, "tokenizer"))
    part_bytes = {p: os.path.getsize(os.path.join(native, f"{p}.msgpack")) for p in PARTS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = load_models(native, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    load_native_s = time.perf_counter() - t0
    compared = 0
    for part in PARTS:
        a, b = getattr(source, part).state_dict(), getattr(back, part).state_dict()
        if a.keys() != b.keys():
            raise AssertionError(f"the native {part} holds other keys than its source")
        for key in a:
            if not torch.equal(a[key], b[key]):
                raise AssertionError(f"the native snapshot's {part} {key} is not its source")
            compared += 1
    if back.spec.name != "sd21base":
        raise AssertionError(f"the native snapshot loaded as {back.spec.name}")
    del source, back, a, b
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[native snapshot] save_snapshot of the seeded sd21base weights (read from the "
          f"diffusers snapshot in {load_diffusers_s:.2f} s, fp32): "
          f"{sum(part_bytes.values())} bytes of flax trees ({part_bytes}) in {save_s:.2f} s; "
          f"load_models read it back in {load_native_s:.2f} s, spec.json sd21base, {compared} "
          f"tensors bit-equal to their source; {smi}", flush=True)
    part_s["a_snapshot"] = time.perf_counter() - t_phase

    # b. two train steps from the native dir and from the diffusers dir ---------
    t0 = time.perf_counter()
    instance_dir = os.path.join(work, "instance")
    os.makedirs(instance_dir)
    write_instance_image(os.path.join(instance_dir, "teapot.png"), seed=1)
    train = {}
    for name, base in (("native", native), ("diffusers", snap)):
        gc.collect()
        torch.cuda.empty_cache()
        train[name] = instrumented_train(paper_flags(
            instance_dir, os.path.join(work, f"train_{name}"),
            f"--pretrained_model_name_or_path={base}", f"--max_train_steps={NATIVE_STEPS}",
            "--checkpointing_steps=0", "--validation_steps=0"))
    dirs = {name: os.path.join(work, f"train_{name}") for name in train}
    losses = {name: t["metrics"]["loss_by_step"] for name, t in train.items()}
    tree_a, tree_b = dp_tree(dirs["native"]), dp_tree(dirs["diffusers"])
    saved = [k for k in tree_a if k.endswith((".pt", ".bin"))]

    def config(raw):  # the adapter records its base's path, which differs by design
        return {k: v for k, v in json.loads(raw).items() if k != "base_model_name_or_path"}

    differ = sorted(k for k in tree_a if k not in saved and k != "metrics.jsonl" and (
        config(tree_a[k]) != config(tree_b[k]) if k.endswith("adapter_config.json")
        else tree_b.get(k) != tree_a[k]))
    differ += [k for k in saved if not same_state(*(
        torch.load(os.path.join(d, k), map_location="cpu", weights_only=True)
        for d in dirs.values()))]
    want_train = {k: NATIVE_STEPS * n for k, n in per_step.items()}
    same_files = not differ and tree_a.keys() == tree_b.keys()
    print(f"[native train] {NATIVE_STEPS} steps with the paper's flags from the native dir and "
          f"from the diffusers dir: losses {losses['native']} / "
          f"{'the same bits' if losses['native'] == losses['diffusers'] else losses['diffusers']};"
          f" {len(tree_a)} files {'bit-identical' if same_files else f'DIFFER: {differ}'} "
          f"(torch.save files by value); {train['native']['run_s']:.1f} / "
          f"{train['diffusers']['run_s']:.1f} s; launches {train['native']['launches']} / "
          f"{train['diffusers']['launches']}; {smi}", flush=True)
    if not (losses["native"] == losses["diffusers"] and len(losses["native"]) == NATIVE_STEPS
            and all(math.isfinite(x) for x in losses["native"])):
        raise AssertionError("training from the native dir left the diffusers dir's losses")
    if not same_files:
        raise AssertionError(f"the exports from the two dirs differ: {differ}")
    if any(t["launches"] != want_train for t in train.values()):
        raise AssertionError(f"the runs launched {[t['launches'] for t in train.values()]}, "
                             f"expected {want_train}")
    part_s["b_train"] = time.perf_counter() - t0

    # c. the scorer trees: CLIP and DINO in the published layouts, as flax trees ---
    weights, trees = os.path.join(work, "scorer_weights"), os.path.join(work, "scorer_trees")
    t0 = time.perf_counter()
    written = write_scorer_weights(weights, dev, vqa=False)
    os.makedirs(trees)
    tree_tensors = 0
    for name, read, inverse in (
            ("clip", scorer_weights.clip_weights, scorer_weights.clip_tree_from_state_dict),
            ("dino", scorer_weights.dino_weights, scorer_weights.dino_tree_from_state_dict)):
        state = dict(read(os.path.join(weights, name)).items())
        with open(os.path.join(trees, f"{name}.msgpack"), "wb") as f:
            msgpack.dump(inverse(state), f)
        got = scorer_weights.part_weights(os.path.join(trees, name), name)
        if set(got) != set(state) or not all(torch.equal(got[k], state[k]) for k in state):
            raise AssertionError(f"the {name} tree does not read back as its checkpoint")
        tree_tensors += len(state)
        del state, got
    shutil.rmtree(weights)
    tree_bytes = _part_bytes(trees, ("clip.msgpack", "dino.msgpack"))
    print(f"[native scorer trees] CLIP ViT-L/14-336 and DINOv2 ViT-L/14 from seeded published "
          f"checkpoints ({written}) written as flax trees by the port's codec {tree_bytes} in "
          f"{time.perf_counter() - t0:.2f} s; read back, {tree_tensors} tensors bit-equal to "
          f"the checkpoints'; {smi}", flush=True)
    part_s["c_scorer_trees"] = time.perf_counter() - t0

    # d. inference and the eval over two ranks; at the same time, in one
    # process, the runs they are held to and inference from the diffusers dir
    t0 = time.perf_counter()
    model_dir = dirs["native"]
    gen_root = os.path.join(work, "gen")
    sweep_dir, data, val = (os.path.join(gen_root, d) for d in ("sweep", "data", "val"))
    shutil.copytree(model_dir, os.path.join(sweep_dir, GEN_INSTANCE))
    for root, seed in ((data, 300), (val, 301)):
        os.makedirs(os.path.join(root, GEN_INSTANCE))
        write_instance_image(os.path.join(root, GEN_INSTANCE, "0.png"), seed=seed)

    def inference_job(base, seeds, grid):
        return ["inference", [model_dir, "--model", base, "--prompt",
                              f"photo of a <{GEN_INSTANCE}> {GEN_INSTANCE}", "--seeds",
                              *map(str, seeds), "--steps", "25", "--guidance-scale", "7.5",
                              "--lora-rank", "4", "--output", os.path.join(gen_root, grid)]]

    def eval_job(batch, desc):
        return ["eval", [sweep_dir, "--model", native, "--instances", GEN_INSTANCE, "--seeds",
                         "0", "--batch-size", str(batch), "--steps", "25", "--metric", "clip-t",
                         "clip-i", "dino", "--scorer-weights", trees, "--train-dir", data,
                         "--val-dir", val, "--outdir", os.path.join(gen_root, "bench"),
                         "--output-desc", desc]]

    def jobs_file(name, jobs):
        path = os.path.join(work, f"{name}_jobs.json")
        with open(path, "w") as f:
            json.dump({"watch": gen_root, "jobs": jobs}, f)
        return [path]

    half, sub = len(GEN_SEEDS) // GEN_RANKS, GEN_BATCH // GEN_RANKS
    one_jobs = ([inference_job(native, GEN_SEEDS[r * half:(r + 1) * half], f"one{r}.png")
                 for r in range(GEN_RANKS)]
                + [inference_job(native, GEN_SEEDS, "one_batch.png"),
                   inference_job(snap, GEN_SEEDS, "diffusers.png"), eval_job(sub, "one")])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        one_run = pool.submit(launch_rank_program, work, "gen_one", 0,
                              jobs_file("gen_one", one_jobs), "--gen-rank")
        dp_out, ranks = launch_rank_program(work, "gen_dp", GEN_RANKS, jobs_file("gen_dp", [
            inference_job(native, GEN_SEEDS, "grid_dp.png"), eval_job(GEN_BATCH, "dp")]),
            program="--gen-rank")
        _, (one,) = one_run.result()
    part_s["d_generation"] = time.perf_counter() - t0
    dp_json, one_json = (os.path.join(work, f"{n}_json") for n in ("gen_dp", "gen_one"))
    dp_images = np.load(os.path.join(dp_json, "rank0_job0.npy"))
    one_images = [np.load(os.path.join(one_json, f"rank0_job{i}.npy")) for i in range(4)]
    native_batch, diffusers_batch = one_images[GEN_RANKS:]
    same_inference = np.array_equal(dp_images, np.concatenate(one_images[:GEN_RANKS]))
    gap = np.abs(dp_images.astype(np.int16) - native_batch).max(axis=-1)
    one_batch = {"max_uint8_gap": int(gap.max()), "pixels_differ": float((gap > 0).mean())}
    bench = os.path.join(gen_root, "bench")
    names = {d: sorted(os.listdir(os.path.join(bench, f"sweep_{d}", "seed0", GEN_INSTANCE)))
             for d in ("dp", "one")}
    same_eval = names["dp"] == names["one"] and len(names["dp"]) == 25 and all(
        np.array_equal(*(np.asarray(Image.open(os.path.join(bench, f"sweep_{d}", "seed0",
                                                            GEN_INSTANCE, n)))
                         for d in ("dp", "one"))) for n in names["dp"])
    csvs = {}
    for d in ("dp", "one"):
        with open(os.path.join(sweep_dir, f"metric_last_{d}.csv")) as f:
            csvs[d] = f.read()
    backends = joined_ranks(dp_out)
    want_batches = [[[half], [sub, sub]], [[half], [sub, 25 - 3 * sub]]]
    want_one = [[half], [half], [len(GEN_SEEDS)], [len(GEN_SEEDS)], [sub, sub, sub, 25 - 3 * sub]]
    got_batches = [[j["batches"] for j in r["jobs"]] for r in ranks]
    one_batches = [j["batches"] for j in one["jobs"]]
    derived = [generation_calls([b for job in rb for b in job]) for rb in want_batches]
    derived_one = generation_calls([b for job in want_one for b in job])
    launches = [{k: sum(j["launches"][k] for j in r["jobs"]) for k in per_step} for r in ranks]
    one_launches = {k: sum(j["launches"][k] for j in one["jobs"]) for k in per_step}
    rank_s = [[round(j["s"], 2) for j in r["jobs"]] for r in ranks]
    one_s = [round(j["s"], 2) for j in one["jobs"]]
    print(f"[native inference] textboost_torch.inference, seeds {list(GEN_SEEDS)} in one "
          f"batch, from the native dir ({one_s[2]} s) and the diffusers dir ({one_s[3]} s, load "
          f"included): {native_batch.shape} "
          f"{'bit-identical' if np.array_equal(native_batch, diffusers_batch) else 'DIFFERENT'}"
          f"; launches {one['jobs'][2]['launches']} / {one['jobs'][3]['launches']}; {smi}",
          flush=True)
    print(f"[dp generation] python -m torch.distributed.run --standalone --nproc_per_node "
          f"{GEN_RANKS}, each rank textboost_torch.inference (seeds {list(GEN_SEEDS)}) then "
          f"textboost_torch.eval ({GEN_INSTANCE}, seed 0, --batch-size {GEN_BATCH}, CLIP-T, "
          f"CLIP-I, DINO from the flax trees): (rank, world, backend) {backends}; "
          f"{ranks[0]['wall_s']:.1f} s of command, the jobs' s by rank {rank_s}; prompts per "
          f"sampling call by rank {got_batches}; launches {launches}; rank 0 wrote "
          f"{len(ranks[0]['writes'])} paths, rank 1 {ranks[1]['writes']}; the one-process runs "
          f"(at the same time, sharing the card: {one['wall_s']:.1f} s of command, jobs {one_s} "
          f"s) sampled {one_batches} prompts a call, launches {one_launches}; {smi}", flush=True)
    print(f"[dp generation vs one process] inference: the gathered grid "
          f"{'bit-identical to' if same_inference else 'DIFFERENT from'} one-process runs over "
          f"each rank's seeds; against all {len(GEN_SEEDS)} seeds in one batch (reported, not "
          f"held) the largest uint8 gap {one_batch['max_uint8_gap']}, pixels that differ "
          f"{one_batch['pixels_differ']:.4f}; eval: {len(names['dp'])} images "
          f"{'bit-identical to' if same_eval else 'DIFFERENT from'} one process at "
          f"--batch-size {sub}, CSV {'identical' if csvs['dp'] == csvs['one'] else 'DIFFERENT'}: "
          f"{csvs['dp'].splitlines()[1:]}; {smi}", flush=True)
    if not np.array_equal(native_batch, diffusers_batch) or native_batch.shape != (
            len(GEN_SEEDS), 512, 512, 3):
        raise AssertionError("sampling from the native dir gave other images than the "
                             "diffusers dir")
    if sorted(backends) != [("0", "2", "gloo"), ("1", "2", "gloo")]:
        raise AssertionError(f"the generation ranks joined as {backends}")
    for line in (f"Sharding the {len(GEN_SEEDS)} seeds over {GEN_RANKS} ranks, {half} a rank",
                 f"Sharding generation batches over {GEN_RANKS} ranks: sub-chunks of {sub} "
                 "prompts"):
        if line not in dp_out:
            raise AssertionError(f"the launch printed no {line!r}")
    if not (same_inference and same_eval and csvs["dp"] == csvs["one"]):
        raise AssertionError("a rank's images or the CSV differ from the one-process run over "
                             "the same sub-batch")
    if ranks[1]["writes"] or not {"grid_dp.png", "sweep/metric_last_dp.csv"} <= set(
            ranks[0]["writes"]):
        raise AssertionError(f"writes: rank 0 {ranks[0]['writes'][:5]}, rank 1 "
                             f"{ranks[1]['writes']}")
    if got_batches != want_batches or one_batches != want_one:
        raise AssertionError(f"sampling calls of {got_batches} / {one_batches} prompts")
    if launches != [d["launches"] for d in derived] or one_launches != derived_one["launches"]:
        raise AssertionError(f"launches {launches} / {one_launches}, derived "
                             f"{[d['launches'] for d in derived]} / {derived_one['launches']}")
    if [r["shapes"]["gn"] for r in ranks] != [d["gn"] for d in derived] or \
            one["shapes"]["gn"] != derived_one["gn"]:
        raise AssertionError("the generation's GroupNorm calls differ from those derived from "
                             "the config")

    # e. every kernel at every shape the phase gave it ----------------------------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    seen = {k: collections.Counter() for k in per_step}
    for shapes in [t["shapes"] for t in train.values()] + [r["shapes"] for r in ranks + [one]]:
        for k in seen:
            seen[k].update(shapes[k])
    new_flash = sorted(set(seen["flash"]) - held["flash"])
    new_flash_bwd = sorted(set(seen["flash_bwd"]) - held["flash_bwd"])
    k1_err = check_flash_forward(gen, new_flash)
    k2_err = check_flash_backward(gen, [(b, n, h, d, m, m) for b, n, h, d, m in new_flash_bwd])
    tail = ((2 * (25 - 3 * sub), 320, 64, 64), 32, 1e-6, False)  # the tail's UNet level 0
    new_gn = set(seen["gn"]) - set(held["gn_rows"])
    rows, gn_err = group_norm_table(gen, new_gn - {tail}, {k: {"native_dp": n} for k, n in
                                                           seen["gn"].items()},
                                    backward=False, timed=False)
    timed_rows, tail_err = group_norm_table(gen, {tail}, {tail: {"native_dp": seen["gn"][tail]}},
                                            backward=False)
    bwd_rows, gn_bwd_err = group_norm_table(
        gen, set(seen["gn_bwd"]) - set(held["gn_bwd_rows"]),
        {k: {"native_dp": n} for k, n in seen["gn_bwd"].items()}, backward=True, timed=False)
    k1 = {"tail_unet_level0_2x4096x5x64": flash_forward_times(gen, 2, 4096, 5, 64, card),
          "eval_vae_mid_8x4096x1x512": flash_forward_times(gen, sub, 4096, 1, 512, card)}
    print(f"[native dp kernels] K1 at the phase's {len(seen['flash'])} shapes "
          f"{sorted(seen['flash'])} ({len(new_flash)} new, held now), K2 at "
          f"{dict(seen['flash_bwd'])} ({len(new_flash_bwd)} new); GroupNorm at "
          f"{len(seen['gn'])} forward and {len(seen['gn_bwd'])} backward keys, "
          f"{len(rows) + len(timed_rows)} + {len(bwd_rows)} new ones held now; K1 times: " +
          "; ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, SDPA "
                    f"{v['library_ms']:.4f}, plain {v['plain_ms']:.3f})" for k, v in k1.items())
          + f"; K3 at {tail[0]} {timed_rows[tail]['ms']:.4f} ms (bound "
          f"{timed_rows[tail]['bound_ms']:.4f}, F.group_norm {timed_rows[tail]['library_ms']:.4f})"
          f"; {smi}", flush=True)
    shutil.rmtree(native)
    part_s["e_kernels"] = time.perf_counter() - t0
    phase_s = time.perf_counter() - t_phase
    print(f"[native dp] the whole phase in {phase_s:.1f} s (the native dir deleted; by part "
          f"{ {k: round(v, 1) for k, v in part_s.items()} }); {smi}", flush=True)
    return {
        "launches": {"train_native": train["native"]["launches"],
                     "train_diffusers": train["diffusers"]["launches"],
                     "inference_native_batch": one["jobs"][2]["launches"],
                     "inference_diffusers_batch": one["jobs"][3]["launches"],
                     **{f"gen_rank{r['rank']}": launches[i] for i, r in enumerate(ranks)},
                     "gen_one_process": one_launches},
        "snapshot": {"native_bytes": sum(part_bytes.values()), "part_bytes": part_bytes,
                     "save_s": save_s, "load_native_s": load_native_s,
                     "load_diffusers_s": load_diffusers_s, "tensors_equal": compared},
        "train": {name: {"losses": losses[name], "run_s": t["run_s"]}
                  for name, t in train.items()},
        "scorer_tree_bytes": tree_bytes,
        "dp_generation": {"command_s": ranks[0]["wall_s"], "rank_job_s": rank_s,
                          "one_process_command_s": one["wall_s"],
                          "one_process_job_s": [j["s"] for j in one["jobs"]],
                          "peak_gib": [r["peak_bytes"] / 2**30 for r in ranks],
                          "batches": got_batches, "one_batch": one_batch},
        "phase_s": phase_s, "part_s": part_s, "k1": k1,
        "gn_tail": group_norm_json(timed_rows[tail]),
        "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_err,
        "gn_max_abs_err": max(gn_err, tail_err), "gn_bwd_max_abs_err": gn_bwd_err,
    }


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.nn.functional as F
    import torch.profiler

    from textboost_torch.inference import generate, parse_args
    from textboost_torch.lora.peft_io import export_lora_adapter, export_token_embeddings
    from textboost_torch.models.configs import get_spec
    from textboost_torch.models.layers import GroupNorm, set_impl
    from textboost_torch.models.pretrained import load_models
    from textboost_torch.ops import _build
    from textboost_torch.ops import flash_attention as fa
    from textboost_torch.ops import group_norm as gn
    from textboost_torch.pipelines.loading import load_textboost_pipeline
    from textboost_torch.graphs import set_capture

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(0)

    # 1. build -------------------------------------------------------------
    t0 = time.time()
    libs = _build.build()
    for src, path in libs.items():
        _build.load(src, path)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[build] {len(libs)} kernels built in {time.time() - t0:.1f} s on {kind}", flush=True)
    card = {"sm_count": torch.cuda.get_device_properties(0).multi_processor_count,
            "sm_clock_hz": card_clock_hz()}
    print(f"[card] {card['sm_count']} SMs, max SM clock {card['sm_clock_hz'] / 1e6:.0f} MHz "
          f"(the exponentials' floor: {EX2_PER_SM_CLOCK} ex2 per SM and clock)", flush=True)

    # 2. flash attention vs its plain version ------------------------------
    flash_err = check_flash_forward(gen, ((8, 4096, 8, 40, 4096), (8, 1024, 8, 80, 1024),
                                          (4, 4096, 1, 512, 4096), (8, 4096, 8, 40, 77)))
    check_flash_edges()

    # 3-4. sd15 UNet (kernels vs math) and VAE decode, GN shapes recorded ----
    spec = get_spec("sd15")
    bundle = load_models("sd15", lora_rank=4, dtype=bf16, device=dev)
    unet, vae = bundle.unet.requires_grad_(False), bundle.vae.requires_grad_(False)
    # GN calls of one UNet forward and one VAE decode: (shape, eps, silu) -> count.
    seen = {"unet": collections.Counter(), "vae": collections.Counter()}

    def recorder(counter):
        def record(mod, args):
            counter[(tuple(args[0].shape), mod.eps, mod.silu)] += 1
        return record

    hooks = [m.register_forward_pre_hook(recorder(seen[name]))
             for name, model in (("unet", unet), ("vae", vae))
             for m in model.modules() if isinstance(m, GroupNorm)]
    x = torch.randn(8, 4, 64, 64, generator=gen, device=dev)
    t = torch.randint(0, 1000, (8,), generator=gen, device=dev)
    ctx = torch.randn(8, 77, 768, generator=gen, device=dev)
    z = torch.randn(4, 4, 64, 64, generator=gen, device=dev)
    with torch.inference_mode():
        out_kernel = unet(x, t, ctx).float()
        images = vae.decode(z)
        for hk in hooks:
            hk.remove()
        unet_ms = cuda_ms(lambda: unet(x, t, ctx), 3, 1)  # one CFG-doubled call of a step
        vae_ms = cuda_ms(lambda: vae.decode(z), 2, 1)
        set_impl(unet, "math")
        out_math = unet(x, t, ctx).float()
        set_impl(unet, "auto")
    rel = ((out_kernel - out_math).norm() / out_math.norm()).item()
    print(f"[unet] sd15 bf16 batch 8: rel L2 kernels vs math {rel:.3g} (bound {UNET_REL_L2})",
          flush=True)
    if not (torch.isfinite(out_kernel).all() and rel <= UNET_REL_L2):
        raise AssertionError("sd15 UNet with kernels disagrees with plain math")
    if not torch.isfinite(images).all() or tuple(images.shape) != (4, 3, 512, 512):
        raise AssertionError(f"VAE decode gave {tuple(images.shape)} / non-finite values")
    del out_kernel, out_math, images

    # GroupNorm forward (K3) at every shape of both main paths: the calls
    # derived from the config must be those the run just made.
    steps, seeds = 25, [0, 1, 2, 3]
    calls = group_norm_calls("sd15")
    for name, part in (("unet", "unet"), ("vae", "decode")):
        derived = collections.Counter()
        for (shape, _, eps, silu), n in calls[part].items():
            derived[(shape, eps, silu)] += n
        if derived != seen[name]:
            raise AssertionError(f"the GroupNorm calls of one {name} pass derived from the "
                                 f"config differ from the run's")
    fwd_keys = set(calls["unet"]) | set(calls["decode"]) | set(calls["encode"])
    gn_rows, gn_err = group_norm_table(gen, fwd_keys, {
        key: {"generate": steps * calls["unet"][key] + calls["decode"][key],
              "train_step": calls["unet"][key] + calls["encode"][key]} for key in fwd_keys},
        backward=False)
    level0 = ((8, 320, 64, 64), 32, 1e-5, True)  # ResnetBlock norm, UNet level 0
    # The control needs a span split over a cluster: at level 0 the forward
    # splits the up path's 640-channel norms.
    group_norm_control(gen, ((8, 640, 64, 64), 32, 1e-5, True), backward=False)
    gn_regs = {path: register_sums(gn_rows, path) for path in ("generate", "train_step")}
    print(f"[group_norm registers] the {gn_regs['generate']['launches']} launches per generate "
          f"whose plan holds the chunk in registers: {gn_regs['generate']['registers_ms']:.3f} "
          f"ms, the same plans in shared memory {gn_regs['generate']['shared_memory_ms']:.3f} "
          f"ms (L2-warm, launch-weighted)", flush=True)
    gn_host = group_norm_host_us(gen)
    print(f"[group_norm host] us per call at 8x1280x8x8 (host clock): plan built anew "
          f"{gn_host['plan_new']:.2f}, from the cache {gn_host['plan_cached']:.2f}; forward "
          f"wrapper with a new plan {gn_host['forward_new']:.2f}, with the cached one "
          f"{gn_host['forward_cached']:.2f}", flush=True)
    gn_sums = {path: {field: sum(r["launches"][path] * r[field] for r in gn_rows.values())
                      for field in ("ms", "cold_ms", "bound_ms", "library_ms")}
               for path in ("generate", "train_step")}
    print(f"[group_norm] {len(gn_rows)} distinct (shape, groups, eps, silu) of sampling and "
          f"training agree, two calls bit-identical; max|y err| {gn_err:.3g}; launch-weighted "
          f"per generate ({sum(r['launches']['generate'] for r in gn_rows.values())} launches): "
          f"{gn_sums['generate']['ms']:.3f} ms warm, {gn_sums['generate']['cold_ms']:.3f} cold, "
          f"bound {gn_sums['generate']['bound_ms']:.3f}, F.group_norm "
          f"{gn_sums['generate']['library_ms']:.3f}; per train step "
          f"({sum(r['launches']['train_step'] for r in gn_rows.values())}): "
          f"{gn_sums['train_step']['ms']:.3f} warm, {gn_sums['train_step']['cold_ms']:.3f} "
          f"cold, bound {gn_sums['train_step']['bound_ms']:.3f}", flush=True)

    # 5. main path: inference.generate on a model dir ------------------------
    work = tempfile.TemporaryDirectory()
    te = bundle.text_encoder
    with torch.no_grad():
        for layer in te.text_model.encoder.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj):
                proj.lora_B.weight.normal_(0.0, 0.01, generator=gen)
    export_lora_adapter(te, f"{work.name}/text_encoder", rank=4, base_model_name="sd15")
    export_token_embeddings(torch.randn(1, 768, generator=gen, device=dev) * 0.02,
                            {"<v*>": 0}, work.name)
    del bundle, te, unet, vae
    release_memos()  # the cold call below loads its model, as a fresh process does

    args = parse_args([work.name, "--model", "sd15", "--prompt", "photo of a <v*> dog",
                       "--seeds", *map(str, seeds), "--steps", str(steps),
                       "--guidance-scale", "7.5", "--lora-rank", "4"])
    want_flash, want_gn = expected_launches(spec, steps)
    if (want_flash, want_gn) != (251, 1555):
        raise AssertionError(f"spec-derived launch counts {want_flash, want_gn} != (251, 1555)")
    fa.launches = fa.bwd_launches = gn.launches = gn.bwd_launches = 0
    fa.variant_counts.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    out = generate(args)  # raises if a decoded image is not finite
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = {"flash": fa.launches, "gn": gn.launches}
    variants = dict(fa.variant_counts)
    if set(variants) - WGMMA_VARIANTS or sum(variants.values()) != fa.launches:
        raise AssertionError(f"sampling's flash launches went through {variants}, "
                             f"not all through {sorted(WGMMA_VARIANTS)}")
    if fa.bwd_launches or gn.bwd_launches:
        raise AssertionError("sampling launched a backward kernel")
    print(f"[generate] {out.shape} {out.dtype} in {cold_s:.2f} s (model init included): "
          f"{len(seeds) / cold_s:.3f} images/s; launches flash {launches['flash']} "
          f"(by variant: {variants}) group_norm {launches['gn']}", flush=True)
    if out.dtype.name != "uint8" or out.shape != (4, 512, 512, 3):
        raise AssertionError(f"generate returned {out.dtype} {out.shape}")
    if (launches["flash"], launches["gn"]) != (want_flash, want_gn):
        raise AssertionError(f"main path launched {launches}, expected {want_flash, want_gn}")
    t0 = time.time()
    generate(args)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    print(f"[generate] second call {warm_s:.2f} s: {len(seeds) / warm_s:.3f} images/s", flush=True)
    # The same sampling without the model load, for the time breakdown.
    t0 = time.time()
    pipe = load_textboost_pipeline(work.name, "sd15", lora_rank=4, device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    latents = torch.randn(len(seeds), 64, 64, 4, generator=gen, device=dev)

    def sample():
        """(images, seconds, launches (flash, group norm, backward)) of one call."""
        before = (fa.launches, gn.launches, fa.bwd_launches + gn.bwd_launches)
        torch.cuda.synchronize()
        t0 = time.time()
        images = pipe([args.prompt] * len(seeds), num_inference_steps=steps,
                      guidance_scale=7.5, latents=latents)
        torch.cuda.synchronize()
        return images, time.time() - t0, (fa.launches - before[0], gn.launches - before[1],
                                          fa.bwd_launches + gn.bwd_launches - before[2])

    # A pipeline samples eagerly unless its caller gives it graphs; given
    # them, the signature's first call runs eagerly, the second captures the
    # trajectory as a CUDA graph and replays it, the third replays.
    from textboost_torch.graphs import CapturedSampler

    pipe.graphs = CapturedSampler([(len(seeds), 512, 512, steps, True, "dpm++2m", 7.5)])
    gen_calls = [sample() for _ in range(3)]
    first_sample_s, capture_sample_s, sample_s = (c[1] for c in gen_calls)
    sample_graph = next(iter(pipe.graphs.stats().values()))
    print(f"[generate graph] {len(seeds)} prompts, {steps} steps, CFG 7.5: eager call "
          f"{first_sample_s * 1e3:.1f} ms ({len(seeds) / first_sample_s:.3f} images/s), capture "
          f"and replay {capture_sample_s * 1e3:.1f} ms (capture {sample_graph['capture_ms']:.1f} "
          f"ms, pool {sample_graph['pool_bytes'] / 2**30:.2f} GiB), replay {sample_s * 1e3:.1f} "
          f"ms ({len(seeds) / sample_s:.3f} images/s); launches per call "
          f"{[c[2] for c in gen_calls]} (derived {want_flash, want_gn}); the three calls' "
          f"images bit-equal: {all(np.array_equal(gen_calls[0][0], c[0]) for c in gen_calls)}; "
          f"{smi}", flush=True)
    if not all(np.array_equal(gen_calls[0][0], c[0]) for c in gen_calls):
        raise AssertionError("the sampler graph's images differ from the eager call's")
    if any(c[2] != (want_flash, want_gn, 0) for c in gen_calls):
        raise AssertionError(f"sampling calls launched {[c[2] for c in gen_calls]}, derived "
                             f"{want_flash, want_gn}")
    # One more replay traced on the card: kernel time against wall time,
    # and each kernel's launches in the trace.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced_s = sample()[1]
    sample_counts = traced_counts(prof)
    check_traced_counts(sample_counts, {"flash": want_flash, "gn": want_gn},
                        "the traced sampling replay")
    kernel_ms = collections.Counter()  # device ms by kernel name
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernel_ms[e.key] += e.self_device_time_total / 1e3
    busy_ms = sum(kernel_ms.values())
    traced_port_ms = {name: sum(ms for key, ms in kernel_ms.items() if tag in key)
                      for name, tag in (("flash_attention_fwd", "flash_fwd"),
                                        ("group_norm_fwd", "group_norm_fwd_kernel"))}
    print(f"[breakdown] load {load_s * 1e3:.0f} ms; sampling {first_sample_s * 1e3:.0f} ms "
          f"(eager), {sample_s * 1e3:.0f} ms (replay); UNet forward (batch 8) "
          f"{unet_ms:.1f} ms x {steps}, VAE decode {vae_ms:.1f} ms; traced call "
          f"{traced_s * 1e3:.0f} ms wall, {busy_ms:.0f} ms of kernels, of which flash "
          f"{traced_port_ms['flash_attention_fwd']:.1f} ms and group norm "
          f"{traced_port_ms['group_norm_fwd']:.1f} ms (idle {1 - busy_ms / (traced_s * 1e3):.3f}); "
          f"kernels in the trace {sample_counts}", flush=True)
    for name, ms in kernel_ms.most_common(10):
        print(f"[breakdown]   {ms:8.1f} ms  {name[:100]}", flush=True)
    del pipe
    work.cleanup()

    # 6. kernel times at the main path's shapes ------------------------------
    fa_shapes = {"unet_level0_8x4096x8x40": (8, 4096, 8, 40),
                 "unet_level1_8x1024x8x80": (8, 1024, 8, 80),
                 "vae_mid_4x4096x1x512": (4, 4096, 1, 512)}
    fa_t = {name: flash_forward_times(gen, *shp, card) for name, shp in fa_shapes.items()}
    flash_ms = (steps * 5 * (fa_t["unet_level0_8x4096x8x40"]["ms"]
                             + fa_t["unet_level1_8x1024x8x80"]["ms"])
                + fa_t["vae_mid_4x4096x1x512"]["ms"])
    main_key = ((8, 320, 64, 64), 32, 1e-6, False)  # Transformer2D norm, UNet level 0
    x = torch.randn(main_key[0], generator=gen, device=dev).to(bf16)
    ga = torch.randn(320, generator=gen, device=dev) * 0.2 + 1
    be = torch.randn(320, generator=gen, device=dev) * 0.1
    gn_plain = cuda_ms(lambda: gn.group_norm_reference(x, ga, be, 32, 1e-6, False), 10)
    del x

    # 7. flash backward vs fp32 autograd, and its times -----------------------
    flash_bwd_err = check_flash_backward(gen)
    fb_t = {name: flash_backward_times(gen, *shp, card)
            for name, shp in (("unet_level0_8x4096x8x40", (8, 4096, 8, 40)),
                              ("unet_level1_8x1024x8x80", (8, 1024, 8, 80)),
                              # No sd15 shape: the widest head the backward
                              # serves, whose dK/dV kernel spills registers.
                              ("widest_head_8x4096x8x128", (8, 4096, 8, 128)))}

    # 8. one sd15 train step at batch 2, kernels vs math -----------------------
    train_work = tempfile.TemporaryDirectory()
    instance_dir = os.path.join(train_work.name, "instance")
    os.makedirs(instance_dir)
    write_instance_image(os.path.join(instance_dir, "dog.png"), seed=0)
    parity, gn_train_shapes = train_step_parity(gen, instance_dir,
                                                os.path.join(train_work.name, "parity"))
    release_memos()

    # 9. group norm backward vs its plain version, training shapes at batch 8 --
    if {(k[0][1:],) + k[1:] for k in calls["unet_backward"]} != gn_train_shapes:
        raise AssertionError("the UNet norms of the train step's backward differ from those "
                             "derived from the config")
    gn_bwd_rows, gn_bwd_err = group_norm_table(
        gen, set(calls["unet_backward"]),
        {key: {"train_step": n} for key, n in calls["unet_backward"].items()}, backward=True)
    group_norm_control(gen, level0, backward=True)
    gn_bwd_sums = {field: sum(r["launches"]["train_step"] * r[field] for r in gn_bwd_rows.values())
                   for field in ("ms", "cold_ms", "bound_ms", "library_ms")}
    print(f"[group_norm_bwd] {len(gn_bwd_rows)} distinct (shape, groups, eps, silu) of the "
          f"UNet's training backward at batch 8 agree, two calls bit-identical; max|dx err| "
          f"{gn_bwd_err:.3g}; launch-weighted per train step "
          f"({sum(calls['unet_backward'].values())} launches): {gn_bwd_sums['ms']:.3f} ms warm, "
          f"{gn_bwd_sums['cold_ms']:.3f} cold, bound {gn_bwd_sums['bound_ms']:.3f}, "
          f"native_group_norm_backward {gn_bwd_sums['library_ms']:.3f}", flush=True)
    gn_bwd_regs = register_sums(gn_bwd_rows, "train_step")
    print(f"[group_norm_bwd registers] the {gn_bwd_regs['launches']} launches per train step "
          f"whose plan holds the chunks in registers: {gn_bwd_regs['registers_ms']:.3f} ms, "
          f"the same plans in shared memory {gn_bwd_regs['shared_memory_ms']:.3f} ms (L2-warm, "
          f"launch-weighted)", flush=True)
    x = torch.randn(main_key[0], generator=gen, device=dev).to(bf16)
    dy = torch.randn(main_key[0], generator=gen, device=dev).to(bf16)
    _, mu, rs = gn.group_norm_forward(x, ga, be, 32, eps=1e-6, silu=False)
    gn_bwd_plain = cuda_ms(
        lambda: gn.group_norm_backward_reference(x, ga, be, mu, rs, dy, 32, 1e-6, False), 10)
    del x, dy, mu, rs

    # 10. main path: textboost_torch.train.main, then sampling from its output -
    want = expected_train_launches(spec)
    if want != (11, 9, 83, 58):
        raise AssertionError(f"spec-derived train-step launch counts {want} != (11, 9, 83, 58)")
    want_run = {key: n * TRAIN_STEPS
                for key, n in zip(("flash", "flash_bwd", "gn", "gn_bwd"), want)}
    out_dir = os.path.join(train_work.name, "out")
    tr = train_main_path(instance_dir, out_dir)
    m = tr["metrics"]
    print(f"[train] {TRAIN_STEPS} steps sd15 512 px batch 8 bf16 in {tr['run_s']:.1f} s "
          f"(model init and export included): loss {m['loss']:.5g}, kpl {m['kpl']:.3g}, "
          f"grad_norm {m['grad_norm']:.3g}; warm step (CUDA events) captured {tr['warm_step_ms']:.1f} "
          f"ms (replays, steps 5-9), eager {tr['eager_step_ms']:.1f} ms (steps 2-3), step 4 (capture "
          f"and replay) {tr['capture_step_ms']:.1f} ms; {step_graph_check(m, TRAIN_STEPS, 'the sd15 run')}; "
          f"peak {tr['peak_bytes'] / 2**30:.2f} GiB allocated, {tr['reserved_bytes'] / 2**30:.2f} "
          f"reserved; launches {tr['launches']} (expected "
          f"{want_run}); flash forward by variant {tr['variants']}", flush=True)
    check_traced_counts(tr["traced_counts"], dict(zip(("flash", "flash_bwd", "gn", "gn_bwd"), want)),
                        "the sd15 run's traced step (a replay)")
    if tr["launches"] != want_run:
        raise AssertionError(f"training launched {tr['launches']}, expected {want_run}")
    if m["steps"] != TRAIN_STEPS or not all(
            math.isfinite(m[key]) for key in ("loss", "kpl", "grad_norm", "added_embedding_norm")):
        raise AssertionError(f"training returned {m}")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if not any(r["step"] == TRAIN_STEPS and math.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"metrics.jsonl has no step-{TRAIN_STEPS} record")
    for name in ("text_encoder/adapter_model.safetensors", "text_encoder/adapter_config.json",
                 "v*.bin", "training.log"):
        if not os.path.isfile(os.path.join(out_dir, name)):
            raise AssertionError(f"training wrote no {name}")
    busy = sum(tr["kernel_ms"].values())
    new_ms = {name: sum(ms for key, ms in tr["kernel_ms"].items() if tag in key)
              for name, tag in (("flash_attention_bwd", "flash_bwd_"),
                                ("group_norm_bwd", "group_norm_bwd_kernel"),
                                ("flash_attention_fwd", "flash_fwd"),
                                ("group_norm_fwd", "group_norm_fwd_kernel"))}
    print(f"[train breakdown] traced step {tr['traced_wall_ms']:.1f} ms wall, {busy:.1f} ms "
          f"of kernels (idle {1 - busy / tr['traced_wall_ms']:.3f}); flash bwd "
          f"{new_ms['flash_attention_bwd']:.1f} ms ({new_ms['flash_attention_bwd'] / busy:.3f}), "
          f"group norm bwd {new_ms['group_norm_bwd']:.1f} ms "
          f"({new_ms['group_norm_bwd'] / busy:.3f}), flash fwd "
          f"{new_ms['flash_attention_fwd']:.1f} ms, group norm fwd "
          f"{new_ms['group_norm_fwd']:.1f} ms", flush=True)
    for name, ms in tr["kernel_ms"].most_common(10):
        print(f"[train breakdown]   {ms:8.2f} ms  {name[:100]}", flush=True)
    # The same flags with capture off for 5 steps: the eager path,
    # its warm step and peak beside the captured run's, and its losses those
    # of the captured run's first 5 steps bit for bit (steps 4-5 replays
    # there).
    set_capture(False)
    try:
        eager_tr = instrumented_train(train_flags(instance_dir, out_dir + "_eager", 8, 5))
    finally:
        set_capture(True)
    eager_ev = eager_tr["events"]
    eager_run = {"warm_step_ms": eager_ev[0].elapsed_time(eager_ev[4]) / 4,
                 "peak_bytes": eager_tr["peak_bytes"], "reserved_bytes": eager_tr["reserved_bytes"],
                 "step_graph": eager_tr["metrics"]["step_graph"],
                 "loss_by_step": eager_tr["metrics"]["loss_by_step"]}
    same_losses = eager_run["loss_by_step"] == m["loss_by_step"][:5]
    print(f"[train eager] the same flags with capture off, 5 steps: warm step "
          f"{eager_run['warm_step_ms']:.1f} ms (steps 2-5) against {tr['warm_step_ms']:.1f} "
          f"captured; peak {eager_run['peak_bytes'] / 2**30:.2f} GiB allocated and "
          f"{eager_run['reserved_bytes'] / 2**30:.2f} reserved against "
          f"{tr['peak_bytes'] / 2**30:.2f} and {tr['reserved_bytes'] / 2**30:.2f} captured; "
          f"launches {eager_tr['launches']}; losses "
          f"{'the same bits as' if same_losses else 'DIFFER from'} the captured run's steps 1-5 "
          f"({eager_run['loss_by_step']}); {smi}", flush=True)
    if not same_losses or eager_tr["launches"] != {k: n // TRAIN_STEPS * 5 for k, n in want_run.items()}:
        raise AssertionError("the eager sd15 run differs from the captured one")
    images = generate(parse_args([out_dir, "--model", "sd15", "--prompt", "photo of a <v*> dog",
                                  "--seeds", "0", "--steps", "2", "--lora-rank", "4"]))
    if images.dtype.name != "uint8" or images.shape != (1, 512, 512, 3):
        raise AssertionError(f"sampling the trained model gave {images.dtype} {images.shape}")
    print(f"[train] the exported model dir samples through textboost_torch.inference: "
          f"{images.shape}", flush=True)
    train_work.cleanup()

    # 11. main path: the paper's run at sd21base, then its resume --------------
    release_memos()
    paper_work = tempfile.TemporaryDirectory()
    paper = paper_run_phase(gen, card, paper_work.name, gn_rows, gn_bwd_rows)
    paper_work.cleanup()
    held = paper.pop("held")
    held["gn_rows"] = {**gn_rows, **held["gn_rows"]}
    held["gn_bwd_rows"] = {**gn_bwd_rows, **held["gn_bwd_rows"]}

    # 11b. main path: --attention_impl flash at sd15, bf16 and fp32, with K2
    # at its new forms --------------------------------------------------------
    release_memos()
    flash_work = tempfile.TemporaryDirectory()
    sd15_held = {"flash": held["flash"] | {(8, 4096, 8, 40, 4096), (8, 1024, 8, 80, 1024),
                                           (4, 4096, 1, 512, 4096), (8, 4096, 8, 40, 77)},
                 "flash_bwd": held["flash_bwd"] | {(8, 4096, 8, 40, 4096), (8, 1024, 8, 80, 1024)}}
    fl = flash_impl_phase(gen, card, flash_work.name, smi, sd15_held)
    flash_work.cleanup()

    # 12. main path: training from a diffusers snapshot with the DB runner's
    # remaining flags, then serving its output over the snapshot ------------
    release_memos()
    snapshot_work = tempfile.TemporaryDirectory()
    snap = snapshot_run_phase(gen, card, snapshot_work.name, smi, held)
    # The seeded snapshot serves the native phase last; the rest goes now.
    for name in os.listdir(snapshot_work.name):
        path = os.path.join(snapshot_work.name, name)
        if name != "sd21base_snapshot":
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)

    # 13. main path: the DreamBooth benchmark: the sweep runner's training,
    # the eval's generation and its four scorers --------------------------
    release_memos()
    bench_work = tempfile.TemporaryDirectory()
    bench = benchmark_phase(gen, card, bench_work.name, smi, held)
    bench_work.cleanup()

    # 14. main path: sd21 at 768 px, the plans executed on the card, PNDM
    # validation, then sampling with every sampler ------------------------
    release_memos()
    sd21_work = tempfile.TemporaryDirectory()
    sd21 = sd21_phase(gen, card, sd21_work.name, smi, held)
    sd21_work.cleanup()

    # 15. main path: data parallel over torch.distributed at sd21base: one
    # process, NCCL at world 1, two ranks on the card over gloo and their
    # resume, each launched as a user would ---------------------------------
    release_memos()
    dp_work = tempfile.TemporaryDirectory()
    dp = dp_phase(gen, card, dp_work.name, smi, held)
    dp_work.cleanup()

    # 16. main path: tensor parallel over torch.distributed at sd21base: one
    # process and two tp ranks on the card over gloo and their resume, each
    # launched as a user would ---------------------------------------------
    release_memos()
    tp_work = tempfile.TemporaryDirectory()
    tp = tp_phase(gen, card, tp_work.name, smi, held)
    tp_work.cleanup()

    # 17. main path: the JAX package's native snapshot written, read and
    # served, and inference and the eval over two ranks on the card ---------
    release_memos()
    native_work = tempfile.TemporaryDirectory()
    nd = native_dp_phase(gen, card, native_work.name, smi, held,
                         os.path.join(snapshot_work.name, "sd21base_snapshot"))
    native_work.cleanup()
    snapshot_work.cleanup()
    by_path = {name: {"generate_sd15": launches.get(key, 0), "train_sd15": tr["launches"][key],
                      "flash_sd15_bf16": fl["launches"]["bf16"][key],
                      "flash_sd15_fp32": fl["launches"]["fp32"][key],
                      "paper_sd21base": paper["launches"][key],
                      "paper_sd21base_resumed": paper["resumed_launches"][key],
                      "paper_sd21base_accumulation": paper["accumulation"]["launches"][key],
                      "paper_sd21base_accumulation_resumed":
                          paper["accumulation"]["resumed_launches"][key],
                      "snapshot_sd21base": snap["launches"][key],
                      "snapshot_sd21base_resumed": snap["resumed_launches"][key],
                      "dp_sd21base_world_1_nccl": dp["world_1_nccl"]["launches"][key],
                      "benchmark_sd21base": bench["launches"][key],
                      "sd21_768": sd21["launches"][key],
                      **{f"dp_sd21base_{r}": n[key] for r, n in dp["launches"].items()},
                      **{f"tp_sd21base_{r}": n[key] for r, n in tp["launches"].items()},
                      **{f"native_dp_sd21base_{r}": n[key] for r, n in nd["launches"].items()}}
               for name, key in (("flash_attention_fwd", "flash"), ("flash_attention_bwd", "flash_bwd"),
                                 ("group_norm_fwd", "gn"), ("group_norm_bwd", "gn_bwd"))}
    # The top-level numbers are the sd21 phase's, the newest main path: its
    # launches, and the times at its dominant shape, UNet level 0 at batch 8
    # (the training step, and four prompts under CFG in sampling).
    k_main = "sd21_8x9216x5x64"

    kernels = {"kernels": [
        dict({"name": "flash_attention_fwd", "route": "cuda",
              "source": "textboost_torch/csrc/flash_attention_fwd.cu",
              "replaces": "textboost_tpu/ops/flash_attention.py:42",
              "launches": sd21["launches"]["flash"],
              "max_abs_err": max(flash_err, paper["k1_max_abs_err"], fl["k1_max_abs_err"],
                                 snap["k1_max_abs_err"],
                                 bench["k1_max_abs_err"], sd21["k1_max_abs_err"],
                                 dp["k1_max_abs_err"], tp["k1_max_abs_err"],
                                 nd["k1_max_abs_err"])},
             **{k: v for k, v in sd21["k1"][k_main].items() if k != "launches"},
             shape="B,N,H,D=8,9216,5,64 bf16 (sd21 UNet level 0 at 768 px: the train step at "
                   "batch 8, four prompts under CFG)",
             other_shapes={**{k: v for k, v in sd21["k1"].items() if k != k_main},
                           **{f"snapshot_{k}": v for k, v in snap["k1"].items()},
                           **paper["k1"], **bench["k1"],
                           **{f"sd15_{k}": v for k, v in fa_t.items()},
                           **{f"dp_{k}": v for k, v in dp["k1"].items()},
                           **{f"tp_{k}": v for k, v in tp["k1"].items()},
                           **{f"native_dp_{k}": v for k, v in nd["k1"].items()},
                           **{f"flash_impl_{k}": v for k, v in fl["k1_forms"].items()}},
             per_generate_ms=flash_ms, launches_by_path=by_path["flash_attention_fwd"], launches_counted=REPLAYS_COUNTED,
             variants={"generate": variants, "train": tr["variants"],
                       "paper": paper["variants"],
                       "flash_sd15_bf16": fl["runs"]["bf16"]["variants"],
                       "flash_sd15_fp32": fl["runs"]["fp32"]["variants"]}),
        dict({"name": "flash_attention_bwd", "route": "cuda",
              "source": "textboost_torch/csrc/flash_attention_bwd.cu",
              "replaces": "textboost_tpu/ops/flash_attention.py:119",
              "launches": sd21["launches"]["flash_bwd"],
              "max_abs_err": max(flash_bwd_err, paper["k2_max_abs_err"], fl["k2_max_abs_err"],
                                 snap["k2_max_abs_err"],
                                 bench["k2_max_abs_err"], sd21["k2_max_abs_err"],
                                 dp["k2_max_abs_err"], tp["k2_max_abs_err"],
                                 nd["k2_max_abs_err"])},
             **{k: v for k, v in sd21["k2"][k_main].items() if k != "launches"},
             shape="B,N,H,D=8,9216,5,64 bf16 (sd21 UNet level 0 at 768 px, the train step at "
                   "batch 8)",
             other_shapes={**{k: v for k, v in sd21["k2"].items() if k != k_main},
                           **{f"snapshot_{k}": v for k, v in snap["k2"].items()},
                           **paper["k2"], **{f"sd15_{k}": v for k, v in fb_t.items()},
                           **{f"dp_{k}": v for k, v in dp["k2"].items()},
                           **{f"tp_{k}": v for k, v in tp["k2"].items()},
                           **{f"flash_impl_{k}": v for k, v in fl["k2_forms"].items()}},
             launches_by_path=by_path["flash_attention_bwd"], launches_counted=REPLAYS_COUNTED,
             variants={"flash_sd15_bf16": fl["runs"]["bf16"]["bwd_variants"],
                       "flash_sd15_fp32": fl["runs"]["fp32"]["bwd_variants"]},
             launches_per_train_step=snap["launches"]["flash_bwd"] / SNAPSHOT_STEPS),
        {"name": "group_norm_fwd", "route": "cuda",
         "source": "textboost_torch/csrc/group_norm_fwd.cu",
         "replaces": "textboost_tpu/ops/group_norm.py:58",
         "launches": sd21["launches"]["gn"],
         "max_abs_err": max(gn_err, paper["gn_max_abs_err"], fl["gn_fp32_max_abs_err"],
                            snap["gn_max_abs_err"],
                            bench["gn_max_abs_err"], sd21["gn_max_abs_err"],
                            dp["gn_max_abs_err"], nd["gn_max_abs_err"]),
         **{k: v for k, v in sd21["gn_main"]["fwd"].items() if k != "launches"},
         "shape": "8x320x96x96 bf16 G=32 eps=1e-6 silu=off (sd21 at 768 px)",
         "other_shapes": {**{name: group_norm_json(gn_rows[key]) for name, key in (
             ("sd15_8x320x64x64", main_key), ("resnet_silu_8x320x64x64", level0),
             ("vae_silu_4x128x512x512", ((4, 128, 512, 512), 32, 1e-6, True)))},
             "dp_4x320x64x64": dp["gn_main"]["fwd"],
             "native_dp_tail_2x320x64x64": nd["gn_tail"]},
         "per_dp_rank_step": dp["group_norm_per_rank_step"]["group_norm_fwd"],
         "plain_ms_sd15_8x320x64x64": gn_plain, "per_sd21_phase": sd21["group_norm"]["group_norm_fwd"],
         "per_generate": gn_sums["generate"], "per_train_step": gn_sums["train_step"],
         "launches_by_path": by_path["group_norm_fwd"], "launches_counted": REPLAYS_COUNTED, "registers": gn_regs,
         "host_us_8x1280x8x8": gn_host},
        {"name": "group_norm_bwd", "route": "cuda",
         "source": "textboost_torch/csrc/group_norm_bwd.cu",
         "replaces": "textboost_tpu/ops/group_norm.py:93",
         "launches": sd21["launches"]["gn_bwd"],
         "max_abs_err": max(gn_bwd_err, paper["gn_bwd_max_abs_err"], fl["gn_fp32_max_abs_err"],
                            snap["gn_bwd_max_abs_err"],
                            bench["gn_bwd_max_abs_err"], sd21["gn_bwd_max_abs_err"],
                            dp["gn_bwd_max_abs_err"], nd["gn_bwd_max_abs_err"]),
         **{k: v for k, v in sd21["gn_main"]["bwd"].items() if k != "launches"},
         "shape": "8x320x96x96 bf16 G=32 eps=1e-6 silu=off (sd21 at 768 px)",
         "other_shapes": {"sd15_8x320x64x64": group_norm_json(gn_bwd_rows[main_key]),
                          "resnet_silu_8x320x64x64": group_norm_json(gn_bwd_rows[level0]),
                          "dp_4x320x64x64": dp["gn_main"]["bwd"]},
         "per_dp_rank_step": dp["group_norm_per_rank_step"]["group_norm_bwd"],
         "plain_ms_sd15_8x320x64x64": gn_bwd_plain,
         "per_sd21_phase": sd21["group_norm"]["group_norm_bwd"],
         "per_train_step": gn_bwd_sums, "registers": gn_bwd_regs,
         "launches_by_path": by_path["group_norm_bwd"], "launches_counted": REPLAYS_COUNTED,
         "launches_per_train_step": tr["launches"]["gn_bwd"] / TRAIN_STEPS},
    ], "sd15_images_per_s": len(seeds) / warm_s, "sd15_images_per_s_cold": len(seeds) / cold_s,
        "generate_ms": warm_s * 1e3, "load_ms": load_s * 1e3,
        "sample_ms": sample_s * 1e3, "sample_first_ms": first_sample_s * 1e3,
        "sample_capture_ms": capture_sample_s * 1e3, "sample_graph": sample_graph,
        "sd15_images_per_s_eager_call": len(seeds) / first_sample_s,
        "sd15_images_per_s_replay": len(seeds) / sample_s,
        "traced_sample_idle": 1 - busy_ms / (traced_s * 1e3),
        "traced_sample_ms": traced_s * 1e3, "traced_kernel_ms": busy_ms,
        "traced_port_kernel_ms": traced_port_ms,
        "unet_forward_ms": unet_ms, "vae_decode_ms": vae_ms,
        "unet_rel_l2_kernels_vs_math": rel, "card": card,
        "train": {"steps": TRAIN_STEPS, "batch": 8, "run_s": tr["run_s"],
                  "warm_step_ms": tr["warm_step_ms"], "eager_step_ms": tr["eager_step_ms"],
                  "capture_step_ms": tr["capture_step_ms"], "peak_bytes": tr["peak_bytes"],
                  "reserved_bytes": tr["reserved_bytes"],
                  "step_graph": {k: m[k] for k in m if k.startswith("step_graph")},
                  "traced_step_idle": 1 - busy / tr["traced_wall_ms"], "eager_run": eager_run,
                  "traced_step_wall_ms": tr["traced_wall_ms"],
                  "traced_step_kernel_ms": busy, "traced_port_kernel_ms": new_ms,
                  "final_loss": m["loss"], "step_parity_batch2": parity},
        "paper_run_sd21base": {k: v for k, v in paper.items()
                               if not (k in ("k1", "k2") or k.endswith("max_abs_err"))},
        "flash_impl_sd15": {k: v for k, v in fl.items()
                            if not (k in ("k1_forms", "k2_forms") or k.endswith("max_abs_err"))},
        "snapshot_run_sd21base": {k: v for k, v in snap.items()
                                  if not (k in ("k1", "k2") or k.endswith("max_abs_err"))},
        "benchmark_sd21base": {k: v for k, v in bench.items()
                               if not (k == "k1" or k.endswith("max_abs_err"))},
        "sd21_768": {k: v for k, v in sd21.items()
                     if not (k in ("k1", "k2", "gn_main") or k.endswith("max_abs_err"))},
        "dp_sd21base": {k: v for k, v in dp.items()
                        if not (k in ("k1", "k2", "gn_main") or k.endswith("max_abs_err"))},
        "tp_sd21base": {k: v for k, v in tp.items()
                        if not (k in ("k1", "k2") or k.endswith("max_abs_err"))},
        "native_dp_sd21base": {k: v for k, v in nd.items()
                               if not (k in ("k1", "gn_tail") or k.endswith("max_abs_err"))}}
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    if sys.argv[1:2] in (["--dp-rank"], ["--tp-rank"]) and sys.argv[3:4] == ["--"]:
        sys.exit(dp_rank(sys.argv[2], sys.argv[4:], digest=sys.argv[1] == "--tp-rank"))
    if sys.argv[1:2] == ["--gen-rank"] and sys.argv[3:4] == ["--"] and len(sys.argv) == 5:
        sys.exit(gen_rank(sys.argv[2], sys.argv[4]))
    sys.exit(main())
