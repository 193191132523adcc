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
    image ops against this machine's PIL are checked;
  * the snapshot run: a full-width sd21base diffusers snapshot written from
    seeded weights (fp32 text encoder and VAE, fp16 UNet, a 49408-entry BPE
    tokenizer with sd2's pad token) is loaded back by `load_models` (family
    inferred, every tensor its file's value cast as loaded), then
    `textboost_torch.train.main` trains from it with the paper run's flags
    plus the DB runner's remaining ones (the UNet's cross-attention LoRA,
    the image prior with 8 class images generated into an empty dir,
    gradient checkpointing, the padded CLIP mask) for 6 steps, a checkpoint
    at 3 and a validation round at 6; its launches must be those derived
    from the config on the meta device, the recompute of the checkpointed
    blocks included, each kernel is held at every shape the run gave it
    (the UNet at batch 16), and `load_textboost_pipeline` serves the output
    over the snapshot (4 seeds; its UNet LoRA the trainer's export, bit for
    bit).  Last, one train step at these flags with and without
    checkpointing: step time, peak memory and the launches counted in each
    (those derived, with and without the recompute), and one forward and
    backward in each mode, whose loss and trainable gradients must be
    bit-identical.

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

fp32 matmuls and convolutions are held to full fp32 (TF32 off) so that the
plain references are what they say.
"""
from __future__ import annotations

import collections
import gc
import json
import math
import os
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
RESUME_REL_L2 = 1e-2

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (H100 SXM)
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
EX2_PER_SM_CLOCK = 16  # base-2 exponentials an SM retires per clock (NVIDIA's throughput table, cc 9.0)

# The variants of the flash forward that count as the Hopper design.
WGMMA_VARIANTS = {"wgmma", "wgmma_wide"}


def flash_floors_ms(b: int, n: int, m: int, h: int, d: int, *, backward: bool,
                    sm_count: int, sm_clock_hz: float) -> dict:
    """The least times (ms) the card could take for attention over q
    [b, n, h, d], k/v [b, m, h, d] in a 16-bit type, one per resource:
    "bytes" (every input read once, every output written once, lse fp32),
    "tensor_cores" (two products forward, five backward, 2 operations per
    multiply-add, at the card's dense 16-bit rate) and "exponentials" (one
    ex2 per score at 16 per SM and clock)."""
    q_el, kv_el = b * n * h * d, b * m * h * d
    if backward:  # q, o, dO in, dq out; k, v in, dk, dv out; lse
        nbytes = 2 * (4 * q_el + 4 * kv_el) + 4 * b * h * n
        products = 5
    else:  # q in, o out; k, v in; lse
        nbytes = 2 * (2 * q_el + 2 * kv_el) + 4 * b * h * n
        products = 2
    return {
        "bytes": nbytes / H100_BYTES_PER_S * 1e3,
        "tensor_cores": products * 2 * b * h * n * m * d / H100_BF16_FLOPS * 1e3,
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


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call of `fn`.  The stream is first held by a spin
    kernel while the host enqueues the whole timed loop, so the host's launch
    cost (ctypes, allocation) is not counted as the kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
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


def write_instance_image(path: str, seed: int) -> None:
    """A 512x512 RGB PNG: smooth colour ramps plus noise, from a seed."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:512, 0:512] / 511.0
    img = np.stack([xx, yy, 1.0 - xx * yy], axis=-1) * 200 + rng.normal(0, 20, (512, 512, 3))
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


def check_flash_forward(gen, shapes) -> float:
    """K1 against its plain version computed in fp32 at each (B, N, H, D, M)
    of `shapes`, with the P-in-bf16 and dropped-tile controls printed; the
    dropped tile must fail the limits.  Returns the largest |o error|."""
    import torch

    from textboost_torch.ops import flash_attention as fa

    dev, bf16 = gen.device, torch.bfloat16
    worst = 0.0
    for b, n, h, d, m in shapes:
        q = torch.randn(b, n, h, d, generator=gen, device=dev).to(bf16)
        k = torch.randn(b, m, h, d, generator=gen, device=dev).to(bf16)
        v = torch.randn(b, m, h, d, generator=gen, device=dev).to(bf16)
        o, lse = fa.flash_attention_forward(q, k, v, scale=d**-0.5)
        torch.cuda.synchronize()
        ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(), d**-0.5)
        eo = (o.float() - ro).abs().max().item()
        el = (lse - rl).abs().max().item()
        rel, row = flash_errors(o, ro)
        p_bf16 = flash_errors(attention_fp32(q, k, v, d**-0.5, p_dtype=bf16).to(bf16), ro)
        dropped = flash_errors(attention_fp32(q, k, v, d**-0.5, drop_keys=64).to(bf16), ro)
        print(f"[flash] B,N,H,D,M={b},{n},{h},{d},{m}: o rel L2 {rel:.3g} (limit "
              f"{FLASH_REL_L2}), worst row {row:.3g} (limit {FLASH_ROW_REL_L2}), max|o err| "
              f"{eo:.3g} of max|o| {ro.abs().max().item():.3g}, max|lse err| {el:.3g}; "
              f"controls rel L2 / worst row: P in bf16 {p_bf16[0]:.3g} / {p_bf16[1]:.3g}, "
              f"first 64 keys dropped {dropped[0]:.3g} / {dropped[1]:.3g}", flush=True)
        if not (dropped[0] > FLASH_REL_L2 and dropped[1] > FLASH_ROW_REL_L2):
            raise AssertionError("the flash limits would pass a kernel that drops a key tile")
        if not (rel <= FLASH_REL_L2 and row <= FLASH_ROW_REL_L2 and el <= FLASH_LSE_ATOL):
            raise AssertionError(f"flash attention disagrees with its plain version at "
                                 f"{b, n, h, d, m}")
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
        "plain_ms": cuda_ms(lambda: fa.flash_attention_reference(q, k, v, d**-0.5), 3, 1),
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
        "plain_ms": cuda_ms(
            lambda: fa.flash_attention_backward_reference(q, k, v, o, lse, do, d**-0.5), 2, 1),
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


def train_step_calls(model: str, unet_batch: int, encode_batch: int, *,
                     checkpointing: bool, cross_lora_rank: int) -> dict:
    """The kernel calls of one train step at `model`'s full width, found by
    running its UNet forward and backward (the text and the UNet's LoRA
    trainable, `gradient_checkpointing` as given) and its VAE encoder on the
    meta device: {"flash", "flash_bwd", "gn", "gn_bwd"}, each a Counter of
    the kernel wrappers' keys (flash (B, N, H, D, M); GroupNorm (shape,
    groups, eps, silu)).  The forward kernels count the forward's calls and
    those the checkpointed blocks' recompute makes in the backward (torch
    runs it for the blocks that saved something: not for one whose inputs
    and parameters need no gradient); the backward kernels count the
    forward calls whose input needs a gradient."""
    import torch

    from textboost_torch.models.configs import get_spec
    from textboost_torch.models.layers import CrossAttention, GroupNorm, VAEAttention, set_impl
    from textboost_torch.models.unet import UNet2DCondition
    from textboost_torch.models.vae import AutoencoderKL
    from textboost_torch.ops.attention import use_flash

    spec = get_spec(model)
    with torch.device("meta"):
        unet = UNet2DCondition(spec.unet, cross_lora_rank=cross_lora_rank)
        vae = AutoencoderKL(spec.vae)
    calls = {name: collections.Counter() for name in ("flash", "flash_bwd", "gn", "gn_bwd")}
    forward = [True]

    def record(kind, key, x):
        calls[kind][key] += 1
        if forward[0] and x.requires_grad:
            calls[kind + "_bwd"][key] += 1

    def gn_hook(mod, args):
        record("gn", (tuple(args[0].shape), mod.num_groups, mod.eps, mod.silu), args[0])

    def attn_hook(mod, args):
        x = args[0]
        if isinstance(mod, VAEAttention):
            b, c, h, w = x.shape
            n, heads, d = h * w, 1, c
        elif len(args) == 1:  # self-attention; cross-attention's 77 keys take the math path
            b, n, c = x.shape
            heads, d = mod.heads, c // mod.heads
        else:
            return
        if use_flash("cuda", n, n, d, torch.bfloat16, False, False):
            record("flash", (b, n, heads, d, n), x)

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


def group_norm_table(gen, keys, launches: dict, backward: bool):
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
                dy, x, lmu, lrs, ga16, b, c, hw, groups, [True, False, False]), 10)
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
            library_ms = cuda_ms(lambda: F.group_norm(x, groups, ga16, be16, eps), 10)
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
        warm = cuda_ms(lambda: kernel(*inputs), 10)
        shared_ms = None
        if plan.regs:
            shared = gn.split_span(plan.span, plan.elem_bytes, plan.tensors, plan.vector,
                                   plan.cluster, registers=False)
            gn.plan_group_norm = lambda *args, **kwargs: shared
            try:
                if not check(kernel(*inputs))[1]:
                    raise AssertionError(f"{tag} in shared memory disagrees with its plain "
                                         f"version at {key}")
                shared_ms = cuda_ms(lambda: kernel(*inputs), 10)
            finally:
                gn.plan_group_norm = planner
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
        print(f"[{tag}] {'x'.join(map(str, shape))} G={groups} eps={eps:g} silu={int(silu)}: "
              f"k={plan.cluster} {holds(plan)} {plan.threads} thr; ms {warm:.4f} warm"
              f"{shared_note} {cold:.4f} cold; bound_ms {rows[key]['bound_ms']:.4f} "
              f"({rows[key]['bytes']} bytes); {library} {library_ms:.4f}; launches "
              f"{launches[key]}", flush=True)
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


def instrumented_train(argv, trace_call=None, capture_call=None, on_step=None):
    """`textboost_torch.train.main(argv)` with the launch counts set to 0
    just before and read just after.  A CUDA event is recorded after each
    step call; call `trace_call` (0-based) is traced with torch.profiler
    after the queue has drained; call `capture_call` has its batch and draws
    copied to the host; `on_step(call, state, batch, metrics)` runs after
    each step call."""
    import torch
    import torch.profiler

    from textboost_torch import train as train_pkg
    from textboost_torch.ops import flash_attention as fa
    from textboost_torch.ops import group_norm as gn
    from textboost_torch.train import trainer as trainer_mod

    events, traced, captured = [], {}, {}
    real_make = trainer_mod.make_train_step

    def timed_make(config):
        step = real_make(config)

        def timed_step(state, batch, draws):
            if len(events) == capture_call:
                captured.update({name: {k: v.detach().cpu().clone() for k, v in d.items()}
                                 for name, d in (("batch", batch), ("draws", draws))})
            if len(events) == trace_call:
                torch.cuda.synchronize()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    out = step(state, batch, draws)
                    torch.cuda.synchronize()
                    traced["wall_ms"] = (time.perf_counter() - t0) * 1e3
                traced["prof"] = prof
            else:
                out = step(state, batch, draws)
            if on_step is not None:
                on_step(len(events), state, batch, out)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            return out

        return timed_step

    # The shapes each kernel wrapper is called at: flash (B, N, H, D, M),
    # GroupNorm (shape, groups, eps, silu), the keys of the checks.
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

    trainer_mod.make_train_step = timed_make
    for name, (mod, attr) in wrappers.items():
        setattr(mod, attr, recording(name))
    fa.launches = fa.bwd_launches = gn.launches = gn.bwd_launches = 0
    fa.variant_counts.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        metrics = train_pkg.main(argv)
    finally:
        trainer_mod.make_train_step = real_make
        for name, (mod, attr) in wrappers.items():
            setattr(mod, attr, real[name])
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = {"flash": fa.launches, "flash_bwd": fa.bwd_launches, "gn": gn.launches,
                "gn_bwd": gn.bwd_launches}
    variants = dict(fa.variant_counts)
    if set(variants) - WGMMA_VARIANTS or sum(variants.values()) != fa.launches:
        raise AssertionError(f"training's flash forward launches went through {variants}, "
                             f"not all through {sorted(WGMMA_VARIANTS)}")
    kernel_ms = collections.Counter()
    if "prof" in traced:
        for e in traced["prof"].key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernel_ms[e.key] += e.self_device_time_total / 1e3
    if {name: sum(c.values()) for name, c in shapes.items()} != launches:
        raise AssertionError(f"training called the kernel wrappers other than it launched: "
                             f"{launches}")
    return {"metrics": metrics, "launches": launches, "variants": variants, "run_s": run_s,
            "events": events, "traced_wall_ms": traced.get("wall_ms"), "kernel_ms": kernel_ms,
            "captured": captured, "shapes": shapes}


def train_main_path(instance_dir: str, output_dir: str):
    """The sd15 training main path: TRAIN_STEPS steps at batch 8; the warm
    step time averages steps 3-9, the last step is traced."""
    tr = instrumented_train(train_flags(instance_dir, output_dir, 8, TRAIN_STEPS),
                            trace_call=TRAIN_STEPS - 1)
    events = tr.pop("events")
    tr["warm_step_ms"] = events[1].elapsed_time(events[TRAIN_STEPS - 2]) / (TRAIN_STEPS - 3)
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
    run = instrumented_train(paper_flags(instance_dir, out), trace_call=PAPER_STEPS - 1,
                             capture_call=PAPER_CADENCE)
    m = run["metrics"]
    rounds = PAPER_STEPS // PAPER_CADENCE
    want = {"flash": PAPER_STEPS * per_step[0] + rounds * val_launches[0],
            "flash_bwd": PAPER_STEPS * per_step[1],
            "gn": PAPER_STEPS * per_step[2] + rounds * val_launches[1],
            "gn_bwd": PAPER_STEPS * per_step[3]}
    ev = run["events"]
    # Step s runs between events s-1 and s; step 6 also holds the checkpoint
    # and the validation round of step 5.
    warm = [ev[s - 2].elapsed_time(ev[s - 1]) for s in range(3, PAPER_STEPS)
            if (s - 1) % PAPER_CADENCE]
    busy = sum(run["kernel_ms"].values())
    port_ms = {name: sum(ms for key, ms in run["kernel_ms"].items() if tag in key)
               for name, tag in (("flash_attention_fwd", "flash_fwd"),
                                 ("flash_attention_bwd", "flash_bwd_"),
                                 ("group_norm_fwd", "group_norm_fwd_kernel"),
                                 ("group_norm_bwd", "group_norm_bwd_kernel"))}
    print(f"[paper] {PAPER_STEPS} steps sd21base 512 px batch 8 bf16, --augment pda "
          f"--augment_inversion, checkpoint and validation every {PAPER_CADENCE}, in "
          f"{run['run_s']:.1f} s (model init, validation and export included): loss "
          f"{m['loss']:.5g}, kpl {m['kpl']:.3g}; warm step {np.mean(warm):.1f} ms (steps 3-9 "
          f"but 6, CUDA events; each {[round(w, 1) for w in warm]}); launches {run['launches']} "
          f"(expected {want}); flash forward by variant {run['variants']}", flush=True)
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
    print(f"[paper resume] from checkpoint-{PAPER_CADENCE} to step {PAPER_STEPS}: step 6's batch "
          f"{'the same bytes' if same_batch else 'DIFFERS'}, its draws (noise, VAE eps, "
          f"timesteps) {'the same bits' if same_draws else 'DIFFER'}; step-10 loss "
          f"{res['metrics']['loss']:.6g} vs {m['loss']:.6g}: relative gap {loss_gap:.3g} (limit "
          f"{RESUME_LOSS_REL}); rel L2 gap of the exported LoRA {lora_gap:.3g}, of the added rows "
          f"{rows_gap:.3g} (limit {RESUME_REL_L2})" + (
              "; all gaps are zero" if loss_gap == lora_gap == rows_gap == 0 else ""), flush=True)
    if not (same_batch and same_draws and loss_gap <= RESUME_LOSS_REL
            and lora_gap <= RESUME_REL_L2 and rows_gap <= RESUME_REL_L2):
        raise AssertionError("the resumed run left the straight run's trajectory")
    return {
        "launches": run["launches"], "resumed_launches": res["launches"],
        "variants": run["variants"], "run_s": run["run_s"], "resumed_run_s": res["run_s"],
        "warm_step_ms": float(np.mean(warm)), "warm_steps_ms": warm,
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
    through a Trainer of those flags.  After one step (which takes every
    LoRA B off zero), one forward and backward from the same weights, batch
    and draws in turns (plain, checkpointed, plain): the loss and the
    gradient of every trainable tensor (the text encoder's and the UNet's
    LoRA, the added embedding rows) must be bit-identical in all three,
    which holds the recompute's K1 and K3 outputs to those of the first
    forward.  Then whole steps in turns (off, on, on, off, off, on;
    warm, the modes having run once already), with the launch counts set to
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

    t0 = time.perf_counter()
    trainer = Trainer(parse_args(flags), device="cuda")
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
        for mode in (False, True, True, False, False, True):
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
                             trace_call=SNAPSHOT_STEPS - 1, on_step=on_step)
    m = run["metrics"]
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
    ev = run["events"]
    warm = [ev[s - 2].elapsed_time(ev[s - 1]) for s in range(3, SNAPSHOT_STEPS)
            if s - 1 != SNAPSHOT_CHECKPOINT]
    busy = sum(run["kernel_ms"].values())
    print(f"[snapshot run] {SNAPSHOT_STEPS} steps sd21base from the snapshot, 512 px, batch 8 "
          f"+ 8 class images, kv-LoRA, gradient checkpointing, padded CLIP mask, in "
          f"{run['run_s']:.1f} s (load, {SNAPSHOT_PRIOR_IMAGES} prior images, a validation round "
          f"and export included): loss {m['loss']:.5g}, prior_loss by step "
          f"{[round(x, 5) for x in prior_losses]}; warm step {np.mean(warm):.1f} ms (each "
          f"{[round(w, 1) for w in warm]}); traced step {SNAPSHOT_STEPS}: "
          f"{run['traced_wall_ms']:.1f} ms wall, {busy:.1f} ms of kernels (idle "
          f"{1 - busy / run['traced_wall_ms']:.3f}); launches {run['launches']} (expected {want}: "
          f"per step {per_step_n} with the recompute, {plain_n} without; {generates} sampling "
          f"calls of {calls_per_generate})", flush=True)
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
        "warm_step_ms": float(np.mean(warm)), "warm_steps_ms": warm,
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


def main() -> int:
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
    torch.cuda.empty_cache()

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

    def sample() -> float:
        t0 = time.time()
        pipe([args.prompt] * len(seeds), num_inference_steps=steps, guidance_scale=7.5,
             latents=latents)
        torch.cuda.synchronize()
        return time.time() - t0

    first_sample_s, sample_s = sample(), sample()
    # One more call traced on the card: kernel time against wall time.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced_s = sample()
    kernel_ms = collections.Counter()  # device ms by kernel name
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernel_ms[e.key] += e.self_device_time_total / 1e3
    busy_ms = sum(kernel_ms.values())
    traced_port_ms = {name: sum(ms for key, ms in kernel_ms.items() if tag in key)
                      for name, tag in (("flash_attention_fwd", "flash_fwd"),
                                        ("group_norm_fwd", "group_norm_fwd_kernel"))}
    print(f"[breakdown] load {load_s * 1e3:.0f} ms; sampling {first_sample_s * 1e3:.0f} ms "
          f"(first call), {sample_s * 1e3:.0f} ms (second); UNet forward (batch 8) "
          f"{unet_ms:.1f} ms x {steps}, VAE decode {vae_ms:.1f} ms; traced call "
          f"{traced_s * 1e3:.0f} ms wall, {busy_ms:.0f} ms of kernels, of which flash "
          f"{traced_port_ms['flash_attention_fwd']:.1f} ms and group norm "
          f"{traced_port_ms['group_norm_fwd']:.1f} ms", flush=True)
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
    gc.collect()
    torch.cuda.empty_cache()

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
          f"grad_norm {m['grad_norm']:.3g}; warm step (steps 3-9, CUDA events) "
          f"{tr['warm_step_ms']:.1f} ms; launches {tr['launches']} (expected {want_run}); "
          f"flash forward by variant {tr['variants']}", flush=True)
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
    images = generate(parse_args([out_dir, "--model", "sd15", "--prompt", "photo of a <v*> dog",
                                  "--seeds", "0", "--steps", "2", "--lora-rank", "4"]))
    if images.dtype.name != "uint8" or images.shape != (1, 512, 512, 3):
        raise AssertionError(f"sampling the trained model gave {images.dtype} {images.shape}")
    print(f"[train] the exported model dir samples through textboost_torch.inference: "
          f"{images.shape}", flush=True)
    train_work.cleanup()

    # 11. main path: the paper's run at sd21base, then its resume --------------
    gc.collect()
    torch.cuda.empty_cache()
    paper_work = tempfile.TemporaryDirectory()
    paper = paper_run_phase(gen, card, paper_work.name, gn_rows, gn_bwd_rows)
    paper_work.cleanup()
    held = paper.pop("held")
    held["gn_rows"] = {**gn_rows, **held["gn_rows"]}
    held["gn_bwd_rows"] = {**gn_bwd_rows, **held["gn_bwd_rows"]}

    # 12. main path: training from a diffusers snapshot with the DB runner's
    # remaining flags, then serving its output over the snapshot ------------
    gc.collect()
    torch.cuda.empty_cache()
    snapshot_work = tempfile.TemporaryDirectory()
    snap = snapshot_run_phase(gen, card, snapshot_work.name, smi, held)
    snapshot_work.cleanup()
    by_path = {name: {"generate_sd15": launches.get(key, 0), "train_sd15": tr["launches"][key],
                      "paper_sd21base": paper["launches"][key],
                      "paper_sd21base_resumed": paper["resumed_launches"][key],
                      "snapshot_sd21base": snap["launches"][key]}
               for name, key in (("flash_attention_fwd", "flash"), ("flash_attention_bwd", "flash_bwd"),
                                 ("group_norm_fwd", "gn"), ("group_norm_bwd", "gn_bwd"))}
    k1_main, k2_main = "unet_level0_16x4096x5x64", "unet_level0_16x4096x5x64"

    kernels = {"kernels": [
        dict({"name": "flash_attention_fwd", "route": "cuda",
              "source": "textboost_torch/csrc/flash_attention_fwd.cu",
              "replaces": "textboost_tpu/ops/flash_attention.py:42",
              "launches": snap["launches"]["flash"],
              "max_abs_err": max(flash_err, paper["k1_max_abs_err"], snap["k1_max_abs_err"])},
             **snap["k1"][k1_main],
             shape="B,N,H,D=16,4096,5,64 bf16 (sd21base UNet level 0, batch 8 + 8 class images)",
             other_shapes={**{k: v for k, v in snap["k1"].items() if k != k1_main},
                           **paper["k1"], **{f"sd15_{k}": v for k, v in fa_t.items()}},
             per_generate_ms=flash_ms, launches_by_path=by_path["flash_attention_fwd"],
             variants={"generate": variants, "train": tr["variants"],
                       "paper": paper["variants"]}),
        dict({"name": "flash_attention_bwd", "route": "cuda",
              "source": "textboost_torch/csrc/flash_attention_bwd.cu",
              "replaces": "textboost_tpu/ops/flash_attention.py:119",
              "launches": snap["launches"]["flash_bwd"],
              "max_abs_err": max(flash_bwd_err, paper["k2_max_abs_err"], snap["k2_max_abs_err"])},
             **snap["k2"][k2_main],
             shape="B,N,H,D=16,4096,5,64 bf16 (sd21base UNet level 0, batch 8 + 8 class images)",
             other_shapes={**{k: v for k, v in snap["k2"].items() if k != k2_main},
                           **paper["k2"], **{f"sd15_{k}": v for k, v in fb_t.items()}},
             launches_by_path=by_path["flash_attention_bwd"],
             launches_per_train_step=snap["launches"]["flash_bwd"] / SNAPSHOT_STEPS),
        {"name": "group_norm_fwd", "route": "cuda",
         "source": "textboost_torch/csrc/group_norm_fwd.cu",
         "replaces": "textboost_tpu/ops/group_norm.py:58",
         "launches": snap["launches"]["gn"],
         "max_abs_err": max(gn_err, paper["gn_max_abs_err"], snap["gn_max_abs_err"]),
         **group_norm_json(gn_rows[main_key]), "plain_ms": gn_plain,
         "shape": "8x320x64x64 bf16 G=32 eps=1e-6 silu=off",
         "other_shapes": {name: group_norm_json(gn_rows[key]) for name, key in (
             ("resnet_silu_8x320x64x64", level0),
             ("vae_silu_4x128x512x512", ((4, 128, 512, 512), 32, 1e-6, True)))},
         "per_generate": gn_sums["generate"], "per_train_step": gn_sums["train_step"],
         "launches_by_path": by_path["group_norm_fwd"], "registers": gn_regs,
         "host_us_8x1280x8x8": gn_host},
        {"name": "group_norm_bwd", "route": "cuda",
         "source": "textboost_torch/csrc/group_norm_bwd.cu",
         "replaces": "textboost_tpu/ops/group_norm.py:93",
         "launches": snap["launches"]["gn_bwd"],
         "max_abs_err": max(gn_bwd_err, paper["gn_bwd_max_abs_err"], snap["gn_bwd_max_abs_err"]),
         **group_norm_json(gn_bwd_rows[main_key]), "plain_ms": gn_bwd_plain,
         "shape": "8x320x64x64 bf16 G=32 eps=1e-6 silu=off",
         "other_shapes": {"resnet_silu_8x320x64x64": group_norm_json(gn_bwd_rows[level0])},
         "per_train_step": gn_bwd_sums, "registers": gn_bwd_regs,
         "launches_by_path": by_path["group_norm_bwd"],
         "launches_per_train_step": tr["launches"]["gn_bwd"] / TRAIN_STEPS},
    ], "sd15_images_per_s": len(seeds) / warm_s, "sd15_images_per_s_cold": len(seeds) / cold_s,
        "generate_ms": warm_s * 1e3, "load_ms": load_s * 1e3,
        "sample_ms": sample_s * 1e3, "sample_first_ms": first_sample_s * 1e3,
        "traced_sample_ms": traced_s * 1e3, "traced_kernel_ms": busy_ms,
        "traced_port_kernel_ms": traced_port_ms,
        "unet_forward_ms": unet_ms, "vae_decode_ms": vae_ms,
        "unet_rel_l2_kernels_vs_math": rel, "card": card,
        "train": {"steps": TRAIN_STEPS, "batch": 8, "run_s": tr["run_s"],
                  "warm_step_ms": tr["warm_step_ms"], "traced_step_wall_ms": tr["traced_wall_ms"],
                  "traced_step_kernel_ms": busy, "traced_port_kernel_ms": new_ms,
                  "final_loss": m["loss"], "step_parity_batch2": parity},
        "paper_run_sd21base": {k: v for k, v in paper.items()
                               if not (k in ("k1", "k2") or k.endswith("max_abs_err"))},
        "snapshot_run_sd21base": {k: v for k, v in snap.items()
                                  if not (k in ("k1", "k2") or k.endswith("max_abs_err"))}}
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
