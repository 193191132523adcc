#!/usr/bin/env python3
"""Smoke test of the textboost_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from textboost_torch/csrc/ (four: flash-attention
forward and backward, GroupNorm forward and input-gradient backward) and
holds each against its plain PyTorch version at the shapes sd15 gives it,
and the two flash kernels also at shapes that cross their tiles' edges.
Then it drives the port's two main paths through their entry points, each
with the launch counts set to 0 just before and read just after:

  * sampling: `textboost_torch.inference.generate` on a model dir written
    by the port's exporters (sd15 at full width with seeded random weights,
    512 px, bf16, DPM-Solver++ 25 steps, CFG 7.5, seeds 0-3);
  * training: `textboost_torch.train.main` for 10 steps (sd15, 512 px,
    batch 8, bf16, LoRA r=4, KPL 0.1, --augment none) on a synthetic
    instance image; its exported model dir then samples through
    `textboost_torch.inference.generate`.

Before them: one sd15 UNet forward and one sd15 train step (batch 2) with
the kernels and with plain math.  The GroupNorm kernels are held against
their plain versions at every GroupNorm shape of both paths (derived from
the config by running the models on the meta device, and checked against
the calls the run makes), two calls must be bit-identical, and a plain
version that drops one cluster rank's partial sums must fail the limits;
a table gives each shape's plan, L2-warm and L2-cold times, bytes moved,
bound and `F.group_norm` time, with launch-weighted sums per generate call
and per train step.  It checks the outputs, that each path
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
import subprocess
import sys
import tempfile
import time

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


def check_flash_backward(gen) -> float:
    """K2 against fp32 autograd of plain attention at sd15's two training
    shapes and one masked KV tail; returns the largest |error|."""
    import torch

    from textboost_torch.ops import flash_attention as fa

    dev, bf16 = gen.device, torch.bfloat16
    worst = 0.0
    for b, n, h, d, m, kv in ((8, 4096, 8, 40, 4096, 4096), (8, 1024, 8, 80, 1024, 1024),
                              (2, 1024, 8, 64, 1024, 700)):
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


def group_norm_calls(model: str):
    """The GroupNorm calls of the port's main paths at `model`'s full width,
    found by running its UNet and VAE on the meta device (shapes only: no
    memory, no arithmetic), at the main paths' batches: the UNet at 8 (four
    seeds under CFG; the train step), the VAE decoder at 4, the encoder at 8.
    Returns {"unet": one UNet forward, "unet_backward": the UNet norms a
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
    ctx = torch.empty(8, 77, spec.unet.cross_attention_dim, device=meta, requires_grad=True)
    unet(torch.empty(8, spec.unet.in_channels, s, s, device=meta),
         torch.zeros(8, dtype=torch.long, device=meta), ctx)
    with torch.no_grad():
        part[0] = "decode"
        vae.decode(torch.empty(4, spec.vae.latent_channels, s, s, device=meta))
        part[0] = "encode"
        vae.encode_moments(torch.empty(8, 3, r, r, device=meta))
    return calls


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


def train_main_path(instance_dir: str, output_dir: str):
    """The training main path: `textboost_torch.train.main` for TRAIN_STEPS
    steps at batch 8, with the launch counts set to 0 just before and read
    just after.  CUDA events after each step give the warm step time (steps
    3-9); the last step is traced with torch.profiler after the queue has
    drained."""
    import torch
    import torch.profiler

    from textboost_torch import train as train_pkg
    from textboost_torch.ops import flash_attention as fa
    from textboost_torch.ops import group_norm as gn
    from textboost_torch.train import trainer as trainer_mod

    events, traced = [], {}
    real_make = trainer_mod.make_train_step

    def timed_make(config):
        step = real_make(config)

        def timed_step(state, batch, draws):
            if len(events) == TRAIN_STEPS - 1:
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
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            return out

        return timed_step

    trainer_mod.make_train_step = timed_make
    fa.launches = fa.bwd_launches = gn.launches = gn.bwd_launches = 0
    fa.variant_counts.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        metrics = train_pkg.main(train_flags(instance_dir, output_dir, 8, TRAIN_STEPS))
    finally:
        trainer_mod.make_train_step = real_make
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = {"flash": fa.launches, "flash_bwd": fa.bwd_launches, "gn": gn.launches,
                "gn_bwd": gn.bwd_launches}
    variants = dict(fa.variant_counts)
    if set(variants) - WGMMA_VARIANTS or sum(variants.values()) != fa.launches:
        raise AssertionError(f"training's flash forward launches went through {variants}, "
                             f"not all through {sorted(WGMMA_VARIANTS)}")
    kernel_ms = collections.Counter()
    for e in traced["prof"].key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernel_ms[e.key] += e.self_device_time_total / 1e3
    return {
        "metrics": metrics, "launches": launches, "variants": variants, "run_s": run_s,
        "warm_step_ms": events[1].elapsed_time(events[TRAIN_STEPS - 2]) / (TRAIN_STEPS - 3),
        "traced_wall_ms": traced["wall_ms"], "kernel_ms": kernel_ms,
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
    flash_err = 0.0
    for b, n, h, d, m in ((8, 4096, 8, 40, 4096), (8, 1024, 8, 80, 1024),
                          (4, 4096, 1, 512, 4096), (8, 4096, 8, 40, 77)):
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
            raise AssertionError(f"flash attention disagrees with its plain version at {b, n, h, d, m}")
        flash_err = max(flash_err, eo)
        del q, k, v, o, lse, ro, rl
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
    def flash_times(b, n, h, d):
        q, k, v = (torch.randn(b, n, h, d, generator=gen, device=dev).to(bf16) for _ in range(3))
        qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        fa.variant_counts.clear()
        fa.flash_attention_forward(q, k, v, scale=d**-0.5)
        if set(fa.variant_counts) - WGMMA_VARIANTS:
            raise AssertionError(f"the main-path shape {b, n, h, d} was served by "
                                 f"{dict(fa.variant_counts)}, not by wgmma")
        return {
            "ms": cuda_ms(lambda: fa.flash_attention_forward(q, k, v, scale=d**-0.5), 10),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_reference(q, k, v, d**-0.5), 3, 1),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10),
            **bound_of(flash_floors_ms(b, n, n, h, d, backward=False, **card)),
        }

    fa_shapes = {"unet_level0_8x4096x8x40": (8, 4096, 8, 40),
                 "unet_level1_8x1024x8x80": (8, 1024, 8, 80),
                 "vae_mid_4x4096x1x512": (4, 4096, 1, 512)}
    fa_t = {name: flash_times(*shp) for name, shp in fa_shapes.items()}
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

    kernels = {"kernels": [
        dict({"name": "flash_attention_fwd", "route": "cuda",
              "source": "textboost_torch/csrc/flash_attention_fwd.cu",
              "replaces": "textboost_tpu/ops/flash_attention.py:42",
              "launches": launches["flash"], "max_abs_err": flash_err},
             **fa_t["unet_level0_8x4096x8x40"], shape="B,N,H,D=8,4096,8,40 bf16",
             other_shapes={k: fa_t[k] for k in list(fa_t)[1:]},
             per_generate_ms=flash_ms, train_launches=tr["launches"]["flash"],
             variants={"generate": variants, "train": tr["variants"]}),
        dict({"name": "flash_attention_bwd", "route": "cuda",
              "source": "textboost_torch/csrc/flash_attention_bwd.cu",
              "replaces": "textboost_tpu/ops/flash_attention.py:119",
              "launches": tr["launches"]["flash_bwd"], "max_abs_err": flash_bwd_err},
             **fb_t["unet_level0_8x4096x8x40"], shape="B,N,H,D=8,4096,8,40 bf16",
             other_shapes={k: fb_t[k] for k in list(fb_t)[1:]},
             launches_per_train_step=tr["launches"]["flash_bwd"] / TRAIN_STEPS),
        {"name": "group_norm_fwd", "route": "cuda",
         "source": "textboost_torch/csrc/group_norm_fwd.cu",
         "replaces": "textboost_tpu/ops/group_norm.py:58",
         "launches": launches["gn"], "max_abs_err": gn_err,
         **group_norm_json(gn_rows[main_key]), "plain_ms": gn_plain,
         "shape": "8x320x64x64 bf16 G=32 eps=1e-6 silu=off",
         "other_shapes": {name: group_norm_json(gn_rows[key]) for name, key in (
             ("resnet_silu_8x320x64x64", level0),
             ("vae_silu_4x128x512x512", ((4, 128, 512, 512), 32, 1e-6, True)))},
         "per_generate": gn_sums["generate"], "per_train_step": gn_sums["train_step"],
         "train_launches": tr["launches"]["gn"], "registers": gn_regs,
         "host_us_8x1280x8x8": gn_host},
        {"name": "group_norm_bwd", "route": "cuda",
         "source": "textboost_torch/csrc/group_norm_bwd.cu",
         "replaces": "textboost_tpu/ops/group_norm.py:93",
         "launches": tr["launches"]["gn_bwd"], "max_abs_err": gn_bwd_err,
         **group_norm_json(gn_bwd_rows[main_key]), "plain_ms": gn_bwd_plain,
         "shape": "8x320x64x64 bf16 G=32 eps=1e-6 silu=off",
         "other_shapes": {"resnet_silu_8x320x64x64": group_norm_json(gn_bwd_rows[level0])},
         "per_train_step": gn_bwd_sums, "registers": gn_bwd_regs,
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
                  "final_loss": m["loss"], "step_parity_batch2": parity}}
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
