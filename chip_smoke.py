#!/usr/bin/env python3
"""Smoke test of the textboost_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from textboost_torch/csrc/, holds each against its
plain PyTorch version at the shapes the sd15 sampling path gives it, runs
one sd15 UNet forward with the kernels and with plain math, then drives the
port's main path once through its entry point: `textboost_torch.inference.
generate` on a model dir written by the port's exporters (sd15 at full
width with seeded random weights, 512 px, bf16, DPM-Solver++ 25 steps,
CFG 7.5, seeds 0-3).  It checks the images and that the main path launched
each kernel exactly as often as the model spec says, then prints the card
(name and power limit from nvidia-smi), one JSON line of per-kernel
numbers, and as its last line {"ok": true, "device": {...}}.  Any failed
phase raises and the script exits non-zero with no result line.  Without
CUDA, or without the repo beside it, it fails the same way.

fp32 matmuls and convolutions are held to full fp32 (TF32 off) so that the
plain references are what they say.
"""
from __future__ import annotations

import collections
import json
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

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (H100 SXM)
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores


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

    gn_err, gn_shape_ms = 0.0, {}
    for shape, eps, silu in sorted(set(seen["unet"]) | set(seen["vae"])):
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(bf16)
        ga = torch.randn(shape[1], generator=gen, device=dev) * 0.2 + 1
        be = torch.randn(shape[1], generator=gen, device=dev) * 0.1
        y, mu, rs = gn.group_norm_forward(x, ga, be, 32, eps=eps, silu=silu)
        torch.cuda.synchronize()
        ry, rmu, rrs = gn.group_norm_reference(x, ga, be, 32, eps, silu)
        ey = (y.float() - ry.float()).abs()
        ok = bool((ey <= GN_ATOL + GN_RTOL * ry.float().abs()).all())
        ok &= bool(((mu - rmu).abs() <= GN_STAT_RTOL * rmu.abs() + 1e-6).all())
        ok &= bool(((rs - rrs).abs() <= GN_STAT_RTOL * rrs).all())
        if not ok:
            raise AssertionError(f"group norm disagrees with its plain version at {shape, eps, silu}")
        gn_err = max(gn_err, ey.max().item())
        gn_shape_ms[(shape, eps, silu)] = cuda_ms(
            lambda: gn.group_norm_forward(x, ga, be, 32, eps=eps, silu=silu), 10)
    print(f"[group_norm] {len(gn_shape_ms)} distinct (shape, eps, silu) of one UNet forward "
          f"and one VAE decode agree; max|y err| {gn_err:.3g}", flush=True)
    del x, y, ry

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

    steps, seeds = 25, [0, 1, 2, 3]
    args = parse_args([work.name, "--model", "sd15", "--prompt", "photo of a <v*> dog",
                       "--seeds", *map(str, seeds), "--steps", str(steps),
                       "--guidance-scale", "7.5", "--lora-rank", "4"])
    want_flash, want_gn = expected_launches(spec, steps)
    if (want_flash, want_gn) != (251, 1555):
        raise AssertionError(f"spec-derived launch counts {want_flash, want_gn} != (251, 1555)")
    fa.launches = gn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out = generate(args)  # raises if a decoded image is not finite
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = {"flash": fa.launches, "gn": gn.launches}
    print(f"[generate] {out.shape} {out.dtype} in {cold_s:.2f} s (model init included): "
          f"{len(seeds) / cold_s:.3f} images/s; launches flash {launches['flash']} "
          f"group_norm {launches['gn']}", flush=True)
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
        nbytes = 4 * q.numel() * 2 + b * h * n * 4  # q, k, v read, o written (bf16); lse fp32
        ops = 4 * b * h * n * n * d  # two matmuls, 2 operations per multiply-add
        return {
            "ms": cuda_ms(lambda: fa.flash_attention_forward(q, k, v, scale=d**-0.5), 10),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_reference(q, k, v, d**-0.5), 3, 1),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10),
            "bound_ms": max(nbytes / H100_BYTES_PER_S, ops / H100_BF16_FLOPS) * 1e3,
            "bound_by": "operations" if ops / H100_BF16_FLOPS > nbytes / H100_BYTES_PER_S else "bytes",
        }

    fa_shapes = {"unet_level0_8x4096x8x40": (8, 4096, 8, 40),
                 "unet_level1_8x1024x8x80": (8, 1024, 8, 80),
                 "vae_mid_4x4096x1x512": (4, 4096, 1, 512)}
    fa_t = {name: flash_times(*shp) for name, shp in fa_shapes.items()}
    flash_ms = (steps * 5 * (fa_t["unet_level0_8x4096x8x40"]["ms"]
                             + fa_t["unet_level1_8x1024x8x80"]["ms"])
                + fa_t["vae_mid_4x4096x1x512"]["ms"])
    gn_call_ms = {name: sum(c * gn_shape_ms[key] for key, c in seen[name].items())
                  for name in seen}
    gn_total_ms = steps * gn_call_ms["unet"] + gn_call_ms["vae"]

    shape, eps, silu = (8, 320, 64, 64), 1e-6, False  # Transformer2D norm, level 0
    x = torch.randn(shape, generator=gen, device=dev).to(bf16)
    ga = torch.randn(320, generator=gen, device=dev) * 0.2 + 1
    be = torch.randn(320, generator=gen, device=dev) * 0.1
    gn_ms = cuda_ms(lambda: gn.group_norm_forward(x, ga, be, 32, eps=eps, silu=silu), 20)
    gn_plain = cuda_ms(lambda: gn.group_norm_reference(x, ga, be, 32, eps, silu), 10)
    ga16, be16 = ga.to(bf16), be.to(bf16)
    gn_lib = cuda_ms(lambda: F.group_norm(x, 32, ga16, be16, eps), 20)
    gn_bytes = 2 * x.numel() * 2 + 2 * 320 * 4 + 2 * 8 * 32 * 4
    gn_ops = 7 * x.numel()  # stats 3, normalize+affine 4 per element
    gn_bound = max(gn_bytes / H100_BYTES_PER_S, gn_ops / H100_FP32_FLOPS) * 1e3
    extra = {}
    for name, (shp, e, s) in {"resnet_silu_8x320x64x64": ((8, 320, 64, 64), 1e-5, True),
                              "vae_silu_4x128x512x512": ((4, 128, 512, 512), 1e-6, True)}.items():
        xx = torch.randn(shp, generator=gen, device=dev).to(bf16)
        g1, b1 = torch.ones(shp[1], device=dev), torch.zeros(shp[1], device=dev)
        extra[name] = {
            "ms": cuda_ms(lambda: gn.group_norm_forward(xx, g1, b1, 32, eps=e, silu=s), 10),
            "bound_ms": 2 * xx.numel() * 2 / H100_BYTES_PER_S * 1e3,
        }
        del xx

    kernels = {"kernels": [
        dict({"name": "flash_attention_fwd", "route": "cuda",
              "source": "textboost_torch/csrc/flash_attention_fwd.cu",
              "replaces": "textboost_tpu/ops/flash_attention.py:42",
              "launches": launches["flash"], "max_abs_err": flash_err},
             **fa_t["unet_level0_8x4096x8x40"], shape="B,N,H,D=8,4096,8,40 bf16",
             other_shapes={k: fa_t[k] for k in list(fa_t)[1:]},
             per_generate_ms=flash_ms),
        {"name": "group_norm_fwd", "route": "cuda",
         "source": "textboost_torch/csrc/group_norm_fwd.cu",
         "replaces": "textboost_tpu/ops/group_norm.py:58",
         "launches": launches["gn"], "max_abs_err": gn_err,
         "ms": gn_ms, "plain_ms": gn_plain, "bound_ms": gn_bound,
         "bound_by": "bytes" if gn_bytes / H100_BYTES_PER_S > gn_ops / H100_FP32_FLOPS else "operations",
         "library_ms": gn_lib, "shape": "8x320x64x64 bf16 G=32 eps=1e-6 silu=off",
         "other_shapes": extra, "per_generate_ms": gn_total_ms},
    ], "sd15_images_per_s": len(seeds) / warm_s, "sd15_images_per_s_cold": len(seeds) / cold_s,
        "generate_ms": warm_s * 1e3, "load_ms": load_s * 1e3,
        "sample_ms": sample_s * 1e3, "sample_first_ms": first_sample_s * 1e3,
        "traced_sample_ms": traced_s * 1e3, "traced_kernel_ms": busy_ms,
        "traced_port_kernel_ms": traced_port_ms,
        "unet_forward_ms": unet_ms, "vae_decode_ms": vae_ms,
        "unet_rel_l2_kernels_vs_math": rel}
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
