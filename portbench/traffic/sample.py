"""The sample traffic: the DreamBooth eval's generation as
`textboost_torch.eval` runs it for one instance of a sweep.

Set-up writes the instance's trained dir (a PEFT text-encoder adapter with
nonzero LoRA weights and a `<token>.bin` per added token, all made from the
seed), loads it through the eval's own loader (`load_textboost_pipeline`)
over the run's base weights, and gives the pipeline the CUDA graphs that
the eval's own rule (`sampler_signatures`) names for a sweep of
`sweep_instances` instances x `sweep_seeds` seeds.  Then it calls the
pipeline as the eval does (`TextToImagePipeline.__call__` with the chunk's
prompts and the seed's latent, `num_inference_steps`, CFG), the chunks of
the instance's prompts in turn, a new seed latent after each pass over
them.  `warmup_calls` calls are set-up (each signature's eager call, its
capture, the first replays); the window opens after them and closes at the
end of the first call that returns after `--seconds`.

`correct` samples one call of the window (drawn from the seed) with the
reference: the same prompts, tokenized again; the same latent; the
reference's own null embedding, grown table and adapters from the same
inputs.  The number compared is the worst image's mean absolute difference
in uint8 levels.
"""
from __future__ import annotations

import collections
import gc
import json
import os
import re
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from .. import inputs, program
from ..counts import flops
from ..reference import quant
from ..reference.sample import sample as ref_sample
from ..reference.tokenizer import Tokenizer
from ..tracing import Tracer
from .train import _corpus, reference_models

PEFT_PREFIX = "base_model.model."


def _natural(name: str):
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", name)]


def write_instance(path: str, weights: Dict, rows: torch.Tensor, tokens: List[str],
                   lora_rank: int) -> None:
    """A trained instance dir as the trainer exports it: `text_encoder/`
    (the PEFT adapter of the run's LoRA weights) and `<token>.bin` files."""
    adapter = os.path.join(path, "text_encoder")
    os.makedirs(adapter, exist_ok=True)
    inputs.write_safetensors({PEFT_PREFIX + k: v.float() for k, v in
                              weights["text_encoder"].items() if ".lora_" in k},
                             os.path.join(adapter, "adapter_model.safetensors"))
    with open(os.path.join(adapter, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": lora_rank, "lora_alpha": lora_rank,
                   "target_modules": ["q_proj", "k_proj", "v_proj"],
                   "init_lora_weights": "gaussian", "bias": "none"}, f)
    for token, row in zip(tokens, rows):
        torch.save({token: row.float().cpu()},
                   os.path.join(path, token.strip("<>") + ".bin"))


def run(ctx) -> Dict:
    from textboost_torch import graphs
    from textboost_torch.eval import __main__ as eval_main
    from textboost_torch.pipelines import loading

    config, traffic = ctx.config, ctx.traffic
    program.check_preset(config)
    ctx.mark("program imported")
    res, dev = config["resolution"], ctx.device
    base_dir = os.path.join(ctx.tmp, "base")
    inst_dir = os.path.join(ctx.tmp, traffic["instance"])
    tok_dir = os.path.join(base_dir, "tokenizer")
    inputs.write_tokenizer(tok_dir, _corpus() + traffic["prompts"], config["tokenizer_pad_token"])
    rank = traffic["lora_rank"]
    weights = inputs.make_weights(config, ctx.seed, dev, lora_rank=rank, lora_b=0.01)
    ctx.mark("weights made")
    tokens = traffic["added_tokens"]
    rows = inputs.rows(ctx.seed, len(tokens), config["text_encoder"]["hidden_size"], dev)
    write_instance(inst_dir, weights, rows, tokens, rank)
    ctx.mark("inputs made")

    with program.weights_into(weights, config["preset"], [loading]):
        pipe = loading.load_textboost_pipeline(inst_dir, base_dir, lora_rank=rank, device=dev)
    batch, steps, guidance = traffic["batch_size"], traffic["steps"], traffic["guidance"]
    identifier = (traffic["token_format"].replace("INSTANCE", traffic["instance"])
                  .replace("SUBJECT", traffic["class"]))
    prompts = [p.format(identifier) for p in traffic["prompts"]]
    chunks = [prompts[i:i + batch] for i in range(0, len(prompts), batch)]
    calls = collections.Counter()
    for chunk in chunks:  # eval/__main__.py::planned_runs for the sweep
        calls[graphs.sampler_key(len(chunk), res, res, steps, guidance, traffic["sampler"])] += \
            traffic["sweep_instances"] * traffic["sweep_seeds"]
    signatures = eval_main.sampler_signatures(calls, dev)
    pipe.graphs = graphs.CapturedSampler(signatures) if signatures else None
    ctx.mark(f"pipeline loaded; graphs named by the eval's rule: {signatures}")

    gen = torch.Generator(dev).manual_seed(ctx.seed * 8 + 6)
    size = res // 8
    latents: List[torch.Tensor] = []
    warmup, traced = traffic["warmup_calls"], traffic.get("traced_calls", 0)
    tracer = Tracer(ctx.trace_path) if ctx.trace else None
    traced_calls = None
    recorder = program.KernelCalls().__enter__() if ctx.trace else None
    window: List[Dict] = []
    n, window_open, setup_s = 0, None, None
    try:
        while True:
            c = n % len(chunks)
            if c == 0:  # eval/__main__.py::seed_latent: one latent a seed, shared by its chunks
                latents.append(torch.randn((size, size, 4), generator=gen, device=dev))
            if tracer is not None and n == warmup:
                before = recorder.snapshot()
                tracer.start()
            images = pipe(chunks[c], num_inference_steps=steps, guidance_scale=guidance,
                          sampler=traffic["sampler"], latents=latents[-1], height=res, width=res)
            n += 1
            if tracer is not None and n == warmup + traced:
                tracer.stop()
                after = recorder.snapshot()
                traced_calls = {k: after[k] - before[k] for k in after}
            if n == warmup:
                window_open = time.perf_counter()
                setup_s = window_open - ctx.t0
                ctx.mark(f"window open after {n} calls")
            elif n > warmup:
                window.append({"chunk": c, "latent": len(latents) - 1, "images": images})
                if time.perf_counter() - window_open >= ctx.seconds and n >= warmup + traced:
                    break
    finally:
        if recorder is not None:
            recorder.__exit__(None, None, None)
    elapsed = time.perf_counter() - window_open
    images_done = sum(len(w["images"]) for w in window)
    print(f"window: {len(window)} calls, {images_done} images in {elapsed:.3f} s", file=sys.stderr)
    memory = torch.cuda.max_memory_reserved() if ctx.cuda else 0
    out = {"attempted": len(window), "failed": 0, "memory_peak_bytes": memory,
           "metrics": {"images_per_s": images_done / elapsed,
                       "peak_reserved_gib": memory / 2**30, "setup_s": setup_s}}
    if ctx.trace:
        tracer.finish()
        sizes = [len(chunks[(warmup + i) % len(chunks)]) for i in range(traced)]
        out["readings"] = {
            "kind": "sample", "trace": tracer.summary, "kernel_calls": traced_calls,
            "flops": sum(flops.sample_call(config, b, steps, rank) for b in sizes),
            "traced_units": sum(sizes),
        }
    pick = int(np.random.default_rng(ctx.seed).integers(len(window)))
    chosen = window[pick]
    chosen_latent = latents[chosen["latent"]]
    del pipe, window
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()
    out["checks"] = compare(ctx, weights, rows, tokens, tok_dir, chunks[chosen["chunk"]],
                            chosen_latent, chosen["images"], rank)
    ctx.mark("reference done")
    return out


def compare(ctx, weights, rows, tokens, tok_dir, prompts, latent, images, rank) -> List:
    """[(name, value, limit)]: the call's images against the reference's
    (or, with `ctx.control`, the fp8 reference's against the reference's)."""
    tok = Tokenizer(tok_dir)
    order = sorted(range(len(tokens)), key=lambda i: _natural(tokens[i].strip("<>") + ".bin"))
    tok.add([tokens[i] for i in order])
    ids = torch.from_numpy(tok(prompts)).to(ctx.device)
    neg = torch.from_numpy(tok([""] * len(prompts))).to(ctx.device)
    null_ids = torch.from_numpy(tok([""])).to(ctx.device)
    lat = latent.permute(2, 0, 1)[None].expand(len(prompts), -1, -1, -1).contiguous()
    scaling = ctx.config["vae"]["scaling_factor"]
    traffic = ctx.traffic

    def reference(ops):
        mods = reference_models(ctx, weights, rank, ops)
        te = mods["text_encoder"]
        base = te.text_model.embeddings.token_embedding.weight
        table = base.new_zeros(base.shape[0] + len(tokens), base.shape[1])
        table[:base.shape[0]] = base
        for i, t in enumerate(tokens):
            table[tok.added[t]] = rows[i].float()
        with torch.no_grad():
            null = te(null_ids, use_lora=False)[0]
        return ref_sample(te, mods["unet"], mods["vae"], ids, neg, null, lat, table=table,
                          eos_id=tok.eos, vae_scaling=scaling, steps=traffic["steps"],
                          guidance=traffic["guidance"])

    want = reference(quant.Ops())
    if ctx.control:
        images = reference(quant.Fp8Ops())
    diff = np.abs(images.astype(np.int16) - want.astype(np.int16)).reshape(len(prompts), -1)
    return [("image_gap", float(diff.mean(1).max()), ctx.limits["image_gap"])]
