"""The train traffic: the trainer's own loop (`Trainer.train`, its loader
and `run_step`) on one instance image made from the seed, with the flags of
the traffic file.

Set-up builds one `Trainer` over the run's weights and drives it through
`warmup_steps` steps of its own loop (the eager warm-up, the capture, the
first replays).  The window opens after the last of them, on the device
timeline (a CUDA event after each `run_step`), and closes at the end of the
first step whose call returns after `--seconds` of host time: the wrapper
lowers the config's `max_train_steps` to that step, so the loop ends there
and the trainer's own result comes back.

`correct` compares the first `compared_steps` steps, which the window's own
call and feed made (the eager warm-up and the first replays of the captured
step), with the reference following them from the same start: each step's
loss; each leaf's gradient as the optimizer got it at the first step
(eager) and at the last (a replay of the window's graph), read from AdamW's
first moments; and each leaf's change after three steps and after all of
them, the added token rows apart from the LoRA weights.  The last step's
gradient is held against the reference's from the program's own state
before that step, on the same batch and draws: from the start, bf16
against fp32 drifts too far in five steps for a gradient to be compared
(PERF.md).  The reference works out
again the token surgery (the grown table, checked against the program's
bit for bit) and the captions' ids (checked row by row), and takes the
loader's augmented pixels as the program made them: the paired
augmentation is not written out in the reference (PERF.md, Open
questions).
"""
from __future__ import annotations

import gc
import os
import re
import statistics
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import inputs, program
from ..counts import flops
from ..reference import models as ref_models
from ..reference import quant
from ..reference import train as ref_train
from ..reference.tokenizer import Tokenizer
from ..tracing import Tracer


def _corpus() -> List[str]:
    """Texts the tokenizer's merges are learned from: the captions' templates
    and the KPL prompt bank, with the class words."""
    from textboost_torch.data.human_prompts import EXTENDED_HUMAN_PROMPTS
    from textboost_torch.data.templates import TEMPLATE_BANKS

    return list(EXTENDED_HUMAN_PROMPTS) + [
        t.format(w) for bank in TEMPLATE_BANKS.values() for t in bank
        for w in ("dog", "teapot", "cat", "backpack", "sks")]


class Recorder:
    """Wraps the trainer's per-step call (the window's events, the compared
    steps' batches and states, the traced span) and its host-to-device copy
    (the compared steps' captions)."""

    def __init__(self, ctx, traffic):
        self.ctx = ctx
        self.warmup = traffic["warmup_steps"]
        self.compared = traffic["compared_steps"]
        self.calls = 0
        self.host_batches: List[Dict] = []
        self.batches: List[Dict[str, torch.Tensor]] = []
        self.states: Dict[int, Dict[str, torch.Tensor]] = {}
        self.moments: Dict[int, Dict[str, torch.Tensor]] = {}
        self.events: List[torch.cuda.Event] = []
        self.window_open = None
        self.setup_s = None
        self.replays_before = 0
        self.tracer = None
        self.traced_from = self.traced_to = None

    def leaves(self, trainer) -> Dict[str, torch.Tensor]:
        from textboost_torch.lora.partition import lora_parameters

        te = trainer.text_encoder
        names = {id(p): k for k, p in te.named_parameters()}
        out = {"embedding": te.token_embedding.weight[trainer.first_added_id:]}
        out.update({names[id(p)]: p for p in lora_parameters(te)})
        return out

    def snapshot(self, trainer) -> Dict[str, torch.Tensor]:
        return {k: v.detach().float().clone() for k, v in self.leaves(trainer).items()}

    def first_moments(self, trainer) -> Dict[str, torch.Tensor]:
        """AdamW's first moment of each leaf (the added rows' of the table)."""
        opt = trainer.state.optimizer
        emb = trainer.text_encoder.token_embedding.weight
        out = {}
        for k, p in self.leaves(trainer).items():
            m = opt.state[emb if k == "embedding" else p]["exp_avg"]
            out[k] = (m[trainer.first_added_id:] if k == "embedding" else m).detach().clone()
        return out

    def device_batch(self, real):
        rec = self

        def wrapped(trainer, batch, prior_batch):
            out = real(trainer, batch, prior_batch)
            if len(rec.host_batches) < rec.compared:
                rec.host_batches.append({"prompt": list(batch["prompt"]),
                                         "prior_prompt": list(prior_batch["prompt"])})
            return out
        return wrapped

    def run_step(self, real):
        rec = self

        def wrapped(trainer, batch, draws):
            rec.calls += 1
            i = rec.calls
            if i == 1:
                rec.states[0] = rec.snapshot(trainer)
                rec.table0 = trainer.text_encoder.token_embedding.weight.detach().float().clone()
            if i <= rec.compared:
                rec.batches.append({k: v.detach().clone() for k, v in batch.items()})
            if rec.tracer is not None and i == rec.traced_from:
                rec.tracer.start()
            out = real(trainer, batch, draws)
            if i in (1, rec.compared - 1, rec.compared):
                rec.moments[i] = rec.first_moments(trainer)
            if i in (3, rec.compared - 1, rec.compared):
                rec.states[i] = rec.snapshot(trainer)
            if rec.tracer is not None and i == rec.traced_to:
                rec.tracer.stop()
            ev = torch.cuda.Event(enable_timing=True) if rec.ctx.cuda else None
            if ev is not None:
                ev.record()
            if i == rec.warmup:
                if rec.ctx.cuda:
                    torch.cuda.synchronize()
                rec.window_open = time.perf_counter()
                rec.setup_s = rec.window_open - rec.ctx.t0
                rec.replays_before = trainer.graph_stats().get("step_graph_replays", 0)
                rec.events = [ev]
                rec.ctx.mark(f"window open after {i} steps")
            elif i > rec.warmup:
                rec.events.append(ev)
                if time.perf_counter() - rec.window_open >= rec.ctx.seconds and (
                        rec.traced_to is None or i >= rec.traced_to):
                    trainer.config.max_train_steps = i  # the loop ends after this step
            return out
        return wrapped


def run(ctx) -> Dict:
    from textboost_torch.train import trainer as trainer_mod
    from textboost_torch.train.config import parse_args

    config, traffic = ctx.config, ctx.traffic
    program.check_preset(config)
    ctx.mark("program imported")
    tmp = ctx.tmp
    image_dir, tok_dir, out_dir = (os.path.join(tmp, d) for d in ("instance", "tokenizer", "out"))
    inputs.write_instance_image(os.path.join(image_dir, "instance.png"), ctx.seed,
                                config["resolution"])
    inputs.write_tokenizer(tok_dir, _corpus(), config["tokenizer_pad_token"])
    ctx.mark("tokenizer written")
    lora_rank = next(int(f.split("=")[1]) for f in traffic["flags"] if f.startswith("--lora_rank="))
    weights = inputs.make_weights(config, ctx.seed, ctx.device, lora_rank=lora_rank)
    ctx.mark("weights made")
    argv = [f"--model_preset={config['preset']}", f"--instance_data_dir={image_dir}",
            f"--output_dir={out_dir}", f"--tokenizer_name={tok_dir}", f"--seed={ctx.seed}",
            "--max_train_steps=1000000", *traffic["flags"]]
    cfg = parse_args(argv)
    ctx.mark("inputs made")

    rec = Recorder(ctx, traffic)
    if ctx.trace:
        rec.tracer = Tracer(ctx.trace_path)
        rec.traced_from = traffic["warmup_steps"] + 1
        rec.traced_to = traffic["warmup_steps"] + traffic["traced_steps"]
    Trainer = trainer_mod.Trainer
    saved = Trainer.run_step, Trainer._device_batch
    Trainer.run_step = rec.run_step(Trainer.run_step)
    Trainer._device_batch = rec.device_batch(Trainer._device_batch)
    calls = program.KernelCalls() if ctx.trace else None
    try:
        with program.weights_into(weights, config["preset"], [trainer_mod]):
            if calls is not None:
                calls.__enter__()
            trainer = Trainer(cfg, device=ctx.device)
            ctx.mark("trainer built")
            if ctx.trace:
                wrap_trace(rec, calls)
            result = trainer.train()
    finally:
        Trainer.run_step, Trainer._device_batch = saved
        if calls is not None:
            calls.__exit__(None, None, None)
    if ctx.cuda:
        torch.cuda.synchronize()
    steps = rec.calls - rec.warmup
    intervals = [a.elapsed_time(b) for a, b in zip(rec.events, rec.events[1:])] if ctx.cuda \
        else [1.0] * steps
    elapsed_s = sum(intervals) / 1e3
    batch = cfg.train_batch_size
    print(f"window: {steps} steps of {batch} samples in {elapsed_s:.3f} s; step ms by "
          f"quantile (0, .5, .9, .95, .99, 1): "
          f"{[round(q, 3) for q in np.quantile(intervals, (0, .5, .9, .95, .99, 1))]}",
          file=sys.stderr)
    losses = result["loss_by_step"]
    memory = torch.cuda.max_memory_reserved() if ctx.cuda else 0
    out = {
        "attempted": steps,
        "failed": sum(1 for v in losses[rec.warmup:] if not np.isfinite(v)),
        "memory_peak_bytes": memory,
        "metrics": {
            "train_samples_per_s": steps * batch / elapsed_s,
            "train_step_p95_ms": statistics.quantiles(intervals, n=20)[18] if steps > 1
            else intervals[0],
            "peak_reserved_gib": memory / 2**30,
            "setup_s": rec.setup_s,
        },
    }
    if ctx.trace:
        rec.tracer.finish()
        waits = result["host_wait_ms_by_step"][rec.warmup + 1:rec.calls + 1]
        replays = result.get("step_graph_replays", 0) - rec.replays_before
        out["readings"] = {
            "kind": "train", "steps": steps,
            "flops": flops.train_step(config, batch, lora_rank) * traffic["traced_steps"],
            "host_wait_ms": waits, "replays": replays,
            "trace": rec.tracer.summary, "traced_units": traffic["traced_steps"],
            "kernel_calls": rec.traced_calls,
        }
    # The program's state goes before the reference runs.
    prog = {"losses": losses[:rec.compared],
            "grads": grads_from_moments(rec.moments, rec.compared, cfg.adam_beta1),
            "states": rec.states}
    seen = {"table0": rec.table0, "batches": rec.batches, "host_batches": rec.host_batches}
    del trainer, result
    rec.states = rec.batches = rec.table0 = rec.moments = None
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()
    out["checks"] = compare(ctx, weights, prog, seen, cfg, lora_rank, tok_dir)
    ctx.mark("reference done")
    return out


def wrap_trace(rec, calls) -> None:
    """Count the kernel calls of the traced steps: the counts at the
    tracer's start and stop."""
    tracer = rec.tracer
    start, stop = tracer.start, tracer.stop

    def started():
        rec.calls_before = calls.snapshot()
        start()

    def stopped():
        stop()
        after = calls.snapshot()
        rec.traced_calls = {k: after[k] - rec.calls_before[k] for k in after}

    tracer.start, tracer.stop = started, stopped


def grads_from_moments(moments: Dict[int, Dict[str, torch.Tensor]], last: int,
                       beta1: float) -> Dict[int, Dict[str, float]]:
    """Each leaf's gradient norm as AdamW got it at step 1 and at step
    `last`, from its first moments m: m_1 = (1 - b1) g_1, and
    m_t = b1 m_(t-1) + (1 - b1) g_t."""
    out = {1: {k: float(torch.linalg.vector_norm(m.float())) / (1 - beta1)
               for k, m in moments[1].items()}}
    out[last] = {k: float(torch.linalg.vector_norm(
        m.float() - beta1 * moments[last - 1][k].float())) / (1 - beta1)
        for k, m in moments[last].items()}
    return out


def plan(tok: Tokenizer, traffic: Dict, cfg) -> Tuple[List[int], List[int], Dict[str, str]]:
    """The token surgery worked out again: (added ids, their initializer
    rows, {augmentation token: its sub-tokens joined}) of the concept's
    placeholder, then of the augmentation bank, each expanded to one token
    per initializer sub-token."""
    pairs = [(cfg.placeholder_token, cfg.initializer_token)]
    if cfg.augment_inversion:
        pairs += list(traffic["augmentation_tokens"].items())
    added, init, captions = [], [], {}
    for placeholder, initializer in pairs:
        ids = tok.ids(initializer)
        toks = ([placeholder] if len(ids) == 1 else
                [f"{placeholder[:-1]}_{i}>" for i in range(len(ids))])
        tok.add(toks)
        added += [tok.added[t] for t in toks]
        init += ids
        if placeholder != cfg.placeholder_token:
            captions[placeholder] = " ".join(toks)
    return added, init, captions


def compare(ctx, weights, prog, seen, cfg, lora_rank, tok_dir) -> List:
    """[(name, value, limit)] (module docstring)."""
    tok = Tokenizer(tok_dir)
    added, init, captions = plan(tok, ctx.traffic, cfg)
    base = weights["text_encoder"]["text_model.embeddings.token_embedding.weight"].float()
    table = torch.cat([base, base[torch.tensor(init, device=base.device)]])
    first_added = base.shape[0]
    checks = [("table_gap", float((seen["table0"] - table).abs().max())
               if seen["table0"].shape == table.shape else float("inf"), 0.0)]
    bad_ids = 0
    batches = []
    for host, dev in zip(seen["host_batches"], seen["batches"]):
        ids = torch.from_numpy(tok(host["prompt"])).to(ctx.device)
        prior = torch.from_numpy(tok(host["prior_prompt"])).to(ctx.device)
        bad_ids += int((ids != dev["input_ids"]).any(1).sum())
        bad_ids += int((prior != dev["prior_input_ids"]).any(1).sum())
        batches.append({"pixel_values": dev["pixel_values"], "input_ids": ids,
                        "prior_input_ids": prior})
    checks.append(("token_rows_differing", float(bad_ids), 0.0))
    mine = prog
    if ctx.control:  # the reference in fp8 in the program's place
        mine = follow(ctx, weights, table, batches, cfg, lora_rank, first_added, tok,
                      quant.Fp8Ops())
    ref = follow(ctx, weights, table, batches, cfg, lora_rank, first_added, tok,
                 ref_models.Ops(), resume=mine["states"][len(batches) - 1])
    for name, value in gaps(mine, ref, len(batches)).items():
        if name in ctx.limits:
            checks.append((name, value, ctx.limits[name]))
        else:  # a number with no upper reading: read, not compared (PERF.md)
            print(f"read, not compared: {name} {value!r}", file=sys.stderr)
    return checks


def follow(ctx, weights, table, batches, cfg, lora_rank, first_added, tok, ops,
           resume=None) -> Dict:
    """The reference, its products in `ops`' precision, through `batches`
    from the start: each step's loss, the gradients of the first and the
    last step, the leaves after step 3 and after the last two, and each
    leaf's largest gradient norm.  Given `resume`, the leaves of the side
    judged before the last step, it then takes the last step again from
    them, on the same batch and draws, for its loss and gradients
    (`loss_at_resume`, `grads_at_resume`)."""
    mods = reference_models(ctx, weights, lora_rank, ops)
    te = mods["text_encoder"]
    null_ids = torch.from_numpy(tok([""])).to(ctx.device)
    with torch.no_grad():
        null = te(null_ids, use_lora=False)[0]
    spec = ref_train.StepSpec(
        first_added=first_added, eos_id=tok.eos,
        vae_scaling=ctx.config["vae"]["scaling_factor"], kpl_weight=cfg.kpl_weight,
        lr=cfg.learning_rate, emb_lr=cfg.emb_learning_rate,
        betas=(cfg.adam_beta1, cfg.adam_beta2), weight_decay=cfg.adam_weight_decay,
        eps=cfg.adam_epsilon, max_grad_norm=cfg.max_grad_norm,
        micro_batch=ctx.traffic["micro_batch"])
    trainer = ref_train.Trainer(te, mods["unet"], mods["vae"], table, null, spec)
    gen = torch.Generator(ctx.device).manual_seed(cfg.seed)
    latent = (ctx.config["unet"]["in_channels"], cfg.resolution // 8, cfg.resolution // 8)
    out = {"losses": [], "states": {0: trainer.snapshot()}, "grad_max": {}, "grads": {}}
    for i, batch in enumerate(batches, 1):
        drawn = ref_train.draws(gen, batch["input_ids"].shape[0], latent)
        step = trainer.step(batch, drawn)
        out["losses"].append(step["loss"])
        for k, v in step["grad_norms"].items():
            out["grad_max"][k] = max(out["grad_max"].get(k, 0.0), v)
        if i == 1:
            out["grads"][1] = trainer.first_grads()
        elif i == len(batches):
            out["grads"][i] = step["grad_norms"]
        if i in (3, len(batches) - 1, len(batches)):
            out["states"][i] = trainer.snapshot()
    if resume is not None:
        trainer.load(resume)
        again = trainer.step(batch, drawn)
        out["loss_at_resume"], out["grads_at_resume"] = again["loss"], again["grad_norms"]
    del trainer, mods
    gc.collect()
    return out


def gaps(mine: Dict, ref: Dict, steps: int) -> Dict[str, float]:
    """The numbers read (the training bullet's measures): the worst step's
    relative loss gap; the worst leaf's gradient gap at step 1 (`grad`) and
    at the last compared step, against the reference's from the judged
    side's own state (`grad<steps>`; its median leaf's,
    `grad<steps>_median`; the added rows', `grad<steps>_embedding`; and
    that step's relative loss gap, `loss<steps>`); and after step 3 and after
    the last, the gap in the norm of the added rows' change over the
    reference's (`change<i>_embedding`), and the gaps of the LoRA weights'
    changes by the median and by the worst leaf (`change<i>_median`,
    `change<i>`), leaving out the LoRA leaves whose largest reference
    gradient is under a thousandth of the median leaf's.  The three worst LoRA leaves of each change go to
    standard error with their norms."""
    out = {"loss": max(abs(a - b) / abs(b) for a, b in zip(mine["losses"], ref["losses"]))}
    names = list(ref["grads"][1])
    out["grad"] = ref_train.gap(mine["grads"][1], ref["grads"][1], names)
    each = ref_train.leaf_gaps(mine["grads"][steps], ref["grads_at_resume"], names)
    out[f"grad{steps}"] = max(each.values())
    out[f"grad{steps}_median"] = float(np.median(list(each.values())))
    out[f"grad{steps}_embedding"] = each["embedding"]
    out[f"loss{steps}"] = abs(mine["losses"][steps - 1] - ref["loss_at_resume"]) / abs(
        ref["loss_at_resume"])
    _print_worst(f"grad{steps}", each, mine["grads"][steps], ref["grads_at_resume"], names)
    _print_kinds(f"grad{steps}", each)
    median = float(np.median(list(ref["grad_max"].values())))
    keep = [k for k in names if ref["grad_max"][k] >= 1e-3 * median]
    lora = [k for k in keep if k != "embedding"]
    start = ref["states"][0]
    for i in (3, steps):
        def norm(s):
            return {k: float(torch.linalg.vector_norm(s[k].float() - start[k].float()))
                    for k in ["embedding"] + lora}
        got, want = norm(mine["states"][i]), norm(ref["states"][i])
        out[f"change{i}_embedding"] = abs(got["embedding"] - want["embedding"]) / max(
            want["embedding"], 1e-30)
        each = ref_train.leaf_gaps(got, want, lora)
        out[f"change{i}"] = max(each.values())
        out[f"change{i}_median"] = float(np.median(list(each.values())))
        _print_worst(f"change{i}", each, got, want, lora,
                     f"; median leaf's largest gradient {median:.3g}")
    return out


def _print_kinds(name: str, each: Dict[str, float]) -> None:
    """The median and the widest gap of each kind of leaf (a LoRA weight's
    projection and factor, over the layers), and the layers of the quarter
    of leaves with the widest gaps."""
    kinds: Dict[str, List[float]] = {}
    for k, v in each.items():
        kinds.setdefault(".".join(k.split(".")[-3:-1]) if ".lora_" in k else k, []).append(v)
    top = sorted(each, key=each.get, reverse=True)[:max(1, len(each) // 4)]
    layers = sorted(int(m.group(1)) for k in top for m in [re.search(r"layers\.(\d+)\.", k)] if m)
    print(f"{name} by kind: " + "; ".join(
        f"{k} median {np.median(v):.3g} max {max(v):.3g} of {len(v)}" for k, v in sorted(
            kinds.items())) + f"; widest quarter in layers {layers}", file=sys.stderr)


def _print_worst(name: str, each: Dict[str, float], got: Dict[str, float],
                 want: Dict[str, float], leaves: List[str], note: str = "") -> None:
    """The three leaves of `each` with the widest gaps, with both norms."""
    worst = sorted(each, key=each.get, reverse=True)[:3]
    print(f"{name}: {len(leaves)} leaves; worst " + "; ".join(
        f"{k} gap {each[k]:.4g} (norm {got[k]:.4g} vs {want[k]:.4g})" for k in worst) + note,
        file=sys.stderr)


def reference_models(ctx, weights, lora_rank: int, ops):
    mods = ref_models.build(ops, ctx.config, lora_rank=lora_rank, device="meta")
    for part, mod in mods.items():
        mod.to_empty(device=ctx.device)
        mod.load_state_dict({k: v.float() for k, v in weights[part].items()})
        mod.eval()
    return mods
