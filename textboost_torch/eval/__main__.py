"""DreamBooth 30-instance benchmark: generation and metrics (the flags of the
root eval_dreambooth.py, plus --device).

    python -m textboost_torch.eval output/tb-sd21base-n1 --model sd21base \\
        --seeds 0 1 2 3 --metric clip-t clip-i dino vqa \\
        --scorer-weights scorer_weights --vqa-weights scorer_weights/vqa

For each trained instance dir of the sweep (`run_textboost_db`'s output),
samples its 25 prompts for every seed (DPM-Solver++ 25 steps, CFG 7.5, one
latent per seed shared by every prompt, chunks of --batch-size) into
`<outdir>/<sweep>[-ckpt][_desc]/seed{s}/<instance>/{prompt}.png`, then scores
them with CLIP-T, CLIP-I, DINO (seen: --train-dir, unseen: --val-dir) and
VQAScore into `<sweep>/metric{_ckptN|_last}{_desc}.csv` (the reference's
columns, "%.3f").  Consecutive instances over one base share the resident
base weights (`load_textboost_pipeline(reuse=)`).

Over several ranks (one process per card):

    python -m torch.distributed.run --nproc_per_node 2 -m textboost_torch.eval <sweep> ...

When --batch-size B divides over the W ranks (the JAX CLI's condition for
sharding each generation batch over a dp mesh of its devices,
eval_dreambooth.py:126-134), the prompts of each (instance, seed) are cut
into sub-chunks of B/W and sub-chunk j is sampled by rank j % W: the rows
a dp-sharded batch of B gives each device.  Rank 0 gathers each chunk's
images and alone writes them; after a barrier it alone scores.  A rank's
images are the bits a one-process run at --batch-size B/W gives, so the CSV
is that run's.  When B does not divide, rank 0 samples every chunk (the JAX
CLI then runs on one device) and the other ranks wait for it.  Every rank
keeps the resident base across instances (`reuse=`).

In one process on a card, a chunk signature is sampled as a CUDA graph,
captured at its second call and replayed, where it pays the capture back
(`sampler_signatures`): the reused pipeline keeps its graphs across a run
of consecutive instances that add as many token rows (pipelines/
loading.py, `reuse=`), so the calls are counted for each such run before
the first call (`planned_runs`: its instances x seeds x chunks), and a
signature called graphs.VALIDATION_CAPTURE_ROUNDS times or more in a run
is captured for it.  The JAX CLI compiles its sampler once for the whole
run.  Ranks under torch.distributed sample eagerly, as the trainer's
validation rounds do there.

Deviations from the JAX CLI:
  * the tail chunk (25 = 16 + 9) runs at its own size; the JAX CLI padded it
    to a full batch to reuse one compiled program;
  * the seed's latent is drawn from `torch.Generator(device).manual_seed(seed)`
    as [h/8, w/8, 4] (`seed_latent`): threefry cannot be reproduced, so the
    two CLIs give different images for the same seed;
  * scorer weights are the published torch checkpoints or the JAX package's
    converted flax trees (`*.msgpack`, `params/` `.safetensors`), read
    without flax (eval/scorer_weights.py).
"""
from __future__ import annotations

import argparse
import collections
import csv
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# The reference's metric CSV header, in its column order (score_dict's keys).
REFERENCE_CSV_HEADER = [
    "seed", "clip_score", "vqa_score", "clip_i", "clip_i_unseen",
    "dino", "dino_unseen",
]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str, help="path to model sweep dir")
    parser.add_argument("--token-format", type=str, default="<INSTANCE> SUBJECT")
    parser.add_argument("--outdir", type=str, default="./benchmarks")
    parser.add_argument("--checkpoint", type=int, default=None)
    parser.add_argument("--instances", type=str, nargs="+", default=None)
    parser.add_argument("--skip-gen", action="store_true")
    parser.add_argument("--metric", type=str, nargs="+", default=["clip-t", "clip-i", "vqa"])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--dreambooth-path", type=str, default="./data/dreambooth")
    parser.add_argument("--train-dir", type=str, default="./data/dreambooth_n1_train")
    parser.add_argument("--val-dir", type=str, default="./data/dreambooth_n1_val")
    parser.add_argument("--model", type=str, default=None)
    parser.add_argument("--output-desc", type=str, default=None)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--lora-rank", type=int, default=4)
    parser.add_argument("--scorer-weights", type=str, default=None,
                        help="dir with the CLIP (`clip`) and DINOv2 (`dino`) torch checkpoints")
    parser.add_argument("--allow-random-scorers", action="store_true",
                        help="explicitly permit random-init scorers (scores are "
                        "self-consistent only, NOT paper-comparable)")
    parser.add_argument("--vqa-weights", type=str, default=None,
                        help="dir with the clip-flant5 parts (vision, projector, t5, "
                        "tokenizer.json, config.json) for the native VQAScore")
    parser.add_argument("--null-emb-path", type=str, default=None,
                        help="reference-format null/start embedding .pt asset")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def detect_model(args):
    if args.model is not None:
        model = args.model
    else:
        model = next((name for name in ("sd21base", "sd21", "sd15", "sd14", "tiny")
                      if name in args.path), None)
        if model is None:
            # A silent default would evaluate a checkpoint with the wrong geometry.
            raise ValueError(
                f"cannot infer the base model from path {args.path!r}; "
                "pass --model (sd14|sd15|sd21base|sd21|tiny)"
            )
    size = 96 if model == "sd21" else (16 if model == "tiny" else 64)
    return model, size


def detect_num_vectors(files, instance):
    """The reference's multi-vector detection: bin file names are unbracketed,
    so `startswith(instance)` counts `{instance}.bin` / `{instance}_{i}.bin`."""
    return len([f for f in files if f.startswith(instance) and f.endswith(".bin")])


def seed_latent(seed: int, size: int, device) -> torch.Tensor:
    """The latent [size, size, 4] one seed shares across every prompt."""
    return torch.randn((size, size, 4), generator=torch.Generator(device).manual_seed(seed),
                       device=device)


GUIDANCE = 7.5
SAMPLER = "dpm++2m"  # DPM-Solver++(2M), the pipeline's default


def planned_runs(args, instances: Dict[str, str], size: int
                 ) -> List[Tuple[List[str], collections.Counter]]:
    """The runs of consecutive instance dirs that add as many token rows,
    each with the sampling calls `generate` makes for it in one process, by
    signature (graphs.sampler_key): each instance, each seed, each chunk of
    its prompts."""
    from .. import graphs
    from ..pipelines.loading import added_rows
    from .dreambooth_bench import prompts_for

    runs, rows = [], None
    for instance in instances:
        model_path = os.path.join(args.path.rstrip("/"), instance)
        if not os.path.isdir(model_path):
            continue
        n_rows = added_rows(model_path, args.checkpoint)
        if not runs or n_rows != rows:
            runs.append(([], collections.Counter()))
        rows = n_rows
        names, calls = runs[-1]
        names.append(instance)
        n = len(prompts_for(instance))
        for i in range(0, n, args.batch_size):
            key = graphs.sampler_key(min(args.batch_size, n - i), size * 8, size * 8,
                                     args.steps, GUIDANCE, SAMPLER)
            calls[key] += len(args.seeds)
    return runs


def sampler_signatures(calls: Dict[Tuple, int], device, distributed: bool = False
                       ) -> List[Tuple]:
    """The signatures of one run sampled as CUDA graphs: those it calls
    often enough to pay a capture back (graphs.VALIDATION_CAPTURE_ROUNDS),
    on a card, outside a torch.distributed launch, with capture on; at most
    graphs.MAX_SIGNATURES, the most called first."""
    from .. import graphs

    if torch.device(device).type != "cuda" or distributed or not graphs.capture_enabled():
        return []
    often = sorted((key for key, n in calls.items() if n >= graphs.VALIDATION_CAPTURE_ROUNDS),
                   key=lambda key: -calls[key])
    return often[:graphs.MAX_SIGNATURES]


def output_dir(args) -> str:
    basename = os.path.basename(args.path.rstrip("/"))
    if args.checkpoint is not None:
        basename = f"{basename}-{args.checkpoint}"
    outdir = os.path.join(args.outdir.rstrip("/"), basename)
    return outdir + (f"_{args.output_desc}" if args.output_desc else "")


def generate(args) -> str:
    """Sample every instance's prompts for every seed (over the launch's
    ranks when its process group is joined, as the module docstring says);
    returns the image dir."""
    from PIL import Image

    from .. import graphs
    from ..device import resolve_device
    from ..parallel import mesh
    from ..pipelines.loading import load_textboost_pipeline
    from .dreambooth_bench import INSTANCES, prompts_for

    instances = ({k: v for k, v in INSTANCES.items() if k in args.instances}
                 if args.instances else INSTANCES)
    outdir = output_dir(args)
    if args.skip_gen:
        return outdir
    device = resolve_device(args.device)
    model, size = detect_model(args)
    path = args.path.rstrip("/")
    world, rank = mesh.world_size(), mesh.rank()
    sub = args.batch_size // world if args.batch_size % world == 0 else None
    if world > 1 and rank == 0:
        print(f"Sharding generation batches over {world} ranks: sub-chunks of {sub} prompts"
              if sub else f"--batch-size {args.batch_size} does not divide over {world} "
              "ranks: rank 0 generates every batch", flush=True)
    if sub is None and rank > 0:
        return outdir  # rank 0 generates alone; `main` waits for it
    # Each run's first instance: the signatures its pipeline captures.
    starts = {}
    for run, calls in planned_runs(args, instances, size):
        starts[run[0]] = sampler_signatures(calls, device,
                                            distributed=torch.distributed.is_initialized())
    pipeline = None
    for instance, cls in instances.items():
        model_path = os.path.join(path, instance)
        if not os.path.isdir(model_path):
            if rank == 0:
                print(f"[skip] missing instance dir: {model_path}")
            continue
        pipeline = load_textboost_pipeline(
            model_path, model, checkpoint=args.checkpoint, lora_rank=args.lora_rank,
            null_embedding_path=args.null_emb_path, device=device, reuse=pipeline,
        )
        if instance in starts:  # loading released the last run's graphs
            pipeline.release_graphs()
            pipeline.graphs = graphs.CapturedSampler(starts[instance]) if starts[instance] else None
        files = os.listdir(model_path if args.checkpoint is None
                           else os.path.join(model_path, f"checkpoint-{args.checkpoint}"))
        num_vectors = detect_num_vectors(files, instance)
        identifier = args.token_format.replace("INSTANCE", instance)
        if num_vectors > 1:
            identifier = " ".join(identifier.replace(">", f"_{i}>") for i in range(num_vectors))
        identifier = identifier.replace("SUBJECT", cls)
        prompt_list = prompts_for(instance)
        for seed in args.seeds:
            latent = seed_latent(seed, size, device)
            dst = os.path.join(outdir, f"seed{seed}", instance)
            if rank == 0:
                os.makedirs(dst, exist_ok=True)
            for i in range(0, len(prompt_list), args.batch_size):
                prompts = [p.format(identifier) for p in prompt_list[i:i + args.batch_size]]
                images = _sample_chunk(pipeline, prompts, latent, size, args.steps,
                                       sub if world > 1 else None)
                if images is None:  # another rank's chunk: rank 0 writes it
                    continue
                for prompt, image in zip(prompts, images):
                    fname = f"{prompt.replace(identifier, cls).replace(' ', '_')}.png"
                    Image.fromarray(image).save(os.path.join(dst, fname))
            if rank == 0:
                print(f"[{instance}] seed {seed}: {len(prompt_list)} images")
    return outdir


def _sample_chunk(pipeline, prompts, latent, size: int, steps: int, sub: Optional[int]):
    """One chunk's images; with `sub`, this rank samples its sub-chunks (j %
    world == rank) and rank 0 returns the chunk's images gathered in prompt
    order, the other ranks None."""
    from ..parallel import mesh

    def sample(batch):
        return pipeline(batch, num_inference_steps=steps, guidance_scale=GUIDANCE,
                        sampler=SAMPLER, latents=latent, height=size * 8, width=size * 8)

    if sub is None:
        return sample(prompts)
    world, rank = mesh.world_size(), mesh.rank()
    mine = [prompts[j:j + sub] for j in range(0, len(prompts), sub)][rank::world]
    parts = mesh.gather_to_main([sample(batch) for batch in mine])
    if parts is None:
        return None
    # Sub-chunk j is rank j % world's (j // world)-th: interleave them back.
    return np.concatenate([parts[j % world][j // world]
                           for j in range(sum(len(p) for p in parts))])


def load_dir_images(path):
    from PIL import Image

    images, prompts = [], []
    for f in sorted(os.listdir(path)):
        if f.endswith((".png", ".jpg")):
            images.append(np.asarray(Image.open(os.path.join(path, f)).convert("RGB")))
            prompts.append(os.path.splitext(f)[0].replace("_", " "))
    return images, prompts


def build_scorers(args, device):
    """(CLIP scorer, DINO scorer, VQA scorer or None, CLIP tokenizer) as the
    flags ask; raises SystemExit without weights unless random scorers are
    allowed."""
    from ..data.tokenizer import load_tokenizer
    from .clip_scorer import TINY_CLIP, CLIPScorer
    from .dino import TINY_VIT, DINOScorer
    from .vqa import NativeVQAScorer, VQAScorer, vqa_available

    if args.scorer_weights is None:
        # Random-init numbers must not pass for parity metrics.
        if not args.allow_random_scorers:
            raise SystemExit(
                "No --scorer-weights given. Metric scorers would be random-init and the CSV "
                "meaningless as a parity number. Pass a dir with the CLIP and DINOv2 torch "
                "checkpoints, or --allow-random-scorers for a self-consistency smoke run.")
        print("WARNING: no --scorer-weights; using random-init tiny scorers. "
              "Scores are self-consistent only, NOT paper-comparable.")
        clip, dino = CLIPScorer(TINY_CLIP, device=device), DINOScorer(TINY_VIT, device=device)
        tokenizer = load_tokenizer(None)
    else:
        from .scorer_weights import load_scorers

        clip, dino = load_scorers(args.scorer_weights, device=device)
        # A transformers CLIPModel dir carries its BPE files; else the hash
        # fallback, as in the JAX CLI.
        tokenizer = load_tokenizer(os.path.join(args.scorer_weights, "clip"))
    vqa = None
    if "vqa" in args.metric:
        if args.vqa_weights:
            vqa = NativeVQAScorer(args.vqa_weights, device=device)
        elif vqa_available():
            vqa = VQAScorer(device=str(device))
        elif args.allow_random_scorers:
            print("WARNING: VQAScore running the tiny random-init native clip-flant5 "
                  "(no --vqa-weights); self-consistent only.")
            vqa = NativeVQAScorer(device=device)
        else:
            print("WARNING: VQAScore skipped: pass --vqa-weights (the clip-flant5 parts) or "
                  "install t2v_metrics.")
    return clip, dino, vqa, tokenizer


def compute_metrics(args, outdir: str) -> Optional[str]:
    """Score `outdir`'s images into the sweep dir's metric CSV; returns its
    path (None when no metric is asked for)."""
    from ..device import resolve_device

    if not {"clip-t", "clip-i", "dino", "vqa"}.intersection(args.metric):
        # e.g. `--metric none`: a generation-only run builds no scorer.
        print("No metrics requested; generation-only run complete.")
        return None
    clip, dino, vqa, tokenizer = build_scorers(args, resolve_device(args.device))
    ckpt = f"_ckpt{args.checkpoint}" if args.checkpoint is not None else "_last"
    desc = f"_{args.output_desc}" if args.output_desc is not None else ""
    csv_path = os.path.join(args.path.rstrip("/"), f"metric{ckpt}{desc}.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(REFERENCE_CSV_HEADER)
        for seed in args.seeds:
            seed_dir = os.path.join(outdir, f"seed{seed}")
            if not os.path.isdir(seed_dir):
                continue
            scores = {k: [] for k in REFERENCE_CSV_HEADER[1:]}
            for instance in sorted(os.listdir(seed_dir)):
                images, prompts = load_dir_images(os.path.join(seed_dir, instance))
                if not images:
                    continue
                gen = np.stack(images)
                if "clip-t" in args.metric:
                    scores["clip_score"].append(clip.clip_t(tokenizer, gen, prompts))
                if vqa is not None:
                    scores["vqa_score"].append(vqa.score(list(gen), prompts))
                # The reference images: seen (train dir) and unseen (val dir),
                # the latter only where the former exists.
                refs, train_dir = {}, os.path.join(args.train_dir, instance)
                if {"clip-i", "dino"} & set(args.metric) and os.path.isdir(train_dir):
                    for key, ref_dir in (("", train_dir),
                                         ("_unseen", os.path.join(args.val_dir, instance))):
                        ref = load_dir_images(ref_dir)[0] if os.path.isdir(ref_dir) else []
                        if ref:
                            refs[key] = np.stack(ref)
                for key, ref in refs.items():
                    if "clip-i" in args.metric:
                        scores[f"clip_i{key}"].append(clip.clip_i(gen, ref))
                    if "dino" in args.metric:
                        scores[f"dino{key}"].append(dino.dino_score(gen, ref))
            # Unselected or unavailable metrics keep the reference's 0.0.
            row = {k: float(np.mean(v)) if v else 0.0 for k, v in scores.items()}
            writer.writerow([str(seed)] + [f"{row[k]:.3f}" for k in REFERENCE_CSV_HEADER[1:]])
            f.flush()
            print(f"seed {seed}: " + " ".join(f"{k}={row[k]:.3f}"
                                              for k in REFERENCE_CSV_HEADER[1:]))
    print(f"Wrote {csv_path}")
    return csv_path


def main(argv: Optional[List[str]] = None) -> Optional[str]:
    """Generate, then score on rank 0 (see the module docstring); returns
    the CSV path (None on the other ranks and without metrics)."""
    from ..parallel import mesh

    args = parse_args(argv)
    with mesh.distributed(args.device):
        outdir = generate(args)
        mesh.barrier()  # rank 0 has written every image
        return compute_metrics(args, outdir) if mesh.is_main() else None


if __name__ == "__main__":
    main()
