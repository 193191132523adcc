"""Time the flash backward (K2) of one or more source trees on the card.

    python -m textboost_torch.tools.time_flash_bwd --trees OLD_TREE . [--json OUT]

Each tree is a checkout of this repository (for instance an older commit
unpacked with `git archive`).  Each is timed in a process of its own that
imports that tree's `textboost_torch` and builds that tree's kernels, in the
order A B B A for two trees (A B for one, ...), so that a drift of the
card's clock over the call shows as a gap between one tree's two times.

In each process, at each of the training shapes SHAPES [B, N, H, D] (sd15
levels 0 and 1, sd21base level 0; bf16 self-attention, q, k, v and dO
drawn from a CUDA generator seeded 0), K2 is timed with CUDA events over
20 calls, with the stream held by a spin kernel while the host enqueues
them, and a SHA-1 of its (dq, dk, dv) bits is kept, so that two trees that
compute the same function show the same digest.  Prints one JSON line a
process and, at the end, a summary with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

SHAPES = ("8,4096,8,40", "8,1024,8,80", "8,4096,5,64")
ITERS = 20
SPIN_CYCLES = 400_000_000


def _child() -> dict:
    import torch

    from textboost_torch.ops import flash_attention as fa

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    out = {}
    for text in SHAPES:
        b, n, h, d = (int(x) for x in text.split(","))
        gen = torch.Generator(dev).manual_seed(0)
        q, k, v, do = (torch.randn(b, n, h, d, generator=gen, device=dev).to(bf16)
                       for _ in range(4))
        scale = d**-0.5
        o, lse = fa.flash_attention_forward(q, k, v, scale=scale)

        def call():
            return fa.flash_attention_backward(q, k, v, o, lse, do, scale=scale)

        digest = hashlib.sha1()
        for g in call():
            digest.update(g.view(torch.int16).cpu().numpy().tobytes())
        for _ in range(3):
            call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(ITERS):
            call()
        end.record()
        torch.cuda.synchronize()
        out[text] = {"ms": start.elapsed_time(end) / ITERS, "sha1": digest.hexdigest()}
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trees", nargs="+", required=True)
    p.add_argument("--json", default=None, help="write the results here as well")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:  # one tree, imported from the working directory
        print(json.dumps(_child()), flush=True)
        return 0

    trees = [os.path.abspath(t) for t in args.trees]
    order = trees + trees[::-1]
    runs = []
    for tree in order:
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--trees", tree],
            cwd=tree, env=env, capture_output=True, text=True, timeout=1200,
        )
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"timing {tree} failed with exit code {proc.returncode}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, "times": result}), flush=True)
        runs.append((tree, result))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    summary = {"card": smi, "order": [t for t, _ in runs], "shapes": {}}
    for shape in SHAPES:
        summary["shapes"][shape] = {
            tree: {"ms": [r[shape]["ms"] for t, r in runs if t == tree],
                   "sha1": sorted({r[shape]["sha1"] for t, r in runs if t == tree})}
            for tree in trees
        }
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
