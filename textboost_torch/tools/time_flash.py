"""Time the flash kernels (K1 forward, K2 backward) of one or more source
trees on the card.

    python -m textboost_torch.tools.time_flash --trees OLD_TREE . [--kernel fwd|bwd|both]
        [--json OUT]

Each tree is a checkout of this repository (for instance an older commit
unpacked with `git archive`).  Each is timed in a process of its own that
imports that tree's `textboost_torch` and builds that tree's kernels, in the
order A B B A for two trees (A B for one, ...), so that a drift of the
card's clock over the call shows as a gap between one tree's two times.

In each process, at each form of FWD_FORMS (K1) and BWD_FORMS (K2), written
"dtype:B,N,H,D" with "/M" for M keys (cross-attention; self-attention
otherwise): q, k, v and dO drawn from a CUDA generator seeded 0, the kernel
timed with CUDA events over ITERS to 200 calls (as many as fit in about
0.2 s), with the stream held by a spin kernel while the host enqueues them,
and a SHA-1 of its output bits kept, so that two trees that compute the same
function show the same digest.  The forms are sd15's training shapes in
bf16 (the wgmma variants), every shape of the fp32 `--attention_impl flash`
step (CUDA cores), and the 16-bit heads wider than 128 (K2's mma variant).
Prints one JSON line a process and, at the end, a summary with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

FWD_FORMS = (
    "bfloat16:8,4096,8,40",
    "float32:8,4096,8,40", "float32:8,4096,8,40/77", "float32:8,1024,8,80",
    "float32:8,1024,8,80/77", "float32:8,256,8,160", "float32:8,256,8,160/77",
    "float32:8,4096,1,512",
)
BWD_FORMS = (
    "bfloat16:8,4096,8,40", "bfloat16:8,1024,8,80", "bfloat16:8,4096,5,64",
    "bfloat16:8,256,8,160", "bfloat16:8,256,8,160/77", "bfloat16:2,4096,1,512",
    "float32:8,4096,8,40", "float32:8,4096,8,40/77", "float32:8,1024,8,80",
    "float32:8,1024,8,80/77", "float32:8,256,8,160", "float32:8,256,8,160/77",
    "float32:2,4096,1,512",
)
ITERS = 20
SPIN_CYCLES = 400_000_000


def parse_form(text: str):
    """'dtype:B,N,H,D[/M]' -> (dtype name, B, N, H, D, M)."""
    dtype, dims = text.split(":")
    dims, _, m = dims.partition("/")
    b, n, h, d = (int(x) for x in dims.split(","))
    return dtype, b, n, h, d, int(m) if m else n


def _time(call, iters: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _child(kernels) -> dict:
    import torch

    from textboost_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    out = {}
    for kernel in kernels:
        for text in FWD_FORMS if kernel == "fwd" else BWD_FORMS:
            dt, b, n, h, d, m = parse_form(text)
            dtype = getattr(torch, dt)
            gen = torch.Generator(dev).manual_seed(0)
            q, do = (torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(b, m, h, d, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            scale = d**-0.5
            o, lse = fa.flash_attention_forward(q, k, v, scale=scale)
            if kernel == "fwd":
                def call():
                    return fa.flash_attention_forward(q, k, v, scale=scale)
            else:
                def call():
                    return fa.flash_attention_backward(q, k, v, o, lse, do, scale=scale)
            digest = hashlib.sha1()
            for t in call():
                digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            for _ in range(3):
                call()
            first = _time(call, 2)
            ms = _time(call, max(ITERS, min(200, int(200 / max(first, 1e-3)))))
            out[f"{kernel} {text}"] = {"ms": ms, "sha1": digest.hexdigest()}
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trees", nargs="+", required=True)
    p.add_argument("--kernel", choices=("fwd", "bwd", "both"), default="both")
    p.add_argument("--json", default=None, help="write the results here as well")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    kernels = ("fwd", "bwd") if args.kernel == "both" else (args.kernel,)
    if args.child:  # one tree, imported from the working directory
        print(json.dumps(_child(kernels)), flush=True)
        return 0

    trees = [os.path.abspath(t) for t in args.trees]
    order = trees + trees[::-1]
    runs = []
    for tree in order:
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--kernel", args.kernel,
             "--trees", tree],
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
    summary = {"card": smi, "order": [t for t, _ in runs], "forms": {}}
    for form in runs[0][1]:
        summary["forms"][form] = {
            tree: {"ms": [r[form]["ms"] for t, r in runs if t == tree],
                   "sha1": sorted({r[form]["sha1"] for t, r in runs if t == tree})}
            for tree in trees
        }
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
