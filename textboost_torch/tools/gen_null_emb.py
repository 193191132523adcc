"""Write the reference's cached embedding asset: the frozen text encoder's
output for a prompt (by default the empty one: the null embedding), as a
torch-pickled fp32 [77, hidden] tensor (counterpart of tools/gen_null_emb.py).

    python -m textboost_torch.tools.gen_null_emb --model sd21base --out null_emb_sd21base.pt
    python -m textboost_torch.tools.gen_null_emb --model <snapshot dir> --out start_emb.pt \\
        --prompt "" --device cuda

The trainer reads the file with --null_embedding_path.  `--model` is a
preset name (seeded weights) or a local diffusers snapshot, whose own
tokenizer files are used when it has them.
"""
from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", required=True,
                        help="preset name (sd15/sd21base/...) or diffusers snapshot dir")
    parser.add_argument("--out", required=True, help="output .pt path")
    parser.add_argument("--prompt", default="",
                        help="prompt to embed (default: empty = the null embedding; the BOS "
                        "row doubles as start_emb)")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    from ..data.tokenizer import load_tokenizer
    from ..device import resolve_device
    from ..models.pretrained import load_models
    from ..pipelines.text_to_image import TextToImagePipeline

    args = parse_args(argv)
    device = resolve_device(args.device)
    bundle = load_models(args.model, dtype=torch.float32, device=device)
    pipe = TextToImagePipeline(bundle.spec, load_tokenizer(args.model), bundle.text_encoder,
                               bundle.unet, bundle.vae, device=device)
    arr = pipe.compute_null_embedding(args.prompt)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(torch.from_numpy(arr.copy()), args.out)
    print(f"wrote {args.out}: shape {tuple(arr.shape)} fp32 (prompt={args.prompt!r})")
    return args.out


if __name__ == "__main__":
    main()
