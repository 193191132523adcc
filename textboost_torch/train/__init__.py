"""TextBoost training CLI of the port: the flags of train_textboost.py,
parsed by the same TrainConfig, plus --device.

    python -m textboost_torch.train --model_preset sd15 \\
        --instance_data_dir imgs/ --placeholder_token "<v*>" --initializer_token dog \\
        --max_train_steps 250 --train_batch_size 8 --mixed_precision bf16 \\
        --lora_rank 4 --checkpointing_steps 0 --output_dir out/

Runs on the GPU unless --device cpu is given.  Writes training.log,
metrics.jsonl, the `text_encoder/` PEFT adapter and `<token>.bin` files into
--output_dir; `python -m textboost_torch.inference <output_dir>` samples
from them.  The package holds the config (config.py), the step (step.py)
and the trainer (trainer.py).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Parse the CLI flags, train, export; returns the last metrics."""
    device_parser = argparse.ArgumentParser(add_help=False)
    device_parser.add_argument("--device", type=str, default="cuda")
    ns, rest = device_parser.parse_known_args(argv)

    from .config import parse_args
    from .trainer import Trainer

    return Trainer(parse_args(rest), device=ns.device).train()
