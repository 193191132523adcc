"""TextBoost training CLI of the port: the flags of train_textboost.py,
parsed by the same TrainConfig, plus --device.

    python -m textboost_torch.train --model_preset sd21base \\
        --instance_data_dir imgs/ --placeholder_token "<v*>" --initializer_token dog \\
        --max_train_steps 250 --train_batch_size 8 --mixed_precision bf16 \\
        --lora_rank 4 --augment pda --augment_p 0.5 --augment_inversion \\
        --checkpointing_steps 50 --validation_steps 50 \\
        --validation_prompts "photo of a <0>" --output_dir out/

Runs on the GPU unless --device cpu is given.  Writes training.log,
metrics.jsonl, `checkpoint-{step}/` dirs, `validation_{step}.jpg` grids,
and at the end the `text_encoder/` PEFT adapter and `<token>.bin` files
into --output_dir; `--resume_from_checkpoint latest` carries a run on from
its latest checkpoint; `python -m textboost_torch.inference <output_dir>`
samples from the result.  The package holds the config (config.py), the
step (step.py), the checkpoints (checkpoint.py) and the trainer
(trainer.py).

Data parallel, one process per card (--train_batch_size stays the global
batch; parallel/mesh.py):

    python -m torch.distributed.run --nproc_per_node 2 -m textboost_torch.train ...

and across hosts `--nnodes N --node_rank i --master_addr HOST --master_port
PORT` (a shared --output_dir for resume).  The ranks join the process group
here, before the trainer is built, and leave it at the end.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Parse the CLI flags, train, export; returns the last metrics."""
    device_parser = argparse.ArgumentParser(add_help=False)
    device_parser.add_argument("--device", type=str, default="cuda")
    ns, rest = device_parser.parse_known_args(argv)

    from ..parallel.mesh import barrier, distributed
    from .config import parse_args
    from .trainer import Trainer

    config = parse_args(rest)
    with distributed(ns.device):
        result = Trainer(config, device=ns.device).train()
        barrier()  # rank 0's export has landed before any rank leaves
        return result
