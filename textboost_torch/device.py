"""Device selection for the port's entry points."""
from __future__ import annotations

import os
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is none.

    Entry points default to "cuda" and never drop to the CPU on their own:
    a caller who wants the CPU passes device="cpu".  In a rank of a
    torchrun launch, a bare "cuda" is the card cuda:{LOCAL_RANK % cards}
    (ranks share cards round-robin when there are more of them), and it is
    made the current device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run textboost_torch on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev
