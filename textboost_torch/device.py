"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is none.

    Entry points default to "cuda" and never drop to the CPU on their own:
    a caller who wants the CPU passes device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run textboost_torch on the CPU"
        )
    return dev
