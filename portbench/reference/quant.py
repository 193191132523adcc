"""The lower-precision control: the reference with every product of a linear
or convolution layer taken over operands rounded to float8 (e4m3), each
tensor scaled by its own absolute maximum over 448 (per-tensor scaling, as
an fp8 GEMM takes it), and accumulated in float32; gradients stay float32.  The configurations run
in bfloat16; fp8 is the next precision below it, the step a later change
would be tempted to take.  A comparison that the control passes cannot tell
a bfloat16 program from an fp8 one."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .models import Ops

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to e4m3 under its per-tensor scale; the gradient passes
    through the rounding unchanged (in float32), as fp8 training keeps it."""
    scale = t.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    q = (t.detach() / scale).to(FP8).to(t.dtype) * scale
    return t + (q - t).detach()


class Fp8Ops(Ops):
    def linear(self, x, weight, bias=None):
        return F.linear(fp8(x), fp8(weight), bias)

    def conv(self, x, weight, bias, stride: int, padding: int):
        return F.conv2d(fp8(x), fp8(weight), bias, stride=stride, padding=padding)
