"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip elsewhere; this file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_port_kernels.py -m cuda -q --noconftest
"""
import pytest
import torch

from textboost_torch.ops import flash_attention as fa
from textboost_torch.ops import group_norm as gn


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    g = torch.Generator("cuda").manual_seed(0)
    # Tensor-core variants (bf16/fp16, D % 8 == 0: D <= 128 per warp, wide
    # up to 512) and the CUDA-core variant (D = 100, fp32), with ragged N and
    # masked KV tails.
    for b, n, h, d, m, dtype in ((2, 1024, 2, 40, 1024, torch.bfloat16),
                                 (1, 300, 3, 128, 77, torch.bfloat16),
                                 (1, 200, 2, 64, 130, torch.float16),
                                 (1, 512, 1, 512, 300, torch.bfloat16),
                                 (1, 100, 2, 200, 64, torch.float16),
                                 (1, 256, 2, 100, 256, torch.bfloat16),
                                 (1, 130, 2, 40, 99, torch.float32)):
        q = torch.randn(b, n, h, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(b, m, h, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(b, m, h, d, generator=g, device="cuda").to(dtype)
        o, lse = fa.flash_attention_forward(q, k, v, scale=d**-0.5)
        ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(), d**-0.5)
        # o against the fp32 plain version: relative L2 over the whole output
        # and over the worst row (chip_smoke.py states why these limits).
        diff = o.float() - ro
        assert (diff.norm() / ro.norm()).item() <= 5e-3, (b, n, h, d, m, dtype)
        assert (diff.norm(dim=-1) / ro.norm(dim=-1)).max().item() <= 2e-2, (b, n, h, d, m, dtype)
        torch.testing.assert_close(lse, rl, atol=1e-3, rtol=0)
    x = torch.randn(2, 320, 32, 32, generator=g, device="cuda").bfloat16()
    gamma = torch.rand(320, generator=g, device="cuda") + 0.5
    beta = torch.randn(320, generator=g, device="cuda")
    y, mean, rstd = gn.group_norm_forward(x, gamma, beta, 32, eps=1e-5, silu=True)
    ry, rmean, rrstd = gn.group_norm_reference(x, gamma, beta, 32, 1e-5, True)
    torch.testing.assert_close(y.float(), ry.float(), atol=1e-3, rtol=2.0**-7)
    torch.testing.assert_close(mean, rmean, atol=1e-6, rtol=1e-4)
    torch.testing.assert_close(rstd, rrstd, atol=0, rtol=1e-4)
