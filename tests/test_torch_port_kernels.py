"""The port's CUDA kernels (forward and backward) against their plain
PyTorch versions, on the card.

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


@pytest.mark.cuda
def test_backward_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    g = torch.Generator("cuda").manual_seed(1)
    # Flash backward: its envelope (bf16/fp16, D % 8 == 0, D <= 128), with
    # ragged N and masked KV tails, against fp32 autograd of plain attention
    # (chip_smoke.py states why these limits).
    for b, n, h, d, m, kv, dtype in ((2, 1024, 2, 40, 1024, 1024, torch.bfloat16),
                                     (1, 300, 2, 64, 320, 250, torch.float16),
                                     (1, 256, 2, 128, 256, 256, torch.bfloat16),
                                     (1, 200, 1, 8, 100, 77, torch.bfloat16),
                                     (2, 512, 3, 80, 512, 400, torch.bfloat16)):
        q, do = (torch.randn(b, n, h, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(b, m, h, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        o, lse = fa.flash_attention_forward(q, k, v, scale=d**-0.5, kv_len=kv)
        grads = fa.flash_attention_backward(q, k, v, o, lse, do, scale=d**-0.5, kv_len=kv)
        qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
        s = torch.einsum("bnhd,bmhd->bhnm", qf, kf[:, :kv]) * d**-0.5
        torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), vf[:, :kv]).backward(do.float())
        for got, ref in zip(grads, (qf.grad, kf.grad, vf.grad)):
            diff, live = got.float() - ref, ref.norm(dim=-1) > 0
            assert (diff.norm() / ref.norm()).item() <= 5e-3, (b, n, h, d, m, kv, dtype)
            assert (diff.norm(dim=-1)[live] / ref.norm(dim=-1)[live]).max().item() <= 2e-2
        assert not grads[1][:, kv:].any() and not grads[2][:, kv:].any()
    with pytest.raises(NotImplementedError, match="queue B"):
        fa.flash_attention(*(torch.randn(1, 256, 1, 512, device="cuda", dtype=torch.bfloat16,
                                         requires_grad=True) for _ in range(3)), scale=0.1)
    # GroupNorm backward against its plain version (bf16: one ulp; fp32 tight).
    for shape, silu, dtype in (((2, 320, 32, 32), True, torch.bfloat16),
                               ((2, 640, 16, 16), False, torch.bfloat16),
                               ((2, 64, 5, 3), True, torch.float32)):
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
        dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
        gamma = torch.rand(shape[1], generator=g, device="cuda") + 0.5
        beta = torch.randn(shape[1], generator=g, device="cuda")
        _, mean, rstd = gn.group_norm_forward(x, gamma, beta, 32, eps=1e-5, silu=silu)
        dx = gn.group_norm_backward(x, gamma, beta, mean, rstd, dy, 32, 1e-5, silu)
        ref = gn.group_norm_backward_reference(x, gamma, beta, mean, rstd, dy, 32, 1e-5, silu)
        if dtype == torch.float32:
            torch.testing.assert_close(dx, ref, atol=1e-5, rtol=1e-5)
        else:
            torch.testing.assert_close(dx.float(), ref.float(), atol=1e-3, rtol=2.0**-7)
