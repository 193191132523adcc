"""The port's CUDA kernels (forward and backward) against their plain
PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip elsewhere; this file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_port_kernels.py -m cuda -q --noconftest
"""
import dataclasses

import pytest
import torch

from textboost_torch.ops import flash_attention as fa
from textboost_torch.ops import group_norm as gn


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    g = torch.Generator("cuda").manual_seed(0)
    # wgmma variants (bf16/fp16, D % 8 == 0: D <= 128, wide up to 512) and
    # the CUDA-core variant (register tiles: D = 100, fp32 at D = 40 and at
    # the VAE's 512), with ragged N, masked KV tails and a kv_len inside the
    # last 128-key tile at D = 40, 80 and 128.
    for b, n, h, d, m, kv, dtype, variant in (
            (2, 1024, 2, 40, 1024, 1024, torch.bfloat16, "wgmma"),
            (1, 300, 3, 128, 77, 77, torch.bfloat16, "wgmma"),
            (1, 200, 2, 64, 130, 130, torch.float16, "wgmma"),
            (2, 1024, 4, 40, 1024, 1000, torch.bfloat16, "wgmma"),
            (2, 1000, 4, 80, 1024, 650, torch.bfloat16, "wgmma"),
            (2, 1024, 2, 128, 1024, 900, torch.bfloat16, "wgmma"),
            (2, 1024, 4, 64, 1024, 1024, torch.float16, "wgmma"),
            (1, 200, 1, 8, 100, 77, torch.bfloat16, "wgmma"),
            (1, 512, 1, 512, 300, 300, torch.bfloat16, "wgmma_wide"),
            (1, 100, 2, 200, 64, 64, torch.float16, "wgmma_wide"),
            (1, 256, 2, 100, 256, 256, torch.bfloat16, "cuda_cores"),
            (1, 130, 2, 40, 99, 99, torch.float32, "cuda_cores"),
            (1, 256, 1, 512, 256, 256, torch.float32, "cuda_cores")):
        q = torch.randn(b, n, h, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(b, m, h, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(b, m, h, d, generator=g, device="cuda").to(dtype)
        fa.variant_counts.clear()
        o, lse = fa.flash_attention_forward(q, k, v, scale=d**-0.5, kv_len=kv)
        assert dict(fa.variant_counts) == {variant: 1}
        ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(), d**-0.5, kv)
        # o against the fp32 plain version: relative L2 over the whole output
        # and over the worst row (chip_smoke.py states why these limits).
        diff = o.float() - ro
        assert (diff.norm() / ro.norm()).item() <= 5e-3, (b, n, h, d, m, kv, dtype)
        assert (diff.norm(dim=-1) / ro.norm(dim=-1)).max().item() <= 2e-2, (b, n, h, d, m, kv, dtype)
        torch.testing.assert_close(lse, rl, atol=1e-3, rtol=0)
    # Views the TMA unit cannot read in place go to the CUDA cores, and agree.
    qkv = torch.randn(1, 256, 2, 3 * 40 + 4, generator=g, device="cuda").bfloat16()
    q, k, v = (qkv[..., i * 40 + 4:(i + 1) * 40 + 4] for i in range(3))
    fa.variant_counts.clear()
    o, _ = fa.flash_attention_forward(q, k, v, scale=40**-0.5)
    assert dict(fa.variant_counts) == {"cuda_cores": 1}
    ro, _ = fa.flash_attention_reference(q.float(), k.float(), v.float(), 40**-0.5)
    assert ((o.float() - ro).norm() / ro.norm()).item() <= 5e-3
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
    # ragged N, masked KV tails and a kv_len inside the last 64-key tile at
    # D = 40, 80 and 128, against fp32 autograd of plain attention
    # (chip_smoke.py states why these limits).  Two calls on the same inputs
    # must agree bit for bit: the kernels use no atomics.
    for b, n, h, d, m, kv, dtype in ((2, 1024, 2, 40, 1024, 1024, torch.bfloat16),
                                     (1, 300, 2, 64, 320, 250, torch.float16),
                                     (1, 256, 2, 128, 256, 256, torch.bfloat16),
                                     (1, 200, 1, 8, 100, 77, torch.bfloat16),
                                     (2, 512, 3, 80, 512, 400, torch.bfloat16),
                                     (2, 1024, 4, 40, 1024, 1000, torch.bfloat16),
                                     (2, 1000, 4, 80, 1024, 650, torch.bfloat16),
                                     (2, 1024, 2, 128, 1024, 900, torch.bfloat16),
                                     (2, 1024, 4, 64, 1024, 1024, torch.float16)):
        q, do = (torch.randn(b, n, h, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(b, m, h, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        o, lse = fa.flash_attention_forward(q, k, v, scale=d**-0.5, kv_len=kv)
        grads = fa.flash_attention_backward(q, k, v, o, lse, do, scale=d**-0.5, kv_len=kv)
        again = fa.flash_attention_backward(q, k, v, o, lse, do, scale=d**-0.5, kv_len=kv)
        assert all(torch.equal(x, y) for x, y in zip(grads, again)), (b, n, h, d, m, kv, dtype)
        qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
        s = torch.einsum("bnhd,bmhd->bhnm", qf, kf[:, :kv]) * d**-0.5
        torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), vf[:, :kv]).backward(do.float())
        for got, ref in zip(grads, (qf.grad, kf.grad, vf.grad)):
            diff, live = got.float() - ref, ref.norm(dim=-1) > 0
            assert (diff.norm() / ref.norm()).item() <= 5e-3, (b, n, h, d, m, kv, dtype)
            assert (diff.norm(dim=-1)[live] / ref.norm(dim=-1)[live]).max().item() <= 2e-2
        assert not grads[1][:, kv:].any() and not grads[2][:, kv:].any()
    # Two samples from different seeds in one batch: each equals, bit for bit,
    # the kernels' results on that sample alone (no batch or head mix-up).
    parts = []
    for seed in (5, 6):
        gs = torch.Generator("cuda").manual_seed(seed)
        parts.append([torch.randn(1, 1024, 3, 40, generator=gs, device="cuda").bfloat16()
                      for _ in range(4)])
    q, k, v, do = (torch.cat(t) for t in zip(*parts))
    o, lse = fa.flash_attention_forward(q, k, v, scale=40**-0.5)
    grads = fa.flash_attention_backward(q, k, v, o, lse, do, scale=40**-0.5)
    for i, (qi, ki, vi, doi) in enumerate(parts):
        oi, li = fa.flash_attention_forward(qi, ki, vi, scale=40**-0.5)
        gi = fa.flash_attention_backward(qi, ki, vi, oi, li, doi, scale=40**-0.5)
        assert torch.equal(oi, o[i:i + 1]) and torch.equal(li, lse[i:i + 1])
        assert all(torch.equal(x, y[i:i + 1]) for x, y in zip(gi, grads))
    # Dense views whose base is 8 bytes off a 16-byte boundary: the backward
    # copies them and gives the bits it gives on aligned copies.
    qi, ki, vi, doi = parts[0]
    oi, li = fa.flash_attention_forward(qi, ki, vi, scale=40**-0.5)
    want = fa.flash_attention_backward(qi, ki, vi, oi, li, doi, scale=40**-0.5)
    off = [torch.cat([t.new_zeros(4), t.flatten()])[4:].view(t.shape) for t in (qi, ki, vi, oi, doi)]
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 8 for t in off)
    got = fa.flash_attention_backward(*off[:4], li, off[4], scale=40**-0.5)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # 16-bit heads outside the wgmma form train through the mma backward: a
    # 512-wide head and a 160-wide one over 77 keys, their gradients against
    # the plain version on the same o and lse, computed in fp32.
    for n, h, d, m in ((256, 1, 512, 256), (256, 2, 160, 77)):
        q = torch.randn(1, n, h, d, generator=g, device="cuda").bfloat16().requires_grad_()
        k, v = (torch.randn(1, m, h, d, generator=g, device="cuda").bfloat16().requires_grad_()
                for _ in range(2))
        do = torch.randn(1, n, h, d, generator=g, device="cuda").bfloat16()
        fa.bwd_variant_counts.clear()
        fa.flash_attention(q, k, v, scale=d**-0.5).backward(do)
        assert dict(fa.bwd_variant_counts) == {"mma": 1}
        qf, kf, vf = (t.detach().float() for t in (q, k, v))
        with torch.no_grad():
            o, lse = fa.flash_attention_forward(q, k, v, scale=d**-0.5)
        refs = fa.flash_attention_backward_reference(qf, kf, vf, o.float(), lse, do.float(),
                                                     d**-0.5)
        for t, ref in zip((q, k, v), refs):
            diff = t.grad.float() - ref
            assert (diff.norm() / ref.norm()).item() <= 5e-3, (n, h, d, m)
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


@pytest.mark.cuda
def test_group_norm_cluster_plans_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    g = torch.Generator("cuda").manual_seed(2)
    fwd_k, bwd_k = gn.max_cluster_of(gn.SOURCE), gn.max_cluster_of(gn.BWD_SOURCE)
    assert fwd_k >= 2 and bwd_k >= 2
    # (shape, silu, storage offset of x in elements, what the plans must be):
    # a span over several CTAs (UNet level 0), small spans held in
    # registers over two CTAs and in one (UNet 16x16 and 8x8), a VAE decoder
    # span in the shared memory of a cluster and one larger than its
    # cluster's shared memory (streamed), spans whose HW % 8 != 0 (element
    # by element, a chunk of 3 channels of 5x3), and a contiguous x that
    # starts off a 16-byte boundary over a split span (element by element
    # although HW % 8 == 0).
    cases = (((2, 960, 64, 64), True, 0, lambda p: p.cluster > 1 and p.regs == 0),
             ((1, 1280, 16, 16), False, 0, lambda p: p.cluster > 1 and p.regs > 0),
             ((2, 1280, 8, 8), False, 0, lambda p: p.cluster == 1 and p.regs > 0),
             ((1, 128, 512, 512), True, 0, lambda p: p.cluster > 1 and p.regs == 0),
             ((1, 256, 512, 512), True, 0, lambda p: p.streamed),
             ((2, 96, 5, 3), True, 0, lambda p: not p.vector),
             ((1, 320, 33, 35), False, 0, lambda p: not p.vector and p.cluster > 1),
             ((1, 640, 64, 64), True, 1, lambda p: not p.vector and p.cluster > 1))
    for shape, silu, offset, want in cases:
        b, c = shape[:2]
        hw = shape[2] * shape[3]
        plan = gn.plan_group_norm(b, c, 32, hw, torch.bfloat16, False, fwd_k, aligned=offset == 0)
        assert want(plan), shape
        x = torch.empty(b * c * hw + offset, device="cuda", dtype=torch.bfloat16)[offset:]
        x = x.view(shape).copy_(torch.randn(shape, generator=g, device="cuda") * 2 + 0.5)
        assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
        dy = torch.randn(shape, generator=g, device="cuda").bfloat16()
        gamma = torch.rand(c, generator=g, device="cuda") + 0.5
        beta = torch.randn(c, generator=g, device="cuda")
        y, mean, rstd = gn.group_norm_forward(x, gamma, beta, 32, eps=1e-6, silu=silu)
        again = gn.group_norm_forward(x, gamma, beta, 32, eps=1e-6, silu=silu)
        assert all(torch.equal(u, v) for u, v in zip((y, mean, rstd), again)), shape
        ry, rmean, rrstd = gn.group_norm_reference(x, gamma, beta, 32, 1e-6, silu)
        torch.testing.assert_close(y.float(), ry.float(), atol=1e-3, rtol=2.0**-7)
        torch.testing.assert_close(mean, rmean, atol=1e-6, rtol=1e-4)
        torch.testing.assert_close(rstd, rrstd, atol=0, rtol=1e-4)
        dx = gn.group_norm_backward(x, gamma, beta, mean, rstd, dy, 32, 1e-6, silu)
        assert torch.equal(dx, gn.group_norm_backward(x, gamma, beta, mean, rstd, dy, 32, 1e-6,
                                                      silu)), shape
        ref = gn.group_norm_backward_reference(x, gamma, beta, mean, rstd, dy, 32, 1e-6, silu)
        torch.testing.assert_close(dx.float(), ref.float(), atol=1e-3, rtol=2.0**-7)
    # A plan the C side finds inconsistent is refused, and the wrapper
    # raises: chunks that leave the span's end uncovered, and 16-byte
    # vectors over an x that starts off a 16-byte boundary.
    x = torch.randn(2, 320, 16, 16, device="cuda").bfloat16()
    x_off = torch.empty(x.numel() + 1, device="cuda", dtype=torch.bfloat16)[1:]
    x_off = x_off.view(x.shape).copy_(x)
    ones, zeros = torch.ones(320, device="cuda"), torch.zeros(320, device="cuda")
    short = gn.split_span(10 * 256, 2, 1, True, 2)
    short = dataclasses.replace(short, chunk=short.chunk // 2)
    vector = gn.plan_group_norm(2, 320, 32, 256, torch.bfloat16, False, fwd_k)
    assert vector.vector
    real = gn.plan_group_norm
    try:
        for bad, xx in ((short, x), (vector, x_off)):
            gn.plan_group_norm = lambda *args, bad=bad, **kwargs: bad
            with pytest.raises(RuntimeError, match="CUDA error"):
                gn.group_norm_forward(xx, ones, zeros, 32)
    finally:
        gn.plan_group_norm = real
