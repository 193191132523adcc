"""`--attention_impl flash` held against the JAX package on the CPU.

The port's flash path (plain forward and backward of the two kernels, the
dispatch of `multi_head_attention(impl="flash")`, the tiny UNet under
"flash", one training step through the CLI) against the JAX package's
`flash_attention` run in interpret mode, on the same numpy inputs.  Nothing
in the JAX package changes: the tests switch its attention to "flash" and
its kernel to interpret mode by monkeypatch.  Also: the JAX package's
"flash" drops CLIP's causal mask (ROADMAP.md C11), the port's does not; and
`--attention_impl xla` leaves the GroupNorm kernels on.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textboost_tpu.models.clip import CLIPTextModel as JaxCLIP
from textboost_tpu.models.pretrained import load_models as jax_load_models
from textboost_tpu.ops import attention as jax_attention
from textboost_tpu.ops import flash_attention as jax_fa
from textboost_torch.models.clip import CLIPTextModel
from textboost_torch.models.configs import get_spec
from textboost_torch.models.convert import state_dict_from_jax
from textboost_torch.models.layers import CrossAttention, GroupNorm, VAEAttention
from textboost_torch.models.layers import set_attention_impl
from textboost_torch.models.pretrained import build_models
from textboost_torch.ops import attention as port_attention
from textboost_torch.ops import flash_attention as fa
from textboost_torch.train import main as train_main
from textboost_torch.train.config import parse_args
from textboost_torch.train.trainer import Trainer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models run thousands of small ops; under the suite's other
    workers torch's thread pool waits on its own threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX package with every attention on "flash" and its Pallas
    kernels in interpret mode (as its own tests run them on the CPU)."""
    monkeypatch.setattr(jax_attention, "_DEFAULT_IMPL", "flash")
    monkeypatch.setattr(jax_fa, "flash_attention",
                        functools.partial(jax_fa.flash_attention, interpret=True))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Ops: the plain versions of K1 and K2 against the Pallas kernels
# ---------------------------------------------------------------------------
# fp32: both sides sum in fp32 in another order (the Pallas kernel over
# blocks of 128 keys with D zero-padded to 128); bf16: the inputs are bf16
# on both sides, the JAX kernel keeps dq in fp32 but rounds dk, dv and o to
# bf16, as the port's plain version does (one bf16 ulp, 2**-8 relative).
# The shapes are those the kernels' CUDA-core and mma forms serve: fp32 at
# D = 160, 100 and the VAE's 512, a head dim of 33 over 130 keys (N = 300
# is outside the JAX kernel's envelope: there the JAX function's XLA path
# answers), and bf16 heads of 40 and 160 over the 77 text keys.
@pytest.mark.parametrize("b,n,h,d,m,dtype,atol,rtol", [
    (1, 256, 2, 160, 77, "float32", 2e-5, 1e-4),
    (1, 256, 2, 40, 77, "bfloat16", 2e-2, 2e-2),
    (1, 256, 1, 100, 256, "float32", 2e-5, 1e-4),
    (1, 256, 1, 512, 256, "float32", 2e-5, 1e-4),
    (1, 300, 2, 33, 130, "float32", 2e-5, 1e-4),
    (1, 256, 2, 160, 77, "bfloat16", 2e-2, 2e-2),
])
def test_flash_plain_versions_match_the_jax_kernels(b, n, h, d, m, dtype, atol, rtol):
    rng = np.random.default_rng(31)
    q, do = _randn(rng, b, n, h, d), _randn(rng, b, n, h, d)
    k, v = _randn(rng, b, m, h, d), _randn(rng, b, m, h, d)
    jdt = jnp.dtype(dtype)
    scale = d**-0.5

    def loss(q, k, v):
        o = jax_fa.flash_attention(q, k, v, scale=scale, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do)), o

    (_, want_o), want_grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    got_o = fa.flash_attention(tq, tk, tv, scale=scale)
    got_o.backward(torch.from_numpy(do).to(tdt))
    np.testing.assert_allclose(got_o.float().detach().numpy(),
                               np.asarray(want_o.astype(jnp.float32)), atol=atol, rtol=rtol)
    for name, got, want in zip(("dq", "dk", "dv"), (tq, tk, tv), want_grads):
        np.testing.assert_allclose(got.grad.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("how,in_place", [
    ("odd_stride", True),    # a sequence stride of 84 elements
    ("offset", True),        # base 8 bytes off a 16-byte boundary
    ("packed", True),        # one of three fused fp32 projections, strides of 121
    ("strided_head_dim", False),
])
def test_cuda_core_backward_reads_views_in_place(how, in_place):
    """The CUDA-core backward (fp32, wide or odd heads) reads any strides
    over a contiguous head dim: only a strided head dim is copied."""
    b, n, h, d = 1, 16, 2, 40
    if how == "odd_stride":
        t = torch.randn(b, n, h * d + 4)[..., :h * d].unflatten(-1, (h, d))
    elif how == "offset":
        t = torch.randn(b * n * h * d + 2)[2:].view(b, n, h, d)
    elif how == "packed":
        t = torch.randn(b, n, h, 3 * d + 1)[..., 1 + d:1 + 2 * d]
    else:
        t = torch.randn(b, n, h, 2 * d)[..., ::2]
    ready = fa._kernel_ready(t, wgmma=False)
    assert (ready is t) == in_place
    assert torch.equal(ready, t) and ready.stride(-1) == 1


def test_backward_out_buffers_are_for_the_kernels_only():
    """`out=` names the buffers the CUDA kernels write into; on the CPU the
    plain version returns new tensors, and a given buffer raises."""
    q = torch.randn(1, 16, 1, 8)
    o, lse = fa.flash_attention_forward(q, q, q, scale=0.5)
    with pytest.raises(ValueError, match="out="):
        fa.flash_attention_backward(q, q, q, o, lse, q, scale=0.5,
                                    out=tuple(torch.empty_like(q) for _ in range(3)))


# ---------------------------------------------------------------------------
# Dispatch: which calls "flash" sends to the kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,m,d,dtype,masked,causal,want", [
    (256, 256, 40, torch.float32, False, False, True),
    (256, 77, 160, torch.bfloat16, False, False, True),   # cross-attention over the text
    (4096, 77, 40, torch.float16, False, False, True),
    (256, 256, 512, torch.float32, False, False, True),   # the VAE's head
    (64, 77, 160, torch.bfloat16, False, False, False),   # sd15's mid block: n < 256
    (384, 384, 513, torch.float32, False, False, False),  # past the JAX envelope
    (300, 300, 40, torch.float32, False, False, False),   # n % 128 != 0
    (256, 256, 40, torch.float32, True, False, False),
    (256, 256, 40, torch.float32, False, True, False),
    (77, 77, 16, torch.float32, True, True, False),       # CLIP
])
def test_flash_impl_sends_the_jax_kernels_calls_and_keeps_masks(monkeypatch, n, m, d, dtype,
                                                                  masked, causal, want):
    calls = []

    def spy(q, k, v, *, scale, kv_len=None):
        calls.append((tuple(q.shape), k.shape[1]))
        return fa.flash_attention(q, k, v, scale=scale, kv_len=kv_len)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    rng = np.random.default_rng(32)
    q = torch.from_numpy(_randn(rng, 1, n, 1, d)).to(dtype)
    k, v = (torch.from_numpy(_randn(rng, 1, m, 1, d)).to(dtype) for _ in range(2))
    mask = None
    if masked:
        keep = rng.random((1, 1, 1, m)) > 0.3
        keep[..., 0] = True
        mask = torch.from_numpy(keep)
    got = port_attention.multi_head_attention(q, k, v, mask=mask, causal=causal, impl="flash")
    assert calls == ([((1, n, 1, d), m)] if want else [])
    ref = port_attention.multi_head_attention(q, k, v, mask=mask, causal=causal, impl="math")
    # Outside the envelope "flash" is the math path itself, mask and all.
    if not want:
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2 if dtype != torch.float32
                                   else 2e-6, rtol=1e-5 if dtype == torch.float32 else 2e-2)


# ---------------------------------------------------------------------------
# Modules: the tiny UNet under "flash" against the JAX UNet's kernels
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_pair():
    jax_tiny = jax_load_models(preset="tiny", lora_rank=4, dtype=jnp.float32)
    _, unet, _ = build_models(get_spec("tiny"), lora_rank=4, device="cpu")
    unet.load_state_dict(state_dict_from_jax("unet", jax_tiny.unet_params), strict=True)
    return jax_tiny, unet.eval()


def test_tiny_unet_under_flash_matches_the_jax_unet_under_its_kernels(tiny_pair, jax_flash,
                                                                       monkeypatch):
    """At 16x16 latents level 0 has 256 tokens: its self-attention (256 keys)
    and cross-attention (77 keys) take the kernels on both sides; the levels
    of 64 tokens the math path.  Forward, and the gradients of a fixed
    projection of the output with respect to the latents and the text."""
    jax_tiny, unet = tiny_pair
    rng = np.random.default_rng(33)
    x = _randn(rng, 2, 16, 16, 4)
    t = np.array([3, 871], np.int32)
    ctx = _randn(rng, 2, 77, 64)
    w = _randn(rng, 2, 16, 16, 4)

    def loss(x, ctx):
        out = jax_tiny.unet.apply(jax_tiny.unet_params, x, jnp.asarray(t), ctx)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), (want_dx, want_dctx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(ctx))

    calls = []
    real = port_attention.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), k.shape[1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    set_attention_impl(unet, "flash")
    try:
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
        tctx = torch.from_numpy(ctx).requires_grad_()
        out = unet(tx, torch.from_numpy(t), tctx)
        (out * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    finally:
        set_attention_impl(unet, "auto")
    # Level 0: one down and two up transformers, self (256 keys) and cross (77).
    assert sorted(set(calls)) == [((2, 256, 2, 16), 77), ((2, 256, 2, 16), 256)]
    assert len(calls) == 6
    # fp32, the tolerance of the UNet's parity test (tests/test_torch_port_models.py).
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_dx),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(tctx.grad.numpy(), np.asarray(want_dctx), atol=5e-4, rtol=1e-3)


def test_jax_flash_drops_clips_causal_mask_and_the_port_keeps_it(jax_flash):
    """ROADMAP.md C11: under "flash" the JAX `multi_head_attention` hands
    `flash_attention` the call without its mask; CLIP's 77 tokens are outside
    the kernel's envelope, so the wrapper's unmasked fallback runs, and the
    text encoder is no longer causal.  The port's CLIP (whose attention has
    no impl) gives what the JAX CLIP gives under "xla"."""
    spec = get_spec("tiny").text_encoder
    rng = np.random.default_rng(34)
    ids = rng.integers(0, 49406, (2, 77)).astype(np.int32)
    jax_te = JaxCLIP(spec, lora_rank=0, dtype=jnp.float32)
    params = jax_te.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    under_flash = np.asarray(jax_te.apply(params, jnp.asarray(ids))[0])
    jax_attention._DEFAULT_IMPL = "xla"  # restored by the fixture's monkeypatch
    under_xla = np.asarray(jax_te.apply(params, jnp.asarray(ids))[0])
    assert np.abs(under_flash - under_xla).max() > 1e-2  # no longer causal

    te = CLIPTextModel(spec, lora_rank=0)
    te.load_state_dict(state_dict_from_jax("text_encoder", params), strict=True)
    with torch.no_grad():
        got = te(torch.from_numpy(ids.astype(np.int64)))[0].numpy()
    np.testing.assert_allclose(got, under_xla, atol=1e-4, rtol=1e-4)  # fp32 on both sides


# ---------------------------------------------------------------------------
# The training CLI
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def instance_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("instance")
    rng = np.random.default_rng(35)
    Image.fromarray(rng.integers(0, 256, (96, 80, 3), dtype=np.uint8)).save(d / "img0.png")
    return str(d)


def _flags(instance_dir, out, *extra):
    return ["--device", "cpu", "--model_preset", "tiny", "--instance_data_dir", instance_dir,
            "--output_dir", out, "--placeholder_token", "<v*>", "--initializer_token", "dog",
            "--max_train_steps", "1", "--train_batch_size", "2", "--resolution", "128",
            "--checkpointing_steps", "0", "--report_to", "none", *extra]


def test_cli_trains_one_step_under_flash(instance_dir, tmp_path, monkeypatch):
    """One `--attention_impl flash` step at tiny: level 0's self- and
    cross-attention (256 queries, 256 or 77 keys) go through the flash
    Function forward and backward; the loss is finite and the exports are
    written."""
    calls = []
    real = port_attention.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), k.shape[1], torch.is_grad_enabled() and q.requires_grad))
        return real(q, k, v, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    out = str(tmp_path / "out")
    metrics = train_main(_flags(instance_dir, out, "--attention_impl", "flash"))
    assert metrics["steps"] == 1 and np.isfinite(metrics["loss"])
    assert {(shape[1], m) for shape, m, _ in calls} == {(256, 256), (256, 77)}
    assert any(grad and m == 77 for _, m, grad in calls)  # the text's gradient road
    assert (tmp_path / "out" / "text_encoder" / "adapter_model.safetensors").is_file()


def test_attention_impl_xla_leaves_the_group_norm_kernels_on(instance_dir, tmp_path):
    """As in the JAX package, `--attention_impl` switches attention only:
    under "xla" every attention layer takes the math path and every
    GroupNorm keeps "auto" (the K3/K4 kernels on the card)."""
    trainer = Trainer(parse_args(_flags(instance_dir, str(tmp_path / "out"),
                                        "--attention_impl", "xla")[2:]), device="cpu")
    try:
        for model in (trainer.state.unet, trainer.state.vae):
            norms = [m.impl for m in model.modules() if isinstance(m, GroupNorm)]
            attns = [m.impl for m in model.modules()
                     if isinstance(m, (CrossAttention, VAEAttention))]
            assert norms and set(norms) == {"auto"}
            assert attns and set(attns) == {"math"}
    finally:
        trainer.train_loader.stop()
        trainer.prior_loader.stop()
