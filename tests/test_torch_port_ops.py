"""textboost_torch ops held against the JAX package on the same inputs.

The plain PyTorch versions of the two CUDA kernels (flash-attention forward,
GroupNorm(+SiLU) forward) against the Pallas kernels in interpret mode and
the XLA fallbacks; the attention dispatch; the noise schedule; the
DPM-Solver++(2M) sampler; the safetensors reader/writer; and the port's
import isolation.  Inputs come from numpy seeds and go to both sides.
The kernels themselves run only on a GPU (test marked `cuda`).
"""
import ctypes
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textboost_tpu.models.layers import GroupNorm as JaxGroupNorm
from textboost_tpu.ops import attention as jax_attention
from textboost_tpu.ops.flash_attention import _fwd as jax_flash_fwd
from textboost_tpu.ops.flash_attention import flash_attention as jax_flash
from textboost_tpu.ops.group_norm import _run_fwd as jax_gn_fwd
from textboost_tpu.ops.group_norm import fused_group_norm
from textboost_tpu.ops.schedule import NoiseSchedule as JaxSchedule
from textboost_tpu.samplers import solvers as jax_solvers
from textboost_torch.lora.peft_io import load_safetensors, save_safetensors
from textboost_torch.ops import flash_attention as fa
from textboost_torch.ops import group_norm as gn
from textboost_torch.ops.attention import multi_head_attention, use_flash
from textboost_torch.ops.schedule import NoiseSchedule
from textboost_torch.samplers import solvers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# Flash attention (K1): plain version vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,n,h,d,m", [
    (2, 512, 2, 40, 512),  # sd15 level-0 head dim
    (1, 256, 1, 512, 256),  # VAE mid block: one head, d=512
    (1, 256, 2, 40, 77),  # KV tail masked past 77
])
def test_flash_reference_matches_jax_kernel(b, n, h, d, m):
    rng = np.random.default_rng(0)
    q, k, v = _randn(rng, b, n, h, d), _randn(rng, b, m, h, d), _randn(rng, b, m, h, d)
    scale = d**-0.5
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                     interpret=True, block_q=128, block_k=128)
    got, _ = fa.flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), scale)
    # fp32 on both sides; the tolerance of tests/test_flash_attention.py.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("m", [256, 77])
def test_flash_lse_matches_jax_fwd(m):
    rng = np.random.default_rng(1)
    b, n, h, d = 1, 256, 2, 40
    q, k, v = _randn(rng, b, n, h, d), _randn(rng, b, m, h, d), _randn(rng, b, m, h, d)
    scale = d**-0.5

    def bhnd(x, rows):  # [B,N,H,D] -> [B*H, rows, D], zero rows past N
        x = x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d)
        return jnp.asarray(np.pad(x, ((0, 0), (0, rows - x.shape[1]), (0, 0))))

    _, lse_jax = jax_flash_fwd(bhnd(q, n), bhnd(k, 256), bhnd(v, 256), scale, 128, 128, m, True)
    o, lse = fa.flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), scale)
    assert lse.shape == (b, h, n) and lse.dtype == torch.float32
    # logsumexp ~ 6 in fp32: 1e-5 is a few ulps.
    np.testing.assert_allclose(lse.reshape(b * h, n).numpy(), np.asarray(lse_jax)[..., 0],
                               atol=1e-5, rtol=1e-6)


def test_flash_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 128, 2, 24)) for _ in range(3))
    before = fa.launches
    o, lse = fa.flash_attention_forward(q, k, v, scale=0.2, kv_len=100)
    ro, rl = fa.flash_attention_reference(q, k, v, 0.2, 100)
    assert torch.equal(o, ro) and torch.equal(lse, rl)
    assert fa.launches == before  # no kernel ran


# ---------------------------------------------------------------------------
# GroupNorm (K3): plain version vs the Pallas kernel and the XLA fallback
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (1, 16, 16, 256), (1, 8, 8, 320)])
def test_group_norm_reference_matches_jax(shape, silu, eps):
    rng = np.random.default_rng(3)
    x = _randn(rng, *shape)
    gamma = _randn(rng, shape[-1]) * 0.2 + 1.0
    beta = _randn(rng, shape[-1]) * 0.1
    want_pallas = fused_group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32,
                                   eps=eps, silu=silu, interpret=True)
    want_xla = JaxGroupNorm(num_groups=32, eps=eps, silu=silu).apply(
        {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}, jnp.asarray(x)
    )
    got, mean, rstd = gn.group_norm_reference(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(gamma),
        torch.from_numpy(beta), 32, eps, silu,
    )
    # fp32 on all sides; the tolerance of tests/test_group_norm.py.
    np.testing.assert_allclose(_nhwc(got), np.asarray(want_pallas), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want_xla), atol=2e-5, rtol=1e-4)
    _, jmean, jrstd = jax_gn_fwd(jnp.asarray(x.reshape(shape[0], -1, shape[-1])),
                                 jnp.asarray(gamma), jnp.asarray(beta), 32, eps, silu, True)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0, :32], atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0, :32], rtol=1e-5)


def test_group_norm_wrapper_on_cpu_is_the_plain_version_and_differentiable():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_randn(rng, 2, 64, 5, 3)).requires_grad_(True)
    gamma, beta = torch.ones(64), torch.zeros(64)
    before = gn.launches
    y, mean, rstd = gn.group_norm_forward(x, gamma, beta, 32, eps=1e-6, silu=True)
    ry, rmean, rrstd = gn.group_norm_reference(x, gamma, beta, 32, 1e-6, True)
    assert torch.equal(y, ry) and torch.equal(mean, rmean) and torch.equal(rstd, rrstd)
    y.square().sum().backward()  # the CPU path keeps autograd
    assert x.grad is not None and gn.launches == before


def test_group_norm_variance_is_clamped():
    x = torch.full((1, 32, 4, 4), 3.0) + 1e-7 * torch.arange(512.0).reshape(1, 32, 4, 4)
    _, _, rstd = gn.group_norm_reference(x, torch.ones(32), torch.zeros(32), 32, 1e-6, False)
    assert torch.isfinite(rstd).all() and (rstd <= 1e3 + 1).all()


# ---------------------------------------------------------------------------
# Attention dispatch
# ---------------------------------------------------------------------------
def test_auto_rule_sends_the_sd15_shapes_to_flash():
    bf16 = torch.bfloat16
    assert use_flash("cuda", 4096, 4096, 40, bf16, False, False)  # UNet level 0
    assert use_flash("cuda", 1024, 1024, 80, bf16, False, False)  # UNet level 1
    assert use_flash("cuda", 4096, 4096, 512, bf16, False, False)  # VAE mid block
    assert use_flash("cuda", 4096, 4096, 40, torch.float16, False, False)
    assert not use_flash("cuda", 256, 256, 160, bf16, False, False)  # level 2: n < 1024
    assert not use_flash("cuda", 4096, 77, 40, bf16, False, False)  # cross-attention
    assert not use_flash("cuda", 4096, 4096, 40, torch.float32, False, False)
    assert not use_flash("cuda", 77, 77, 64, bf16, True, True)  # CLIP
    assert not use_flash("cpu", 4096, 4096, 40, bf16, False, False)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False), (True, True)])
def test_math_attention_matches_jax(causal, masked):
    rng = np.random.default_rng(5)
    q, k, v = (_randn(rng, 2, 77, 4, 16) for _ in range(3))
    mask = (rng.random((2, 1, 1, 77)) > 0.3) if masked else None
    if mask is not None:
        mask[..., 0] = True
    want = jax_attention.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        mask=None if mask is None else jnp.asarray(mask), impl="xla",
    )
    got = multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        mask=None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)


def test_flash_impl_on_cpu_matches_math():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 256, 2, 40)) for _ in range(3))
    flash = multi_head_attention(q, k, v, impl="flash")
    math = multi_head_attention(q, k, v, impl="math")
    torch.testing.assert_close(flash, math, atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# Schedule and sampler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("beta_schedule", ["scaled_linear", "linear", "squaredcos_cap_v2"])
def test_schedule_tables_bit_identical(beta_schedule):
    want = JaxSchedule.create(beta_schedule=beta_schedule)
    got = NoiseSchedule.create(beta_schedule=beta_schedule)
    assert np.array_equal(got.betas.numpy(), np.asarray(want.betas))
    assert np.array_equal(got.alphas_cumprod.numpy(), np.asarray(want.alphas_cumprod))


@pytest.mark.parametrize("steps", [2, 25])
def test_dpm_coefficients_bit_identical(steps):
    want = jax_solvers._dpm_coeffs(JaxSchedule.create(), steps)
    got = solvers._dpm_coeffs(NoiseSchedule.create(), steps)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_dpm_solver_sample_matches_jax(prediction_type):
    rng = np.random.default_rng(7)
    latents = _randn(rng, 2, 8, 8, 4)
    steps = 6

    def toy(x, t, xp):  # the same denoiser on both sides
        return 0.3 * xp.tanh(x) + 1e-4 * t.reshape(-1, 1, 1, 1) * x

    want = jax_solvers.dpm_solver_sample(
        lambda x, t: toy(x, t.astype(jnp.float32), jnp),
        JaxSchedule.create(prediction_type=prediction_type), jnp.asarray(latents), steps,
    )
    got = solvers.dpm_solver_sample(
        lambda x, t: toy(x, t.float(), torch),
        NoiseSchedule.create(prediction_type=prediction_type), torch.from_numpy(latents), steps,
    )
    # fp32 elementwise math on both sides, summed in possibly another order.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# safetensors reader/writer
# ---------------------------------------------------------------------------
def test_safetensors_round_trip_with_the_safetensors_package(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(8)
    tensors = {
        "a.lora_A.weight": _randn(rng, 4, 64),
        "b": rng.standard_normal((3, 5)).astype(np.float16),
        "c": np.arange(6, dtype=np.int64).reshape(2, 3),
        "d": np.array([True, False]),
    }
    save_safetensors(tensors, str(tmp_path / "port.safetensors"))
    theirs = load_file(str(tmp_path / "port.safetensors"))
    save_file(tensors, str(tmp_path / "lib.safetensors"))
    ours = load_safetensors(str(tmp_path / "lib.safetensors"))
    for name, arr in tensors.items():
        assert theirs[name].dtype == arr.dtype and np.array_equal(theirs[name], arr)
        assert ours[name].dtype == arr.dtype and np.array_equal(ours[name], arr)


def test_safetensors_reads_bf16_as_float32(tmp_path):
    from safetensors.torch import save_file

    t = torch.randn(3, 4).to(torch.bfloat16)
    save_file({"w": t}, str(tmp_path / "bf16.safetensors"))
    got = load_safetensors(str(tmp_path / "bf16.safetensors"))["w"]
    assert got.dtype == np.float32 and np.array_equal(got, t.float().numpy())


# ---------------------------------------------------------------------------
# Isolation
# ---------------------------------------------------------------------------
def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, importlib, textboost_torch\n"
        "for m in pkgutil.walk_packages(textboost_torch.__path__, 'textboost_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'textboost_tpu', 'transformers', 'msgpack', 'ml_dtypes', "
        "'safetensors'))\n"
        "assert not bad, bad\n"
        "assert {'textboost_torch.data.device_augment', 'textboost_torch.data.aux_datasets', "
        "'textboost_torch.tools.gen_null_emb', 'textboost_torch.parallel.mesh', "
        "'textboost_torch.utils.msgpack'} <= set(sys.modules)\n"
        "print(len([m for m in sys.modules if m.startswith('textboost_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported


def _write_csrc(tmp_path, files):
    for name, text in files.items():
        (tmp_path / name).write_text(text)


def test_library_path_follows_the_included_headers(tmp_path, monkeypatch):
    from textboost_torch.ops import _build

    _write_csrc(tmp_path, {
        "a.cu": '#include "h.cuh"\n#include <cuda.h>\n  #  include "missing.cuh"\nint a;\n',
        "b.cu": "int b;\n",
        "h.cuh": '#pragma once\n#include "h2.cuh"\n',
        "h2.cuh": '#include "h.cuh"\nint h2;\n',  # a cycle must not loop
        "other.cuh": "int other;\n",
    })
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.included_headers("a.cu") == ["h.cuh", "h2.cuh"]
    assert _build.included_headers("b.cu") == []
    before = {s: _build.library_path(s) for s in ("a.cu", "b.cu")}
    assert before["a.cu"].name.startswith("a-") and before["a.cu"].parent == tmp_path / "build"
    (tmp_path / "other.cuh").write_text("int other2;\n")  # included by neither
    assert {s: _build.library_path(s) for s in before} == before
    (tmp_path / "h2.cuh").write_text('#include "h.cuh"\nint h2_edited;\n')  # included through h.cuh
    assert _build.library_path("a.cu") != before["a.cu"]
    assert _build.library_path("b.cu") == before["b.cu"]
    edited = _build.library_path("a.cu")
    (tmp_path / "a.cu").write_text((tmp_path / "a.cu").read_text() + "int a2;\n")
    assert _build.library_path("a.cu") != edited


def test_the_flash_sources_hash_their_shared_header():
    from textboost_torch.ops import _build

    # Both flash sources include the register tiles of their CUDA-core forms,
    # which include hopper.cuh.
    for source in (fa.SOURCE, fa.BWD_SOURCE):
        assert _build.included_headers(source) == ["flash_tiles.cuh", "hopper.cuh"]
    # The GroupNorm kernels share their cluster body and reuse its mbarriers.
    for source in (gn.SOURCE, gn.BWD_SOURCE):
        assert _build.included_headers(source) == ["group_norm.cuh", "hopper.cuh"]
    # The forward reports the variant it chose through its last argument.
    assert _build.SIGNATURES[fa.SOURCE]["tb_flash_attention_fwd"][-1] == ctypes.POINTER(ctypes.c_int)


@pytest.mark.parametrize("how,in_place", [
    ("plain", True),
    ("head_slice", True),    # one of three fused projections: strides stay multiples of 8
    ("odd_stride", False),   # a sequence stride of 84 elements
    ("offset", False),       # base 8 bytes off a 16-byte boundary
    ("strided_head_dim", False),
])
def test_kernel_ready_copies_only_what_the_backward_cannot_read_in_place(how, in_place):
    b, n, h, d = 1, 16, 2, 40
    if how == "plain":
        t = torch.arange(b * n * h * d, dtype=torch.float32).bfloat16().view(b, n, h, d)
    elif how == "head_slice":
        t = torch.randn(b, n, h, 3 * d).bfloat16()[..., d:2 * d]
    elif how == "odd_stride":
        t = torch.randn(b, n, h * d + 4).bfloat16()[..., :h * d].unflatten(-1, (h, d))
    elif how == "offset":
        t = torch.randn(b * n * h * d + 4).bfloat16()[4:].view(b, n, h, d)
    else:
        t = torch.randn(b, n, h, 2 * d).bfloat16()[..., ::2]
    ready = fa._kernel_ready(t)
    assert (ready is t) == in_place
    assert torch.equal(ready, t)
    assert ready.stride(-1) == 1 and all(s % 8 == 0 for s in ready.stride()[:-1])
    assert ready.data_ptr() % 16 == 0


@pytest.mark.parametrize("shape,backward,floor,ms", [
    # 16 ex2 per SM and clock on 132 SMs at 1.98 GHz; 989 TFLOP/s; 3.35 TB/s.
    ((8, 4096, 4096, 8, 40), False, "exponentials", 8 * 8 * 4096**2 / (16 * 132 * 1.98e9) * 1e3),
    ((8, 1024, 1024, 8, 80), False, "tensor_cores", 4 * 64 * 1024**2 * 80 / 989e12 * 1e3),
    ((4, 4096, 4096, 1, 512), False, "tensor_cores", 4 * 4 * 4096**2 * 512 / 989e12 * 1e3),
    ((8, 4096, 4096, 8, 40), True, "tensor_cores", 10 * 64 * 4096**2 * 40 / 989e12 * 1e3),
    ((8, 4096, 1, 8, 8), False, "bytes",
     (2 * 2 * (8 * 4096 * 8 * 8 + 8 * 1 * 8 * 8) + 4 * 8 * 8 * 4096) / 3.35e12 * 1e3),
    # fp32 (the CUDA-core forms of K1 in the fp32 flash step): products at 67 TFLOP/s.
    ((8, 4096, 4096, 8, 40), False, "cuda_cores", 4 * 64 * 4096**2 * 40 / 67e12 * 1e3),
    ((8, 4096, 77, 8, 40), False, "cuda_cores", 4 * 64 * 4096 * 77 * 40 / 67e12 * 1e3),
    ((8, 1024, 1024, 8, 80), False, "cuda_cores", 4 * 64 * 1024**2 * 80 / 67e12 * 1e3),
    ((8, 256, 77, 8, 160), False, "cuda_cores", 4 * 64 * 256 * 77 * 160 / 67e12 * 1e3),
    ((8, 4096, 4096, 1, 512), False, "cuda_cores", 4 * 8 * 4096**2 * 512 / 67e12 * 1e3),
])
def test_chip_smoke_floors(shape, backward, floor, ms):
    import chip_smoke

    fp32 = floor == "cuda_cores"
    products = "cuda_cores" if fp32 else "tensor_cores"
    floors = chip_smoke.flash_floors_ms(*shape, backward=backward, sm_count=132,
                                        sm_clock_hz=1.98e9, fp32=fp32)
    assert set(floors) == {"bytes", products, "exponentials"}
    bound = chip_smoke.bound_of(floors)
    assert bound["bound_floor"] == floor
    assert bound["bound_by"] == ("bytes" if floor == "bytes" else "operations")
    assert bound["bound_ms"] == pytest.approx(ms, rel=1e-12)
    assert bound["bound_ms"] == max(floors.values())
    # The backward moves twice the bytes and does 2.5 times the products.
    fwd = chip_smoke.flash_floors_ms(*shape, backward=False, sm_count=132, sm_clock_hz=1.98e9,
                                     fp32=fp32)
    bwd = chip_smoke.flash_floors_ms(*shape, backward=True, sm_count=132, sm_clock_hz=1.98e9,
                                     fp32=fp32)
    assert bwd[products] == pytest.approx(2.5 * fwd[products])
    assert bwd["exponentials"] == fwd["exponentials"]
    assert fwd["bytes"] < bwd["bytes"] < 2 * fwd["bytes"] + 1e-12


def test_chip_smoke_flash_forms_name_the_variants_the_rules_give():
    """Every row of chip_smoke's K1 and K2 form tables names the variant
    that `k1_variant` / `k2_variant` (the C entry points' rules for an
    aligned call) give its dtype and head dim, so that the tables and the
    rules cannot drift apart; and the rules send no 16-bit K2 call and
    every fp32 call to the CUDA cores."""
    import chip_smoke

    assert len(chip_smoke.FLASH_FWD_FORMS) >= 9 and len(chip_smoke.FLASH_BWD_FORMS) >= 20
    for name, _, _, _, d, _, dt, variant, _ in chip_smoke.FLASH_FWD_FORMS:
        assert chip_smoke.k1_variant(dt, d) == variant, name
        assert variant in fa.VARIANTS
    for name, _, _, _, d, _, _, dt, variant, _ in chip_smoke.FLASH_BWD_FORMS:
        assert chip_smoke.k2_variant(dt, d) == variant, name
        assert variant in fa.BWD_VARIANTS
    for d in (8, 33, 40, 64, 80, 100, 128, 136, 160, 512):
        assert chip_smoke.k2_variant("float32", d) == "cuda_cores"
        assert chip_smoke.k1_variant("float32", d) == "cuda_cores"
        for dt in ("bfloat16", "float16"):
            assert chip_smoke.k2_variant(dt, d) == ("wgmma" if d <= 128 and d % 8 == 0
                                                    else "mma")
            assert chip_smoke.k1_variant(dt, d) == ("cuda_cores" if d % 8 else
                                                    "wgmma" if d <= 128 else "wgmma_wide")
    assert set(chip_smoke.K2_TILE_KEYS) == set(fa.BWD_VARIANTS)
    assert set(chip_smoke.K1_TILE_KEYS) == set(fa.VARIANTS)
