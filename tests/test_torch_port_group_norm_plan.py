"""The GroupNorm kernels' launch plan (ops/group_norm.py::plan_group_norm)
at every GroupNorm shape of the port's main paths, and chip_smoke.py's
dropped-rank control held against the JAX package.

The shapes come from running the port's models on the meta device
(chip_smoke.group_norm_calls), at the batches of the main paths: the UNet
at 8 (CFG-doubled sampling, training), the VAE decoder at 4, the encoder at
8.  The kernels themselves run only on the card (tests/test_torch_port_kernels.py
and chip_smoke.py); what runs here is the arithmetic around them.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from textboost_tpu.ops.group_norm import _run_bwd as jax_gn_bwd
from textboost_tpu.ops.group_norm import _run_fwd as jax_gn_fwd
from textboost_torch.models.configs import get_spec
from textboost_torch.ops import _build
from textboost_torch.ops import group_norm as gn

SMEM_LIMIT = 227 * 1024  # shared memory a CTA may use on sm_90


@pytest.fixture(scope="module", params=["sd15", "sd21base", "sd21"])
def model_calls(request):
    return request.param, chip_smoke.group_norm_calls(request.param)


def test_the_derived_calls_are_the_launches_of_the_main_paths(model_calls):
    model, calls = model_calls
    spec = get_spec(model)
    _, per_generate = chip_smoke.expected_launches(spec, 1)
    assert sum(calls["unet"].values()) + sum(calls["decode"].values()) == per_generate
    if model == "sd15":
        assert (sum(calls["unet"].values()), sum(calls["decode"].values())) == (61, 30)
    _, _, fwd, bwd = chip_smoke.expected_train_launches(spec)
    assert sum(calls["unet"].values()) + sum(calls["encode"].values()) == fwd
    assert sum(calls["unet_backward"].values()) == bwd
    for name, batch in (("unet", 8), ("unet_backward", 8), ("decode", 4), ("encode", 8)):
        assert {key[0][0] for key in calls[name]} == {batch}


@pytest.mark.parametrize("max_cluster", [8, 16])
@pytest.mark.parametrize("backward", [False, True])
def test_plans_tile_each_span_within_the_card(model_calls, backward, max_cluster):
    _, calls = model_calls
    parts = ("unet_backward",) if backward else ("unet", "decode", "encode")
    for part in parts:
        for shape, groups, _, _ in calls[part]:
            b, c, h, w = shape
            plan = gn.plan_group_norm(b, c, groups, h * w, torch.bfloat16, backward, max_cluster)
            assert plan.span == c // groups * h * w and plan.tensors == 1 + backward
            assert 1 <= plan.cluster <= min(max_cluster, 16)
            assert plan.smem_bytes + 1024 <= SMEM_LIMIT and plan.threads <= gn.MAX_THREADS
            # The chunks tile the span exactly, and no CTA is empty.
            covered = 0
            for start, n in plan.chunks():
                assert start == covered and n > 0
                covered += n
            assert covered == plan.span
            # Registers that hold each chunk in whole 16-byte vectors, or bulk
            # copies with 16-byte aligned offsets and sizes that cover each
            # chunk's resident part, or a plan that goes element by element.
            assert plan.vector == (h * w * 2 % 16 == 0)
            for rank, (start, n) in enumerate(plan.chunks()):
                copies = plan.bulk_copies(rank)
                if plan.regs:
                    assert plan.vector and plan.regs in gn.REGS and plan.threads % 32 == 0
                    assert n <= plan.regs * plan.threads * 8 and plan.smem_bytes == 0
                if plan.regs or not plan.vector:
                    assert copies == []
                    continue
                at = start * 2
                for off, size in copies:
                    assert off % 16 == 0 and size % 16 == 0 and 0 < size <= gn.PIECE_BYTES
                    assert off == at
                    at += size
                assert at == (start + min(plan.resident, n)) * 2
            if part.startswith("unet"):
                assert not plan.streamed, (shape, backward, max_cluster)
            assert (plan.reread_bytes(b, groups) > 0) == plan.streamed


def test_a_split_that_leaves_a_cta_empty_is_refused():
    with pytest.raises(ValueError, match="empty"):
        gn.split_span(64, 2, 1, True, 16)
    assert gn.split_span(64, 2, 1, True, 8).chunks() == [(8 * r, 8) for r in range(8)]


def test_a_register_plan_has_a_shared_memory_twin(model_calls):
    """chip_smoke.py times each register plan against the plan that holds
    the same chunks in shared memory: the same split, other storage."""
    _, calls = model_calls
    twins = 0
    for backward, parts in ((False, ("unet", "decode", "encode")), (True, ("unet_backward",))):
        for part in parts:
            for (b, c, h, w), groups, _, _ in calls[part]:
                plan = gn.plan_group_norm(b, c, groups, h * w, torch.bfloat16, backward, 16)
                if not plan.regs:
                    continue
                twin = gn.split_span(plan.span, plan.elem_bytes, plan.tensors, plan.vector,
                                     plan.cluster, registers=False)
                assert (twin.cluster, twin.chunk, twin.resident) == (
                    plan.cluster, plan.chunk, plan.resident)
                assert twin.regs == 0 and not twin.streamed
                assert twin.smem_bytes == -(-plan.chunk * 2 // 16) * 16 * plan.tensors
                twins += 1
    assert twins > 0


def test_the_plan_limits_are_the_headers():
    header = (_build.CSRC / "group_norm.cuh").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", header).group(1))

    assert constant("kSmemBytes") == gn.SMEM_BYTES
    assert constant("kMaxCluster") == gn.MAX_CLUSTER
    assert constant("kMaxThreads") == gn.MAX_THREADS
    assert constant("kPieceBytes") == gn.PIECE_BYTES


def test_the_plan_is_cached_and_follows_the_tensors_alignment():
    aligned = gn.plan_group_norm(1, 640, 32, 64 * 64, torch.bfloat16, False, 16)
    assert gn.plan_group_norm(1, 640, 32, 64 * 64, torch.bfloat16, False, 16) is aligned
    assert aligned.vector and aligned.chunk % 8 == 0
    # A contiguous view that starts off 16 bytes: element by element over
    # the same cluster, which the C side checks against the pointers.
    moved = gn.plan_group_norm(1, 640, 32, 64 * 64, torch.bfloat16, False, 16, aligned=False)
    assert not moved.vector and moved.cluster == aligned.cluster
    assert moved.launch_args()[-1] == 0 and aligned.launch_args()[-1] == 1


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (NHWC shape, CTAs per span): four, sixteen, and three whose last chunk is
# shorter (a span of 256 fp32 elements in chunks of 88, 88, 80).
PLANS = [((2, 8, 8, 128), 4), ((1, 16, 16, 64), 16), ((2, 8, 8, 128), 3),
         ((2, 8, 8, 128), 2)]


def _outside_the_dropped_rank(t, start):
    """[B, G, span] of an NCHW tensor, before the dropped rank's chunk."""
    return t.reshape(t.shape[0], 32, -1)[..., :start]


def _fails_the_limits(got, want, atol, rtol):
    return not np.all(np.abs(got - want) <= atol + rtol * np.abs(want))


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,cluster", PLANS)
def test_the_dropped_rank_control_fails_against_jax_forward(shape, cluster, silu):
    rng = np.random.default_rng(40 + cluster)
    x = _randn(rng, *shape) * 2 + 0.5
    gamma = _randn(rng, shape[-1]) * 0.2 + 1.0
    beta = _randn(rng, shape[-1]) * 0.1
    b, h, w, c = shape
    plan = gn.split_span(c // 32 * h * w, 4, 1, True, cluster)
    assert plan.cluster == cluster and len({n for _, n in plan.chunks()}) == 1 + (cluster == 3)
    want, _, _ = jax_gn_fwd(jnp.asarray(x.reshape(b, -1, c)), jnp.asarray(gamma),
                            jnp.asarray(beta), 32, 1e-5, silu, True)
    want = torch.from_numpy(np.array(want).reshape(shape)).permute(0, 3, 1, 2)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    dropped, start = chip_smoke.drop_last_rank(tx, plan, 32)
    assert start == plan.chunks()[-1][0]
    assert torch.equal(_outside_the_dropped_rank(dropped, start),
                       _outside_the_dropped_rank(tx, start))
    # fp32 on both sides: the plain version agrees with the JAX kernel (the
    # tolerance of tests/test_torch_port_ops.py), the control fails the
    # limits that chip_smoke.py holds the kernel to.
    y = gn.group_norm_reference(tx, tg, tb, 32, 1e-5, silu)[0]
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=2e-5, rtol=1e-4)
    bad = gn.group_norm_reference(dropped, tg, tb, 32, 1e-5, silu)[0]
    assert _fails_the_limits(_outside_the_dropped_rank(bad, start).numpy(),
                             _outside_the_dropped_rank(want, start).numpy(),
                             chip_smoke.GN_ATOL, chip_smoke.GN_RTOL)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,cluster", PLANS)
def test_the_dropped_rank_control_fails_against_jax_backward(shape, cluster, silu):
    rng = np.random.default_rng(50 + cluster)
    x, dy = _randn(rng, *shape) * 2 + 0.5, _randn(rng, *shape)
    gamma = _randn(rng, shape[-1]) * 0.2 + 1.0
    beta = _randn(rng, shape[-1]) * 0.1
    b, h, w, c = shape
    plan = gn.split_span(c // 32 * h * w, 4, 2, True, cluster)
    x3, dy3 = jnp.asarray(x.reshape(b, -1, c)), jnp.asarray(dy.reshape(b, -1, c))
    _, jmean, jrstd = jax_gn_fwd(x3, jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5, silu, True)
    want = jax_gn_bwd(x3, jnp.asarray(gamma), jnp.asarray(beta), jmean, jrstd, dy3, 32, 1e-5,
                      silu, True)
    want = torch.from_numpy(np.array(want).reshape(shape)).permute(0, 3, 1, 2)
    tx, tdy = (torch.from_numpy(a).permute(0, 3, 1, 2).contiguous() for a in (x, dy))
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    _, mean, rstd = gn.group_norm_reference(tx, tg, tb, 32, 1e-5, silu)
    # fp32 on both sides; the tolerance of tests/test_torch_port_train.py.
    dx = gn.group_norm_backward_reference(tx, tg, tb, mean, rstd, tdy, 32, 1e-5, silu)
    np.testing.assert_allclose(dx.numpy(), want.numpy(), atol=5e-5, rtol=5e-4)
    dropped, start = chip_smoke.drop_last_rank(tdy, plan, 32)
    bad = gn.group_norm_backward_reference(tx, tg, tb, mean, rstd, dropped, 32, 1e-5, silu)
    assert _fails_the_limits(_outside_the_dropped_rank(bad, start).numpy(),
                             _outside_the_dropped_rank(want, start).numpy(),
                             chip_smoke.GN_BWD_ATOL, chip_smoke.GN_BWD_RTOL)
