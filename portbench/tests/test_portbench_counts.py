"""The FLOP and byte counts against shapes worked by hand."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT
from portbench.counts import flops, kernels, readings
from portbench.reference import models


def test_one_attention():
    # q [2, 4096, 5, 64], k/v [2, 4096, 5, 64], bf16: q k^T and p v are
    # 2 x 2*B*H*N*M*D = 4 * 2*5*4096*4096*64 = 4.2950e10 operations; q, k, v,
    # o 2 bytes each over 2*4096*5*64 elements, lse 4 bytes over 2*5*4096.
    b, n, h, d = 2, 4096, 5, 64
    ops = 4 * b * h * n * n * d
    nbytes = 4 * 2 * b * n * h * d + 4 * b * h * n
    want = max(ops / 989e12, nbytes / 3.35e12)
    assert kernels.flash_floor_s(b, n, h, d, n, "torch.bfloat16", False) == pytest.approx(want)
    assert ops / 989e12 > nbytes / 3.35e12  # bound by the tensor cores
    bwd = kernels.flash_floor_s(b, n, h, d, n, "torch.bfloat16", True)
    assert bwd == pytest.approx(max(2.5 * ops / 989e12, (8 * 2 * b * n * h * d + 4 * b * h * n)
                                    / 3.35e12))
    q = torch.empty(b, n, h, d, device="meta")
    with FlopCounterMode(display=False) as c:
        models.attention(q, q, q)
    assert c.get_total_flops() == ops


def test_one_group_norm():
    # x [8, 320, 64, 64] bf16, 32 groups: reads x, gamma, beta, writes y, mean,
    # rstd: 2*2*8*320*4096 + 2*4*320 + 2*4*8*32 bytes, bound by memory.
    shape = (8, 320, 64, 64)
    nbytes = 2 * 2 * 8 * 320 * 4096 + 2 * 4 * 320 + 2 * 4 * 8 * 32
    assert kernels.group_norm_floor_s(shape, "torch.bfloat16", False) == pytest.approx(
        nbytes / 3.35e12)
    nbytes_bwd = 3 * 2 * 8 * 320 * 4096 + 2 * 4 * 320 + 2 * 4 * 8 * 32
    assert kernels.group_norm_floor_s(shape, "torch.bfloat16", True) == pytest.approx(
        nbytes_bwd / 3.35e12)


def test_one_conv():
    # 3x3 conv 320 -> 640 over [2, 320, 32, 32], padding 1: 2 * 2*32*32 *
    # 640 * 320*9 multiply-adds.
    conv = models.Conv(models.Ops(), 320, 640, 3, padding=1).to("meta")
    with FlopCounterMode(display=False) as c:
        conv(torch.empty(2, 320, 32, 32, device="meta"))
    assert c.get_total_flops() == 2 * 2 * 32 * 32 * 640 * 320 * 9


def test_model_flops_of_the_cells():
    """A paper step at sd21base, as counted: about 3 TFLOP a sample (UNet
    forward ~0.8, its backward to the activations ~1.6, the VAE encoder ~0.54,
    CLIP ~0.07); a sampling call ~43 TFLOP an image."""
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs", "sd21base.json")))
    per_sample = flops.train_step(cfg, 2, 4) / 2
    assert 2.5e12 < per_sample < 3.5e12
    assert 38e12 < flops.sample_call(cfg, 1, 25, 4) < 48e12


FWD = "void (anonymous namespace)::flash_fwd_wgmma_kernel<__nv_bfloat16, 64>(CUtensorMap_st)"


def test_a_roofline_share_scales_lost_records():
    key = (2, 4096, 5, 64, 4096, "torch.bfloat16")
    floor = kernels.flash_floor_s(*key[:5], key[5], False)
    r = {"kernel_calls": {"flash": {key: 4}}, "traced_units": 1,
         "trace": {"kernels": {FWD: [3, 3 * 2 * floor * 1e6]}}}
    assert readings.roofline_percent(r, ("flash",)) == pytest.approx(50.0)
    r["trace"]["kernels"] = {}
    assert readings.roofline_percent(r, ("flash",)) is None


@pytest.mark.parametrize("wrapper,names", [
    ("flash", ["void (anonymous namespace)::flash_fwd_wgmma_kernel<__nv_bfloat16, 40>(int)",
               "void (anonymous namespace)::flash_fwd_wgmma_wide_kernel<__nv_bfloat16, 160>(int)",
               "void (anonymous namespace)::flash_fwd_cc_kernel<float, 2>(float const*)"]),
    ("flash_bwd", ["void (anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16, 40>(int)",
                   "void (anonymous namespace)::flash_bwd_dkdv_kernel<__nv_bfloat16, 40>(int)",
                   "void (anonymous namespace)::mma::dq_kernel<__nv_bfloat16, 160>(int)",
                   "void (anonymous namespace)::mma::dkdv_kernel<__nv_bfloat16, 160>(int)",
                   "void (anonymous namespace)::cc::dq_kernel<2>(float const*)",
                   "void (anonymous namespace)::cc::dkdv_kernel<2>(float const*)"]),
])
def test_every_form_of_a_kernel_is_its_own(wrapper, names):
    """Each form's launches count for the wrapper and none for the library;
    a call of K2 launches one dQ and one dK/dV kernel."""
    per_role = len(readings.TAGS[wrapper])
    calls = len(names) // per_role
    r = {"kernel_calls": {wrapper: {"any shape": calls}}, "traced_units": 1,
         "trace": {"kernels": {n: [1, 10.0] for n in names + ["sm90_gemm"]}}}
    assert readings.kernel_time_us(r, wrapper) == pytest.approx(10.0 * len(names))
    assert readings.library_ms(r) == pytest.approx(0.01)


def test_launches_that_miss_the_calls_give_no_share():
    """One lost record is made up; a form that no tag knows leaves its
    launches out, and the share goes."""
    key = (2, 4096, 5, 64, 4096, "torch.bfloat16")
    r = {"kernel_calls": {"flash": {key: 10}}, "traced_units": 1,
         "trace": {"kernels": {FWD: [9, 90.0]}}}
    assert readings.kernel_time_us(r, "flash") == pytest.approx(100.0)
    r["trace"]["kernels"] = {FWD: [8, 80.0], "void (anonymous namespace)::new_form<1>()": [2, 9.0]}
    assert readings.kernel_time_us(r, "flash") is None
    assert readings.roofline_percent(r, ("flash",)) is None
