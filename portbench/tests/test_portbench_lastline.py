"""The result line and the trace summary."""
import json

import torch

from portbench import harness, tracing

FWD = "void (anonymous namespace)::flash_fwd_wgmma_kernel<__nv_bfloat16, 64>(CUtensorMap_st)"

TRACE = {"traceEvents": [
    {"ph": "X", "cat": "user_annotation", "name": "portbench.traced", "ts": 0, "dur": 100},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10, "dur": 50},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 80, "dur": 15},
    {"ph": "X", "cat": "kernel", "name": FWD, "ts": 20, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "sm90_gemm", "ts": 25, "dur": 20},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 70, "dur": 5}]}


def ctx(workload, trace):
    return harness.Context(workload=workload, config={}, traffic={}, limits={}, seed=1,
                           seconds=1.0, trace=trace, device=torch.device("cpu"), tmp="",
                           trace_path="", t0=0.0)


def test_untraced_line_keys_and_metrics():
    b = harness.benchmark()
    out = {"attempted": 3, "failed": 0, "checks": [("loss", 0.1, 0.2), ("grad", 0.5, 0.2)],
           "metrics": {"train_samples_per_s": 1.0, "train_step_p95_ms": 2.0,
                       "peak_reserved_gib": 3.0, "setup_s": 4.0}}
    line = harness.result_line(b, ctx("sd21base-train-paper", False), out, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "limits"]
    assert line["correct"] is False  # grad over its limit
    assert set(line["metrics"]) == {"train_samples_per_s", "train_step_p95_ms",
                                    "peak_reserved_gib", "setup_s"}
    assert line["limits"]["grad"] == {"value": 0.5, "limit": 0.2}
    json.dumps(line)


def test_traced_line_reads_the_per_layer_metrics():
    b = harness.benchmark()
    summary = tracing.summarize(TRACE)
    assert summary["window_us"] == 100 and summary["busy_us"] == 30
    assert summary["idle_gaps"][0] == ["aten::mm", 2.5e-05]
    assert summary["kernels"] == {FWD: [1, 10.0], "sm90_gemm": [1, 20.0]}
    readings = {"kind": "sample", "flops": 4e7,
                "trace": summary, "traced_units": 2,
                "kernel_calls": {"flash": {(2, 4096, 5, 64, 4096, "torch.bfloat16"): 1},
                                 "flash_bwd": {}, "gn": {}, "gn_bwd": {}}}
    out = {"attempted": 1, "failed": 0, "checks": [("image_gap", 1.0, 2.0)],
           "readings": readings}
    line = harness.result_line(b, ctx("sd21base-sample-eval", True), out, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "limits"]
    m = line["metrics"]
    assert m["idle_share.sample"]["value"] == 70.0 and m["idle_share.sample"]["unit"] == "%"
    assert m["sample_mfu"]["value"] == 100.0 * 4e7 / 100e-6 / 989e12
    assert m["library_kernel_ms.sample"]["value"] == 0.01
    assert "group_norm_roofline.sample" not in m  # no GroupNorm call traced
    assert not any(k.endswith(".train") for k in m)
    assert len(line["breakdown"]["device_ops"]) == 2
